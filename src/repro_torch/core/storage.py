"""Memtables and SSTables (§4.1), per-cohort storage engine.

Committed writes land in a sorted in-memory *memtable*; when it exceeds a
threshold it is flushed to an immutable *SSTable* tagged with the min/max
LSN of the writes it contains (§6.1: catch-up falls back to SSTables when
the log has rolled over).  Background size-tiered compaction merges small
SSTables.  Reads consult the memtable, then SSTables newest-first.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

from .types import Cell, CONTROL_OPS, LogRecord, OpType


def _in_range(key: str, lo: str, hi: str) -> bool:
    """[lo, hi) membership; hi == "" means +inf (tail range)."""
    return key >= lo and (hi == "" or key < hi)


def _cell_bytes(colname: str, cell: Cell) -> int:
    return 48 + len(colname) + (
        len(cell.value) if isinstance(cell.value, (bytes, str)) else 16)


class Memtable:
    def __init__(self):
        self.rows: dict[str, dict[str, Cell]] = {}
        self.bytes = 0
        self.min_lsn: Optional[int] = None
        self.max_lsn: int = 0

    def apply(self, rec: LogRecord) -> None:
        """Apply a committed record.  Idempotent: re-applying the same LSN
        leaves identical state (local recovery replays ranges of the log)."""
        row = self.rows.setdefault(rec.key, {})
        for colname, value, version in rec.columns:
            old = row.get(colname)
            if old is not None and old.lsn >= rec.lsn:
                continue  # replay of an already-applied record
            deleted = rec.op in (OpType.DELETE, OpType.COND_DELETE) or value is None
            row[colname] = Cell(value=None if deleted else value,
                                version=version, lsn=rec.lsn, deleted=deleted)
            self.bytes += 48 + len(colname) + (
                len(value) if isinstance(value, (bytes, str)) else 16)
        if self.min_lsn is None:
            self.min_lsn = rec.lsn
        self.max_lsn = max(self.max_lsn, rec.lsn)

    def get(self, key: str, colname: str) -> Optional[Cell]:
        row = self.rows.get(key)
        return row.get(colname) if row else None

    def items(self) -> Iterator[tuple[str, str, Cell]]:
        for key in sorted(self.rows):
            for colname in sorted(self.rows[key]):
                yield key, colname, self.rows[key][colname]


@dataclass
class SSTable:
    """Immutable sorted run, indexed by (key, colname); LSN-tagged (§6.1)."""
    cells: dict[tuple[str, str], Cell]
    min_lsn: int
    max_lsn: int

    def get(self, key: str, colname: str) -> Optional[Cell]:
        return self.cells.get((key, colname))

    @property
    def nbytes(self) -> int:
        return 48 * len(self.cells)


class Store:
    """Per-(node, range) storage engine: one memtable + SSTable stack.

    The memtable is volatile (rebuilt by local recovery); SSTables and the
    flushed-LSN watermark are durable.
    """

    def __init__(self, flush_threshold_bytes: int = 4 << 20,
                 compact_fanin: int = 4):
        self.memtable = Memtable()
        self.sstables: list[SSTable] = []   # oldest first
        self.flush_threshold = flush_threshold_bytes
        self.compact_fanin = compact_fanin
        self.flushed_upto = 0               # durable watermark
        self.flushes = 0
        self.compactions = 0

    # -- write path -----------------------------------------------------------
    def apply(self, rec: LogRecord) -> None:
        if rec.op in CONTROL_OPS:
            return  # range/txn control records carry no direct row data
        self.memtable.apply(rec)

    def maybe_flush(self, committed_lsn: int) -> Optional[int]:
        """Flush the memtable if over threshold.  Returns the new flushed
        watermark (callers feed it to WAL.note_flushed for log GC)."""
        if self.memtable.bytes < self.flush_threshold or self.memtable.min_lsn is None:
            return None
        return self.flush(committed_lsn)

    def flush(self, committed_lsn: int) -> int:
        mt = self.memtable
        if mt.min_lsn is None:
            return self.flushed_upto
        cells = {(k, c): cell for k, c, cell in mt.items()}
        self.sstables.append(SSTable(cells=cells, min_lsn=mt.min_lsn,
                                     max_lsn=mt.max_lsn))
        self.flushed_upto = max(self.flushed_upto, committed_lsn)
        self.memtable = Memtable()
        self.flushes += 1
        self._maybe_compact()
        return self.flushed_upto

    def _maybe_compact(self) -> None:
        """Size-tiered: merge the `fanin` *oldest* runs when they pile up.

        The victims are the oldest runs and the merged run becomes the new
        bottom of the stack, so dropping its tombstones cannot resurrect
        anything: every surviving cell above has a higher LSN (SSTable LSN
        ranges are disjoint and flush-ordered) and still wins reads.  The
        GC is visible to `cells_with_lsn_above` — peers catching up from
        SSTables after the log rolled over miss the delete, the same
        gc-grace caveat real LSM stores carry (§6.1)."""
        if len(self.sstables) < self.compact_fanin * 2:
            return
        merged: dict[tuple[str, str], Cell] = {}
        victims = self.sstables[:self.compact_fanin]
        for t in victims:  # oldest→newest so newer cells overwrite
            merged.update(t.cells)
        merged = {k: v for k, v in merged.items() if not v.deleted}
        self.sstables = [SSTable(
            cells=merged,
            min_lsn=min(t.min_lsn for t in victims),
            max_lsn=max(t.max_lsn for t in victims))] + self.sstables[self.compact_fanin:]
        self.compactions += 1

    # -- read path ------------------------------------------------------------
    def get(self, key: str, colname: str) -> Optional[Cell]:
        """Newest cell for (key, colname), or None if never written.

        CONTRACT: deletes are returned as tombstone cells
        (`cell.deleted == True`, `cell.value is None`) rather than None.
        Callers that present reads to clients must check `.deleted` and
        report NOT_FOUND; callers doing version arithmetic (conditional
        puts) must keep using the tombstone's `version` so versions stay
        monotone across a delete.  Only after a whole-stack compaction
        garbage-collects the tombstone does `get` return None (and
        `current_version` restarts at 0)."""
        best = self.memtable.get(key, colname)
        for t in reversed(self.sstables):
            c = t.get(key, colname)
            if c is not None and (best is None or c.lsn > best.lsn):
                best = c
        return best

    def current_version(self, key: str, colname: str) -> int:
        cell = self.get(key, colname)
        if cell is None:
            return 0
        return cell.version

    # -- catch-up source (SSTable path, §6.1) ----------------------------------
    def cells_with_lsn_above(self, lo_excl: int) -> list[tuple[str, str, Cell]]:
        out: dict[tuple[str, str], Cell] = {}
        for t in self.sstables:
            for (k, c), cell in t.cells.items():
                if cell.lsn > lo_excl:
                    prev = out.get((k, c))
                    if prev is None or cell.lsn > prev.lsn:
                        out[(k, c)] = cell
        for k, c, cell in self.memtable.items():
            if cell.lsn > lo_excl:
                prev = out.get((k, c))
                if prev is None or cell.lsn > prev.lsn:
                    out[(k, c)] = cell
        return [(k, c, cell) for (k, c), cell in sorted(out.items())]

    # -- range lifecycle (live splits / migration, core/ranges.py) -------------
    def iter_range(self, lo: str, hi: str) -> Iterator[tuple[str, str, Cell]]:
        """Newest-wins cells with key in [lo, hi), sorted by (key, colname).
        Tombstones are included (a migrating replica must learn deletes)."""
        out: dict[tuple[str, str], Cell] = {}
        for t in self.sstables:
            for (k, c), cell in t.cells.items():
                if _in_range(k, lo, hi):
                    prev = out.get((k, c))
                    if prev is None or cell.lsn > prev.lsn:
                        out[(k, c)] = cell
        for k, c, cell in self.memtable.items():
            if _in_range(k, lo, hi):
                prev = out.get((k, c))
                if prev is None or cell.lsn > prev.lsn:
                    out[(k, c)] = cell
        for (k, c), cell in sorted(out.items()):
            yield k, c, cell

    def keys_in_range(self, lo: str, hi: str) -> list[str]:
        keys: set[str] = set()
        for t in self.sstables:
            keys.update(k for (k, _c) in t.cells if _in_range(k, lo, hi))
        keys.update(k for k in self.memtable.rows if _in_range(k, lo, hi))
        return sorted(keys)

    def median_key(self, lo: str, hi: str) -> Optional[str]:
        """Median stored key strictly above `lo` — the default split point.
        None when the range has fewer than 2 distinct keys (unsplittable)."""
        keys = self.keys_in_range(lo, hi)
        if len(keys) < 2:
            return None
        return keys[len(keys) // 2]   # index >= 1, so strictly above lo

    def detach_range(self, lo: str, hi: str, fork_lsn: int = 0) -> "Store":
        """Fork [lo, hi) out into a new child Store with zero data copy:
        SSTable cells move by reference into one LSN-tagged child run, and
        the child's durable watermark covers everything forked (the fork
        rides the durable SPLIT record that triggered it, so a restarted
        child recovers via snapshot catch-up, not from its empty log)."""
        moved: dict[tuple[str, str], Cell] = {}
        for t in self.sstables:
            take = {(k, c): cell for (k, c), cell in t.cells.items()
                    if _in_range(k, lo, hi)}
            if take:
                for kc in take:
                    del t.cells[kc]
                for kc, cell in take.items():
                    prev = moved.get(kc)
                    if prev is None or cell.lsn > prev.lsn:
                        moved[kc] = cell
        mt = self.memtable
        for key in [k for k in mt.rows if _in_range(k, lo, hi)]:
            for colname, cell in mt.rows.pop(key).items():
                prev = moved.get((key, colname))
                if prev is None or cell.lsn > prev.lsn:
                    moved[(key, colname)] = cell
        # recompute parent memtable byte accounting after the eviction
        mt.bytes = sum(_cell_bytes(c, cell)
                       for row in mt.rows.values()
                       for c, cell in row.items())
        child = Store(flush_threshold_bytes=self.flush_threshold,
                      compact_fanin=self.compact_fanin)
        if moved:
            lsns = [cell.lsn for cell in moved.values()]
            child.sstables = [SSTable(cells=moved, min_lsn=min(lsns),
                                      max_lsn=max(lsns))]
        child.flushed_upto = max(fork_lsn,
                                 max((c.lsn for c in moved.values()),
                                     default=0))
        return child

    def restrict(self, lo: str, hi: str) -> None:
        """Drop every cell outside [lo, hi) — boot-time reconciliation when
        coordination metadata says this replica's range narrowed while the
        node was down (the data lives in the child cohort now)."""
        for t in self.sstables:
            for kc in [kc for kc in t.cells if not _in_range(kc[0], lo, hi)]:
                del t.cells[kc]
        self.sstables = [t for t in self.sstables if t.cells]
        mt = self.memtable
        for key in [k for k in mt.rows if not _in_range(k, lo, hi)]:
            del mt.rows[key]
        mt.bytes = sum(_cell_bytes(c, cell)
                       for row in mt.rows.values()
                       for c, cell in row.items())

    # -- crash ------------------------------------------------------------------
    def crash_volatile(self) -> None:
        self.memtable = Memtable()

    def lose_disk(self) -> None:
        """Disk failure: SSTables and watermark gone (§6.1 'lost all its
        data because of a disk failure ... moves directly to catch up')."""
        self.memtable = Memtable()
        self.sstables = []
        self.flushed_upto = 0
