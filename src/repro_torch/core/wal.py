"""Shared write-ahead log (one per node, shared by the node's 3 cohorts).

Implements the paper's §4.1/§6 log semantics on the simulator:

- records from multiple cohorts interleave in one physical log, each cohort
  using its own logical LSN sequence;
- group commit: concurrent force requests coalesce into one device force
  (`Disk.force` models this);
- *non-forced* appends (commit markers) become durable when any later force
  completes;
- crash loses the un-forced tail; durable records survive;
- *logical truncation* (§6.1.1): per-range skipped-LSN lists, persisted,
  consulted by local recovery so discarded records are never re-applied;
- segment rollover + GC once every record in a segment is captured in an
  SSTable (tracked via per-range `flushed_upto`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Union

from .sim import Disk, Simulator
from .types import CommitMarker, LogRecord

Entry = Union[LogRecord, CommitMarker]


@dataclass
class _Pending:
    entry: Entry
    forced: bool
    cb: Optional[Callable]


class WAL:
    def __init__(self, sim: Simulator, disk: Disk, segment_bytes: int = 1 << 20):
        self.sim = sim
        self.disk = disk
        self.segment_bytes = segment_bytes

        # Durable state (survives crash):
        self.durable: list[Entry] = []
        self.durable_bytes = 0
        # per-range skipped-LSN lists, persisted out-of-band (§6.1.1 "saved to
        # a known location on disk")
        self.skipped: dict[int, set[int]] = {}
        # per-range flushed-to-SSTable watermark (enables segment GC)
        self.flushed_upto: dict[int, int] = {}
        # GC low-water mark: durable entries with index < gc_index discarded
        self._gc_dropped_upto: dict[int, int] = {}
        # per-range GC floor (core/txn.py): records at or above the floor
        # are pinned — an unresolved 2PC prepare/decision must survive in
        # the log until it resolves, whatever the SSTable watermark says
        self.gc_floor: dict[int, int] = {}

        # Volatile state (lost on crash):
        self._buffer: list[_Pending] = []
        self.appends = 0
        # observability hook: called as (kind, range_id, lsn) on GC-floor
        # pin/release transitions (wired by the owning node)
        self.on_gc_event: Optional[Callable[[str, int, Optional[int]], None]] \
            = None

    # -- write path ---------------------------------------------------------
    def append(self, entry: Entry, force: bool, cb: Optional[Callable] = None,
               component: str = "wal.force",
               rid: Optional[int] = None) -> None:
        """Append an entry.  If `force`, `cb()` fires when it is durable.
        Non-forced entries ride along with the next force (commit markers).
        `component`/`rid` label the resulting device force for the resource
        profiler (e.g. catch-up installs vs the normal data path)."""
        self.appends += 1
        if isinstance(entry, LogRecord):
            # re-appending an LSN supersedes an earlier logical truncation of
            # it (catch-up re-sends committed writes; the fresh durable copy
            # must be replayed by future local recovery)
            sk = self.skipped.get(entry.range_id)
            if sk is not None:
                sk.discard(entry.lsn)
        self._buffer.append(_Pending(entry, force, cb))
        if force:
            self.force(component=component, rid=rid)

    def force(self, cb: Optional[Callable] = None,
              component: str = "wal.force",
              rid: Optional[int] = None) -> None:
        """Force the buffered tail to disk with one device write; `cb()`
        fires when every buffered entry (and everything forced before it —
        the device is FIFO) is durable.  This is the leader-side batch
        force: a batch is appended record-by-record with `force=False` and
        covered by a single `force(cb)` at flush time.  An empty buffer
        still issues a zero-byte barrier so `cb` orders after any force
        already in flight."""
        batch = self._buffer
        self._buffer = []
        nbytes = sum(self._entry_bytes(p.entry) for p in batch)

        def on_durable():
            for p in batch:
                self.durable.append(p.entry)
                self.durable_bytes += self._entry_bytes(p.entry)
            for p in batch:
                if p.cb is not None:
                    p.cb()
            if cb is not None:
                cb()

        self.disk.force(nbytes, on_durable, component=component, rid=rid)

    @staticmethod
    def _entry_bytes(entry: Entry) -> int:
        return entry.nbytes() if isinstance(entry, LogRecord) else 16

    # -- crash/recovery -----------------------------------------------------
    def crash(self) -> None:
        """Lose the un-forced tail and any in-flight force callbacks."""
        self._buffer.clear()
        self.disk.crash()

    def recover_range(self, range_id: int) -> tuple[list[LogRecord], int]:
        """Scan the durable log for one range.

        Returns (records, last_committed_lsn) where `records` excludes
        logically-truncated LSNs.  In practice all 3 of a node's cohorts are
        recovered in one shared scan (§6); callers loop over ranges which is
        observationally identical.
        """
        skipped = self.skipped.get(range_id, set())
        records: list[LogRecord] = []
        cmt = 0
        for e in self.durable:
            if isinstance(e, LogRecord) and e.range_id == range_id:
                if e.lsn not in skipped:
                    records.append(e)
            elif isinstance(e, CommitMarker) and e.range_id == range_id:
                cmt = max(cmt, e.commit_lsn)
        return records, cmt

    def seed_range(self, range_id: int, fork_lsn: int) -> None:
        """Durably seed a forked child range's log state (§4-style live
        split).  Called while applying the parent's SPLIT record — which is
        already durable on this node — so the seed is modeled as riding
        that force: a commit marker at `fork_lsn` plus watermarks that send
        any catch-up request below `fork_lsn` to the SSTable/snapshot path
        (the child's log holds nothing below the fork point)."""
        self.durable.append(CommitMarker(range_id, fork_lsn))
        self.durable_bytes += 16
        self.flushed_upto[range_id] = max(
            self.flushed_upto.get(range_id, 0), fork_lsn)
        self._gc_dropped_upto[range_id] = max(
            self._gc_dropped_upto.get(range_id, 0), fork_lsn)

    def set_gc_floor(self, range_id: int, lsn: Optional[int]) -> None:
        """Pin (or release, with None) a range's GC floor: durable records
        with `lsn >= floor` are never garbage-collected.  Maintained by the
        transaction manager around unresolved 2PC state."""
        had = range_id in self.gc_floor
        if lsn is None:
            self.gc_floor.pop(range_id, None)
            if had and self.on_gc_event is not None:
                self.on_gc_event("gc_floor_release", range_id, None)
        else:
            self.gc_floor[range_id] = lsn
            if not had and self.on_gc_event is not None:
                self.on_gc_event("gc_floor_pin", range_id, lsn)

    def forget_range(self, range_id: int) -> None:
        """Drop a range's log state after its replica left this node
        (migration retire): records, markers, and watermarks."""
        keep = [e for e in self.durable if getattr(e, "range_id", None) != range_id]
        self.durable_bytes -= sum(self._entry_bytes(e) for e in self.durable
                                  if getattr(e, "range_id", None) == range_id)
        self.durable = keep
        self._buffer = [p for p in self._buffer
                        if getattr(p.entry, "range_id", None) != range_id]
        self.skipped.pop(range_id, None)
        self.flushed_upto.pop(range_id, None)
        self._gc_dropped_upto.pop(range_id, None)
        self.gc_floor.pop(range_id, None)

    # -- logical truncation ---------------------------------------------------
    def logically_truncate(self, range_id: int, lsns: Iterable[int]) -> None:
        self.skipped.setdefault(range_id, set()).update(lsns)

    def range_lsns_between(self, range_id: int, lo_excl: int, hi_incl: int) -> list[int]:
        skipped = self.skipped.get(range_id, set())
        return [e.lsn for e in self.durable
                if isinstance(e, LogRecord) and e.range_id == range_id
                and lo_excl < e.lsn <= hi_incl and e.lsn not in skipped]

    # -- catch-up source ------------------------------------------------------
    def records_between(self, range_id: int, lo_excl: int, hi_incl: int
                        ) -> Optional[list[LogRecord]]:
        """Committed-record fetch for catch-up.  Returns None if the log has
        been GC'd past `lo_excl` (caller falls back to SSTables, §6.1)."""
        if self._gc_dropped_upto.get(range_id, 0) > lo_excl:
            return None
        skipped = self.skipped.get(range_id, set())
        out = [e for e in self.durable
               if isinstance(e, LogRecord) and e.range_id == range_id
               and lo_excl < e.lsn <= hi_incl and e.lsn not in skipped]
        return out

    # -- GC -------------------------------------------------------------------
    def note_flushed(self, range_id: int, lsn: int) -> None:
        self.flushed_upto[range_id] = max(self.flushed_upto.get(range_id, 0), lsn)
        self._maybe_gc()

    def _maybe_gc(self) -> None:
        """Roll over old segments: drop durable entries whose range has
        flushed past them.  Skipped-LSN lists are GC'd with the log files."""
        if self.durable_bytes < 2 * self.segment_bytes:
            return
        keep: list[Entry] = []
        kept_bytes = 0
        for e in self.durable:
            if isinstance(e, LogRecord):
                fl = min(self.flushed_upto.get(e.range_id, 0),
                         self.gc_floor.get(e.range_id, 1 << 62) - 1)
                if e.lsn <= fl:
                    self._gc_dropped_upto[e.range_id] = max(
                        self._gc_dropped_upto.get(e.range_id, 0), e.lsn)
                    sk = self.skipped.get(e.range_id)
                    if sk is not None:
                        sk.discard(e.lsn)
                    continue
            elif isinstance(e, CommitMarker):
                # keep only the newest marker per range (cheap approximation
                # of marker compaction during rollover)
                pass
            keep.append(e)
            kept_bytes += self._entry_bytes(e)
        self.durable = keep
        self.durable_bytes = kept_bytes
