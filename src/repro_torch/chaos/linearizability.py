"""Per-cell linearizability checking over client operation histories.

Spinnaker's data model makes the general Wing&Gong / P-compositionality
search unnecessary: every committed write to a cell `(key, colname)` is
assigned a dense commit version by the cohort's single Paxos log, so the
*versions themselves* are the linearization order of the writes.  The
checker therefore only has to verify that this order is consistent with
real time and that reads respect it:

W1. **Version uniqueness** — two acknowledged writes to one cell can never
    report the same version (a duplicate would mean a double-commit or a
    split-brain leader pair).
W2. **Real-time write order** — if write A completed before write B was
    invoked, then version(A) < version(B).
R1. **No stale reads** — a strong read that returns version `v` must have
    `v >= ` the highest version of any write to the cell that *completed
    before the read was invoked* (the read-your-quorum guarantee the
    leader lease / read-index protects).
R2. **No reads from the future** — `v` cannot exceed the highest version
    that could exist when the read completed.  Every client *attempt* can
    commit at most once (a retry after a lost ack legitimately commits a
    second time), so the ceiling is the max acked version among writes
    invoked before the response plus the extra attempts of every write
    invoked by then — exact (one slot per write) in retry-free runs.
R3. **Value match** — if `v` equals an acked write's version, the read
    must return that write's value (history writers use unique values).

Timed-out / retry-exhausted writes are *unresolved*: they are allowed to
have taken effect (they widen R2's ceiling) but never constrain R1's
floor.  Histories are recorded with `HistoryRecorder`, which wraps a
`core.cluster.Client` and stamps invoke/response sim-times around every
op it issues.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class HistOp:
    client: str
    kind: str                 # "write" | "read"
    key: str
    col: str
    invoke: float
    response: float
    ok: bool
    version: Optional[int]    # acked write version / read version
    value: Any = None
    resolved: bool = True     # False: outcome unknown (timeout)
    attempts: int = 1         # client attempts spent (each may commit)


class HistoryRecorder:
    """Issues strong ops through a `Client` and records the invocation /
    response history the checker consumes.  Write values are unique per
    recorder (`<client_id>#<n>`) so R3's value check has teeth."""

    def __init__(self, client, sim, base_versions: Optional[dict] = None):
        self.client = client
        self.sim = sim
        self.history: list[HistOp] = []
        self.base_versions = dict(base_versions or {})
        self._n = 0

    def put(self, key: str, col: str, done=None) -> None:
        self._n += 1
        value = f"{self.client.id}#{self._n}".encode()
        t0 = self.sim.now

        def cb(res):
            self.history.append(HistOp(
                self.client.id, "write", key, col, t0, self.sim.now,
                ok=bool(res.ok), version=res.version, value=value,
                resolved=res.ok, attempts=getattr(res, "attempts", 1)))
            if done is not None:
                done(res)

        self.client.put(key, col, value, cb)

    def get(self, key: str, col: str, done=None) -> None:
        t0 = self.sim.now

        def cb(res):
            self.history.append(HistOp(
                self.client.id, "read", key, col, t0, self.sim.now,
                ok=bool(res.ok), version=res.version, value=res.value,
                resolved=res.ok))
            if done is not None:
                done(res)

        self.client.get(key, col, True, cb)


def _cell_violations(cell: tuple, ops: list[HistOp], base: int) -> list[dict]:
    bad: list[dict] = []

    def flag(rule: str, detail: str, op: Optional[HistOp] = None) -> None:
        bad.append({"cell": list(cell), "rule": rule, "detail": detail,
                    "client": op.client if op else None,
                    "t": op.response if op else None})

    acked = [o for o in ops if o.kind == "write" and o.ok
             and o.version is not None]
    unresolved = [o for o in ops if o.kind == "write" and not o.resolved]
    reads = [o for o in ops if o.kind == "read" and o.ok
             and o.version is not None]

    # W1: version uniqueness
    by_version: dict[int, HistOp] = {}
    for w in acked:
        if w.version in by_version:
            flag("W1", f"duplicate acked version {w.version} "
                 f"(clients {by_version[w.version].client}, {w.client})", w)
        else:
            by_version[w.version] = w
        if w.version <= base:
            flag("W1", f"acked version {w.version} <= preload base {base}", w)

    # W2 + R1 share a sweep: walk completions in time order, maintaining
    # the highest version known to be committed by each instant; any write
    # or read *invoked* after that instant must see at least that version.
    completions = sorted(((w.response, w.version) for w in acked))
    comp_times = [t for t, _v in completions]
    comp_pmax = []
    for _t, v in completions:
        comp_pmax.append(max(comp_pmax[-1], v) if comp_pmax else v)

    def floor_at(t: float) -> int:
        i = bisect.bisect_left(comp_times, t)
        return comp_pmax[i - 1] if i else base

    for w in acked:
        f = floor_at(w.invoke)
        if w.version <= f and f > base:
            flag("W2", f"write acked version {w.version} but version {f} "
                 "had already completed before it was invoked", w)

    # R2 ceiling: max acked version invoked by then, plus commit slots for
    # extra attempts (acked writes: attempts-1 beyond the acked commit;
    # unresolved writes: every attempt may have committed)
    acked_by_invoke = sorted((w.invoke, w.version) for w in acked)
    inv_times = [t for t, _v in acked_by_invoke]
    inv_pmax = []
    for _t, v in acked_by_invoke:
        inv_pmax.append(max(inv_pmax[-1], v) if inv_pmax else v)
    extra_slots = sorted([(w.invoke, max(0, w.attempts - 1)) for w in acked]
                         + [(w.invoke, max(1, w.attempts))
                            for w in unresolved])
    slot_times = [t for t, _n in extra_slots]
    slot_psum = []
    for _t, n in extra_slots:
        slot_psum.append((slot_psum[-1] if slot_psum else 0) + n)

    def ceiling_at(t: float) -> int:
        i = bisect.bisect_left(inv_times, t)
        vmax = inv_pmax[i - 1] if i else base
        j = bisect.bisect_left(slot_times, t)
        return vmax + (slot_psum[j - 1] if j else 0)

    for r in reads:
        f = floor_at(r.invoke)
        if r.version < f:
            flag("R1", f"stale read: returned version {r.version} but "
                 f"version {f} completed before the read was invoked", r)
        c = ceiling_at(r.response)
        if r.version > c:
            flag("R2", f"read from the future: returned version "
                 f"{r.version} > ceiling {c}", r)
        w = by_version.get(r.version)
        if w is not None and r.value != w.value:
            flag("R3", f"value mismatch at version {r.version}: read "
                 f"{r.value!r}, write was {w.value!r}", r)
    return bad


def check_linearizability(history: list[HistOp],
                          base_versions: Optional[dict] = None
                          ) -> list[dict]:
    """Check a history; returns a list of violation dicts (empty = clean).

    `base_versions` maps `(key, col)` to the version preloaded before the
    history started (defaults to 0 = cell created by the history)."""
    base_versions = base_versions or {}
    cells: dict[tuple, list[HistOp]] = {}
    for op in history:
        cells.setdefault((op.key, op.col), []).append(op)
    violations: list[dict] = []
    for cell, ops in sorted(cells.items()):
        violations.extend(
            _cell_violations(cell, ops, int(base_versions.get(cell, 0))))
    return violations
