"""Structured cluster event log.

One append-only list of dict events — elections, range splits, replica
migrations, 2PC recovery, WAL GC-floor pin/release, node crashes — plus
the fault-schedule DSL's fire log (merged in via `FaultSchedule.install
(on_event=...)`).  The merged stream is what annotates fig9/10-style
timelines: every throughput dip lines up with the regime change that
caused it.
"""

from __future__ import annotations

import json
from typing import Optional


class EventLog:
    def __init__(self, sim, cap: int = 100_000):
        self.sim = sim
        self.cap = cap
        self.events: list[dict] = []
        self.dropped = 0

    def emit(self, kind: str, **fields) -> None:
        if len(self.events) >= self.cap:
            self.dropped += 1
            return
        ev = {"t": self.sim.now, "kind": kind}
        ev.update(fields)
        self.events.append(ev)

    def export(self, t0: float = 0.0, kinds: Optional[set] = None
               ) -> list[dict]:
        """Events at/after `t0`, times shifted to be relative to `t0`."""
        out = []
        for ev in self.events:
            if ev["t"] < t0:
                continue
            if kinds is not None and ev["kind"] not in kinds:
                continue
            e = dict(ev)
            e["t"] = round(e["t"] - t0, 6)
            out.append(e)
        return out

    def to_jsonl(self, t0: float = 0.0, kinds: Optional[set] = None) -> str:
        """One JSON object per line with stable field ordering (`t`,
        `kind`, then remaining fields sorted by name), so exports diff
        cleanly run-to-run.  Non-JSON field values fall back to `str`."""
        lines = []
        for ev in self.export(t0=t0, kinds=kinds):
            rest = {k: ev[k] for k in sorted(ev) if k not in ("t", "kind")}
            ordered = {"t": ev["t"], "kind": ev["kind"], **rest}
            lines.append(json.dumps(ordered, default=str))
        return "\n".join(lines) + ("\n" if lines else "")
