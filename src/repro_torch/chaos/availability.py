"""Availability auditing: majority-healthy windows must serve writes.

The auditor replays the *applied* fault timeline (the structured
`FaultEvent`s a `FaultSchedule` actually fired, with crash targets
resolved) into a piecewise-constant health model, derives per-cohort
**majority-healthy windows** — intervals where some majority subset of
the cohort is up, un-degraded, and mutually connected — and then demands
that inside every such window longer than the recovery bound, the
cohort's probe writes succeed within that bound of the window opening.

This is the liveness half of the chaos harness, and it is exactly the
check a minority-partitioned leader fails at lease-off: the majority
side of the cohort is healthy (the window is open), but the stale leader
still holds the leadership znode via its direct ZooKeeper session, no
re-election happens, and no probe write completes until the partition
heals.  Time-bounded leases turn that stall into a bounded failover, and
this auditor is what proves it.

Health model (deliberately conservative — a window is only *required* to
be available, never forbidden):

- crashed nodes are unhealthy until restarted;
- a node is *degraded* while its disk or CPU gray multiplier is at or
  above `degraded_factor`, and for `flap_grace` seconds after a session
  flap begins;
- two nodes are connected iff no symmetric partition separates them, no
  one-way cut covers either direction, and no link fault with a positive
  drop probability (or a delay factor at or above `degraded_factor`)
  touches either direction between them;
- `heal` clears every network fault and gray multiplier (matching
  `SpinnakerCluster.heal`), `restart` only revives its node.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Iterable, Optional

from ..workload.scenario import FaultEvent


@dataclass
class _State:
    down: set = field(default_factory=set)
    degraded: dict = field(default_factory=dict)   # node -> until (inf ok)
    groups: dict = field(default_factory=dict)     # node -> group idx
    oneway: list = field(default_factory=list)     # (src set, dst set)
    links: dict = field(default_factory=dict)      # (s,d) -> (drop,dup,delay)


class CohortHealthTimeline:
    """Replays applied fault events into per-cohort healthy intervals."""

    def __init__(self, n_nodes: int, degraded_factor: float = 4.0,
                 flap_grace: float = 1.5):
        self.n_nodes = n_nodes
        self.degraded_factor = degraded_factor
        self.flap_grace = flap_grace

    # -- pairwise / subset health on a state snapshot -------------------------
    def _connected(self, st: _State, a: int, b: int) -> bool:
        ga, gb = st.groups.get(a), st.groups.get(b)
        if ga is not None and gb is not None and ga != gb:
            return False
        for src, dst in st.oneway:
            if (a in src and b in dst) or (b in src and a in dst):
                return False
        for s, d in ((a, b), (b, a)):
            drop, _dup, delay = st.links.get((s, d), (0.0, 0.0, 1.0))
            if drop > 0.0 or delay >= self.degraded_factor:
                return False
        return True

    def _node_ok(self, st: _State, n: int, t: float) -> bool:
        return n not in st.down and t >= st.degraded.get(n, 0.0)

    def _majority_healthy(self, st: _State, t: float,
                          members: tuple) -> bool:
        need = len(members) // 2 + 1
        healthy = [m for m in members if self._node_ok(st, m, t)]
        if len(healthy) < need:
            return False
        for subset in combinations(healthy, need):
            if all(self._connected(st, a, b)
                   for a, b in combinations(subset, 2)):
                return True
        return False

    # -- event replay ---------------------------------------------------------
    def _apply(self, st: _State, ev: FaultEvent) -> None:
        if ev.action == "crash":
            st.down.add(ev.node)
        elif ev.action == "restart" and ev.node is not None:
            st.down.discard(ev.node)
        elif ev.action == "partition":
            st.groups = {n: gi for gi, g in enumerate(ev.groups) for n in g}
        elif ev.action == "partition_oneway":
            st.oneway.append((set(ev.groups[0]), set(ev.groups[1])))
        elif ev.action == "link":
            cur = st.links.get((ev.src, ev.dst), (0.0, 0.0, 1.0))
            st.links[(ev.src, ev.dst)] = (
                cur[0] if ev.drop_p is None else ev.drop_p,
                cur[1] if ev.dup_p is None else ev.dup_p,
                cur[2] if ev.factor is None else ev.factor)
        elif ev.action in ("slow_disk", "slow_cpu"):
            if ev.factor is not None and ev.factor >= self.degraded_factor:
                st.degraded[ev.node] = float("inf")
            else:
                st.degraded.pop(ev.node, None)
        elif ev.action == "flap":
            st.degraded[ev.node] = max(
                st.degraded.get(ev.node, 0.0),
                ev.t + ev.outage + self.flap_grace)
        elif ev.action == "heal":
            st.groups = {}
            st.oneway = []
            st.links = {}
            st.degraded = {n: u for n, u in st.degraded.items()
                           if u != float("inf")}

    def windows(self, events: Iterable[FaultEvent], members: tuple,
                t_end: float, t_start: float = 0.0
                ) -> list[tuple[float, float]]:
        """Maximal [a, b) intervals in [t_start, t_end] where `members`
        has a healthy majority.  Event times are schedule-relative; pass
        probe times in the same frame."""
        evs = sorted((e for e in events if e.t <= t_end),
                     key=lambda e: e.t)
        # flap expiries add state-change instants between events
        change_ts = sorted({t_start, t_end, *(e.t for e in evs),
                            *(e.t + e.outage + self.flap_grace
                              for e in evs if e.action == "flap")})
        st = _State()
        out: list[list[float]] = []
        open_at: Optional[float] = None
        i = 0
        for t in change_ts:
            while i < len(evs) and evs[i].t <= t:
                self._apply(st, evs[i])
                i += 1
            healthy = self._majority_healthy(st, t, members)
            if healthy and open_at is None:
                open_at = max(t, t_start)
            elif not healthy and open_at is not None:
                if t > open_at:
                    out.append([open_at, t])
                open_at = None
        if open_at is not None and t_end > open_at:
            out.append([open_at, t_end])
        return out


def majority_healthy_windows(events: Iterable[FaultEvent], members: tuple,
                             t_end: float, n_nodes: int = 5,
                             **kw) -> list[tuple[float, float]]:
    return CohortHealthTimeline(n_nodes, **kw).windows(
        list(events), members, t_end)


def audit_availability(events: Iterable[FaultEvent],
                       cohorts: dict, probe_acks: dict,
                       t_end: float, recovery_bound: float = 4.0,
                       n_nodes: int = 5,
                       degraded_factor: float = 4.0,
                       flap_grace: float = 1.5) -> dict:
    """Audit liveness: for each cohort `rid -> members`, every majority-
    healthy window longer than `recovery_bound` must contain a successful
    probe write acked within `recovery_bound` of the window opening AND
    keep seeing acks at least every `recovery_bound` until it closes.

    `probe_acks` maps rid -> sorted ack times (schedule-relative) of that
    cohort's probe writer.  Returns {"ok", "violations", "windows"}."""
    tl = CohortHealthTimeline(n_nodes, degraded_factor=degraded_factor,
                              flap_grace=flap_grace)
    events = list(events)
    violations = []
    windows_out = {}
    for rid, members in sorted(cohorts.items()):
        wins = tl.windows(events, tuple(members), t_end)
        windows_out[rid] = [[round(a, 6), round(b, 6)] for a, b in wins]
        acks = sorted(probe_acks.get(rid, ()))
        for a, b in wins:
            if b - a <= recovery_bound:
                continue   # too short to demand recovery inside it
            # acks inside the window, scanned for gaps > recovery_bound
            t_prev = a
            for t in acks:
                if t < a:
                    continue
                if t > b:
                    break
                if t - t_prev > recovery_bound:
                    break
                t_prev = t
            # the window's write obligation runs to its close (minus the
            # bound, so a fault landing right at the end can't fail it)
            if t_prev < b - recovery_bound:
                violations.append({
                    "rid": rid, "window": [round(a, 6), round(b, 6)],
                    "last_ack": None if t_prev == a else round(t_prev, 6),
                    "detail": "majority-healthy window served no probe "
                              f"write for > {recovery_bound}s"})
    return {"ok": not violations, "violations": violations,
            "windows": windows_out, "recovery_bound": recovery_bound}
