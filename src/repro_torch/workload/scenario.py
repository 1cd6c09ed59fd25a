"""Declarative fault-schedule DSL.

A scenario is a timeline of one-line directives, e.g.::

    # Fig. 9: kill the leader mid-load, watch availability recover
    at 10s   crash node 2 lose_disk
    at 25s   restart node 2
    at 40s   partition {0,1} | {2,3,4}
    at 55s   heal
    at 60s   crash leader of 0

Grammar (one directive per line, '#' starts a comment):

    at <T>[s] crash node <i> [lose_disk] [no_expire]
    at <T>[s] crash leader of <rid> [lose_disk] [no_expire]
    at <T>[s] restart node <i>
    at <T>[s] restart crashed          # most recently crashed node
    at <T>[s] partition {i,j,...} | {k,...} [| ...]
    at <T>[s] heal
    at <T>[s] split range <rid> [at <key>]       # live split (median default)
    at <T>[s] move range <rid> [from <i>] [to <j>]   # replica migration
    at <T>[s] autobalance on|off                 # hotspot balancer
    at <T>[s] crash txn coordinator [lose_disk] [no_expire]  # mid-2PC kill
    at <T>[s] partition oneway {i,...} -> {j,...}   # asymmetric cut (cumulative)
    at <T>[s] drop link <i> <j> p=<p>            # directed link loses msgs
    at <T>[s] dup link <i> <j> p=<p>             # directed link duplicates
    at <T>[s] slow link <i> <j> x<f>             # directed link delay spike
    at <T>[s] slow disk on <i> x<f>              # gray log device
    at <T>[s] slow cpu on <i> x<f>               # gray CPU
    at <T>[s] flap session of <i> [for <d>s]     # ZK session expiry + rejoin

`heal` clears every injected network fault — symmetric AND one-way
partitions, per-link drop/dup/delay — and resets disk/CPU gray
multipliers; crashed nodes need an explicit `restart`.

`crash leader of <rid>` resolves *at fire time* — whoever leads cohort
`rid` then is killed, so the same scenario file exercises every failover
regime regardless of which node won the previous election.
`crash txn coordinator` also resolves at fire time: it kills the node
currently coordinating the most in-flight 2PC transactions (falling back
to the node holding the most prepared participant state), which is how
the txn scenarios land a kill genuinely mid-two-phase-commit.  The range
events likewise resolve at fire time (`move range` picks a follower
source and an up non-member destination when omitted) and require a
cluster with elastic range management (Spinnaker); they are recorded as
honest no-ops elsewhere.  Times are absolute sim-time seconds (offset by
`install(at=...)`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Optional

_AT = re.compile(r"^at\s+([0-9.]+)s?\s+(.*)$")
_CRASH_NODE = re.compile(r"^crash\s+node\s+(\d+)\s*(.*)$")
_CRASH_LEADER = re.compile(r"^crash\s+leader\s+of\s+(\d+)\s*(.*)$")
_CRASH_TXN_COORD = re.compile(r"^crash\s+txn\s+coordinator\s*(.*)$")
_RESTART = re.compile(r"^restart\s+(node\s+\d+|crashed)$")
_PARTITION = re.compile(r"^partition\s+(.*)$")
_GROUP = re.compile(r"\{([0-9,\s]*)\}")
_SPLIT = re.compile(r"^split\s+range\s+(\d+)(?:\s+at\s+(\S+))?$")
_MOVE = re.compile(
    r"^move\s+range\s+(\d+)(?:\s+from\s+(\d+))?(?:\s+to\s+(\d+))?$")
_AUTOBALANCE = re.compile(r"^autobalance\s+(on|off)$")
_ONEWAY = re.compile(r"^partition\s+oneway\s+(\{[0-9,\s]*\})\s*->\s*"
                     r"(\{[0-9,\s]*\})$")
_LINK = re.compile(r"^(drop|dup)\s+link\s+(\d+)\s+(\d+)\s+p=([0-9.]+)$")
_SLOW_LINK = re.compile(r"^slow\s+link\s+(\d+)\s+(\d+)\s+x([0-9.]+)$")
_SLOW_NODE = re.compile(r"^slow\s+(disk|cpu)\s+on\s+(\d+)\s+x([0-9.]+)$")
_FLAP = re.compile(r"^flap\s+session\s+of\s+(\d+)(?:\s+for\s+([0-9.]+)s?)?$")


@dataclass(frozen=True)
class FaultEvent:
    t: float
    action: str   # crash | crash_leader | crash_txn_coord | restart |
                  # partition | partition_oneway | link | slow_disk |
                  # slow_cpu | flap | heal | split | move | autobalance
    node: Optional[int] = None
    rid: Optional[int] = None
    lose_disk: bool = False
    expire_session: bool = True
    groups: tuple = ()
    key: Optional[str] = None    # split point ('split range ... at <key>')
    src: Optional[int] = None    # move source / link source node
    dst: Optional[int] = None    # move destination / link destination node
    on: bool = True              # autobalance on/off
    drop_p: Optional[float] = None   # link drop probability
    dup_p: Optional[float] = None    # link duplication probability
    factor: Optional[float] = None   # link delay / disk / cpu multiplier
    outage: float = 1.0              # session-flap outage duration (s)

    def describe(self) -> str:
        if self.action == "crash":
            return f"t={self.t}: crash node {self.node}" + \
                (" (disk lost)" if self.lose_disk else "")
        if self.action == "crash_leader":
            return f"t={self.t}: crash leader of range {self.rid}"
        if self.action == "crash_txn_coord":
            return f"t={self.t}: crash txn coordinator"
        if self.action == "restart":
            return f"t={self.t}: restart node {self.node}"
        if self.action == "partition":
            return f"t={self.t}: partition " + \
                "|".join("{" + ",".join(map(str, g)) + "}"
                         for g in self.groups)
        if self.action == "split":
            at = f" at {self.key}" if self.key else ""
            return f"t={self.t}: split range {self.rid}{at}"
        if self.action == "move":
            src = f" from {self.src}" if self.src is not None else ""
            dst = f" to {self.dst}" if self.dst is not None else ""
            return f"t={self.t}: move range {self.rid}{src}{dst}"
        if self.action == "autobalance":
            return f"t={self.t}: autobalance {'on' if self.on else 'off'}"
        if self.action == "partition_oneway":
            a, b = self.groups
            return (f"t={self.t}: partition oneway "
                    "{" + ",".join(map(str, a)) + "} -> "
                    "{" + ",".join(map(str, b)) + "}")
        if self.action == "link":
            parts = []
            if self.drop_p:
                parts.append(f"drop p={self.drop_p}")
            if self.dup_p:
                parts.append(f"dup p={self.dup_p}")
            if self.factor is not None and self.factor != 1.0:
                parts.append(f"delay x{self.factor}")
            what = ", ".join(parts) or "clear"
            return f"t={self.t}: link {self.src}->{self.dst} {what}"
        if self.action == "slow_disk":
            return f"t={self.t}: slow disk on node {self.node} x{self.factor}"
        if self.action == "slow_cpu":
            return f"t={self.t}: slow cpu on node {self.node} x{self.factor}"
        if self.action == "flap":
            return (f"t={self.t}: flap session of node {self.node} "
                    f"for {self.outage}s")
        return f"t={self.t}: heal"


def _parse_flags(rest: str) -> dict:
    flags = set(rest.split())
    unknown = flags - {"lose_disk", "no_expire"}
    if unknown:
        raise ValueError(f"unknown crash flags: {sorted(unknown)}")
    return {"lose_disk": "lose_disk" in flags,
            "expire_session": "no_expire" not in flags}


def parse_schedule(text: str) -> "FaultSchedule":
    events = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        m = _AT.match(line)
        if not m:
            raise ValueError(f"line {lineno}: expected 'at <T>s ...': {raw!r}")
        t, body = float(m.group(1)), m.group(2).strip()
        if body == "heal":
            events.append(FaultEvent(t, "heal"))
            continue
        cm = _CRASH_NODE.match(body)
        if cm:
            events.append(FaultEvent(t, "crash", node=int(cm.group(1)),
                                     **_parse_flags(cm.group(2))))
            continue
        lm = _CRASH_LEADER.match(body)
        if lm:
            events.append(FaultEvent(t, "crash_leader", rid=int(lm.group(1)),
                                     **_parse_flags(lm.group(2))))
            continue
        tm = _CRASH_TXN_COORD.match(body)
        if tm:
            events.append(FaultEvent(t, "crash_txn_coord",
                                     **_parse_flags(tm.group(1))))
            continue
        rm = _RESTART.match(body)
        if rm:
            tgt = rm.group(1)
            node = None if tgt == "crashed" else int(tgt.split()[1])
            events.append(FaultEvent(t, "restart", node=node))
            continue
        om = _ONEWAY.match(body)
        if om:   # before _PARTITION: both start with 'partition'
            src = tuple(int(x) for x in _GROUP.match(om.group(1)).group(1)
                        .split(",") if x.strip())
            dst = tuple(int(x) for x in _GROUP.match(om.group(2)).group(1)
                        .split(",") if x.strip())
            if not src or not dst:
                raise ValueError(
                    f"line {lineno}: oneway partition needs non-empty "
                    f"groups: {raw!r}")
            events.append(FaultEvent(t, "partition_oneway",
                                     groups=(src, dst)))
            continue
        km = _LINK.match(body)
        if km:
            p = float(km.group(4))
            events.append(FaultEvent(
                t, "link", src=int(km.group(2)), dst=int(km.group(3)),
                drop_p=p if km.group(1) == "drop" else None,
                dup_p=p if km.group(1) == "dup" else None))
            continue
        slm = _SLOW_LINK.match(body)
        if slm:
            events.append(FaultEvent(t, "link", src=int(slm.group(1)),
                                     dst=int(slm.group(2)),
                                     factor=float(slm.group(3))))
            continue
        snm = _SLOW_NODE.match(body)
        if snm:
            events.append(FaultEvent(t, f"slow_{snm.group(1)}",
                                     node=int(snm.group(2)),
                                     factor=float(snm.group(3))))
            continue
        fm = _FLAP.match(body)
        if fm:
            outage = float(fm.group(2)) if fm.group(2) else 1.0
            events.append(FaultEvent(t, "flap", node=int(fm.group(1)),
                                     outage=outage))
            continue
        pm = _PARTITION.match(body)
        if pm:
            groups = tuple(
                tuple(int(x) for x in g.split(",") if x.strip())
                for g in _GROUP.findall(pm.group(1)))
            if len(groups) < 2:
                raise ValueError(
                    f"line {lineno}: partition needs >=2 groups: {raw!r}")
            events.append(FaultEvent(t, "partition", groups=groups))
            continue
        sm = _SPLIT.match(body)
        if sm:
            events.append(FaultEvent(t, "split", rid=int(sm.group(1)),
                                     key=sm.group(2)))
            continue
        mm = _MOVE.match(body)
        if mm:
            src = int(mm.group(2)) if mm.group(2) is not None else None
            dst = int(mm.group(3)) if mm.group(3) is not None else None
            events.append(FaultEvent(t, "move", rid=int(mm.group(1)),
                                     src=src, dst=dst))
            continue
        am = _AUTOBALANCE.match(body)
        if am:
            events.append(FaultEvent(t, "autobalance",
                                     on=am.group(1) == "on"))
            continue
        raise ValueError(f"line {lineno}: cannot parse {raw!r}")
    return FaultSchedule(sorted(events, key=lambda e: e.t))


@dataclass
class FaultSchedule:
    """Parsed timeline; `install` arms it on a simulator + cluster."""
    events: list[FaultEvent] = field(default_factory=list)
    applied: list[str] = field(default_factory=list)
    # structured mirror of `applied` (skips excluded): events as they
    # actually fired, with fire-time-resolved nodes — the availability
    # auditor replays this, not the pre-resolution schedule
    applied_events: list[FaultEvent] = field(default_factory=list)
    last_crashed: Optional[int] = None

    def install(self, sim, cluster, at: float = 0.0,
                on_event: Optional[Callable[[str], None]] = None) -> None:
        """Schedule every event at `at + event.t` against `cluster`.

        Works with any cluster exposing crash_node/restart_node and a
        `net` with partition support; `crash leader of` additionally needs
        `leader_replica` (Spinnaker only)."""
        for ev in self.events:
            sim.at(at + ev.t, self._fire, ev, cluster, on_event)

    def _crash(self, cluster, node: int, ev: FaultEvent) -> None:
        if _takes_expire(cluster):
            cluster.crash_node(node, lose_disk=ev.lose_disk,
                               expire_session=ev.expire_session)
        else:
            cluster.crash_node(node, lose_disk=ev.lose_disk)
        self.last_crashed = node

    @staticmethod
    def _find_txn_coordinator(cluster) -> Optional[int]:
        """Node currently coordinating the most in-flight 2PC transactions
        (resolved at fire time); falls back to the node holding the most
        prepared participant state.  None when no 2PC state exists."""
        best, best_score = None, (0, 0)
        for nid, node in sorted(getattr(cluster, "nodes", {}).items()):
            if not node.up:
                continue
            n_active = n_prepared = 0
            for rep in node.replicas.values():
                txn = getattr(rep, "txn", None)
                if txn is None:
                    continue
                n_active += len(txn.active)
                n_prepared += len(txn.prepared)
            score = (n_active, n_prepared)
            if score > best_score:
                best, best_score = nid, score
        return best

    def _fire(self, ev: FaultEvent, cluster, on_event) -> None:
        if ev.action == "crash":
            self._crash(cluster, ev.node, ev)
        elif ev.action == "crash_txn_coord":
            nid = self._find_txn_coordinator(cluster)
            if nid is None:
                msg = f"t={ev.t}: crash txn coordinator skipped " \
                      "(no in-flight transactions)"
                self.applied.append(msg)
                if on_event is not None:
                    on_event(msg)
                return
            self._crash(cluster, nid, ev)
            ev = FaultEvent(ev.t, "crash", node=nid, lose_disk=ev.lose_disk)
        elif ev.action == "crash_leader":
            rep = cluster.leader_replica(ev.rid)
            if rep is None:
                # record the no-op honestly: an artifact claiming a kill
                # that never happened would make recovery checks vacuous
                msg = f"t={ev.t}: crash leader of range {ev.rid} " \
                      "skipped (no open leader)"
                self.applied.append(msg)
                if on_event is not None:
                    on_event(msg)
                return
            nid = rep.node.node_id
            self._crash(cluster, nid, ev)
            ev = FaultEvent(ev.t, "crash", node=nid, lose_disk=ev.lose_disk)
        elif ev.action == "restart":
            node = ev.node if ev.node is not None else self.last_crashed
            if node is not None:
                cluster.restart_node(node)
                ev = FaultEvent(ev.t, "restart", node=node)
        elif ev.action == "partition":
            cluster.net.set_partition(ev.groups)
        elif ev.action == "partition_oneway":
            if hasattr(cluster, "partition_oneway"):
                cluster.partition_oneway(set(ev.groups[0]),
                                         set(ev.groups[1]))
            else:
                cluster.net.set_oneway_partition(set(ev.groups[0]),
                                                 set(ev.groups[1]))
        elif ev.action == "link":
            if hasattr(cluster, "set_link_fault"):
                cluster.set_link_fault(ev.src, ev.dst, drop_p=ev.drop_p,
                                       dup_p=ev.dup_p,
                                       delay_factor=ev.factor)
            else:
                cluster.net.update_link_fault(ev.src, ev.dst,
                                              drop_p=ev.drop_p,
                                              dup_p=ev.dup_p,
                                              delay_factor=ev.factor)
        elif ev.action in ("slow_disk", "slow_cpu", "flap"):
            ok = self._fire_gray_node_event(ev, cluster)
            if not ok:
                msg = f"{ev.describe()} skipped (not supported)"
                self.applied.append(msg)
                if on_event is not None:
                    on_event(msg)
                return
        elif ev.action == "heal":
            if hasattr(cluster, "heal"):
                cluster.heal()   # also resets disk/CPU gray multipliers
            else:
                cluster.net.clear_faults()
        elif ev.action in ("split", "move", "autobalance"):
            ok = self._fire_range_event(ev, cluster)
            if not ok:
                msg = f"{ev.describe()} skipped (not accepted)"
                self.applied.append(msg)
                if on_event is not None:
                    on_event(msg)
                return
        msg = ev.describe()
        self.applied.append(msg)
        self.applied_events.append(ev)
        if on_event is not None:
            on_event(msg)

    @staticmethod
    def _fire_gray_node_event(ev: FaultEvent, cluster) -> bool:
        """Node-local gray faults need the chaos cluster API (slow_disk /
        slow_cpu / flap_session); record an honest skip elsewhere."""
        nodes = getattr(cluster, "nodes", None)
        if nodes is None or ev.node not in nodes:
            return False
        if ev.action == "slow_disk":
            if hasattr(cluster, "slow_disk"):
                cluster.slow_disk(ev.node, ev.factor)
                return True
            disk = getattr(nodes[ev.node], "disk", None)
            if disk is None or not hasattr(disk, "slow_factor"):
                return False
            disk.slow_factor = ev.factor
            return True
        if ev.action == "slow_cpu":
            if hasattr(cluster, "slow_cpu"):
                cluster.slow_cpu(ev.node, ev.factor)
                return True
            cpu = getattr(nodes[ev.node], "cpu", None)
            if cpu is None or not hasattr(cpu, "slow_factor"):
                return False
            cpu.slow_factor = ev.factor
            return True
        # flap
        if hasattr(cluster, "flap_session"):
            cluster.flap_session(ev.node, ev.outage)
            return True
        if hasattr(nodes[ev.node], "flap_session"):
            nodes[ev.node].flap_session(ev.outage)
            return True
        return False

    @staticmethod
    def _fire_range_event(ev: FaultEvent, cluster) -> bool:
        """Range-management events need the elastic-range cluster API;
        record an honest skip on clusters (or states) that lack it."""
        if ev.action == "split":
            if not hasattr(cluster, "admin_split"):
                return False
            return cluster.admin_split(ev.rid, ev.key)
        if ev.action == "move":
            if not hasattr(cluster, "admin_move"):
                return False
            return cluster.admin_move(ev.rid, ev.src, ev.dst)
        if not hasattr(cluster, "set_autobalance"):
            return False
        cluster.set_autobalance(ev.on)
        return True


def _takes_expire(cluster) -> bool:
    import inspect
    try:
        return "expire_session" in inspect.signature(
            cluster.crash_node).parameters
    except (TypeError, ValueError):
        return False
