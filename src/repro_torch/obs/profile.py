"""Sim-time cluster resource profiler (zero modeled cost).

Every unit of CPU work, disk force, and network message in the simulator
carries a component label (``paxos.propose``, ``wal.force``,
``txn.prepare``, ``lease.heartbeat``, ``catchup``, ``client.read``, ...)
and, where applicable, a range id.  The profiler accumulates
per-node x per-component busy-time / message / byte totals, per-interval
utilization timelines, and per-range *heat* (ops, bytes, lock-wait) that
the `RangeBalancer` consumes directly instead of per-leader counters.

Discipline (same as the span tracer): accounting only.  The profiler
never draws from the simulator RNG and never adds modeled time, so a
profiled run is bit-identical to an unprofiled one.  The only events it
schedules are optional utilization-snapshot ticks, which make no RNG
draws of their own.

Attribution invariant: the per-component CPU/disk busy-time sums equal
the measured `FifoServer.total_busy` / `Disk.total_busy` of each node
(the dispatch sites are the only producers of that busy time), which the
``--scenario profile`` check asserts to within 5%.
"""

from __future__ import annotations

from typing import Optional


class Profiler:
    """Per-node x per-component resource accounting + per-range heat."""

    def __init__(self, sim, system: str, enabled: bool = True,
                 interval: float = 0.0):
        self.sim = sim
        self.system = system
        self.enabled = enabled
        self.interval = interval
        self.t0 = sim.now
        # (node, component) -> mutable [busy_s, msgs]
        self.cpu: dict[tuple, list] = {}
        # (node, component) -> [wait_s_total, samples]
        self.queue_wait: dict[tuple, list] = {}
        # (node, component) -> [busy_s, forces, bytes]
        self.disk: dict[tuple, list] = {}
        # (node, component) -> [msgs, bytes]
        self.net: dict[tuple, list] = {}
        # rid -> [ops, bytes, lock_wait_s]
        self.heat: dict[int, list] = {}
        # node_id -> (FifoServer cpu, Disk disk) for measured-busy readback
        self._nodes: dict = {}
        self.timeline: list[dict] = []
        self._prev_busy: dict = {}
        self._running = False

    # -- wiring ---------------------------------------------------------------
    def attach_node(self, node_id, cpu=None, disk=None) -> None:
        """Register a node's resources; tags the disk so group-commit
        batches can attribute their latency back through the profiler."""
        if not self.enabled:
            return
        self._nodes[node_id] = (cpu, disk)
        if disk is not None:
            disk.profiler = self
            disk.profiler_node = node_id

    def attach_network(self, net) -> None:
        if self.enabled:
            net.profiler = self

    # -- accounting hooks (pure bookkeeping: no RNG, no modeled time) ---------
    def cpu_work(self, node, component: str, service_s: float,
                 rid: Optional[int] = None,
                 queue_wait_s: Optional[float] = None) -> None:
        ent = self.cpu.get((node, component))
        if ent is None:
            ent = self.cpu[(node, component)] = [0.0, 0]
        ent[0] += service_s
        ent[1] += 1
        if queue_wait_s is not None:
            qw = self.queue_wait.get((node, component))
            if qw is None:
                qw = self.queue_wait[(node, component)] = [0.0, 0]
            qw[0] += queue_wait_s
            qw[1] += 1

    def disk_busy(self, node, component: str, busy_s: float, nbytes: int,
                  rid: Optional[int] = None) -> None:
        ent = self.disk.get((node, component))
        if ent is None:
            ent = self.disk[(node, component)] = [0.0, 0, 0]
        ent[0] += busy_s
        ent[1] += 1
        ent[2] += nbytes

    def net_msg(self, node, component: str, nbytes: int,
                rid: Optional[int] = None) -> None:
        ent = self.net.get((node, component))
        if ent is None:
            ent = self.net[(node, component)] = [0, 0]
        ent[0] += 1
        ent[1] += nbytes

    def range_op(self, rid: int, nbytes: int = 0) -> None:
        """One served client op on `rid` (bumped at the same semantic sites
        as the replica serve counters, but cluster-global — leader changes
        do not corrupt the balancer's deltas)."""
        ent = self.heat.get(rid)
        if ent is None:
            ent = self.heat[rid] = [0, 0, 0.0]
        ent[0] += 1
        ent[1] += nbytes

    def lock_wait(self, rid: int, wait_s: float) -> None:
        ent = self.heat.get(rid)
        if ent is None:
            ent = self.heat[rid] = [0, 0, 0.0]
        ent[2] += wait_s

    def range_ops(self, rid: int) -> int:
        """Cumulative served ops for `rid` (the balancer's load signal)."""
        ent = self.heat.get(rid)
        return ent[0] if ent is not None else 0

    def heat_snapshot(self, rid: Optional[int] = None):
        """JSON-ready heat reading(s): {ops, bytes, lock_wait_s}."""
        def one(ent):
            return {"ops": ent[0], "bytes": ent[1],
                    "lock_wait_s": round(ent[2], 9)}
        if rid is not None:
            ent = self.heat.get(rid)
            return one(ent) if ent is not None else \
                {"ops": 0, "bytes": 0, "lock_wait_s": 0.0}
        return {r: one(e) for r, e in sorted(self.heat.items())}

    # -- interval utilization timeline ---------------------------------------
    def start(self) -> None:
        if not (self.enabled and self.interval > 0) or self._running:
            return
        self._running = True
        self._prev_busy = {nid: (cpu.total_busy if cpu else 0.0,
                                 disk.total_busy if disk else 0.0)
                           for nid, (cpu, disk) in self._nodes.items()}
        self._prev_t = self.sim.now
        self.sim.schedule(self.interval, self._tick)

    def stop(self) -> None:
        if self._running and self.sim.now > self._prev_t:
            self._snapshot()
        self._running = False

    def _tick(self) -> None:
        if not self._running:
            return
        self._snapshot()
        self.sim.schedule(self.interval, self._tick)

    def _snapshot(self) -> None:
        dt = max(self.sim.now - self._prev_t, 1e-12)
        cpu_util, disk_util = {}, {}
        for nid, (cpu, disk) in sorted(self._nodes.items()):
            pc, pd = self._prev_busy.get(nid, (0.0, 0.0))
            c = cpu.total_busy if cpu else 0.0
            d = disk.total_busy if disk else 0.0
            cpu_util[str(nid)] = round((c - pc) / dt, 6)
            disk_util[str(nid)] = round((d - pd) / dt, 6)
            self._prev_busy[nid] = (c, d)
        self.timeline.append({"t": round(self.sim.now, 6),
                              "cpu_util": cpu_util, "disk_util": disk_util})
        self._prev_t = self.sim.now

    # -- rollups --------------------------------------------------------------
    def _by_component(self, table: dict, node, idx: int, nd: int = 9) -> dict:
        # table keys mix int node ids and str client ids: filter first,
        # then sort by component only
        items = [(c, v) for (n, c), v in table.items() if n == node]
        return {c: round(v[idx], nd) for c, v in sorted(items)}

    def summary(self) -> dict:
        """JSON-ready rollup: per-node measured vs attributed busy time,
        per-component splits, cluster-wide shares, and per-range heat."""
        elapsed = max(self.sim.now - self.t0, 1e-12)
        nodes = {}
        tot_cpu_comp: dict[str, float] = {}
        tot_cpu_busy = 0.0
        for nid, (cpu, disk) in sorted(self._nodes.items()):
            cpu_comp = self._by_component(self.cpu, nid, 0)
            disk_comp = self._by_component(self.disk, nid, 0)
            measured_cpu = cpu.total_busy if cpu else 0.0
            measured_disk = disk.total_busy if disk else 0.0
            tot_cpu_busy += measured_cpu
            for c, v in cpu_comp.items():
                tot_cpu_comp[c] = tot_cpu_comp.get(c, 0.0) + v
            nodes[str(nid)] = {
                "cpu_busy_s": round(measured_cpu, 9),
                "cpu_attributed_s": round(sum(cpu_comp.values()), 9),
                "cpu_util": round(measured_cpu / elapsed, 6),
                "cpu_by_component": cpu_comp,
                "cpu_msgs_by_component": self._by_component(self.cpu, nid, 1),
                "queue_wait_s_by_component": self._by_component(
                    self.queue_wait, nid, 0),
                "disk_busy_s": round(measured_disk, 9),
                "disk_attributed_s": round(sum(disk_comp.values()), 9),
                "disk_util": round(measured_disk / elapsed, 6),
                "disk_by_component": disk_comp,
                "disk_bytes_by_component": self._by_component(
                    self.disk, nid, 2, nd=0),
                "net_msgs_by_component": self._by_component(self.net, nid, 0),
                "net_bytes_by_component": self._by_component(
                    self.net, nid, 1),
            }
        shares = {c: round(v / tot_cpu_busy, 6)
                  for c, v in sorted(tot_cpu_comp.items())} \
            if tot_cpu_busy > 0 else {}
        return {
            "system": self.system,
            "elapsed_s": round(elapsed, 6),
            "nodes": nodes,
            "cpu_share_by_component": shares,
            "cluster_cpu_busy_s": round(tot_cpu_busy, 9),
            "heat": {str(r): h for r, h in self.heat_snapshot().items()},
            "timeline": self.timeline,
        }


def _tree(by_component: dict) -> dict:
    """Group dotted component labels into a top-level -> leaf tree."""
    out: dict[str, dict] = {}
    for comp, v in by_component.items():
        top = comp.split(".", 1)[0]
        out.setdefault(top, {})[comp] = v
    return out


def format_profile_report(profile: dict, width: int = 32) -> list[str]:
    """Text flamegraph-style rollup (node -> component -> sub-stage) of a
    `Profiler.summary()` block; returned as printable lines."""
    lines = []
    for nid, nb in sorted(profile.get("nodes", {}).items(),
                          key=lambda kv: str(kv[0])):
        busy = nb["cpu_busy_s"]
        lines.append(
            f"node {nid}: cpu {100 * nb['cpu_util']:.1f}% util "
            f"({busy * 1e3:.1f} ms busy), disk {100 * nb['disk_util']:.1f}% "
            f"({nb['disk_busy_s'] * 1e3:.1f} ms)")
        total = max(busy, 1e-12)
        for top, leaves in sorted(_tree(nb["cpu_by_component"]).items(),
                                  key=lambda kv: -sum(kv[1].values())):
            tv = sum(leaves.values())
            bar = "#" * int(round(width * tv / total))
            lines.append(f"  {top:<16} {tv * 1e3:9.3f} ms "
                         f"{100 * tv / total:5.1f}%  {bar}")
            if len(leaves) > 1 or next(iter(leaves)) != top:
                for comp, v in sorted(leaves.items(), key=lambda kv: -kv[1]):
                    lines.append(f"    {comp:<18} {v * 1e3:9.3f} ms "
                                 f"{100 * v / total:5.1f}%")
        dtot = max(nb["disk_busy_s"], 1e-12)
        for comp, v in sorted(nb["disk_by_component"].items(),
                              key=lambda kv: -kv[1]):
            lines.append(f"  disk:{comp:<13} {v * 1e3:9.3f} ms "
                         f"{100 * v / dtot:5.1f}%")
    heat = profile.get("heat", {})
    if heat:
        lines.append("range heat (ops / bytes / lock-wait):")
        for rid, h in sorted(heat.items(), key=lambda kv: -kv[1]["ops"]):
            lines.append(f"  range {rid:>3}: {h['ops']:>8} ops  "
                         f"{h['bytes']:>10} B  "
                         f"{h['lock_wait_s'] * 1e3:8.2f} ms lock-wait")
    return lines
