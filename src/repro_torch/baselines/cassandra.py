"""Cassandra-style eventually consistent datastore (§9 baseline).

The paper benchmarks Spinnaker against Cassandra (from whose codebase it
was derived), so the comparison system is reproduced on the same simulator
with the same storage/log/network models:

- no leaders: any cohort replica coordinates a request;
- writes go to all 3 replicas; *weak* writes ack after 1 durable copy,
  *quorum* writes after 2 (same durability as Spinnaker, §9.2);
- *weak* reads touch 1 replica; *quorum* reads touch 2, resolve conflicts
  by timestamp (last-writer-wins) and fire async read repair;
- no quorum-based recovery: a restarted replica serves stale data until
  read repair catches it (the consistency gap §9 highlights).

Timestamps come from the coordinator's clock — concurrent writes to
different coordinators can conflict and LWW-resolve, which is exactly the
anomaly Spinnaker's leader serialization removes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..core.cluster import key_of
from ..core.sim import (Disk, DiskParams, FifoServer, LatencyStats, NetParams,
                        Network, Simulator)
from ..core.types import ErrorCode, Result
from ..obs import Observability, ObsConfig


@dataclass
class CassandraConfig:
    n_nodes: int = 5
    num_keys: int = 100_000
    disk: DiskParams = field(default_factory=DiskParams.hdd)
    net: NetParams = field(default_factory=NetParams)
    # coordinator-side mutation batching, mirroring the Spinnaker leader's
    # adaptive proposal batching so the §9 comparison stays fair: real
    # Cassandra coordinators batch mutations per destination replica too
    batch: str = "adaptive"             # "adaptive" | "off"
    batch_max_records: int = 32
    batch_deadline: float = 0.5e-3
    # server-side ingress batching, mirroring core/node.py (same codebase,
    # §9): messages arriving while the CPU is busy drain as one batch job —
    # per-message overhead once per message class, marginal per record
    ingress_batch: bool = True
    obs: ObsConfig = field(default_factory=ObsConfig)


@dataclass
class _TCell:
    value: Any
    ts: float


# CPU costs mirror the Spinnaker node's (same codebase, §9): a
# (per-message overhead, per-mutation marginal) split, so batched
# replica_write messages amortise the overhead exactly like proposes do
CPU_READ = (96e-6, 14e-6)
CPU_WRITE = (30e-6, 25e-6)
CPU_FWD = (16e-6, 12e-6)
CPU_ACK = (8e-6, 0.0)

# kinds that carry client requests; everything else (forwarded replica
# reads/writes, acks) is protocol traffic the two-class ingress drain
# runs ahead of client request processing
_CLIENT_KINDS = ("coord_read", "coord_write")

# message kind -> profiler component label (mirrors core/node.py so the
# Spinnaker-vs-Cassandra utilization shares compare like for like)
COMPONENT_OF = {
    "coord_read": "client.read",
    "coord_write": "client.write",
    "replica_write": "replica.fwd",
    "replica_read": "replica.fwd",
    "ack": "replica.ack",
    "read_resp": "replica.ack",
}


class CassandraNode:
    def __init__(self, cluster: "CassandraCluster", node_id: int,
                 cfg: CassandraConfig):
        self.cluster = cluster
        self.node_id = node_id
        self.cfg = cfg
        self.sim = cluster.sim
        self.cpu = FifoServer(self.sim, name=f"ccpu{node_id}")
        self.disk = Disk(self.sim, cfg.disk, name=f"clog{node_id}")
        self.data: dict[tuple[str, str], _TCell] = {}
        self.up = True
        # coordinator-side per-destination mutation accumulators
        self._mut_batch: dict[int, list[tuple]] = {}
        self._mut_timer: dict[int, Any] = {}
        self.batches_sent = 0
        self.muts_batched = 0
        # server-side ingress batching (mirrors SpinnakerNode; same
        # codebase, §9): staged messages drained as one amortised CPU job
        self._ingress: list[tuple] = []
        self._ingress_ev = None
        self.ingress_draining = False
        self.ingress_batches = 0
        self.ingress_msgs = 0

    # -- local replica ops -------------------------------------------------------
    def local_write(self, key: str, colname: str, value: Any, ts: float,
                    done: Callable) -> None:
        """Log force (group commit) then memtable apply."""
        def after_force():
            if not self.up:
                return
            cur = self.data.get((key, colname))
            if cur is None or ts >= cur.ts:
                self.data[(key, colname)] = _TCell(value, ts)
            done()
        self.disk.force(4200, after_force, component="wal.force")

    def _apply_local(self, key: str, colname: str, value: Any,
                     ts: float) -> None:
        cur = self.data.get((key, colname))
        if cur is None or ts >= cur.ts:
            self.data[(key, colname)] = _TCell(value, ts)

    def local_read(self, key: str, colname: str) -> Optional[_TCell]:
        return self.data.get((key, colname))

    def crash(self, lose_disk: bool = False) -> None:
        self.up = False
        self.cluster.net.set_down(self.node_id, True)
        self.cpu.close()
        self.cpu.bump_generation()
        self.disk.crash()
        self._ingress.clear()
        if self._ingress_ev is not None:
            self._ingress_ev.cancel()
            self._ingress_ev = None
        for timer in self._mut_timer.values():
            timer.cancel()
        self._mut_timer.clear()
        self._mut_batch.clear()
        if lose_disk:
            self.data.clear()

    def restart(self) -> None:
        # commit log replay restores the pre-crash memtable (all writes were
        # forced before ack); no catch-up — the replica is simply stale.
        self.up = True
        self.cluster.net.set_down(self.node_id, False)
        self.cpu.open()

    # -- message entry points ------------------------------------------------------
    def handle(self, kind: str, kw: dict) -> None:
        if not self.up:
            return
        # trace context rides the request; coord_write carries it onward
        # (it stamps durable-commit), reads only need the receive mark
        tr = kw.pop("trace", None)
        if tr is not None:
            tr.mark_recv(self.sim.now, self.node_id)
            if kind == "coord_write":
                kw["trace"] = tr
        base, per_rec = {"coord_read": CPU_READ, "coord_write": CPU_WRITE,
                         "replica_write": CPU_FWD, "replica_read": CPU_FWD,
                         "ack": CPU_ACK}.get(kind, CPU_ACK)
        n = len(kw["muts"]) if "muts" in kw else \
            len(kw["tags"]) if "tags" in kw else 1
        thunk = lambda: getattr(self, kind)(**kw)   # noqa: E731
        if not self.cfg.ingress_batch or (
                not self._ingress and self.cpu.queue_delay() <= 1e-12):
            self._profile_cpu(kind, base + per_rec * n)
            self.cpu.submit(base + per_rec * n, thunk)
            return
        self._ingress.append((kind, base, per_rec * n, thunk))
        if self._ingress_ev is None:
            self._ingress_ev = self.sim.schedule(
                self.cpu.queue_delay(), self._drain_ingress)

    def _profile_cpu(self, kind: str, cost: float) -> None:
        prof = self.cluster.obs.profiler
        if prof.enabled:
            wait = self.cpu.queue_delay()
            prof.cpu_work(self.node_id, COMPONENT_OF.get(kind, "other"),
                          cost * self.cpu.slow_factor, queue_wait_s=wait)
            self.cluster.obs.metrics.observe(
                self.node_id, "cpu_queue_wait_s", wait)

    def _drain_ingress(self) -> None:
        self._ingress_ev = None
        if not self.up:
            self._ingress.clear()
            return
        if self.cpu.queue_delay() > 1e-12:
            self._ingress_ev = self.sim.schedule(
                self.cpu.queue_delay(), self._drain_ingress)
            return
        batch, self._ingress = self._ingress, []
        if not batch:
            return
        self.ingress_batches += 1
        self.ingress_msgs += len(batch)
        # Two-class drain, mirroring the Spinnaker node: replica-side
        # protocol traffic (forwarded writes/reads, acks) runs as its own
        # CPU job ahead of coordinator-side client requests, the way real
        # stores give replication handling its own stage.
        proto = [it for it in batch if it[0] not in _CLIENT_KINDS]
        client = [it for it in batch if it[0] in _CLIENT_KINDS]
        for job in (proto, client):
            if not job:
                continue
            total = 0.0
            seen: set[str] = set()
            for kind, base, marginal, _thunk in job:
                share = marginal + (base if kind not in seen else 0.0)
                seen.add(kind)
                total += share
                self._profile_cpu(kind, share)

            def run_batch(job=job):
                self.ingress_draining = True
                try:
                    for _k, _b, _m, thunk in job:
                        thunk()
                finally:
                    self.ingress_draining = False
                for dst in list(self._mut_batch):
                    self._maybe_flush_muts(dst)

            self.cpu.submit(total, run_batch)

    # -- coordinator-side mutation batching ----------------------------------------
    def _enqueue_mut(self, dst: int, key: str, colname: str, value: Any,
                     ts: float) -> None:
        """Stage a mutation for `dst`; flush policy mirrors the Spinnaker
        leader's adaptive batching (immediate while the CPU queue is empty,
        else accumulate until count/deadline)."""
        self._mut_batch.setdefault(dst, []).append((key, colname, value, ts))
        self._maybe_flush_muts(dst)

    def _maybe_flush_muts(self, dst: int) -> None:
        cfg = self.cfg
        if not self._mut_batch.get(dst):
            return
        if cfg.batch != "adaptive" \
                or len(self._mut_batch[dst]) >= cfg.batch_max_records:
            self._flush_muts(dst)
            return
        if self.ingress_draining:
            # mid ingress-drain: coord_writes still to run in this CPU
            # batch may stage more mutations for dst; run_batch flushes
            # once at the end (mirrors the Spinnaker leader's accumulator)
            return
        if self.cpu.busy_until <= self.sim.now + 1e-12:
            self._flush_muts(dst)
        elif dst not in self._mut_timer:
            self._mut_timer[dst] = self.sim.schedule(
                cfg.batch_deadline, self._flush_muts, dst)

    def _flush_muts(self, dst: int) -> None:
        timer = self._mut_timer.pop(dst, None)
        if timer is not None:
            timer.cancel()
        muts = self._mut_batch.pop(dst, [])
        if not muts or not self.up:
            return
        self.batches_sent += 1
        self.muts_batched += len(muts)
        node = self.cluster.nodes[dst]
        nbytes = 100 + sum(200 + (len(v) if isinstance(v, (bytes, str))
                                  else 16) for _, _, v, _ in muts)
        self.cluster.net.send(self.node_id, dst, node.handle, "replica_write",
                              dict(muts=muts, origin=self.node_id),
                              nbytes=nbytes, component="replica.fwd")

    # -- coordinator logic -----------------------------------------------------------
    def coord_write(self, key: str, colname: str, value: Any, w: int,
                    reply: Callable, trace=None) -> None:
        """Send to all 3 replicas, ack client after `w` durable copies."""
        ts = self.sim.now  # coordinator clock = LWW timestamp
        if trace is not None:
            trace.t_cpu = ts
        members = self.cluster.cohort(self.cluster.range_of(key))
        acks = [0]
        replied = [False]

        def one_ack():
            acks[0] += 1
            if acks[0] >= w and not replied[0]:
                replied[0] = True
                if trace is not None:
                    trace.t_commit = self.sim.now
                reply(Result(ErrorCode.OK, version=0))

        # ack collection from remote replicas (registered before the sends
        # so a same-tick ack cannot race it)
        self._pending_acks.setdefault((key, colname, ts), one_ack)
        for m in members:
            if m == self.node_id:
                self.local_write(key, colname, value, ts, one_ack)
            else:
                self._enqueue_mut(m, key, colname, value, ts)

    _pending_acks: dict = None  # set in __init__ of cluster wiring

    def replica_write(self, muts: list, origin: int) -> None:
        """Apply a coordinator's mutation batch: ONE log force covers every
        mutation (group commit), then one cumulative ack message carrying
        every tag rides back."""
        def done():
            if not self.up:
                return
            tags = []
            for key, colname, value, ts in muts:
                self._apply_local(key, colname, value, ts)
                tags.append((key, colname, ts))
            node = self.cluster.nodes.get(origin)
            if node is None:
                return
            self.cluster.net.send(self.node_id, origin, node.handle, "ack",
                                  dict(tags=tags),
                                  nbytes=64 + 96 * len(tags),
                                  component="replica.ack")
        self.disk.force(4200 * len(muts), done, component="wal.force")

    def ack(self, tags: list) -> None:
        for tag in tags:
            cb = self._pending_acks.get(tag)
            if cb is not None:
                cb()

    def coord_read(self, key: str, colname: str, r: int,
                   reply: Callable) -> None:
        """Read `r` replicas, LWW-resolve, async read repair on conflict."""
        members = list(self.cluster.cohort(self.cluster.range_of(key)))
        # prefer self if replica, then others round-robin
        if self.node_id in members:
            members.remove(self.node_id)
            targets = [self.node_id] + members
        else:
            targets = members
        targets = targets[:r]
        results: list[tuple[int, Optional[_TCell]]] = []

        def collect(nid: int, cell: Optional[_TCell]):
            results.append((nid, cell))
            if len(results) == len(targets):
                cells = [c for _, c in results if c is not None]
                if not cells:
                    reply(Result(ErrorCode.NOT_FOUND))
                    return
                best = max(cells, key=lambda c: c.ts)
                # read repair: push the winning cell to stale replicas
                for nid2, c in results:
                    if c is None or c.ts < best.ts:
                        if nid2 == self.node_id:
                            self.cluster.nodes[nid2].local_write(
                                key, colname, best.value, best.ts,
                                lambda: None)
                        else:
                            self._enqueue_mut(nid2, key, colname,
                                              best.value, best.ts)
                reply(Result(ErrorCode.OK, value=best.value, version=0))

        for t in targets:
            if t == self.node_id:
                collect(t, self.local_read(key, colname))
            else:
                node = self.cluster.nodes[t]

                def remote(t=t, node=node):
                    self.cluster.net.send(
                        self.node_id, t, node.handle, "replica_read",
                        dict(key=key, colname=colname, origin=self.node_id,
                             tag=(key, colname, self.sim.now)), nbytes=300,
                        component="replica.fwd")
                remote()
        self._read_collect[(key, colname)] = collect

    _read_collect: dict = None

    def replica_read(self, key: str, colname: str, origin: int,
                     tag) -> None:
        cell = self.local_read(key, colname)
        node = self.cluster.nodes.get(origin)
        if node is None:
            return
        nbytes = 4300 if cell is not None else 200
        self.cluster.net.send(self.node_id, origin, node.handle, "read_resp",
                              dict(key=key, colname=colname, cell=cell,
                                   frm=self.node_id), nbytes=nbytes,
                              component="replica.ack")

    def read_resp(self, key: str, colname: str, cell: Optional[_TCell],
                  frm: int) -> None:
        cb = self._read_collect.get((key, colname))
        if cb is not None:
            cb(frm, cell)


class CassandraCluster:
    def __init__(self, sim: Simulator, cfg: CassandraConfig | None = None):
        self.sim = sim
        self.cfg = cfg or CassandraConfig()
        self.net = Network(sim, self.cfg.net)
        self.obs = Observability(sim, "cassandra", self.cfg.obs)
        self.nodes: dict[int, CassandraNode] = {}
        self.obs.profiler.attach_network(self.net)
        n = self.cfg.n_nodes
        self.boundaries = [key_of(i * self.cfg.num_keys // n) for i in range(n)]
        for i in range(n):
            node = CassandraNode(self, i, self.cfg)
            node._pending_acks = {}
            node._read_collect = {}
            self.nodes[i] = node
            self.obs.profiler.attach_node(i, node.cpu, node.disk)
            m = self.obs.metrics
            m.add_gauge(i, "cpu_queue_s", node.cpu.queue_delay)
            m.add_gauge(i, "disk_queue", node.disk.queue_depth)
            m.add_gauge(i, "wal_forces", lambda node=node: node.disk.forces)
            m.add_gauge(i, "wal_bytes_forced",
                        lambda node=node: node.disk.bytes_forced)
        self.obs.start()

    def cohort(self, rid: int) -> tuple[int, int, int]:
        n = self.cfg.n_nodes
        return (rid, (rid + 1) % n, (rid + 2) % n)

    def range_of(self, key: str) -> int:
        import bisect
        return max(0, bisect.bisect_right(self.boundaries, key) - 1)

    def crash_node(self, nid: int, lose_disk: bool = False) -> None:
        self.nodes[nid].crash(lose_disk)

    def restart_node(self, nid: int) -> None:
        self.nodes[nid].restart()

    def partition(self, *groups) -> None:
        self.net.set_partition(groups)

    def heal(self) -> None:
        self.net.clear_partition()

    def make_client(self, client_id: str = "cc0") -> "CassandraClient":
        return CassandraClient(self, client_id)


class CassandraClient:
    """Weak/quorum reads and writes; coordinator = a cohort replica."""

    ATTEMPT_TIMEOUT = 1.0
    MAX_RETRIES = 30
    RETRY_DELAY = 0.05

    def __init__(self, cluster: CassandraCluster, client_id: str):
        self.cluster = cluster
        self.sim = cluster.sim
        self.id = client_id
        self.stats = LatencyStats()
        self.stats_by_kind: dict[str, LatencyStats] = {}
        self.op_hook: Optional[Callable[[str, Result], None]] = None
        self._rr = 0
        # workload adapters set this right before issuing an op so traces
        # carry the workload's label instead of the wire kind
        self.next_trace_kind: Optional[str] = None

    def _coordinator(self, key: str) -> int:
        members = self.cluster.cohort(self.cluster.range_of(key))
        self._rr += 1
        return members[self._rr % len(members)]

    def write(self, key: str, colname: str, value: Any, quorum: bool,
              cb: Callable) -> None:
        self._op("coord_write", key,
                 dict(key=key, colname=colname, value=value,
                      w=2 if quorum else 1), cb, t0=self.sim.now, tries=0,
                 nbytes=4300)

    def read(self, key: str, colname: str, quorum: bool,
             cb: Callable) -> None:
        self._op("coord_read", key,
                 dict(key=key, colname=colname, r=2 if quorum else 1), cb,
                 t0=self.sim.now, tries=0, nbytes=300)

    def _op(self, kind: str, key: str, kw: dict, cb: Callable, t0: float,
            tries: int, nbytes: int) -> None:
        path = kind.removeprefix("coord_")
        if tries == 0:
            hint = self.next_trace_kind
            self.next_trace_kind = None
            tr0 = self.cluster.obs.tracer.maybe_start(hint or path, path, key)
            if tr0 is not None:
                kw["_trace"] = tr0      # kw persists across retries
        if tries > self.MAX_RETRIES:
            res = Result(ErrorCode.TIMEOUT, latency=self.sim.now - t0)
            tr = kw.pop("_trace", None)
            if tr is not None:
                self.cluster.obs.tracer.finish(tr, False, "timeout")
            if self.op_hook is not None:
                self.op_hook(path, res)
            cb(res)
            return
        target = self._coordinator(key)
        settled = [False]

        def on_reply(res: Result):
            if settled[0]:
                return
            settled[0] = True
            timeout_ev.cancel()
            res.latency = self.sim.now - t0
            self.stats.add(res.latency)
            self.stats_by_kind.setdefault(path, LatencyStats()).add(
                res.latency)
            tr = kw.pop("_trace", None)
            if tr is not None:
                self.cluster.obs.tracer.finish(
                    tr, res.ok, getattr(res.code, "name", str(res.code)))
            if self.op_hook is not None:
                self.op_hook(path, res)
            cb(res)

        def on_timeout():
            if settled[0]:
                return
            settled[0] = True
            self.sim.schedule(self.RETRY_DELAY, self._op, kind, key, kw, cb,
                              t0, tries + 1, nbytes)

        timeout_ev = self.sim.schedule(self.ATTEMPT_TIMEOUT, on_timeout)

        def reply_via_net(res: Result):
            self.cluster.net.send(target, self.id, on_reply, res,
                                  nbytes=4300, cross_switch=True,
                                  component="client.reply")

        payload = dict(kw)
        payload.pop("_trace", None)
        tr = kw.get("_trace")
        if tr is not None:
            tr.attempts += 1
            tr.t_send = self.sim.now
            payload["trace"] = tr
        payload["reply"] = reply_via_net
        node = self.cluster.nodes[target]
        comp = "client.write" if kind == "coord_write" else "client.read"
        self.cluster.net.send(self.id, target, node.handle, kind, payload,
                              nbytes=nbytes, cross_switch=True,
                              component=comp)

    # sync helpers for tests
    def sync_write(self, key: str, colname: str, value: Any,
                   quorum: bool = True) -> Result:
        box = []
        self.write(key, colname, value, quorum, lambda r: box.append(r))
        guard = 0
        while not box and guard < 1_000_000:
            if not self.sim.step():
                break
            guard += 1
        return box[0]

    def sync_read(self, key: str, colname: str, quorum: bool = True) -> Result:
        box = []
        self.read(key, colname, quorum, lambda r: box.append(r))
        guard = 0
        while not box and guard < 1_000_000:
            if not self.sim.step():
                break
            guard += 1
        return box[0]
