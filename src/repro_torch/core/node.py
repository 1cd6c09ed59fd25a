"""A Spinnaker node (§4.1): shared WAL on a dedicated log device, CPU
server, 3 cohort replicas (chained declustering), ZooKeeper session with
heartbeats, and message dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, TYPE_CHECKING

from . import ranges as ranges_mod
from .replica import CohortReplica, ReplicaConfig, Role
from .sim import Disk, DiskParams, FifoServer
from .storage import Store
from .types import ErrorCode, KeyRange, Result
from .wal import WAL

if TYPE_CHECKING:
    from .cluster import SpinnakerCluster


# CPU service times, split into (per-message overhead, per-record marginal
# cost).  The overhead is the kernel/network-stack + dispatch cost paid once
# per message; the marginal term is deserialisation + protocol work per
# record carried.  Proposal batching amortises the overhead across the
# batch — that is its entire benefit, and splitting the costs keeps it
# principled instead of free.  Calibrated so single-record messages cost
# what the flat pre-batching model charged (knees match the paper's §C:
# reads are CPU+network bound, writes log-force bound; the write knee moves
# with batch size exactly as Fig. 8's saturation points suggest).
CPU_COST = {
    "client_read": (96e-6, 14e-6),      # 4KB read incl. kernel / net stack
    "client_write": (30e-6, 25e-6),
    "on_propose": (16e-6, 12e-6),
    "on_ack": (8e-6, 0.0),
    "on_commit": (8e-6, 0.0),
    "on_new_leader": (20e-6, 0.0),
    "on_follower_state": (20e-6, 0.0),
    "on_catchup_data": (24e-6, 6e-6),
    "on_catchup_synced": (20e-6, 0.0),
    # 2PC traffic (core/txn.py): prepares carry per-op payload, the
    # control messages are small fixed-cost singles
    "on_txn_prepare": (20e-6, 12e-6),
    "on_txn_vote": (10e-6, 0.0),
    "on_txn_decide": (12e-6, 0.0),
    "on_txn_decided_ack": (8e-6, 0.0),
    # lease renewal + connectivity probes (small control messages)
    "on_lease": (8e-6, 0.0),
    "on_lease_ack": (8e-6, 0.0),
    "on_ping": (6e-6, 0.0),
    "on_pong": (6e-6, 0.0),
    "on_read_confirm": (8e-6, 0.0),
    "on_read_confirm_ack": (8e-6, 0.0),
    "default": (10e-6, 0.0),
}

# dispatch classes that carry client requests; everything else is protocol
# traffic (replication, 2PC, leases) that the two-class ingress drain runs
# ahead of client request processing
_CLIENT_CLASSES = ("client_read", "client_write")


def message_cost(handler: str, kw: dict) -> float:
    """CPU service time for one message: overhead + marginal * records."""
    base, per_rec = CPU_COST.get(handler, CPU_COST["default"])
    records = kw.get("records")
    if not isinstance(records, list):
        records = kw.get("ops")
    n = len(records) if isinstance(records, list) else 1
    return base + per_rec * n


# Resource-profiler component labels (obs/profile.py): every protocol
# message is attributed to the subsystem that sent it, so the profiler can
# answer "which component is burning this node's CPU/network".
COMPONENT_OF = {
    "client_read": "client.read",
    "client_write": "client.write",
    "on_propose": "paxos.propose",
    "on_ack": "paxos.ack",
    "on_commit": "paxos.commit",
    "on_new_leader": "election",
    "on_follower_state": "election",
    "on_deposed": "election",
    "on_catchup_data": "catchup",
    "on_catchup_synced": "catchup",
    "on_txn_prepare": "txn.prepare",
    "on_txn_vote": "txn.vote",
    "on_txn_decide": "txn.decide",
    "on_txn_decided_ack": "txn.ack",
    "on_lease": "lease.heartbeat",
    "on_lease_ack": "lease.heartbeat",
    "on_ping": "lease.heartbeat",
    "on_pong": "lease.heartbeat",
    "on_read_confirm": "paxos.read_confirm",
    "on_read_confirm_ack": "paxos.read_confirm",
}


def component_of(handler: str) -> str:
    return COMPONENT_OF.get(handler, "other")


@dataclass
class NodeConfig:
    replica: ReplicaConfig = field(default_factory=ReplicaConfig)
    disk: DiskParams = field(default_factory=DiskParams.hdd)
    heartbeat_interval: float = 0.5
    wal_segment_bytes: int = 1 << 22
    # -- ingress batching ---------------------------------------------------
    # While the CPU is busy, arriving messages stage in an ingress queue and
    # are served as ONE batch job when it drains: per-message overhead is
    # paid once per message class in the batch, the marginal term per record
    # (recvmmsg-style batched ingest — same amortisation the proposal
    # accumulator applies on the wire, applied at the CPU).  An idle CPU
    # dispatches immediately, so light load keeps the unbatched latency.
    ingress_batch: bool = True
    # -- admission control --------------------------------------------------
    # Client requests arriving when the CPU backlog (queued + staged work)
    # exceeds this many seconds are shed with OVERLOADED instead of queued;
    # the client backs off and retries.  Past the saturation knee this
    # converts collapse (every op queues for seconds, then times out and
    # retries, multiplying load) into flat goodput.  None = admit all.
    admission_limit: Optional[float] = None


class SpinnakerNode:
    def __init__(self, cluster: "SpinnakerCluster", node_id: int,
                 cfg: NodeConfig):
        self.cluster = cluster
        self.node_id = node_id
        self.cfg = cfg
        self.sim = cluster.sim
        self.net = cluster.net
        self.zk = cluster.zk

        self.cpu = FifoServer(self.sim, name=f"cpu{node_id}")
        self.disk = Disk(self.sim, cfg.disk, name=f"log{node_id}")
        self.wal = WAL(self.sim, self.disk, segment_bytes=cfg.wal_segment_bytes)
        def gc_event(kind, rid, lsn):
            # kind ∈ {gc_floor_pin, gc_floor_release}: surfaced in both the
            # cluster event log and the protocol journal (the watchdog's
            # gc_floor_safe invariant reads the journal side)
            cluster.obs.events.emit(kind, node=node_id, rid=rid, lsn=lsn)
            cluster.obs.journal.record(kind, node=node_id, rid=rid, lsn=lsn)
        self.wal.on_gc_event = gc_event
        self.replicas: dict[int, CohortReplica] = {}
        self.session: Optional[int] = None
        self._hb_timer = None
        self.up = False
        # ingress batching: messages staged while the CPU is busy, drained
        # as one amortised batch job (see NodeConfig.ingress_batch)
        self._ingress: list[tuple] = []   # (class, comp, base, marginal, thunk, rid)
        self._ingress_cost = 0.0          # un-amortised staged service time
        self._ingress_ev = None
        self.ingress_draining = False     # replicas defer batch flushes while set
        self.ingress_batches = 0
        self.ingress_msgs = 0
        self.admission_shed = 0
        # reply envelopes: replies minted in one event share one message
        # per client (the "one scheduled ack flush per batch" of §9)
        self._reply_buf: dict[str, list[tuple]] = {}
        # protocol envelopes (send_batched): per-destination staging
        self._proto_buf: dict[int, list[tuple]] = {}

    # -- wiring ----------------------------------------------------------------
    def add_range(self, key_range: KeyRange, peers: tuple[int, ...]) -> None:
        self.replicas[key_range.range_id] = CohortReplica(
            self, key_range, peers, self.cfg.replica)

    # -- range lifecycle (core/ranges.py) ---------------------------------------
    def fork_child_replica(self, child_range: KeyRange,
                           peers: tuple[int, ...], store: Store,
                           fork_lsn: int) -> None:
        """Local zero-copy fork while applying a SPLIT: adopt the detached
        child store, durably seed the child's log state at the fork point,
        and join the child cohort's election."""
        rid = child_range.range_id
        if rid in self.replicas:
            return   # replayed split; the child already exists here
        rep = CohortReplica(self, child_range, peers, self.cfg.replica)
        rep.store = store
        self.wal.seed_range(rid, fork_lsn)
        self.replicas[rid] = rep
        if self.up:
            rep.start()

    def retire_replica(self, rid: int) -> None:
        """Drop a replica this node no longer hosts (migration retire or
        deposed straggler): stop it, clear its candidacies, forget its log
        state, and free the store."""
        rep = self.replicas.pop(rid, None)
        if rep is None:
            return
        rep.stop()
        # the watchdog drops its per-(node, range) expectations here — a
        # later re-add starts this replica's watermarks from scratch
        self.cluster.obs.journal.record("replica_retired", node=self.node_id,
                                        rid=rid)
        for name, (data, _cz) in list(
                self.zk.get_children(f"/ranges/{rid}/candidates").items()):
            if data[0] == self.node_id:
                try:
                    self.zk.delete(f"/ranges/{rid}/candidates/{name}")
                except Exception:
                    pass
        self.wal.forget_range(rid)

    def ensure_replica(self, rid: int) -> None:
        """Host a replica for `rid` if the registered member set includes
        this node and no local replica exists yet (migration destination,
        or a split that happened while this node was down).  The blank
        store is filled by snapshot + WAL catch-up from the range leader."""
        if rid in self.replicas:
            return
        meta = ranges_mod.get_range_meta(self.zk, rid)
        if meta is None:
            return
        lo, hi, members = meta
        if self.node_id not in members:
            return
        if self._hosts_overlapping(lo, hi, rid):
            # a local parent replica still covers these keys: the SPLIT it
            # has yet to apply will fork the child locally, with its data —
            # don't preempt that with an empty snapshot-fed replica
            return
        rep = CohortReplica(self, KeyRange(rid, lo, hi),
                            tuple(m for m in members if m != self.node_id),
                            self.cfg.replica)
        self.replicas[rid] = rep
        if self.up:
            rep.start()

    def _hosts_overlapping(self, lo: str, hi: str, rid: int) -> bool:
        for other in self.replicas.values():
            if other.rid == rid:
                continue
            o_lo, o_hi = other.range.lo, other.range.hi
            if (hi == "" or o_lo < hi) and (o_hi == "" or lo < o_hi):
                return True
        return False

    def reconcile_ranges(self) -> None:
        """Boot-time alignment with coordination metadata: ranges narrowed
        or members changed while this node was down.  Narrow/retire first,
        then create missing replicas (ordering matters: a narrowed parent
        no longer shadows the child it must now host)."""
        rmap = ranges_mod.load_range_map(self.zk)
        if not rmap:
            return
        for rid, (lo, hi, members) in rmap.items():
            rep = self.replicas.get(rid)
            if rep is None:
                continue
            if self.node_id not in members:
                self.retire_replica(rid)
                continue
            rep.peers = tuple(sorted(m for m in members if m != self.node_id))
            if (lo, hi) != (rep.range.lo, rep.range.hi):
                rep.range = KeyRange(rid, lo, hi)
                rep.store.restrict(lo, hi)
        for rid in rmap:
            self.ensure_replica(rid)

    def has_session(self) -> bool:
        return self.session is not None and self.zk.session_alive(self.session)

    # -- lifecycle ---------------------------------------------------------------
    def boot(self) -> None:
        self.up = True
        self.net.set_down(self.node_id, False)
        self.cpu.open()
        self.session = self.zk.create_session()
        try:
            self.zk.create(f"/nodes/{self.node_id}", data=self.sim.now,
                           ephemeral_session=self.session)
        except Exception:
            pass
        self._heartbeat()
        # reconcile hosted replicas with the registered range table first:
        # splits/member changes may have happened while this node was down
        # (replicas created here start themselves, hence the OFFLINE check)
        self.reconcile_ranges()
        # local recovery of the surviving cohorts (shared log scan, §6)
        for replica in list(self.replicas.values()):
            if replica.role is Role.OFFLINE:
                replica.start()

    def _heartbeat(self) -> None:
        if not self.up:
            return
        if self.session is not None:
            self.zk.heartbeat(self.session)
        self._hb_timer = self.sim.schedule(self.cfg.heartbeat_interval,
                                           self._heartbeat)

    def flap_session(self, outage: float = 1.0) -> None:
        """ZK session flap (gray failure): the session expires — every
        ephemeral this node holds (its /nodes znode, leader claims,
        candidacies) vanishes — while the node itself keeps serving.
        After `outage` seconds the client library reconnects with a fresh
        session and the replicas re-join their cohorts."""
        if not self.up or self.session is None:
            return
        old = self.session
        self.session = None
        self.zk.expire_session(old)

        def reconnect():
            if not self.up or self.session is not None:
                return
            self.session = self.zk.create_session()
            try:
                self.zk.create(f"/nodes/{self.node_id}", data=self.sim.now,
                               ephemeral_session=self.session)
            except Exception:
                pass
            for rep in list(self.replicas.values()):
                rep.on_session_reestablished()

        self.sim.schedule(outage, reconnect)

    def crash(self, lose_disk: bool = False, expire_session: bool = False) -> None:
        """Fail-stop: volatile state lost; durable log/SSTables survive
        unless `lose_disk`."""
        self.up = False
        self.net.set_down(self.node_id, True)
        self.cpu.close()
        self.cpu.bump_generation()
        self._ingress.clear()
        self._ingress_cost = 0.0
        if self._ingress_ev is not None:
            self._ingress_ev.cancel()
            self._ingress_ev = None
        self._reply_buf.clear()
        self._proto_buf.clear()
        if self._hb_timer is not None:
            self._hb_timer.cancel()
            self._hb_timer = None
        self.wal.crash()
        for replica in self.replicas.values():
            replica.stop()
            replica.store.crash_volatile()
            if lose_disk:
                replica.store.lose_disk()
        if lose_disk:
            self.wal.durable.clear()
            self.wal.durable_bytes = 0
            self.wal.skipped.clear()
            self.wal.flushed_upto.clear()
            self.wal._gc_dropped_upto.clear()
        if expire_session and self.session is not None:
            self.zk.expire_session(self.session)
        self.session = None

    def restart(self) -> None:
        self.boot()

    # -- messaging -----------------------------------------------------------------
    def send(self, dst: int, rid: int, handler: str, nbytes: int = 256,
             **kw: Any) -> None:
        dst_node = self.cluster.nodes[dst]
        self.net.send(self.node_id, dst,
                      dst_node.receive, rid, handler, kw, nbytes=nbytes,
                      component=component_of(handler), rid=rid)

    def send_batched(self, dst: int, rid: int, handler: str,
                     nbytes: int = 256, **kw: Any) -> None:
        """Protocol-message envelope: messages staged for `dst` in the same
        event leave as ONE wire message (used by the 2PC coordinator so
        prepares/decides per (coordinator, participant) pair share an
        envelope).  The flush is at +0 sim-time — never delays a message."""
        buf = self._proto_buf.get(dst)
        if buf is None:
            buf = self._proto_buf[dst] = []
            self.sim.schedule(0.0, self._flush_proto, dst)
        buf.append((rid, handler, kw, nbytes))

    def _flush_proto(self, dst: int) -> None:
        batch = self._proto_buf.pop(dst, None)
        if not batch or not self.up:
            return
        if len(batch) == 1:
            rid, handler, kw, nbytes = batch[0]
            self.send(dst, rid, handler, nbytes=nbytes, **kw)
            return
        dst_node = self.cluster.nodes[dst]
        items = [(rid, handler, kw) for rid, handler, kw, _n in batch]
        self.net.send(self.node_id, dst, dst_node.receive_batch, items,
                      nbytes=sum(n for *_h, n in batch),
                      component=component_of(batch[0][1]), rid=batch[0][0])

    def receive_batch(self, items: list) -> None:
        """Unpack a protocol envelope; each message dispatches through the
        normal receive path (and the ingress batch amortises their CPU —
        the first dispatch occupies the CPU, the rest stage behind it)."""
        for rid, handler, kw in items:
            self.receive(rid, handler, kw)

    def receive(self, rid: int, handler: str, kw: dict) -> None:
        if not self.up:
            return
        replica = self.replicas.get(rid)
        if replica is None:
            return
        base, per_rec = CPU_COST.get(handler, CPU_COST["default"])
        records = kw.get("records")
        if not isinstance(records, list):
            records = kw.get("ops")
        n = len(records) if isinstance(records, list) else 1
        self._dispatch(handler, component_of(handler), base, per_rec * n,
                       lambda: getattr(replica, handler)(**kw), rid)

    # -- ingress batching (see NodeConfig.ingress_batch) -----------------------
    def _dispatch(self, klass: str, comp: str, base: float, marginal: float,
                  thunk, rid: int) -> None:
        """CPU dispatch: immediate while the CPU is idle; staged into the
        ingress queue while it is busy, to be drained as one batch job."""
        if not self.cfg.ingress_batch or (
                not self._ingress and self.cpu.queue_delay() <= 1e-12):
            self._profile_cpu(comp, base + marginal, rid)
            self.cpu.submit(base + marginal, thunk)
            return
        self._ingress.append((klass, comp, base, marginal, thunk, rid))
        self._ingress_cost += base + marginal
        if self._ingress_ev is None:
            self._ingress_ev = self.sim.schedule(
                self.cpu.queue_delay(), self._drain_ingress)

    def _drain_ingress(self) -> None:
        self._ingress_ev = None
        if not self.up:
            self._ingress.clear()
            self._ingress_cost = 0.0
            return
        if self.cpu.queue_delay() > 1e-12:
            # a completion callback submitted more work in the meantime;
            # keep staging until the CPU actually drains
            self._ingress_ev = self.sim.schedule(
                self.cpu.queue_delay(), self._drain_ingress)
            return
        batch, self._ingress = self._ingress, []
        self._ingress_cost = 0.0
        if not batch:
            return
        self.ingress_batches += 1
        self.ingress_msgs += len(batch)
        # Two-class drain: protocol messages (propose/ack/commit/2PC —
        # microsecond bookkeeping that other nodes' commit paths block on)
        # drain ahead of client request processing, the way real stores
        # run replication handling on its own stage instead of behind the
        # client pool.  Arrival order is preserved within each class.
        proto = [it for it in batch if it[0] not in _CLIENT_CLASSES]
        client = [it for it in batch if it[0] in _CLIENT_CLASSES]
        for job in (proto, client):
            if not job:
                continue
            # one batch job per class group: per-message overhead once per
            # message class, the marginal term per message — each
            # message's share is profiled so component attribution still
            # sums exactly to cpu.total_busy
            total = 0.0
            seen: set[str] = set()
            for klass, comp, base, marginal, _thunk, rid in job:
                share = marginal + (base if klass not in seen else 0.0)
                seen.add(klass)
                total += share
                self._profile_cpu(comp, share, rid)

            def run_batch(job=job):
                # handlers run back-to-back in arrival order at batch end;
                # the draining flag makes replica proposal accumulators
                # hold their flush until every staged write has been
                # admitted, so one ingress batch feeds one proposal batch
                self.ingress_draining = True
                try:
                    for _k, _c, _b, _m, thunk, _r in job:
                        thunk()
                finally:
                    self.ingress_draining = False
                for rep in self.replicas.values():
                    rep.on_ingress_drained()

            self.cpu.submit(total, run_batch)

    # -- reply envelopes --------------------------------------------------------
    def client_reply(self, client_id: str, cb, res, nbytes: int) -> None:
        """Queue a client reply; all replies minted for one client in the
        same event leave as ONE envelope (per-message wire cost paid once).
        The flush is scheduled at +0 sim-time — coalescing never delays an
        ack, it only merges acks that were already simultaneous."""
        buf = self._reply_buf.get(client_id)
        if buf is None:
            buf = self._reply_buf[client_id] = []
            self.sim.schedule(0.0, self._flush_replies, client_id)
        buf.append((cb, res, nbytes))

    def _flush_replies(self, client_id: str) -> None:
        batch = self._reply_buf.pop(client_id, None)
        if not batch or not self.up:
            return   # a node that died this instant loses its replies
        if len(batch) == 1:
            cb, res, nbytes = batch[0]
            self.net.send(self.node_id, client_id, cb, res, nbytes=nbytes,
                          cross_switch=True, component="client.reply")
            return

        def deliver(items=batch):
            for cb, res, _nb in items:
                cb(res)

        self.net.send(self.node_id, client_id, deliver,
                      nbytes=sum(nb for _cb, _res, nb in batch),
                      cross_switch=True, component="client.reply")

    def _profile_cpu(self, component: str, cost: float, rid: int) -> None:
        """Attribute one CPU dispatch to the profiler (the slow factor is
        folded in so component sums match `cpu.total_busy` exactly) and
        feed the queue-wait histogram."""
        prof = self.cluster.obs.profiler
        if not prof.enabled:
            return
        wait = self.cpu.queue_delay()
        prof.cpu_work(self.node_id, component, cost * self.cpu.slow_factor,
                      rid=rid, queue_wait_s=wait)
        self.cluster.obs.metrics.observe(self.node_id, "cpu_queue_wait_s",
                                         wait)

    # client entry points (arrive via network; dispatched through the CPU)
    def handle_client_batch(self, items: list) -> None:
        """Unpack a client request envelope: requests a client issued in
        one event to this node share one message; each unpacks into the
        normal per-request path (and the ingress batch, when busy)."""
        for rid, kind, kw in items:
            self.handle_client(rid, kind, kw)

    def handle_client(self, rid: int, kind: str, kw: dict) -> None:
        if not self.up:
            return
        # the trace context rides the request payload; popped here (the
        # replica handlers are invoked with **kw) and re-threaded to the
        # write-path handlers, which stamp CPU-done on execution
        tr = kw.pop("trace", None)
        if tr is not None:
            tr.mark_recv(self.sim.now, self.node_id)
        replica = self.replicas.get(rid)
        if replica is None:
            kw["reply"](None)
            return
        limit = self.cfg.admission_limit
        if limit is not None \
                and self.cpu.queue_delay() + self._ingress_cost > limit:
            # shed at the NIC, before any CPU is spent: the client backs
            # off and retries, so offered load stops compounding the queue
            self.admission_shed += 1
            self.cluster.obs.metrics.inc(self.node_id, "admission_shed")
            kw["reply"](Result(ErrorCode.OVERLOADED))
            return
        base, per_rec = CPU_COST["client_read" if kind in ("read", "mread")
                                 else "client_write"]
        if kind == "read":
            n, comp = 1, "client.read"
            thunk = lambda: replica.client_read(**kw)           # noqa: E731
        elif kind == "mread":
            # batched read service: one message overhead for the group
            n = max(1, len(kw.get("pairs", ())))
            comp = "client.read"
            thunk = lambda: replica.client_multi_read(**kw)     # noqa: E731
        elif kind == "txn":
            n = max(1, len(kw.get("ops", ())))
            comp = "client.txn"
            thunk = lambda: replica.client_transaction(         # noqa: E731
                kw["ops"], kw["reply"], trace=tr)
        elif kind == "txn2":
            # cross-range transaction: this leader coordinates 2PC
            n = max(1, sum(len(ops) for ops in kw.get("groups", {}).values()))
            comp = "client.txn"
            thunk = lambda: replica.client_txn2(                # noqa: E731
                kw["groups"], kw["reply"], trace=tr)
        else:
            n, comp = 1, "client.write"
            thunk = lambda: replica.client_write(               # noqa: E731
                kw["op"], kw["reply"], trace=tr)
        klass = "client_read" if kind in ("read", "mread") else "client_write"
        self._dispatch(klass, comp, base, per_rec * n, thunk, rid)
