"""Cluster assembly (Fig. 2), range partitioning with chained declustering
(§4), and the client library (routing, retries, consistency levels).

Ranges are *elastic* (core/ranges.py): the table built here is only the
initial pre-split.  Live splits and replica migrations rewrite the
registered metadata; the cluster mirrors it into `ranges`/`members` as
ground truth for tests and the balancer, while clients route through
their own RangeTable cache and chase WRONG_RANGE redirects.
"""

from __future__ import annotations

import bisect
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from . import ranges as ranges_mod
from .coordination import Coordination, NoNode
from .node import NodeConfig, SpinnakerNode
from .ranges import BalancerConfig, RangeBalancer, RangeTable
from .sim import LatencyStats, NetParams, Network, Simulator
from .types import ErrorCode, KeyRange, OpType, Result, WriteOp
from ..obs import Observability, ObsConfig, install_node_gauges


@dataclass
class ClusterConfig:
    n_nodes: int = 5
    num_keys: int = 100_000          # key-space pre-split for range boundaries
    # base ranges per node.  One range per node is the minimal layout; a
    # finer pre-split (the paper's deployments run many ranges per node,
    # §2.1) spreads range leadership round-robin so a skewed workload's
    # hot keys land on different leaders instead of piling onto one node
    ranges_per_node: int = 1
    node: NodeConfig = field(default_factory=NodeConfig)
    net: NetParams = field(default_factory=NetParams)
    session_timeout: float = 2.0     # §D.1
    trace: bool = False
    obs: ObsConfig = field(default_factory=ObsConfig)


def key_of(i: int) -> str:
    return f"k{i:012d}"


class SpinnakerCluster:
    """N nodes; node i owns base range i, replicated on i+1, i+2 (mod N)."""

    def __init__(self, sim: Simulator, cfg: ClusterConfig | None = None):
        self.sim = sim
        self.cfg = cfg or ClusterConfig()
        self.net = Network(sim, self.cfg.net)
        self.zk = Coordination(sim, session_timeout=self.cfg.session_timeout)
        self.nodes: dict[int, SpinnakerNode] = {}
        self.trace_log: list[str] = []
        self.obs = Observability(sim, "spinnaker", self.cfg.obs)

        n = self.cfg.n_nodes
        if n < 3:
            raise ValueError("Spinnaker needs >= 3 nodes for 3-way replication")
        nr = n * max(1, self.cfg.ranges_per_node)
        self.n_base_ranges = nr
        # initial range table: uniform pre-split of the key space,
        # `ranges_per_node` base ranges per node, chained declustering
        # cohort(r) = {r, r+1, r+2} (mod n)
        boundaries = [key_of(i * self.cfg.num_keys // nr) for i in range(nr)]
        self.ranges: dict[int, KeyRange] = {}
        self.members: dict[int, tuple[int, ...]] = {}
        for i in range(nr):
            hi = boundaries[i + 1] if i + 1 < nr else ""
            self.ranges[i] = KeyRange(range_id=i, lo=boundaries[i], hi=hi)
            self.members[i] = tuple(sorted(
                (i % n, (i + 1) % n, (i + 2) % n)))
        self._rebuild_routing()
        # register the table in coordination: clients route from these
        # znodes, and splits/migrations rewrite them
        self.zk.create(ranges_mod.VERSION_PATH, data=0)
        self.zk.create(ranges_mod.NEXT_RID_PATH, data=nr - 1)
        for rid, kr in self.ranges.items():
            ranges_mod.set_range_meta(self.zk, rid, kr.lo, kr.hi,
                                      self.members[rid])

        self.obs.profiler.attach_network(self.net)
        for i in range(n):
            self.nodes[i] = SpinnakerNode(self, i, self.cfg.node)
            install_node_gauges(self.obs, self.nodes[i])
            self.obs.profiler.attach_node(i, self.nodes[i].cpu,
                                          self.nodes[i].disk)
        for rid, kr in self.ranges.items():
            for m in self.members[rid]:
                peers = tuple(x for x in self.members[rid] if x != m)
                self.nodes[m].add_range(kr, peers)
        self.balancer: Optional[RangeBalancer] = None

    def cohort(self, rid: int) -> tuple[int, ...]:
        return self.members[rid]

    def _rebuild_routing(self) -> None:
        table = sorted((kr.lo, rid) for rid, kr in self.ranges.items())
        self._route_los = [lo for lo, _ in table]
        self._route_rids = [rid for _, rid in table]

    def range_of(self, key: str) -> int:
        """Ground-truth routing oracle (tests, preload).  Live clients use
        their own RangeTable cache + WRONG_RANGE redirects instead."""
        idx = bisect.bisect_right(self._route_los, key) - 1
        return self._route_rids[max(0, idx)]

    def on_range_table_changed(self) -> None:
        """Mirror registered range metadata into cluster ground truth and
        reconcile live nodes (create replicas they just joined — migration
        destinations, split children — retire ones they left).  Idempotent;
        invoked by replicas whenever they rewrite `/ranges/*` metadata."""
        rmap = ranges_mod.load_range_map(self.zk)
        if not rmap:
            return
        self.ranges = {rid: KeyRange(rid, lo, hi)
                       for rid, (lo, hi, _m) in rmap.items()}
        self.members = {rid: tuple(sorted(m))
                        for rid, (_lo, _hi, m) in rmap.items()}
        self._rebuild_routing()
        for node in self.nodes.values():
            if not node.up:
                continue   # down nodes reconcile at boot
            for rid, (_lo, _hi, members) in rmap.items():
                if node.node_id in members:
                    node.ensure_replica(rid)
                elif rid in node.replicas:
                    node.retire_replica(rid)

    # -- range administration (split / migrate / rebalance) --------------------
    def admin_split(self, rid: int, split_key: Optional[str] = None) -> bool:
        """Propose a live split of `rid` (at its median key by default)."""
        rep = self.leader_replica(rid)
        return rep.propose_split(split_key) if rep is not None else False

    def admin_move(self, rid: int, src: Optional[int] = None,
                   dst: Optional[int] = None) -> bool:
        """Migrate one replica of `rid` from `src` to `dst`.  Defaults:
        src = first follower member, dst = first up non-member node."""
        rep = self.leader_replica(rid)
        if rep is None:
            return False
        members = self.members.get(rid, ())
        if src is None:
            followers = [m for m in members if m != rep.node.node_id]
            src = followers[0] if followers else None
        if dst is None:
            cands = [i for i, node in sorted(self.nodes.items())
                     if node.up and i not in members]
            dst = cands[0] if cands else None
        if src is None or dst is None:
            return False
        return rep.start_migration(src, dst)

    def set_autobalance(self, on: bool,
                        cfg: Optional[BalancerConfig] = None) -> None:
        if on:
            if self.balancer is not None and cfg is not None \
                    and self.balancer.cfg is not cfg:
                self.balancer.stop()     # never leave two tickers running
                self.balancer = None
            if self.balancer is None:
                self.balancer = RangeBalancer(self, cfg)
            self.balancer.start()
        elif self.balancer is not None:
            self.balancer.stop()

    def start(self) -> None:
        self.obs.start()
        for node in self.nodes.values():
            node.boot()

    def settle(self, timeout: float = 30.0) -> None:
        """Drive the sim until every cohort has an open leader (test helper)."""
        deadline = self.sim.now + timeout
        while self.sim.now < deadline:
            if all(self.leader_replica(r) is not None
                   for r in list(self.ranges)):
                return
            before = self.sim.now
            self.sim.run(until=min(deadline, before + 0.05))
            if not self.sim._heap and self.sim.now >= deadline:
                break
        missing = [r for r in sorted(self.ranges)
                   if self.leader_replica(r) is None]
        if missing:
            raise RuntimeError(f"cohorts without open leader: {missing}")

    def leader_replica(self, rid: int):
        from .replica import Role
        for m in self.members.get(rid, ()):
            rep = self.nodes[m].replicas.get(rid)
            if rep is not None and rep.role is Role.LEADER \
                    and rep.open_for_writes and self.nodes[m].has_session():
                return rep
        return None

    # -- failure injection ------------------------------------------------------
    def crash_node(self, node_id: int, lose_disk: bool = False,
                   expire_session: bool = True) -> None:
        self.obs.events.emit("node_crash", node=node_id,
                             lose_disk=lose_disk)
        self.obs.journal.record("node_crash", node=node_id,
                                lose_disk=lose_disk)
        self.nodes[node_id].crash(lose_disk=lose_disk,
                                  expire_session=expire_session)

    def restart_node(self, node_id: int) -> None:
        self.obs.events.emit("node_restart", node=node_id)
        self.obs.journal.record("node_restart", node=node_id)
        self.nodes[node_id].restart()

    def partition(self, *groups) -> None:
        """Partition the data network into node groups, e.g.
        `cluster.partition({0, 1}, {2, 3, 4})`."""
        self.net.set_partition(groups)

    def partition_oneway(self, src_group, dst_group) -> None:
        """Asymmetric partition: messages src_group -> dst_group are cut,
        the reverse direction keeps flowing (gray failure)."""
        self.obs.events.emit("partition_oneway",
                             src=sorted(src_group), dst=sorted(dst_group))
        self.net.set_oneway_partition(src_group, dst_group)

    def set_link_fault(self, src: int, dst: int,
                       drop_p: Optional[float] = None,
                       dup_p: Optional[float] = None,
                       delay_factor: Optional[float] = None) -> None:
        """Degrade the directed data link src -> dst.  Merge semantics:
        only the aspects passed change, so drop + delay compose."""
        self.obs.events.emit("link_fault", src=src, dst=dst, drop_p=drop_p,
                             dup_p=dup_p, delay_factor=delay_factor)
        self.net.update_link_fault(src, dst, drop_p=drop_p, dup_p=dup_p,
                                   delay_factor=delay_factor)

    def slow_disk(self, node_id: int, factor: float) -> None:
        """Gray failure: the node's log device serves at `factor`x latency."""
        self.obs.events.emit("slow_disk", node=node_id, factor=factor)
        self.nodes[node_id].disk.slow_factor = factor

    def slow_cpu(self, node_id: int, factor: float) -> None:
        """Gray failure: the node's CPU serves at `factor`x service time."""
        self.obs.events.emit("slow_cpu", node=node_id, factor=factor)
        self.nodes[node_id].cpu.slow_factor = factor

    def flap_session(self, node_id: int, outage: float = 1.0) -> None:
        """Expire the node's ZK session while it keeps running; the client
        library reconnects after `outage` seconds."""
        self.obs.events.emit("session_flap", node=node_id, outage=outage)
        # a flapped node's ephemerals (leader claims, candidacies) vanish
        # with the session: any lease it believed in is protocol-moot, so
        # tell the watchdog not to hold it against a successor
        self.obs.journal.record("session_flap", node=node_id, outage=outage)
        self.nodes[node_id].flap_session(outage)

    def heal(self) -> None:
        """Clear EVERY injected network/gray fault: symmetric and one-way
        partitions, per-link drop/dup/delay, and disk/CPU slow factors.
        (Crashed nodes stay down — `restart` is a separate event.)"""
        self.net.clear_faults()
        for node in self.nodes.values():
            node.disk.slow_factor = 1.0
            node.cpu.slow_factor = 1.0

    def trace(self, msg: str) -> None:
        if self.cfg.trace:
            self.trace_log.append(msg)

    def make_client(self, client_id: str = "c0") -> "Client":
        return Client(self, client_id)


class Client:
    """Closed-loop client: routes ops to cohort leaders (strong) or round-
    robin replicas (timeline), retries on NOT_LEADER/UNAVAILABLE with
    capped exponential backoff, and re-routes on WRONG_RANGE redirects.

    Routing is dynamic: the range table is cached from the coordination
    metadata (`core/ranges.py`), invalidated by a data-change watch on the
    table version znode or by a WRONG_RANGE reply from a replica whose
    range no longer covers the key (live splits move keys between cohorts
    mid-flight)."""

    MAX_RETRIES = 60
    BACKOFF_BASE = 0.02      # first retry delay; doubles per retry ...
    BACKOFF_CAP = 1.0        # ... up to this cap (±50% jitter throughout)
    ATTEMPT_TIMEOUT = 1.0    # first attempt; scales with the retry count
    ATTEMPT_TIMEOUT_CAP = 8.0
    # client->node request envelope window: requests headed to the same
    # node within this window share one message (per-message wire cost paid
    # once).  0 = same-event only — ops issued simultaneously (e.g. the
    # convoy a coalesced reply envelope releases) batch for free, and no op
    # is ever delayed to wait for company.
    COALESCE_WINDOW = 0.0

    def __init__(self, cluster: SpinnakerCluster, client_id: str):
        self.cluster = cluster
        self.sim = cluster.sim
        self.id = client_id
        self.leader_cache: dict[int, int] = {}
        self.range_table = RangeTable(cluster.zk)
        self.wrong_range_redirects = 0
        self.mread_batches = 0       # multi_get fan-outs (one per range)
        self.txn2_issued = 0         # cross-range (2PC) transaction sends
        self.lock_retries = 0        # LOCKED replies (no-wait lock policy)
        self._rr = 0
        self.stats = LatencyStats()
        self.stats_by_kind: dict[str, LatencyStats] = {}
        self.errors = 0
        self._session_seen: dict[tuple[str, str], int] = {}
        # client-perceived robustness counters (chaos runs report these as
        # client-side unavailability evidence); mirrored into the obs
        # metrics registry under the client id
        self.retries = 0
        self.backoff_time = 0.0          # total seconds spent backing off
        self.attempt_timeouts = 0        # per-attempt timer expiries
        self.retry_exhausted = 0         # ops that gave up (TIMEOUT result)
        self.error_counts: dict[str, int] = {}   # non-OK reply codes seen
        # per-key retry gate: same-key writes that entered the retry path
        # re-send in issue order (see _schedule_retry)
        self._retry_gate: dict[str, dict] = {}
        self._retry_waiters: dict[str, deque] = {}
        # workload-driver hook: called once per finished op with
        # (kind, result); fires for successes AND retry-exhausted timeouts
        self.op_hook: Optional[Callable[[str, Result], None]] = None
        # workload adapters set this right before a call so the sampled
        # trace carries the workload's op label ("rmw", "txn_cross", ...)
        # instead of the client-internal path name; consumed per op
        self.next_trace_kind: Optional[str] = None
        # request envelopes: per-target staging (see COALESCE_WINDOW)
        self._req_buf: dict[int, list[tuple]] = {}
        self.req_envelopes = 0       # multi-request envelopes sent

    # -- routing -----------------------------------------------------------------
    def _retry_delay(self, tries: int) -> float:
        """Capped exponential backoff with jitter.  The old fixed 50 ms
        retry loop synchronized every blocked client into periodic bursts
        — past the saturation knee those bursts are what collapses
        throughput (congestion collapse); spreading and spacing retries
        keeps the overload tail flat."""
        exp = min(self.BACKOFF_CAP, self.BACKOFF_BASE * (2 ** tries))
        delay = exp * (0.5 + self.sim.rng.random())
        # every _retry_delay call schedules exactly one retry: count it here
        self.retries += 1
        self.backoff_time += delay
        self._count("client_retries")
        self._count("client_backoff_s", delay)
        return delay

    def _schedule_retry(self, kind: str, key: str, kw: dict, cb: Callable,
                        consistent: bool, t0: float, tries: int) -> None:
        """Re-schedule a failed attempt.  Same-key *writes* serialize
        through a per-key gate while in the retry path: pipelined writes
        that all bounced (redirect chasing a live split, leader failover)
        must be re-sent in issue order, or a later conditional put can
        overtake an earlier one and fail with a spurious VERSION_MISMATCH.
        First sends are never gated — the happy path pipelines freely."""
        delay = self._retry_delay(tries)
        if kind not in ("write", "txn"):
            self.sim.schedule(delay, self._op, kind, key, kw, cb,
                              consistent, t0, tries + 1)
            return
        owner = self._retry_gate.get(key)
        if owner is None or owner is kw:
            self._retry_gate[key] = kw
            self.sim.schedule(delay, self._op, kind, key, kw, cb,
                              consistent, t0, tries + 1)
        else:
            self._retry_waiters.setdefault(key, deque()).append(
                (delay, kind, kw, cb, consistent, t0, tries))

    def _gate_release(self, kind: str, key: str, kw: dict) -> None:
        """Terminal completion of a gated write: hand the gate to the next
        parked same-key retry (preserving issue order) or clear it."""
        if kind not in ("write", "txn") or self._retry_gate.get(key) is not kw:
            return
        q = self._retry_waiters.get(key)
        if not q:
            del self._retry_gate[key]
            self._retry_waiters.pop(key, None)
            return
        delay, nkind, nkw, ncb, nconsistent, nt0, ntries = q.popleft()
        if not q:
            del self._retry_waiters[key]
        self._retry_gate[key] = nkw
        self.sim.schedule(delay, self._op, nkind, key, nkw, ncb,
                          nconsistent, nt0, ntries + 1)

    def _attempt_timeout(self, tries: int) -> float:
        """Per-attempt timeout, scaled with the backoff schedule: the first
        attempt keeps the historical 1 s, retries wait longer — under a
        fault the op is probably queued behind recovery, and re-sending it
        on a short fuse just multiplies load on the healing cohort."""
        return min(self.ATTEMPT_TIMEOUT_CAP,
                   self.ATTEMPT_TIMEOUT * (2 ** min(tries, 3)))

    def _count(self, name: str, v: float = 1.0) -> None:
        self.cluster.obs.metrics.inc(self.id, name, v)

    def _note_reply(self, res: Optional[Result]) -> None:
        """Track non-OK replies (and lost attempts) per error code."""
        if res is None:
            code = "ATTEMPT_TIMEOUT"
            self.attempt_timeouts += 1
        elif res.ok:
            return
        else:
            code = getattr(res.code, "name", str(res.code))
        self.error_counts[code] = self.error_counts.get(code, 0) + 1
        self._count(f"client_err_{code}")

    def robustness_summary(self) -> dict:
        return {"retries": self.retries,
                "backoff_time_s": round(self.backoff_time, 6),
                "attempt_timeouts": self.attempt_timeouts,
                "retry_exhausted": self.retry_exhausted,
                "error_counts": dict(sorted(self.error_counts.items()))}

    def _lookup_leader(self, rid: int) -> Optional[int]:
        cached = self.leader_cache.get(rid)
        if cached is not None:
            return cached
        try:
            leader_id, _epoch = self.cluster.zk.get(f"/ranges/{rid}/leader")
            self.leader_cache[rid] = leader_id
            return leader_id
        except NoNode:
            return None

    def _any_replica(self, rid: int) -> Optional[int]:
        members = self.range_table.members(rid)
        if not members:
            return None
        self._rr += 1
        return members[self._rr % len(members)]

    # -- async API -----------------------------------------------------------------
    def get(self, key: str, colname: str, consistent: bool,
            cb: Callable[[Result], None], monotonic: bool = False) -> None:
        """`monotonic=True` adds the PNUTS-style session guarantee to
        timeline reads: this client never observes versions going
        backwards (stale replicas are retried)."""
        if monotonic and not consistent:
            inner = cb

            def cb(res, _key=(key, colname)):
                seen = self._session_seen.get(_key, -1)
                if res.ok and res.version is not None \
                        and res.version < seen:
                    self.get(key, colname, False, inner, monotonic=True)
                    return
                if res.ok and res.version is not None:
                    self._session_seen[_key] = max(seen, res.version)
                inner(res)

        self._op("read", key, dict(key=key, colname=colname,
                                   consistent=consistent), cb,
                 consistent=consistent, t0=self.sim.now, tries=0)

    def put(self, key: str, colname: str, value: Any,
            cb: Callable[[Result], None]) -> None:
        op = WriteOp(OpType.PUT, key, colname, value)
        self._op("write", key, dict(op=op), cb, consistent=True,
                 t0=self.sim.now, tries=0)

    def delete(self, key: str, colname: str, cb: Callable) -> None:
        op = WriteOp(OpType.DELETE, key, colname)
        self._op("write", key, dict(op=op), cb, consistent=True,
                 t0=self.sim.now, tries=0)

    def conditional_put(self, key: str, colname: str, value: Any, version: int,
                        cb: Callable) -> None:
        op = WriteOp(OpType.COND_PUT, key, colname, value,
                     expected_version=version)
        self._op("write", key, dict(op=op), cb, consistent=True,
                 t0=self.sim.now, tries=0)

    def conditional_delete(self, key: str, colname: str, version: int,
                           cb: Callable) -> None:
        op = WriteOp(OpType.COND_DELETE, key, colname,
                     expected_version=version)
        self._op("write", key, dict(op=op), cb, consistent=True,
                 t0=self.sim.now, tries=0)

    def multi_put(self, key: str, columns: list[tuple[str, Any]],
                  cb: Callable) -> None:
        op = WriteOp(OpType.MULTI_PUT, key, columns=tuple(columns))
        self._op("write", key, dict(op=op), cb, consistent=True,
                 t0=self.sim.now, tries=0)

    def multi_get(self, pairs: list[tuple[str, str]], consistent: bool,
                  cb: Callable[[list[Result]], None],
                  monotonic: bool = False) -> None:
        """Range-aware batched read: keys are grouped by the cached range
        table and each group goes out as ONE `mread` message to its
        cohort (leader for strong, round-robin replica for timeline) —
        the fan-out is per *range*, not per key, so both the client and
        the server pay one message overhead per cohort.  Per-key
        WRONG_RANGE redirects re-group just the moved keys; group-level
        failures (leader change, timeout) retry the whole group."""
        if not pairs:
            cb([])
            return
        results: list[Optional[Result]] = [None] * len(pairs)
        pending = [len(pairs)]
        t0 = self.sim.now

        def settle(i: int, res: Result, record: bool) -> None:
            if record:
                res.latency = self.sim.now - t0
                if res.code != ErrorCode.TIMEOUT:
                    # retry-exhausted timeouts are reported (op_hook,
                    # errors) but kept out of the latency population,
                    # matching the single-op path
                    self.stats.add(res.latency)
                    self.stats_by_kind.setdefault(
                        "read", LatencyStats()).add(res.latency)
                if self.op_hook is not None:
                    self.op_hook("read", res)
            results[i] = res
            pending[0] -= 1
            if pending[0] == 0:
                cb(results)  # type: ignore[arg-type]

        def deliver(i: int, res: Result) -> None:
            key, colname = pairs[i]
            if monotonic and not consistent and res.ok \
                    and res.version is not None:
                seen = self._session_seen.get((key, colname), -1)
                if res.version < seen:
                    # stale replica: fall back to the single-get retry path
                    # (it records its own stats)
                    self.get(key, colname, False,
                             lambda r, _i=i: settle(_i, r, False),
                             monotonic=True)
                    return
                self._session_seen[(key, colname)] = max(seen, res.version)
            settle(i, res, True)

        self._mread([(i, k, c) for i, (k, c) in enumerate(pairs)],
                    consistent, deliver, tries=0)

    # per-key retryable mread results (reads never bounce on locks —
    # strong reads of locked keys defer server-side instead)
    _RETRY_CODES = (ErrorCode.NOT_LEADER, ErrorCode.UNAVAILABLE,
                    ErrorCode.WRONG_RANGE, ErrorCode.OVERLOADED)

    def _mread(self, items: list[tuple[int, str, str]], consistent: bool,
               deliver: Callable, tries: int) -> None:
        """Group `items` ((idx, key, colname)) by range and issue one
        batched read per group; re-invoked with the residue on retries."""
        if tries > self.MAX_RETRIES:
            for i, _k, _c in items:
                self.errors += 1
                self.retry_exhausted += 1
                self._count("client_retry_exhausted")
                deliver(i, Result(ErrorCode.TIMEOUT))
            return
        groups: dict[int, list[tuple[int, str, str]]] = {}
        stale: list[tuple[int, str, str]] = []
        for it in items:
            rid = self.range_table.lookup(it[1])
            if rid is None:
                stale.append(it)
            else:
                groups.setdefault(rid, []).append(it)
        if stale:
            self.range_table.invalidate()
            self.sim.schedule(self._retry_delay(tries), self._mread, stale,
                              consistent, deliver, tries + 1)
        for rid, its in groups.items():
            self._mread_group(rid, its, consistent, deliver, tries)

    def _mread_group(self, rid: int, items: list[tuple[int, str, str]],
                     consistent: bool, deliver: Callable,
                     tries: int) -> None:
        target = self._lookup_leader(rid) if consistent \
            else self._any_replica(rid)
        if target is None:
            self.sim.schedule(self._retry_delay(tries), self._mread, items,
                              consistent, deliver, tries + 1)
            return
        self.mread_batches += 1
        settled = [False]

        def retry(residue: list, saw_wrong_range: bool,
                  leader_hint: Optional[int]) -> None:
            self.leader_cache.pop(rid, None)
            if saw_wrong_range:
                self.wrong_range_redirects += 1
                self.range_table.invalidate()
            if leader_hint is not None:
                self.leader_cache[rid] = leader_hint
            self.sim.schedule(self._retry_delay(tries), self._mread, residue,
                              consistent, deliver, tries + 1)

        def on_reply(res) -> None:
            if settled[0]:
                return
            settled[0] = True
            timeout_ev.cancel()
            if isinstance(res, Result):
                self._note_reply(res)
            if res is None or isinstance(res, Result):
                # whole-group gate failure (or dead target): retry all
                wrong = res is not None and res.code == ErrorCode.WRONG_RANGE
                hint = res.leader_hint if res is not None \
                    and res.code == ErrorCode.NOT_LEADER else None
                retry(items, wrong, hint)
                return
            redo: list[tuple[int, str, str]] = []
            wrong = False
            for it, r in zip(items, res):
                if r.code in self._RETRY_CODES:
                    redo.append(it)
                    wrong = wrong or r.code == ErrorCode.WRONG_RANGE
                else:
                    deliver(it[0], r)
            if redo:
                retry(redo, wrong, None)

        def on_timeout() -> None:
            if settled[0]:
                return
            settled[0] = True
            self._note_reply(None)
            retry(items, False, None)

        timeout_ev = self.sim.schedule(self._attempt_timeout(tries),
                                       on_timeout)
        payload = dict(pairs=[(k, c) for _i, k, c in items],
                       consistent=consistent,
                       reply=self._reply_via_net(target, on_reply))
        self._send_req(target, rid, "mread", payload,
                       200 + 64 * len(items), "client.read")

    def transaction(self, ops: list[WriteOp], cb: Callable) -> None:
        """Multi-operation transaction.  Single-cohort op sets keep the
        paper's §8.2 fast path untouched (one Paxos round, no locks, no
        2PC); op sets spanning ranges are partitioned via the cached
        range table and run through the Paxos-backed 2PC coordinator
        (core/txn.py) — the leader of the first op's range coordinates.
        Groups are recomputed on every retry so WRONG_RANGE redirects
        chase live splits."""
        if not ops:
            cb(Result(ErrorCode.OK))
            return
        self._op("txn", ops[0].key, dict(ops=ops), cb, consistent=True,
                 t0=self.sim.now, tries=0)

    # -- engine --------------------------------------------------------------------
    def _op(self, kind: str, key: str, kw: dict, cb: Callable,
            consistent: bool, t0: float, tries: int) -> None:
        if tries == 0:
            # sampled trace rides `kw` across retries ("_trace" never goes
            # on the wire; each attempt forwards it as payload["trace"])
            hint, self.next_trace_kind = self.next_trace_kind, None
            tr = self.cluster.obs.tracer.maybe_start(hint or kind, kind, key)
            if tr is not None:
                kw["_trace"] = tr
        if tries > self.MAX_RETRIES:
            self.errors += 1
            self.retry_exhausted += 1
            self._count("client_retry_exhausted")
            self._gate_release(kind, key, kw)
            tr = kw.pop("_trace", None)
            if tr is not None:
                self.cluster.obs.tracer.finish(tr, False, "timeout")
            res = Result(ErrorCode.TIMEOUT, latency=self.sim.now - t0,
                         attempts=tries)
            if self.op_hook is not None:
                self.op_hook(kind, res)
            cb(res)
            return
        rid = self.range_table.lookup(key)
        wire_kind, payload_kw = kind, kw
        if kind == "txn" and rid is not None:
            # partition the op set by range — recomputed per attempt so
            # redirects chase live splits.  One range: §8.2 fast path.
            # Several: 2PC via the first range's leader (core/txn.py).
            groups: dict[int, list[WriteOp]] = {}
            for op in kw["ops"]:
                r = self.range_table.lookup(op.key)
                if r is None:
                    rid = None
                    break
                groups.setdefault(r, []).append(op)
            if rid is not None and len(groups) > 1:
                wire_kind = "txn2"
                payload_kw = dict(groups=groups)
                self.txn2_issued += 1
        if kind == "read" and not consistent:
            target = self._any_replica(rid) if rid is not None else None
        else:
            target = self._lookup_leader(rid) if rid is not None else None
        if target is None:
            if rid is None:
                self.range_table.invalidate()
            self._schedule_retry(kind, key, kw, cb, consistent, t0, tries)
            return

        settled = [False]

        def retry(res: Optional[Result]):
            self.leader_cache.pop(rid, None)
            if res is not None and res.code == ErrorCode.WRONG_RANGE:
                # the range table moved under us (live split / migration):
                # reload it before re-routing
                self.wrong_range_redirects += 1
                self.range_table.invalidate()
            if res is not None and res.leader_hint is not None \
                    and res.code == ErrorCode.NOT_LEADER:
                self.leader_cache[rid] = res.leader_hint
            self._schedule_retry(kind, key, kw, cb, consistent, t0, tries)

        def on_reply(res: Optional[Result]):
            if settled[0]:
                return
            settled[0] = True
            timeout_ev.cancel()
            self._note_reply(res)
            if res is not None and res.code == ErrorCode.LOCKED:
                self.lock_retries += 1
            if res is None or res.code in (ErrorCode.NOT_LEADER,
                                           ErrorCode.UNAVAILABLE,
                                           ErrorCode.WRONG_RANGE,
                                           ErrorCode.LOCKED,
                                           ErrorCode.OVERLOADED):
                retry(res)
                return
            self._gate_release(kind, key, kw)
            res.latency = self.sim.now - t0
            res.attempts = tries + 1
            tr = kw.pop("_trace", None)
            if tr is not None:
                self.cluster.obs.tracer.finish(
                    tr, res.ok, getattr(res.code, "name", str(res.code)))
            self.stats.add(res.latency)
            self.stats_by_kind.setdefault(kind, LatencyStats()).add(
                res.latency)
            if self.op_hook is not None:
                self.op_hook(kind, res)
            cb(res)

        def on_timeout():
            if settled[0]:
                return
            settled[0] = True
            self._note_reply(None)
            retry(None)

        timeout_ev = self.sim.schedule(self._attempt_timeout(tries),
                                       on_timeout)

        payload = dict(payload_kw)
        payload.pop("_trace", None)
        tr = kw.get("_trace")
        if tr is not None:
            tr.attempts += 1
            tr.t_send = self.sim.now
            payload["trace"] = tr
        payload["reply"] = self._reply_via_net(target, on_reply)
        nbytes = 4200 if kind in ("write", "txn") else 300
        comp = "client.write" if kind in ("write", "txn") else "client.read"
        self._send_req(target, rid, wire_kind, payload, nbytes, comp)

    # -- request/reply envelopes (client <-> node edge) ---------------------------
    def _send_req(self, target: int, rid: int, wire_kind: str, payload: dict,
                  nbytes: int, comp: str) -> None:
        """Stage a request for `target`; everything staged within the
        coalescing window leaves as one envelope."""
        buf = self._req_buf.get(target)
        if buf is None:
            buf = self._req_buf[target] = []
            self.sim.schedule(self.COALESCE_WINDOW, self._flush_reqs, target)
        buf.append((rid, wire_kind, payload, nbytes, comp))

    def _flush_reqs(self, target: int) -> None:
        batch = self._req_buf.pop(target, None)
        if not batch:
            return
        node = self.cluster.nodes[target]
        if len(batch) == 1:
            rid, kind, payload, nbytes, comp = batch[0]
            self.cluster.net.send(self.id, target, node.handle_client, rid,
                                  kind, payload, nbytes=nbytes,
                                  cross_switch=True, component=comp, rid=rid)
            return
        self.req_envelopes += 1
        self._count("client_req_envelopes")
        items = [(rid, kind, payload) for rid, kind, payload, _n, _c in batch]
        self.cluster.net.send(self.id, target, node.handle_client_batch,
                              items,
                              nbytes=sum(n for *_h, n, _c in batch),
                              cross_switch=True, component=batch[0][4],
                              rid=batch[0][0])

    def _reply_via_net(self, src_node: int, cb: Callable) -> Callable:
        """Build the server-side reply hook: replies route through the
        node's per-client reply envelope (node.client_reply), so acks and
        read results minted in one event share one message back."""
        node = self.cluster.nodes[src_node]

        def reply(res):
            if isinstance(res, list):   # batched mread reply
                nbytes = 200 + sum(
                    4200 if r is not None and r.value is not None else 64
                    for r in res)
            else:
                nbytes = 4200 if res is not None and res.value is not None \
                    else 200
            node.client_reply(self.id, cb, res, nbytes)
        return reply

    # -- synchronous helpers for tests ------------------------------------------------
    def sync(self, fn: Callable, *args) -> Result:
        box: list[Result] = []
        fn(*args, lambda r: box.append(r))
        guard = 0
        while not box and guard < 2_000_000:
            if not self.sim.step():
                break
            guard += 1
        if not box:
            raise RuntimeError("op did not complete")
        return box[0]

    def sync_put(self, key: str, colname: str, value: Any) -> Result:
        return self.sync(self.put, key, colname, value)

    def sync_get(self, key: str, colname: str, consistent: bool = True) -> Result:
        return self.sync(self.get, key, colname, consistent)

    def sync_cond_put(self, key: str, colname: str, value: Any,
                      version: int) -> Result:
        return self.sync(self.conditional_put, key, colname, value, version)

    def sync_delete(self, key: str, colname: str) -> Result:
        return self.sync(self.delete, key, colname)
