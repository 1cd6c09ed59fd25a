"""Per-cohort Paxos replica state machine (§5 replication, §6 recovery,
§7 leader election).

One `CohortReplica` instance exists per (node, key-range).  The node wires
replicas to its shared WAL, CPU server, network, and coordination session.

Protocol summary (steady state, Fig. 4):
  client write -> leader: assign LSN (epoch.seq) + versions, append to the
  cohort's *batch accumulator*; the batch flushes (immediately when the
  CPU is idle, else on a record-count/byte/deadline trigger) as ONE
  multi-record PROPOSE per in-sync follower ∥ one WAL force covering the
  whole batch; followers force the batch once and reply with a single
  *cumulative* ACK (their durability watermark, superseding all lower
  acks); the leader commits once 2 of 3 logs hold a record (its own force
  counts), applies to memtable, replies to clients.  A periodic async
  COMMIT message advances followers (the *commit period*, skipped while
  cmt is idle); commit LSNs are persisted with non-forced log writes.

  Batching is the paper's "leader batches writes" lever (§5, §C): it
  amortises per-message CPU and per-force disk cost, which is what moves
  the §C saturation knee.  With `batch="off"` every record flushes alone
  and the wire protocol degenerates to the per-operation original.

Recovery (Fig. 5/6, App. B): follower local recovery replays (flushed,
f.cmt], catch-up pulls committed writes (f.cmt, l.cmt] from the leader
(log- or SSTable-sourced), the window (f.cmt, f.lst] is *logically
truncated* via skipped-LSN lists; leader takeover re-proposes
(l.cmt, l.lst] under a fresh epoch before reopening for writes.

Election (Fig. 7): candidates advertise last-LSN in ephemeral sequential
znodes; with a majority present the max-LSN candidate claims /leader
atomically.  Entries are stamped with the election *round* (the epoch
counter) so stale candidacies from earlier rounds are never counted —
this closes the stale-lst race the paper waves off as "certain race
conditions ignored".
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional, TYPE_CHECKING

from . import ranges as ranges_mod
from .coordination import NodeExists, NoNode
from .storage import Store
from .txn import TxnManager
from .types import (CommitMarker, ErrorCode, KeyRange, LogRecord, OpType,
                    Result, TXN_OPS, WriteOp, fmt_lsn, lsn_epoch, lsn_seq,
                    make_lsn)
from ..obs.journal import record_digest

if TYPE_CHECKING:
    from .node import SpinnakerNode


class Role(enum.Enum):
    OFFLINE = "offline"
    ELECTING = "electing"
    CATCHUP = "catchup"          # follower pulling missed writes
    FOLLOWER = "follower"
    TAKEOVER = "takeover"        # leader-elect running Fig. 6
    LEADER = "leader"


@dataclass
class ReplicaConfig:
    commit_period: float = 1.0          # §D.1 default
    # §D.1: piggy-back the commit LSN on proposal batches.  On by default
    # since the §9 write-path campaign: while writes flow, followers learn
    # commit from the piggybacked watermark and the periodic on_commit
    # broadcast is suppressed (commit markers stop paying their own
    # message); idle ranges keep the slow keepalive rebroadcast.
    piggyback_commit: bool = True
    flush_threshold: int = 4 << 20
    # -- leader-side proposal batching -------------------------------------
    # "adaptive": a write flushes immediately while the node's CPU queue is
    # empty (light load keeps per-op latency), and accumulates under queuing
    # until a record-count/byte/deadline trigger fires — so batch size grows
    # exactly when the per-message costs start to dominate.  "off": flush
    # after every record (the strictly per-operation protocol).
    batch: str = "adaptive"             # "adaptive" | "off"
    batch_max_records: int = 32
    batch_max_bytes: int = 256 << 10
    batch_deadline: float = 0.5e-3      # max extra latency bought for batching
    # -- cross-range 2PC (core/txn.py) -------------------------------------
    txn_prepare_timeout: float = 0.5    # coordinator aborts stuck prepares
    txn_tick: float = 0.15              # resolution/resend/re-vote period
    # -- partition-aware leader leases (§7; Keyspace-style master leases) ---
    # A leader only serves strong reads/writes while it holds a time-bounded
    # lease renewed through follower acks (renewal quorum = commit quorum).
    # The lease window is anchored at the renewal's SEND time minus the
    # maximum simulated clock skew, so a deposed leader's lease provably
    # expires before the majority side elects a successor: followers wait
    # `lease_duration + 4*max_clock_skew` of leader silence before deleting
    # the leader znode (deposal needs fresh majority connectivity so a lone
    # partitioned follower cannot disrupt a healthy cohort).  A leader whose
    # lease lapses abdicates, fences writes, and suppresses its own
    # candidacy until it re-establishes data-network majority contact —
    # without this, the minority-partitioned ex-leader (max lst, ZK always
    # reachable) would win every re-election and stall the range forever.
    lease_enabled: bool = True
    lease_duration: float = 1.0
    max_clock_skew: float = 0.05
    # -- mutation corpus (test-only switches; never enable in production
    # configs).  Each one deliberately reintroduces a known-fixed protocol
    # bug so the invariant watchdog (obs/watchdog.py) can be validated to
    # pinpoint it at the violating transition — see chaos/mutations.py.
    bug_catchup_starvation: bool = False   # pace catch-up retries off the
                                           # lease-heartbeat clock again
    bug_takeover_wedge: bool = False       # skip the WAL reload of the
                                           # unresolved window at takeover
    bug_ack_before_force: bool = False     # follower acks a proposal at
                                           # receive time, before its force
    drop_first_catchup: bool = False       # fault hook: swallow the first
                                           # catch-up data delivery


class CohortReplica:
    def __init__(self, node: "SpinnakerNode", key_range: KeyRange,
                 peers: tuple[int, ...], cfg: ReplicaConfig):
        self.node = node
        self.range = key_range                 # narrows on live splits
        self.rid = key_range.range_id
        self.peers = tuple(sorted(peers))      # other member node ids
        self.cfg = cfg
        self.store = Store(flush_threshold_bytes=cfg.flush_threshold)

        self.role = Role.OFFLINE
        self.epoch = 0
        self.leader_id: Optional[int] = None

        # log positions
        self.cmt = 0           # last committed LSN known locally
        self.lst = 0           # last LSN in local log
        self.forced_upto = 0   # leader: own contiguous durable LSN
        self._next_seq = 1

        # leader-side state
        self.queue: dict[int, LogRecord] = {}           # pending (uncommitted)
        self.acked: dict[int, int] = {}                 # follower -> max acked LSN
        self.insync: set[int] = set()
        self.open_for_writes = False
        self.pending_reply: dict[int, Callable] = {}
        self.blocked_writes: list[tuple[WriteOp, Callable]] = []
        self.proposed_version: dict[tuple[str, str], int] = {}
        self._commit_timer = None
        self._takeover_hi = 0    # l.lst at takeover; writes open when cmt >= this
        self._election_round = 0
        self._last_commit_bcast = -1   # cmt at the last on_commit broadcast
        self._piggy_sent = -1    # highest cmt piggybacked to ALL insync
        # range management (core/ranges.py): a proposed-but-unapplied SPLIT
        # gates writes above the split point; one member change in flight max
        self.pending_split: Optional[tuple[str, int]] = None  # (key, child rid)
        self._pending_member_change = False
        self._watched_peers: set[int] = set()
        # cross-range 2PC state machine (lock table, prepared set,
        # coordinator role) — core/txn.py
        self.txn = TxnManager(self)

        # leader-side batch accumulator (records queued + WAL-buffered but
        # not yet covered by a force / proposed to followers)
        self._batch: list[LogRecord] = []
        self._batch_bytes = 0
        self._batch_timer = None

        # follower-side
        self._announced_leader_epoch = 0

        # -- leader leases + connectivity probes (cfg.lease_enabled) -------
        self._lease_until = 0.0          # leader: lease valid through here
        self._lease_seq = 0              # renewal round counter
        self._lease_sent: dict[int, float] = {}      # seq -> send time
        self._lease_acks: dict[int, set[int]] = {}   # seq -> acked peers
        self._lease_timer = None
        self._guard_timer = None
        self._leader_seen = 0.0          # follower: last leader contact
        self._catchup_seen = 0.0         # CATCHUP: last data-path progress
                                         # (lease heartbeats keep
                                         # _leader_seen fresh, so the
                                         # catch-up retry must pace off its
                                         # own clock or it never fires)
        self._peer_seen: dict[int, float] = {}       # peer -> last pong/ping
        self._suppressed = False         # barred from candidacy until
                                         # majority data-net contact returns
        self._rc_seq = 0                 # read-confirm (read-index) rounds
        self._rc_waiting: list[Callable] = []
        self._rc_acks: set[int] = set()
        self._rc_inflight = False

        # stats
        self.commits = 0
        self.writes_served = 0
        self.reads_served = 0
        self.batches_flushed = 0       # leader: batch forces issued
        self.batched_records = 0       # leader: records covered by them
        self.acks_sent = 0             # follower: cumulative acks sent

        # observability: sampled traces of admitted-but-uncommitted writes,
        # keyed by LSN (leader side only; never serialized into records)
        self._trace_by_lsn: dict[int, object] = {}

    # ------------------------------------------------------------------ utils
    @property
    def zk(self):
        return self.node.zk

    @property
    def base(self) -> str:
        return f"/ranges/{self.rid}"

    def _send(self, dst: int, handler: str, nbytes: int = 256, **kw) -> None:
        self.node.send(dst, self.rid, handler, nbytes=nbytes, **kw)

    def _send_batched(self, dst: int, handler: str, nbytes: int = 256,
                      **kw) -> None:
        """Hot-path variant of `_send`: same-event messages to one peer
        node share a wire envelope (node.send_batched).  With many ranges
        per node an ingress drain flushes several replicas at once — their
        proposes (and the acks coming back) ride one message per peer."""
        self.node.send_batched(dst, self.rid, handler, nbytes=nbytes, **kw)

    def log(self, msg: str) -> None:
        self.node.cluster.trace(
            f"[{self.node.sim.now*1e3:9.2f}ms n{self.node.node_id} r{self.rid} "
            f"{self.role.value:9s} e{self.epoch}] {msg}")

    @property
    def obs(self):
        return self.node.cluster.obs

    def _minc(self, name: str, v: float = 1.0) -> None:
        self.obs.metrics.inc(self.node.node_id, name, v)

    def _heat(self, nbytes: int = 0) -> None:
        """Bump this range's heat (served ops + payload bytes) in the
        cluster-global profiler — the balancer's load signal."""
        prof = self.obs.profiler
        if prof.enabled:
            prof.range_op(self.rid, nbytes)

    def _jrec(self, kind: str, **fields) -> None:
        """Record a protocol transition in the flight-recorder journal
        (obs/journal.py) — pure measurement, zero modeled cost."""
        jr = self.obs.journal
        if jr.enabled:
            jr.record(kind, node=self.node.node_id, rid=self.rid, **fields)

    # ============================================================== lifecycle
    def start(self) -> None:
        """Called after the node's local recovery pass for this range."""
        records, cmt = self.node.wal.recover_range(self.rid)
        # lst floor: records below the SSTable-flush watermark were GC'd
        # from the log (and a forked child's whole prefix lives only in its
        # fork SSTable), so the durable position is at least that watermark
        self.lst = max(max((r.lsn for r in records), default=0),
                       self.node.wal.flushed_upto.get(self.rid, 0))
        self.cmt = min(cmt, self.lst)
        # local recovery: re-apply (flushed, f.cmt] idempotently (§6.1)
        for r in records:
            if self.store.flushed_upto < r.lsn <= self.cmt:
                self.store.apply(r)
        # rebuild 2PC state (prepared txns + locks, logged decisions) from
        # the same scan — a leader promoted after this restart inherits
        # them from the log, not from anyone's memory
        self.txn.reset()
        self.txn.recover(records, self.cmt, self.store.flushed_upto)
        # drop cells outside our range: a SPLIT applied in a prior life
        # detached them, but replaying the shared log re-admits them
        self.store.restrict(self.range.lo, self.range.hi)
        self.queue = {r.lsn: r for r in records if r.lsn > self.cmt}
        self._follower_forced = self.lst   # durable log scanned
        self._reset_batch()
        self.pending_reply.clear()
        self._trace_by_lsn.clear()
        self.acked = {p: 0 for p in self.peers}
        self.insync.clear()
        self.open_for_writes = False
        self.proposed_version.clear()
        self.pending_split = None
        self._pending_member_change = False
        self._suppressed = False     # fresh boots re-join without evidence
        self._leader_seen = self.node.sim.now
        self.role = Role.ELECTING
        self._arm_guard_timer()
        # Stagger the boot-time join by the node's chained-declustering
        # distance from the range's home node.  Cold elections tie on
        # lst=0 and fall to the candidacy-znode sequence, which otherwise
        # always crowns the second-lowest member id — clumping every base
        # range's leadership onto the same few nodes.  A microsecond-scale
        # rotation-ordered stagger makes the winner rotate with the range
        # id instead, spreading leadership round-robin.  Re-elections are
        # unaffected: real lst gaps dominate the tie-break, and the delay
        # is invisible next to the session timeout.
        n = self.node.cluster.cfg.n_nodes
        stagger = ((self.node.node_id - self.rid) % n) * 1e-6
        if stagger > 0.0:
            self.node.sim.schedule(stagger, self._staggered_join)
        else:
            self._join_or_elect()

    def _staggered_join(self) -> None:
        if self.role is Role.ELECTING:
            self._join_or_elect()

    def stop(self) -> None:
        self.role = Role.OFFLINE
        if self._commit_timer is not None:
            self._commit_timer.cancel()
            self._commit_timer = None
        if self._lease_timer is not None:
            self._lease_timer.cancel()
            self._lease_timer = None
        if self._guard_timer is not None:
            self._guard_timer.cancel()
            self._guard_timer = None
        self._lease_until = 0.0
        self._lease_sent.clear()
        self._lease_acks.clear()
        self._fail_read_confirms()
        self._reset_batch()
        self.txn.stop()

    def _reset_batch(self) -> None:
        """Drop the accumulated (not yet proposed) batch.  The records stay
        in `queue`/`pending_reply`/the WAL buffer; regime-change paths
        (`_drop_uncommitted_tail`, crash volatility) settle their fate."""
        self._batch = []
        self._batch_bytes = 0
        if self._batch_timer is not None:
            self._batch_timer.cancel()
            self._batch_timer = None

    # ======================================================== election (§7.2)
    def _join_or_elect(self) -> None:
        if self.role == Role.OFFLINE:
            return
        leader_path = f"{self.base}/leader"
        if self.zk.exists(leader_path):
            leader_id, epoch = self.zk.get(leader_path)
            if leader_id == self.node.node_id:
                # our own stale leader znode (crash + restart faster than
                # session expiry): drop it and start over
                try:
                    self.zk.delete(leader_path)
                except NoNode:
                    pass
                self._join_or_elect()
                return
            self._become_joining_follower(leader_id, epoch)
            return
        self._run_election()

    def _current_round(self) -> int:
        try:
            return self.zk.get(f"{self.base}/epoch")
        except NoNode:
            return 0

    def _majority(self) -> int:
        """Cohort majority; cohorts are briefly 4-wide mid-migration (add
        before remove), where majorities of the old and new member sets
        always intersect — that is what makes single-change
        reconfiguration safe."""
        return (len(self.peers) + 1) // 2 + 1

    def _refresh_membership(self) -> bool:
        """Adopt the registered member set before electing: a replica that
        slept through a MEMBER_CHANGE must not vote under a stale cohort
        (or at all, if it was retired).  Returns False when this replica
        deregistered itself."""
        meta = ranges_mod.get_range_meta(self.zk, self.rid)
        if meta is None:
            return True
        _lo, _hi, members = meta
        me = self.node.node_id
        if me not in members:
            self.log("not in registered member set; deregistering")
            self.node.retire_replica(self.rid)
            return False
        self.peers = tuple(sorted(m for m in members if m != me))
        return True

    def _run_election(self) -> None:
        if self.role == Role.OFFLINE:
            return
        if not self._refresh_membership():
            return
        if self._suppressed and self.cfg.lease_enabled:
            # fenced ex-leader: ZK is reachable (coordination sits outside
            # the data network) and our lst is maximal, so we would win —
            # and stall the range again.  Probe the data network instead;
            # candidacy resumes once a majority answers.
            self.role = Role.ELECTING
            self._probe_connectivity()
            return
        self._minc("elections_started")
        self.role = Role.ELECTING
        self._election_round = self._current_round()
        # Fig. 7 line 1: clean up old state — our prior candidacies and
        # anything stamped with an older round
        for name, (data, _) in self.zk.get_children(f"{self.base}/candidates").items():
            node_id, _lst, rnd = data
            if node_id == self.node.node_id or rnd < self._election_round:
                try:
                    self.zk.delete(f"{self.base}/candidates/{name}")
                except NoNode:
                    pass
        # line 4: advertise our last LSN in an ephemeral sequential znode
        self.zk.create(f"{self.base}/candidates/c",
                       data=(self.node.node_id, self.lst, self._election_round),
                       ephemeral_session=self.node.session,
                       sequential=True)
        self._jrec("elect_start", epoch=self.epoch,
                   round=self._election_round, lst=self.lst)
        self._evaluate_election()

    def _evaluate_election(self, _path: str = "") -> None:
        if self.role is not Role.ELECTING or not self.node.has_session():
            return
        leader_path = f"{self.base}/leader"
        if self.zk.exists(leader_path):
            leader_id, epoch = self.zk.get(leader_path)
            if leader_id != self.node.node_id:
                self._become_joining_follower(leader_id, epoch)
            return
        if self._current_round() != self._election_round:
            # a takeover happened and that leader died already; restart with
            # a fresh candidacy so our advertised lst is current
            self._run_election()
            return
        cands = {n: d for n, (d, cz) in
                 self.zk.get_children(f"{self.base}/candidates").items()
                 if d[2] == self._election_round}
        czxids = {n: cz for n, (d, cz) in
                  self.zk.get_children(f"{self.base}/candidates").items()}
        # lines 5-6: wait for a majority; winner = max n.lst, znode sequence
        # number breaks ties
        if len(cands) < self._majority():
            self.zk.watch_children(f"{self.base}/candidates",
                                   self._evaluate_election)
            return
        winner_name = max(cands, key=lambda n: (cands[n][1], czxids[n]))
        winner_node = cands[winner_name][0]
        if winner_node == self.node.node_id:
            # lines 7-8: atomically claim leadership under a fresh epoch
            new_epoch = self.zk.fetch_and_add(f"{self.base}/epoch", 1, initial=0)
            try:
                self.zk.create(f"{self.base}/leader",
                               data=(self.node.node_id, new_epoch),
                               ephemeral_session=self.node.session)
            except NodeExists:
                leader_id, epoch = self.zk.get(f"{self.base}/leader")
                if leader_id != self.node.node_id:
                    self._become_joining_follower(leader_id, epoch)
                return
            self._jrec("elect_decide", epoch=new_epoch,
                       round=self._election_round,
                       candidates=sorted(d[0] for d in cands.values()),
                       winner=winner_node,
                       winner_lst=cands[winner_name][1],
                       max_lst=max(d[1] for d in cands.values()),
                       n_cohort=len(self.peers) + 1)
            self._start_takeover(new_epoch)
        else:
            # line 11 + liveness: watch for the winner's claim, and for
            # candidate churn (the winner may die before claiming)
            self.zk.watch_children(f"{self.base}/candidates",
                                   self._evaluate_election)
            self.zk.watch_exists(f"{self.base}/leader",
                                 self._evaluate_election)

    def _watch_leader_liveness(self) -> None:
        """Re-elect when the leader's ephemeral znode disappears."""
        leader_path = f"{self.base}/leader"

        def on_change(_p):
            if self.role in (Role.OFFLINE, Role.LEADER, Role.TAKEOVER):
                return
            if not self.zk.exists(leader_path):
                self.log("leader znode gone; (re)electing")
                self._run_election()
            else:
                lid, ep = self.zk.get(leader_path)
                if lid != self.node.node_id and ep > self.epoch:
                    self._become_joining_follower(lid, ep)
                else:
                    self.zk.watch_exists(leader_path, on_change)

        self.zk.watch_exists(leader_path, on_change)

    # ===================================================== leader takeover
    def _start_takeover(self, new_epoch: int) -> None:
        """Fig. 6.  We hold the leader znode; re-commit the unresolved
        window, then open for writes under `new_epoch`."""
        self.epoch = new_epoch
        self.leader_id = self.node.node_id
        self.role = Role.TAKEOVER
        self.open_for_writes = False
        self.insync.clear()
        self.acked = {p: 0 for p in self.peers}
        # the unresolved window (l.cmt, l.lst] is already in self.queue
        # (rebuilt from the durable log in start(), or live from before) —
        # EXCEPT when this election was reached out of a CATCHUP that
        # dropped the volatile tail (an aborted join under a leader that
        # never sent catch-up data, e.g. one-way-partitioned away): the
        # durable, never-truncated copies are still ours to re-commit
        if not self.cfg.bug_takeover_wedge and self.lst > self.cmt \
                and not all(l in self.queue
                            for l in range(self.cmt + 1, self.lst + 1)):
            for rec in (self.node.wal.records_between(
                    self.rid, self.cmt, self.lst) or []):
                self.queue.setdefault(rec.lsn, rec)
            # anything still missing was logically truncated (a superseded
            # tail): don't force peers past what we can actually re-send
            have = max((l for l in self.queue if l > self.cmt),
                       default=self.cmt)
            self.lst = min(self.lst, have)
        self.forced_upto = self.lst        # everything local is durable or inflight->refused on crash
        self._takeover_hi = self.lst
        self._reset_batch()
        self._last_commit_bcast = -1   # first tick re-announces cmt
        self._piggy_sent = -1
        self._watched_peers.clear()
        # rebuild version map + range-op gates from the unresolved queue:
        # an in-flight SPLIT must keep gating writes above the split point
        # across the regime change, else post-takeover writes to moved keys
        # would land above the barrier and be detached away
        self.proposed_version.clear()
        self.pending_split = None
        self._pending_member_change = False
        for lsn in sorted(self.queue):
            rec = self.queue[lsn]
            if rec.op is OpType.SPLIT:
                self.pending_split = (rec.key, rec.columns[0][1])
            elif rec.op is OpType.MEMBER_CHANGE:
                self._pending_member_change = True
            elif rec.op in TXN_OPS:
                # an in-flight prepare must keep its locks gating writes
                # across the regime change; in-flight resolutions keep
                # their txid marked so decides are not double-proposed
                self.txn.stage_from_record(rec)
            else:
                for colname, _value, version in rec.columns:
                    self.proposed_version[(rec.key, colname)] = version
        self._next_seq = lsn_seq(self.lst) + 1
        self._minc("elections_won")
        self.obs.events.emit("leader_takeover", node=self.node.node_id,
                             rid=self.rid, epoch=new_epoch,
                             unresolved=len(self.queue))
        if self.obs.journal.enabled:
            # `missing` = durable, never-truncated records of the unresolved
            # window that takeover did NOT reload into its re-proposal queue
            # — always 0 for a correct takeover; the watchdog flags any gap
            # (the PR 6 takeover-wedge shape) at this very transition
            durable = self.node.wal.range_lsns_between(
                self.rid, self.cmt, self.lst) or []
            self._jrec("takeover", epoch=new_epoch, cmt=self.cmt,
                       lst=self.lst,
                       unresolved=sum(1 for l in self.queue if l > self.cmt),
                       missing=sum(1 for l in durable if l not in self.queue),
                       n_cohort=len(self.peers) + 1)
        # `forced_upto = lst` above re-establishes local durability for the
        # whole queue; traces carried across the regime change would
        # otherwise never see their flush/force milestones again
        now = self.node.sim.now
        for lsn, tr in self._trace_by_lsn.items():
            if lsn in self.queue:
                if tr.t_flush is None:
                    tr.t_flush = now
                if tr.t_forced is None:
                    tr.t_forced = now
        self.log(f"takeover: cmt={fmt_lsn(self.cmt)} lst={fmt_lsn(self.lst)} "
                 f"unresolved={len(self.queue)}")
        for p in self.peers:
            self._send(p, "on_new_leader", epoch=self.epoch,
                       leader=self.node.node_id)
        self._watch_peer_sessions()
        self._arm_commit_timer()
        # takeover grace lease: the previous regime's lease provably lapsed
        # before our deposal/election, so a fresh window starting now is
        # safe; renewals must extend it before it runs out, which doubles
        # as the takeover timeout — a leader elected through ZK while
        # data-partitioned never hears an ack and abdicates instead of
        # squatting on the range
        self._lease_until = self.node.sim.now + self.cfg.lease_duration
        self._jrec("lease_acquire", epoch=new_epoch,
                   until=self._lease_until, grace=True)
        self._lease_sent.clear()
        self._lease_acks.clear()
        self._arm_lease_timer()
        self._renew_lease()

    def _watch_peer_sessions(self) -> None:
        for p in self.peers:
            if p in self._watched_peers:
                continue  # re-invoked after member changes; arm once each
            self._watched_peers.add(p)

            def on_change(_p, peer=p):
                if peer not in self.peers:
                    self._watched_peers.discard(peer)  # retired mid-watch
                    return
                if self.role not in (Role.LEADER, Role.TAKEOVER):
                    return
                if not self.zk.exists(f"/nodes/{peer}"):
                    if peer in self.insync:
                        self.insync.discard(peer)
                        self.acked[peer] = 0
                        self.log(f"follower n{peer} lost (session expired)")
                self.zk.watch_exists(f"/nodes/{peer}", on_change)

            self.zk.watch_exists(f"/nodes/{p}", on_change)

    # --- follower side of takeover / join ------------------------------------
    def _become_joining_follower(self, leader_id: int, epoch: int) -> None:
        """We found an existing leader (restart path §6.1): advertise state,
        wait for catch-up."""
        if epoch < self.epoch or self.role == Role.OFFLINE:
            return
        if epoch == self.epoch and self.leader_id == leader_id \
                and self.role in (Role.CATCHUP, Role.FOLLOWER):
            return  # duplicate announcement (znode watch + NEW_LEADER msg)
        self._step_down()
        self.epoch = epoch
        self.leader_id = leader_id
        self.role = Role.CATCHUP
        self._leader_seen = self.node.sim.now
        self._catchup_seen = self.node.sim.now
        self._jrec("catchup_enter", epoch=epoch, leader=leader_id)
        self._drop_uncommitted_tail()
        self._watch_leader_liveness()
        self._send(leader_id, "on_follower_state", epoch=epoch,
                   follower=self.node.node_id, f_cmt=self.cmt, f_lst=self.lst)

    def on_new_leader(self, epoch: int, leader: int) -> None:
        if self.role == Role.OFFLINE or epoch <= self._announced_leader_epoch \
                or epoch < self.epoch or leader == self.node.node_id:
            return
        self._announced_leader_epoch = epoch
        self._become_joining_follower(leader, epoch)

    def _step_down(self) -> None:
        if self.role in (Role.LEADER, Role.TAKEOVER):
            self.open_for_writes = False
            self._reset_batch()
            if self._commit_timer is not None:
                self._commit_timer.cancel()
                self._commit_timer = None
            if self._lease_timer is not None:
                self._lease_timer.cancel()
                self._lease_timer = None
            self._lease_until = 0.0
            self._lease_sent.clear()
            self._lease_acks.clear()
            self._fail_read_confirms()
            for op, cb, _tr in self.blocked_writes:
                cb(Result(ErrorCode.NOT_LEADER, leader_hint=self.leader_id))
            self.blocked_writes.clear()
            self.txn.on_step_down()

    def _drop_uncommitted_tail(self) -> None:
        """Entering a new regime: pending writes in (cmt, lst] are ambiguous.
        Drop the volatile queue; the durable copies are logically truncated
        when catch-up data arrives (§6.1.1).  The durability watermark must
        retreat with them: a truncated record no longer counts as a stable
        copy, so re-proposals of it must be re-forced before being acked."""
        self.queue = {l: r for l, r in self.queue.items() if l <= self.cmt}
        self._follower_forced = min(self._follower_forced, self.cmt)
        self._trace_by_lsn.clear()   # dropped writes retry with fresh marks
        for lsn in list(self.pending_reply):
            cb = self.pending_reply.pop(lsn)
            cb(Result(ErrorCode.UNAVAILABLE))
        self.txn.drop_uncommitted()

    # ================================== leader leases (cfg.lease_enabled)
    def _lease_tick_period(self) -> float:
        return self.cfg.lease_duration / 4.0

    def _depose_after(self) -> float:
        """Leader silence a follower tolerates before deleting the leader
        znode.  Strictly longer than any lease the silent leader can hold:
        a granted lease ends at renewal-send-time + duration - skew, and
        every acking follower saw that renewal no earlier than it was
        sent, so silence of duration + 4*skew outlives it."""
        return self.cfg.lease_duration + 4.0 * self.cfg.max_clock_skew

    def lease_valid(self) -> bool:
        return (self.cfg.lease_enabled
                and self.node.sim.now <= self._lease_until)

    def _arm_lease_timer(self) -> None:
        if self._lease_timer is not None:
            self._lease_timer.cancel()
        self._lease_timer = self.node.sim.schedule(
            self._lease_tick_period(), self._lease_tick)

    def _lease_tick(self) -> None:
        self._lease_timer = None
        if self.role not in (Role.LEADER, Role.TAKEOVER) \
                or not self.cfg.lease_enabled:
            return
        if self.node.sim.now > self._lease_until:
            why = ("lease lapsed" if self.role is Role.LEADER
                   else "takeover timed out (no data-net quorum)")
            self.obs.events.emit("lease_lapse", node=self.node.node_id,
                                 rid=self.rid, epoch=self.epoch, why=why)
            self._jrec("lease_lapse", epoch=self.epoch, why=why)
            self._abdicate(why, suppress=True)
            return
        prev = self._lease_acks.get(self._lease_seq)
        if prev is not None and len(prev) < self._majority() - 1:
            # the previous renewal round never reached a majority — the
            # lease is burning down; surface it in the cluster event log
            self.obs.events.emit("lease_renew_fail", node=self.node.node_id,
                                 rid=self.rid, epoch=self.epoch,
                                 seq=self._lease_seq, acks=len(prev))
        self._renew_lease()
        self._arm_lease_timer()

    def _renew_lease(self) -> None:
        if not self.cfg.lease_enabled:
            return
        if self._majority() - 1 == 0:
            # single-replica cohort: no follower promises needed
            new_until = (self.node.sim.now
                         + self.cfg.lease_duration - self.cfg.max_clock_skew)
            if new_until > self._lease_until:
                self._lease_until = new_until
                self._jrec("lease_acquire", epoch=self.epoch, until=new_until)
            return
        self._lease_seq += 1
        seq = self._lease_seq
        self._lease_sent[seq] = self.node.sim.now
        self._lease_acks[seq] = set()
        self._jrec("lease_renew", epoch=self.epoch, seq=seq)
        # prune stale rounds (acks for them could no longer extend anything)
        for old in [s for s in self._lease_sent if s < seq - 8]:
            self._lease_sent.pop(old, None)
            self._lease_acks.pop(old, None)
        for p in self.peers:
            self._send(p, "on_lease", nbytes=96, epoch=self.epoch, seq=seq,
                       leader=self.node.node_id)

    def on_lease(self, epoch: int, seq: int, leader: int) -> None:
        """Follower: a lease renewal doubles as a leader heartbeat — ack it
        and push back our deposal clock (the promise not to elect)."""
        if self.role not in (Role.FOLLOWER, Role.CATCHUP) \
                or epoch != self.epoch:
            return
        self._leader_seen = self.node.sim.now
        if self.role is Role.CATCHUP:
            # CATCHUP beats feed the watchdog's starvation monitor: a
            # replica kept alive by heartbeats but starved of catch-up data
            self._jrec("lease_heard", epoch=epoch, role="CATCHUP",
                       leader=leader)
        self._send(leader, "on_lease_ack", nbytes=96, epoch=epoch, seq=seq,
                   follower=self.node.node_id)

    def on_lease_ack(self, epoch: int, seq: int, follower: int) -> None:
        if self.role not in (Role.LEADER, Role.TAKEOVER) \
                or epoch != self.epoch:
            return
        self._peer_seen[follower] = self.node.sim.now
        sent = self._lease_sent.get(seq)
        acks = self._lease_acks.get(seq)
        if sent is None or acks is None:
            return
        acks.add(follower)
        if len(acks) >= self._majority() - 1:
            # the lease window is anchored at the renewal's SEND time: every
            # acking follower promises `_depose_after` of patience measured
            # from a clock that saw the renewal AFTER it was sent
            new_until = sent + self.cfg.lease_duration \
                - self.cfg.max_clock_skew
            if new_until > self._lease_until:
                self._lease_until = new_until
                self._jrec("lease_acquire", epoch=epoch, until=new_until)
                if self._lease_event_epoch != epoch:
                    # event-log satellite: one lease_acquire event per
                    # regime (renewals extend silently; the journal keeps
                    # the per-renewal record)
                    self._lease_event_epoch = epoch
                    self.obs.events.emit(
                        "lease_acquire", node=self.node.node_id,
                        rid=self.rid, epoch=epoch,
                        until=round(new_until, 6))

    _lease_event_epoch = -1

    def _abdicate(self, why: str, suppress: bool) -> None:
        """Fence ourselves out of the leader regime: drop the leader znode
        (if still ours), refuse pending/blocked writes, and go back to
        ELECTING.  The unresolved queue is KEPT — if we legitimately win a
        later election these records are re-proposed exactly like after a
        crash-restart (dropping them here would let `lst` advertise records
        takeover could no longer resolve)."""
        if self.role not in (Role.LEADER, Role.TAKEOVER):
            return
        self.log(f"abdicating: {why}")
        self.obs.events.emit("leader_abdicate", node=self.node.node_id,
                             rid=self.rid, epoch=self.epoch, why=why)
        self._jrec("abdicate", epoch=self.epoch, why=why)
        self._minc("leader_abdications")
        leader_path = f"{self.base}/leader"
        try:
            lid, ep = self.zk.get(leader_path)
            if lid == self.node.node_id and ep == self.epoch:
                self.zk.delete(leader_path)
        except NoNode:
            pass
        self._step_down()
        for lsn in list(self.pending_reply):
            cb = self.pending_reply.pop(lsn)
            cb(Result(ErrorCode.UNAVAILABLE))
        self._trace_by_lsn.clear()
        self._suppressed = suppress and self.cfg.lease_enabled
        self.role = Role.ELECTING
        self._join_or_elect()

    # --- connectivity probes (ping/pong over the data network) -------------
    def on_ping(self, frm: int) -> None:
        if self.role is Role.OFFLINE:
            return
        self._peer_seen[frm] = self.node.sim.now
        self._send(frm, "on_pong", nbytes=96, frm=self.node.node_id)

    def on_pong(self, frm: int) -> None:
        if self.role is Role.OFFLINE:
            return
        self._peer_seen[frm] = self.node.sim.now

    def _fresh_majority_contact(self, window: float = 0.75) -> bool:
        now = self.node.sim.now
        fresh = sum(1 for p in self.peers
                    if now - self._peer_seen.get(p, -1e9) <= window)
        return 1 + fresh >= self._majority()

    def _probe_connectivity(self) -> None:
        """Suppressed ex-leader in ELECTING: ping peers and re-enter the
        join/elect path once a data-network majority answers."""
        if self.role is not Role.ELECTING or not self._suppressed:
            return
        if self._fresh_majority_contact():
            self._suppressed = False
            self.log("data-net majority contact restored; candidacy resumes")
            self._join_or_elect()
            return
        for p in self.peers:
            self._send(p, "on_ping", nbytes=96, frm=self.node.node_id)
        self.node.sim.schedule(0.25, self._probe_connectivity)

    # --- follower watchdog -------------------------------------------------
    def _arm_guard_timer(self) -> None:
        if self._guard_timer is not None:
            self._guard_timer.cancel()
        self._guard_timer = self.node.sim.schedule(0.25, self._guard_tick)

    def _guard_tick(self) -> None:
        self._guard_timer = None
        if self.role is Role.OFFLINE:
            return
        self._arm_guard_timer()
        if self.role not in (Role.FOLLOWER, Role.CATCHUP):
            return
        stale = self.node.sim.now - self._leader_seen
        leader_path = f"{self.base}/leader"
        # bug_catchup_starvation (mutation corpus): the original PR 6 bug
        # paced catch-up retries off `_leader_seen`, which lease heartbeats
        # keep perpetually fresh — so a CATCHUP replica whose data was lost
        # never re-requested it and starved behind a live leader
        catchup_clock = (self._leader_seen if self.cfg.bug_catchup_starvation
                         else self._catchup_seen)
        if self.role is Role.CATCHUP \
                and self.node.sim.now - catchup_clock > 0.6:
            # the catch-up request or its data was lost (flaky link, leader
            # drop): restart the exchange — idempotent, the leader re-syncs
            # us from scratch
            self._catchup_seen = self.node.sim.now   # pace retries
            self._jrec("catchup_retry", epoch=self.epoch)
            if self.leader_id is not None:
                self._send(self.leader_id, "on_follower_state",
                           epoch=self.epoch, follower=self.node.node_id,
                           f_cmt=self.cmt, f_lst=self.lst)
            return
        if not self.cfg.lease_enabled or stale <= self._depose_after() / 2:
            return
        # recover from a lost leader announcement before suspecting anyone
        try:
            lid, ep = self.zk.get(leader_path)
        except NoNode:
            return   # znode already gone; the liveness watch re-elects
        if (lid, ep) != (self.leader_id, self.epoch):
            if ep > self.epoch and lid != self.node.node_id:
                self._become_joining_follower(lid, ep)
            return
        for p in self.peers:
            self._send(p, "on_ping", nbytes=96, frm=self.node.node_id)
        if stale > self._depose_after() and self._fresh_majority_contact():
            # the leader is silent past any lease it could hold, and we can
            # see a cohort majority: depose it so the majority side elects.
            # The get-then-delete pair is atomic here (synchronous ZK model)
            self.log(f"deposing silent leader n{lid} "
                     f"(stale {stale:.2f}s > {self._depose_after():.2f}s)")
            self.obs.events.emit("leader_deposed", node=self.node.node_id,
                                 rid=self.rid, epoch=ep, leader=lid)
            self._jrec("deposed", epoch=ep, leader=lid)
            self._minc("leader_deposals")
            try:
                self.zk.delete(leader_path)
            except NoNode:
                pass

    # --- ZK session flap recovery ------------------------------------------
    def on_session_reestablished(self) -> None:
        """The node's ZK session expired and came back (gray failure): every
        ephemeral we held — leader claim, candidacies, /nodes/<id> — is
        gone, and a leader has dropped us from its in-sync set."""
        if self.role is Role.OFFLINE:
            return
        if self.role in (Role.LEADER, Role.TAKEOVER):
            # our leader znode vanished with the session; a successor may
            # already rule.  No suppression: the data network is fine
            self._abdicate("zk session flapped", suppress=False)
        elif self.role in (Role.FOLLOWER, Role.CATCHUP) \
                and self.leader_id is not None:
            # re-announce so the leader re-syncs us (it zeroed our ack state
            # when /nodes/<id> disappeared)
            self._leader_seen = self.node.sim.now
            self._send(self.leader_id, "on_follower_state", epoch=self.epoch,
                       follower=self.node.node_id, f_cmt=self.cmt,
                       f_lst=self.lst)
        else:
            self._join_or_elect()

    # --- read-index fallback (quorum-confirmed strong reads) ----------------
    def _fail_read_confirms(self) -> None:
        waiting, self._rc_waiting = self._rc_waiting, []
        self._rc_inflight = False
        self._rc_acks.clear()
        for thunk in waiting:
            thunk(False)

    def _confirm_leadership(self, cb: Callable) -> None:
        """Serve a strong read without a valid lease: confirm with a
        follower majority that our regime still stands (one round trip),
        then read locally.  `cb(ok)` fires with the verdict."""
        if self._majority() - 1 == 0:
            cb(True)
            return
        self._rc_waiting.append(cb)
        if self._rc_inflight:
            return
        self._rc_inflight = True
        self._rc_seq += 1
        self._rc_acks.clear()
        seq = self._rc_seq
        for p in self.peers:
            self._send(p, "on_read_confirm", nbytes=96, epoch=self.epoch,
                       seq=seq, leader=self.node.node_id)

        def timeout():
            if self._rc_inflight and self._rc_seq == seq:
                self._fail_read_confirms()

        self.node.sim.schedule(0.5, timeout)

    def on_read_confirm(self, epoch: int, seq: int, leader: int) -> None:
        if self.role not in (Role.FOLLOWER, Role.CATCHUP) \
                or epoch != self.epoch:
            return
        self._leader_seen = self.node.sim.now
        self._send(leader, "on_read_confirm_ack", nbytes=96, epoch=epoch,
                   seq=seq, follower=self.node.node_id)

    def on_read_confirm_ack(self, epoch: int, seq: int, follower: int) -> None:
        if self.role is not Role.LEADER or epoch != self.epoch \
                or seq != self._rc_seq or not self._rc_inflight:
            return
        self._peer_seen[follower] = self.node.sim.now
        self._rc_acks.add(follower)
        if len(self._rc_acks) >= self._majority() - 1:
            waiting, self._rc_waiting = self._rc_waiting, []
            self._rc_inflight = False
            for thunk in waiting:
                thunk(True)

    # --- leader side: follower catch-up (§6.1 + Fig. 6 lines 3-8) ------------
    def on_follower_state(self, epoch: int, follower: int, f_cmt: int,
                          f_lst: int) -> None:
        if self.role not in (Role.LEADER, Role.TAKEOVER) or epoch != self.epoch:
            return
        if follower not in self.peers:
            # a replica retired by a MEMBER_CHANGE it slept through is
            # rejoining: tell it to deregister instead of feeding it data
            self._send(follower, "on_deposed", epoch=self.epoch)
            return
        # a restarted follower must re-sync from scratch
        self.insync.discard(follower)
        self.acked[follower] = 0
        self.log(f"catch-up request from n{follower} "
                 f"(f.cmt={fmt_lsn(f_cmt)} f.lst={fmt_lsn(f_lst)})")
        self._send_catchup(follower, f_cmt, f_lst, first=True)

    def _send_catchup(self, follower: int, f_cmt: int, f_lst: int,
                      first: bool = False) -> None:
        target = self.cmt
        recs = self.node.wal.records_between(self.rid, f_cmt, target)
        if recs is None:
            # log rolled over: source from SSTables (§6.1), synthesising one
            # record per surviving cell — plus any unresolved 2PC records,
            # which carry prepared/decision state data cells cannot
            cells = self.store.cells_with_lsn_above(f_cmt)
            recs = [LogRecord(self.rid, cell.lsn,
                              OpType.DELETE if cell.deleted else OpType.PUT,
                              key, ((colname, cell.value, cell.version),))
                    for key, colname, cell in cells
                    if cell.lsn <= target]
            recs.extend(self.txn.catchup_extras(target))
            recs.sort(key=lambda r: r.lsn)
        nbytes = 128 + sum(r.nbytes() for r in recs)
        self._send(follower, "on_catchup_data", nbytes=nbytes,
                   epoch=self.epoch, records=recs, commit_lsn=target,
                   truncate_from=f_cmt if first else None,
                   truncate_to=f_lst if first else None)

    def on_catchup_synced(self, epoch: int, follower: int, upto: int) -> None:
        if self.role not in (Role.LEADER, Role.TAKEOVER) or epoch != self.epoch:
            return
        if upto < self.cmt:
            # new writes committed while the batch was in flight: send the
            # delta (the paper's "momentarily blocks new writes" final round
            # is subsumed by the gap-forwarding below once upto == cmt)
            self._send_catchup(follower, upto, upto)
            return
        self.insync.add(follower)
        self.acked[follower] = max(self.acked.get(follower, 0), upto)
        # close the in-flight gap: forward pending proposals this follower
        # has not seen (they were proposed while it was out-of-sync) as one
        # batched propose; FIFO links order it before any subsequent propose.
        # Records still sitting in the un-flushed accumulator are excluded —
        # the follower is in-sync now, so the coming flush covers them.
        staged = {r.lsn for r in self._batch}
        pending = [self.queue[l] for l in sorted(self.queue)
                   if l > upto and l not in staged]
        if pending:
            nbytes = sum(r.nbytes() for r in pending) + 64
            self._send(follower, "on_propose", nbytes=nbytes,
                       epoch=self.epoch, records=pending,
                       commit_lsn=self._piggyback())
        self.log(f"follower n{follower} in-sync @ {fmt_lsn(upto)}")
        self._after_quorum_progress()
        self._check_migration()   # a just-synced dst unblocks phase 2

    def _after_quorum_progress(self) -> None:
        if self.role == Role.TAKEOVER and self.insync:
            # Fig. 6 lines 8-10: quorum reached; re-propose (l.cmt, l.lst]
            unresolved = sorted(l for l in self.queue if l > self.cmt)
            self.role = Role.LEADER
            if unresolved:
                self.log(f"re-proposing {len(unresolved)} unresolved writes")
                # records were already forwarded to the in-sync follower by
                # on_catchup_synced's gap-forwarding; commits flow via acks
                self._advance_commit()
            if self.cmt >= self._takeover_hi and not self.open_for_writes:
                self._open_writes()
        elif self.role == Role.LEADER and not self.open_for_writes:
            if self.cmt >= self._takeover_hi:
                self._open_writes()

    def _open_writes(self) -> None:
        self.open_for_writes = True
        self._next_seq = max(self._next_seq, lsn_seq(self.lst) + 1)
        self.obs.events.emit("leader_open", node=self.node.node_id,
                             rid=self.rid, epoch=self.epoch)
        self._jrec("leader_open", epoch=self.epoch, lsn=self.cmt)
        self.log(f"open for writes (next lsn {self.epoch}.{self._next_seq})")
        # self-heal range metadata: a dead leader may have applied a range
        # op without publishing it (idempotent — no version churn when the
        # registered state already matches), then resume any interrupted
        # migration from its intent znode
        ranges_mod.set_range_meta(
            self.zk, self.rid, self.range.lo, self.range.hi,
            tuple(sorted((self.node.node_id,) + self.peers)))
        self.node.cluster.on_range_table_changed()
        self.node.sim.schedule(0.0, self._check_migration)
        # resume 2PC duties: presume-abort orphan intents we coordinate,
        # re-drive logged decisions, re-vote in-doubt prepares
        self.node.sim.schedule(0.0, self.txn.on_leader_open)
        blocked, self.blocked_writes = self.blocked_writes, []
        for op, cb, tr in blocked:
            if isinstance(op, list):                # blocked transaction
                self.client_transaction(op, cb, trace=tr)
            else:
                self.client_write(op, cb, trace=tr)

    # --- follower side: catch-up data -----------------------------------------
    def on_catchup_data(self, epoch: int, records: list[LogRecord],
                        commit_lsn: int, truncate_from: Optional[int],
                        truncate_to: Optional[int]) -> None:
        if self.role not in (Role.CATCHUP, Role.FOLLOWER) or epoch != self.epoch:
            return
        if self.cfg.drop_first_catchup and not self._dropped_catchup:
            # test-only fault hook (chaos/mutations.py): pretend the first
            # catch-up delivery was lost on the wire — the retry logic in
            # _guard_tick must recover; bug_catchup_starvation defeats it
            self._dropped_catchup = True
            return
        self._leader_seen = self.node.sim.now
        self._catchup_seen = self.node.sim.now
        self._suppressed = False   # live data-path contact with the leader
        if truncate_from is not None and truncate_to is not None \
                and truncate_to > truncate_from:
            # §6.1.1 logical truncation: (f.cmt, f.lst] may contain records
            # discarded by the new regime; never re-apply them.  Re-sent
            # records are re-appended afresh (WAL.append un-skips their LSN).
            lsns = self.node.wal.range_lsns_between(self.rid, truncate_from,
                                                    truncate_to)
            self.node.wal.logically_truncate(self.rid, lsns)
            self.lst = min(self.lst, truncate_from)

        fresh = [r for r in records if r.lsn > self.lst]
        e0 = self.epoch

        def complete() -> None:
            if self.role == Role.OFFLINE or self.epoch != e0:
                return
            self._apply_committed(commit_lsn)
            self._jrec("catchup_exit", epoch=self.epoch, lsn=commit_lsn)
            if self.role == Role.CATCHUP:
                self.role = Role.FOLLOWER
            self._send(self.leader_id, "on_catchup_synced",
                       epoch=self.epoch, follower=self.node.node_id,
                       upto=commit_lsn)

        if not fresh:
            complete()
            return
        jr = self.obs.journal
        for i, rec in enumerate(fresh):
            self.queue[rec.lsn] = rec
            self.lst = max(self.lst, rec.lsn)
            if jr.enabled:
                jr.record("append", node=self.node.node_id, rid=self.rid,
                          epoch=lsn_epoch(rec.lsn), lsn=rec.lsn,
                          digest=record_digest(rec), op=rec.op.name,
                          via="catchup")
            last = i == len(fresh) - 1
            self.node.wal.append(rec, force=last, cb=complete if last else None,
                                 component="catchup", rid=self.rid)

    def on_deposed(self, epoch: int) -> None:
        """The leader says we are not in this cohort's member set (we
        missed a MEMBER_CHANGE retiring us while down): drop the replica."""
        if self.role is Role.OFFLINE:
            return
        self.log("deposed: not in the cohort member set; deregistering")
        self.node.retire_replica(self.rid)

    # ===================================================== steady state (§5)
    def _piggyback(self) -> Optional[int]:
        return self.cmt if self.cfg.piggyback_commit else None

    def _owns(self, key: str) -> bool:
        """Does this replica currently serve `key`?  False once the range
        narrowed under a split, or (leader only) once a SPLIT above the
        key is proposed — the barrier must not admit writes that would
        land past it and then be detached away."""
        if not self.range.contains(key):
            return False
        ps = self.pending_split
        return ps is None or key < ps[0]

    def client_write(self, op: WriteOp, reply: Callable,
                     trace=None) -> None:
        if trace is not None:
            trace.t_cpu = self.node.sim.now
        if self.role != Role.LEADER or not self.node.has_session() \
                or (self.cfg.lease_enabled and not self.lease_valid()):
            # a lapsed lease fences writes immediately (abdication follows
            # on the next lease tick): admitting them would let a fenced-off
            # leader queue work that can never commit, stalling clients
            reply(Result(ErrorCode.NOT_LEADER, leader_hint=self.leader_id))
            return
        if not self._owns(op.key):
            self._minc("wrong_range_replies")
            reply(Result(ErrorCode.WRONG_RANGE))
            return
        if not self.open_for_writes:
            self.blocked_writes.append((op, reply, trace))
            return
        if self.txn.lock_owner(op.key) is not None:
            # held by an in-flight cross-range transaction: no-wait policy
            # (core/txn.py) — refuse now, the client's backoff retries
            self.txn.lock_conflicts += 1
            reply(Result(ErrorCode.LOCKED))
            return
        # conditional check against the latest *proposed* version so
        # pipelined writes to one row serialize correctly (§5.1)
        cur = self.proposed_version.get((op.key, op.colname))
        if cur is None:
            cur = self.store.current_version(op.key, op.colname)
        if op.is_conditional and op.expected_version != cur:
            reply(Result(ErrorCode.VERSION_MISMATCH, version=cur))
            return
        if op.op == OpType.MULTI_PUT:
            cols = tuple((c, v, self._bump_version(op.key, c))
                         for c, v in (op.columns or ()))
        elif op.op in (OpType.DELETE, OpType.COND_DELETE):
            cols = ((op.colname, None, self._bump_version(op.key, op.colname)),)
        else:
            cols = ((op.colname, op.value,
                     self._bump_version(op.key, op.colname)),)
        lsn = make_lsn(self.epoch, self._next_seq)
        self._next_seq += 1
        rec = LogRecord(self.rid, lsn, op.op, op.key, cols)
        self.lst = max(self.lst, lsn)
        self.queue[lsn] = rec
        self.pending_reply[lsn] = reply
        if trace is not None:
            trace.lsn = lsn
            self._trace_by_lsn[lsn] = trace
        self.writes_served += 1
        self._heat(rec.nbytes())
        self._batch_append(rec)
        self._maybe_flush_batch()

    def propose_record(self, op: OpType, key: str, columns: tuple = (),
                       txn=None, trace=None) -> LogRecord:
        """Mint an LSN for a single control record (range op / 2PC record)
        and admit it to the replication pipeline: unresolved queue + batch
        accumulator + flush.  One place for the admission invariants that
        client_write spells out inline for data records.  A `trace` rides
        the record's replication milestones (registered before the flush
        below, which may run synchronously)."""
        lsn = make_lsn(self.epoch, self._next_seq)
        self._next_seq += 1
        rec = LogRecord(self.rid, lsn, op, key, columns, txn=txn)
        self.lst = max(self.lst, lsn)
        self.queue[lsn] = rec
        if trace is not None:
            trace.lsn = lsn
            self._trace_by_lsn[lsn] = trace
        self._batch_append(rec)
        self._maybe_flush_batch()
        return rec

    # --- leader-side proposal batching (§5 "batches writes", §C) -----------
    def _batch_append(self, rec: LogRecord) -> None:
        """Stage a record: WAL-buffered (rides along with the next force)
        and queued for the next multi-record propose."""
        self.node.wal.append(rec, force=False)
        jr = self.obs.journal
        if jr.enabled:
            jr.record("append", node=self.node.node_id, rid=self.rid,
                      epoch=lsn_epoch(rec.lsn), lsn=rec.lsn,
                      digest=record_digest(rec), op=rec.op.name)
        self._batch.append(rec)
        self._batch_bytes += rec.nbytes()

    def _maybe_flush_batch(self) -> None:
        cfg = self.cfg
        if not self._batch:
            return
        if cfg.batch != "adaptive" \
                or len(self._batch) >= cfg.batch_max_records \
                or self._batch_bytes >= cfg.batch_max_bytes:
            self._flush_batch()
            return
        if self.node.ingress_draining:
            # mid ingress-drain: later staged writes are about to be
            # admitted in this same CPU batch; on_ingress_drained flushes
            # once, covering all of them with one propose + one force
            return
        if self.node.cpu.busy_until <= self.node.sim.now + 1e-12:
            # CPU queue empty -> no load to amortise against: flush now and
            # keep the unbatched latency profile.  Otherwise writes are
            # arriving faster than they are served; let the batch grow.
            self._flush_batch()
        elif self._batch_timer is None:
            self._batch_timer = self.node.sim.schedule(
                cfg.batch_deadline, self._on_batch_deadline)

    def on_ingress_drained(self) -> None:
        """The node finished serving an ingress batch: flush whatever the
        batched handlers staged (one proposal batch per ingress batch)."""
        if self._batch:
            self._maybe_flush_batch()

    def _on_batch_deadline(self) -> None:
        self._batch_timer = None
        self._flush_batch()

    def _flush_batch(self) -> None:
        """One multi-record propose per in-sync follower ∥ one WAL force
        covering the whole batch (Fig. 4's two parallel arrows, amortised)."""
        if self._batch_timer is not None:
            self._batch_timer.cancel()
            self._batch_timer = None
        batch, self._batch = self._batch, []
        self._batch_bytes = 0
        if not batch or self.role not in (Role.LEADER, Role.TAKEOVER):
            return
        tail = batch[-1].lsn
        e0 = self.epoch
        self.batches_flushed += 1
        self.batched_records += len(batch)
        self._minc("proposal_batches")
        self._minc("proposal_batch_records", len(batch))
        now = self.node.sim.now
        traced = [self._trace_by_lsn[r.lsn] for r in batch
                  if r.lsn in self._trace_by_lsn]
        for tr in traced:
            tr.t_flush = now

        def on_forced():
            # EPOCH-BOUND like the follower path: a force in flight across
            # a regime change must not advance the new regime's watermark
            if self.epoch != e0 or self.role not in (Role.LEADER,
                                                     Role.TAKEOVER):
                return
            for tr in traced:
                tr.t_forced = self.node.sim.now
            self._on_self_forced(tail)
            self._maybe_flush_batch()   # drain what queued during the force

        self.node.wal.force(cb=on_forced, component="wal.force", rid=self.rid)
        nbytes = sum(r.nbytes() for r in batch) + 64
        cl = self._piggyback()
        for f in self.insync:
            self._send_batched(f, "on_propose", nbytes=nbytes,
                               epoch=self.epoch, records=list(batch),
                               commit_lsn=cl)
        if cl is not None and self.insync:
            # every insync follower just learned cmt: the periodic commit
            # broadcast for this watermark is redundant (suppressed in
            # _commit_tick) — the marker stopped paying its own message
            self._piggy_sent = max(self._piggy_sent, cl)

    def client_transaction(self, ops: list, reply: Callable,
                           trace=None) -> None:
        """Multi-operation transaction (§8.2, the paper's sketched
        extension): all ops target this cohort's range; the transaction
        creates multiple log records but invokes the replication protocol
        once, as a batch — consecutive LSNs proposed together, client
        acked when the LAST record commits (commits are in LSN order, so
        the batch is atomic at every replica: a prefix is never visible
        to strong reads because apply happens in one _apply_committed
        sweep only after quorum covers the tail record)."""
        if trace is not None:
            trace.t_cpu = self.node.sim.now
        if self.role != Role.LEADER or not self.node.has_session() \
                or (self.cfg.lease_enabled and not self.lease_valid()):
            reply(Result(ErrorCode.NOT_LEADER, leader_hint=self.leader_id))
            return
        if not all(self._owns(op.key) for op in ops):
            self._minc("wrong_range_replies")
            reply(Result(ErrorCode.WRONG_RANGE))
            return
        if not self.open_for_writes:
            self.blocked_writes.append((ops, reply, trace))
            return
        if self.txn.lock_conflict({op.key for op in ops}):
            self.txn.lock_conflicts += 1
            reply(Result(ErrorCode.LOCKED))
            return
        # validate every conditional against latest proposed state FIRST —
        # any mismatch aborts the whole transaction with nothing proposed
        for op in ops:
            cur = self.proposed_version.get((op.key, op.colname))
            if cur is None:
                cur = self.store.current_version(op.key, op.colname)
            if op.is_conditional and op.expected_version != cur:
                reply(Result(ErrorCode.VERSION_MISMATCH, version=cur))
                return
        records = []
        tail_lsn = make_lsn(self.epoch, self._next_seq + len(ops) - 1)
        for op in ops:
            if op.op in (OpType.DELETE, OpType.COND_DELETE):
                cols = ((op.colname, None,
                         self._bump_version(op.key, op.colname)),)
            else:
                cols = ((op.colname, op.value,
                         self._bump_version(op.key, op.colname)),)
            lsn = make_lsn(self.epoch, self._next_seq)
            self._next_seq += 1
            rec = LogRecord(self.rid, lsn, op.op, op.key, cols,
                            txn_tail=tail_lsn)
            self.lst = max(self.lst, lsn)
            self.queue[lsn] = rec
            records.append(rec)
        self.writes_served += 1
        self._heat(sum(r.nbytes() for r in records))
        # client acked on the LAST record's commit (atomic prefix rule);
        # the records ride the shared batch accumulator — atomicity comes
        # from txn_tail in _apply_committed, not from sharing one force
        self.pending_reply[records[-1].lsn] = reply
        if trace is not None:
            trace.lsn = records[-1].lsn
            self._trace_by_lsn[records[-1].lsn] = trace
        for rec in records:
            self._batch_append(rec)
        self._maybe_flush_batch()

    def _bump_version(self, key: str, colname: str) -> int:
        cur = self.proposed_version.get((key, colname))
        if cur is None:
            cur = self.store.current_version(key, colname)
        self.proposed_version[(key, colname)] = cur + 1
        return cur + 1

    def _on_self_forced(self, lsn: int) -> None:
        if self.role not in (Role.LEADER, Role.TAKEOVER):
            return
        self.forced_upto = max(self.forced_upto, lsn)
        self._jrec("flush", epoch=self.epoch, lsn=self.forced_upto)
        self._advance_commit()

    def on_propose(self, epoch: int, records: list[LogRecord],
                   commit_lsn: Optional[int]) -> None:
        """A leader batch: log every fresh record, force ONCE covering the
        whole batch, reply with one cumulative ack (the durability
        watermark — it supersedes every lower ack)."""
        if self.role is not Role.FOLLOWER or epoch != self.epoch:
            return
        self._leader_seen = self.node.sim.now
        fresh: list[LogRecord] = []
        dup = False
        for record in records:
            if record.lsn <= self._follower_forced or record.lsn <= self.cmt:
                dup = True      # durable duplicate (gap-forward overlap)
            elif record.lsn in self.queue:
                pass  # logged already; that batch's in-flight force acks it
            else:
                self.queue[record.lsn] = record
                self.lst = max(self.lst, record.lsn)
                fresh.append(record)
        if fresh:
            e0 = self.epoch
            tail = fresh[-1].lsn
            if self.cfg.bug_ack_before_force:
                # mutation corpus: claim durability the moment the batch
                # arrives, before our WAL force completes — the ack the
                # commit rule counts is a lie until the force lands
                self._ack(tail)
            jr = self.obs.journal
            for i, record in enumerate(fresh):
                if jr.enabled:
                    jr.record("append", node=self.node.node_id, rid=self.rid,
                              epoch=lsn_epoch(record.lsn), lsn=record.lsn,
                              digest=record_digest(record), op=record.op.name,
                              via="propose")
                last = i == len(fresh) - 1
                self.node.wal.append(
                    record, force=last,
                    cb=(lambda: self._on_follower_forced(tail, e0))
                    if last else None,
                    component="wal.force", rid=self.rid)
        elif dup:
            # nothing new to force: re-ack the watermark
            self._ack(max(self._follower_forced, self.cmt))
        if commit_lsn is not None:
            before = self.cmt
            self._apply_committed(min(commit_lsn, self.lst))
            if self.cmt > before:
                # piggybacked commit progress: persist the marker exactly
                # as a dedicated on_commit broadcast would have
                self.node.wal.append(CommitMarker(self.rid, self.cmt),
                                     force=False)

    _follower_forced = 0
    _dropped_catchup = False   # drop_first_catchup fault-hook latch

    def _on_follower_forced(self, lsn: int, epoch: int) -> None:
        """Durability callback, EPOCH-BOUND: a force that was in flight
        when the regime changed must not ack into the new epoch — the
        records it covers may have just been logically truncated (the
        async-callback-across-regimes hazard the paper's TCP assumption
        hides; see EXPERIMENTS.md §Paper-deviations)."""
        if epoch != self.epoch:
            return
        self._follower_forced = max(self._follower_forced, lsn)
        self._jrec("flush", epoch=self.epoch, lsn=self._follower_forced)
        # forces are FIFO and proposes arrive in LSN order, so the
        # watermark is the highest *contiguous* durable LSN: ack it once
        # for the whole batch instead of once per record
        self._ack(self._follower_forced)

    def _ack(self, lsn: int) -> None:
        if self.role is not Role.FOLLOWER:
            return
        self.acks_sent += 1
        self._jrec("ack", epoch=self.epoch, lsn=lsn)
        self._send_batched(self.leader_id, "on_ack", epoch=self.epoch,
                           follower=self.node.node_id, lsn=lsn, nbytes=96)

    def on_ack(self, epoch: int, follower: int, lsn: int) -> None:
        """Cumulative: `lsn` is the follower's durability watermark; it
        covers everything at or below it, so max() is the whole merge."""
        if self.role not in (Role.LEADER, Role.TAKEOVER) or epoch != self.epoch:
            return
        if follower not in self.insync:
            return
        self.acked[follower] = max(self.acked.get(follower, 0), lsn)
        self._advance_commit()

    def _advance_commit(self) -> None:
        """Commit rule (Fig. 4): a write commits once the *leader's* log
        force completed AND enough followers acked that a majority of the
        cohort holds it — for the paper's 3-replica cohorts that is
        min(own forced, max follower ack); mid-migration the cohort is
        briefly 4-wide and the rule generalizes to the (majority-1)-th
        highest follower ack.  Acks and forces are per-node prefix-closed
        (FIFO links, in-order forces)."""
        if self.role not in (Role.LEADER, Role.TAKEOVER):
            return  # may arrive deferred, after a step-down
        acks = sorted((self.acked.get(f, 0) for f in self.insync),
                      reverse=True)
        need = self._majority() - 1          # follower acks beside our force
        best = acks[need - 1] if len(acks) >= need else 0
        new_cmt = min(self.forced_upto, best)
        if new_cmt <= self.cmt:
            return
        self._jrec("commit", epoch=self.epoch, lsn=new_cmt,
                   n_cohort=len(self.peers) + 1)
        self._apply_committed(new_cmt)
        self._after_quorum_progress()

    def _apply_committed(self, upto: int) -> None:
        """Apply queue entries in LSN order through `upto`; leader replies to
        clients here (the write is now durable on a majority).

        Multi-op transactions (§8.2): a batch becomes visible atomically —
        if `upto` lands inside a batch (tail not yet quorum-covered), apply
        stops before the batch's first record (cmt is held back, which is
        protocol-safe: it is a conservative commit watermark)."""
        if upto <= self.cmt:
            return
        for lsn in sorted(l for l in self.queue if self.cmt < l <= upto):
            rec = self.queue[lsn]
            if rec.txn_tail and rec.txn_tail > upto:
                upto = lsn - 1 if lsn - 1 > self.cmt else self.cmt
                break
        if upto <= self.cmt:
            return
        for lsn in sorted(l for l in self.queue if self.cmt < l <= upto):
            rec = self.queue.pop(lsn)
            tr = self._trace_by_lsn.pop(lsn, None)
            if tr is not None:
                tr.t_commit = self.node.sim.now
                # the ack leaves through the node's reply envelope this
                # same instant (coalescing merges simultaneous acks, it
                # never delays one) — the ack_coalesce stage records that
                tr.t_acked = self.node.sim.now
            self.cmt = lsn   # range ops read cmt; keep it current in-loop
            if rec.op is OpType.SPLIT:
                self._apply_split(rec)
            elif rec.op is OpType.MEMBER_CHANGE:
                self._apply_member_change(rec)
                if self.role is Role.OFFLINE:
                    return   # the change retired this very replica
            elif rec.op in TXN_OPS:
                # 2PC state transition (core/txn.py): every replica applies
                # it at the same log position — prepares install locks +
                # staged writes, commits make them visible atomically
                self.txn.apply_record(rec)
            else:
                self.store.apply(rec)
            self.commits += 1
            cb = self.pending_reply.pop(lsn, None)
            if cb is not None:
                ver = rec.columns[0][2] if rec.columns else None
                cb(Result(ErrorCode.OK, version=ver))
        self.cmt = upto
        self._jrec("commit_idx", epoch=self.epoch, lsn=upto)
        flushed = self.store.maybe_flush(self.cmt)
        if flushed is not None:
            self.node.wal.note_flushed(self.rid, flushed)

    # ============================================ range management (ranges.py)
    def propose_split(self, split_key: Optional[str] = None) -> bool:
        """Live range split: run a SPLIT record through the normal Paxos
        pipeline as a barrier.  Every replica that applies it forks the
        child range locally with zero data copy; the child cohort (same
        members) then elects its own leader.  Returns False when this
        replica cannot split right now (not an open leader, another range
        op in flight, or nothing to split)."""
        if self.role is not Role.LEADER or not self.open_for_writes \
                or not self.node.has_session():
            return False
        if self.pending_split is not None or self._pending_member_change \
                or self.zk.exists(ranges_mod.migration_path(self.rid)):
            return False
        if self.txn.has_participant_state():
            # an unresolved 2PC transaction has staged writes pinned to
            # keys of this range; a split barrier could detach them away
            # from the replica holding the prepared state
            return False
        if split_key is None:
            split_key = self.store.median_key(self.range.lo, self.range.hi)
        if split_key is None or split_key <= self.range.lo \
                or not self.range.contains(split_key):
            return False
        child_rid = ranges_mod.alloc_range_id(
            self.zk, self.node.cluster.n_base_ranges)
        ranges_mod.seed_child_epoch(self.zk, child_rid, self.epoch)
        self.pending_split = (split_key, child_rid)
        self.propose_record(OpType.SPLIT, split_key,
                            (("child_rid", child_rid, 0),))
        self.log(f"SPLIT proposed at {split_key!r} -> child r{child_rid}")
        return True

    def _propose_member_change(self, members: tuple[int, ...]) -> bool:
        """One committed membership change at a time (Raft-style single-
        server reconfiguration: old/new majorities always intersect)."""
        if self.role is not Role.LEADER or not self.open_for_writes \
                or not self.node.has_session():
            return False
        if self.pending_split is not None or self._pending_member_change:
            return False
        members = tuple(sorted(set(members)))
        if self.node.node_id not in members or len(members) < 2:
            return False
        self._pending_member_change = True
        self.propose_record(OpType.MEMBER_CHANGE, "",
                            (("members", members, 0),))
        self.log(f"MEMBER_CHANGE proposed: {members}")
        return True

    def start_migration(self, src: int, dst: int) -> bool:
        """Move this range's replica from `src` to `dst` (§6 machinery as
        a migration primitive): record the intent in coordination, ADD dst
        (snapshot + WAL catch-up brings it in-sync), then — gated on dst
        being in-sync — RETIRE src.  A leader elected mid-migration picks
        the intent back up in `_check_migration`."""
        me = self.node.node_id
        if self.role is not Role.LEADER or not self.open_for_writes \
                or not self.node.has_session():
            return False
        if src == me or src not in self.peers or dst == me \
                or dst in self.peers or dst not in self.node.cluster.nodes:
            return False
        if self.pending_split is not None or self._pending_member_change:
            return False
        try:
            self.zk.create(ranges_mod.migration_path(self.rid),
                           data=(src, dst))
        except NodeExists:
            return False   # a migration is already in flight
        if not self._propose_member_change((me,) + self.peers + (dst,)):
            try:
                self.zk.delete(ranges_mod.migration_path(self.rid))
            except NoNode:
                pass
            return False
        self.obs.events.emit("migration_start", rid=self.rid, src=src,
                             dst=dst)
        self.log(f"migration started: n{src} -> n{dst}")
        return True

    def _check_migration(self) -> None:
        """Drive a recorded migration one step forward.  Idempotent and
        cheap; called after member changes apply, after followers sync,
        and from the commit tick so a freshly elected leader resumes an
        interrupted move unaided."""
        if self.role is not Role.LEADER or not self.open_for_writes \
                or not self.node.has_session():
            return
        try:
            src, dst = self.zk.get(ranges_mod.migration_path(self.rid))
        except NoNode:
            return
        if self._pending_member_change or self.pending_split is not None:
            return
        me = self.node.node_id
        members = (me,) + self.peers
        if src == me:
            # failover elected the retire target itself: abort the move by
            # removing the half-joined destination, never ourselves
            try:
                self.zk.delete(ranges_mod.migration_path(self.rid))
            except NoNode:
                pass
            self.obs.events.emit("migration_abort", rid=self.rid, src=src,
                                 dst=dst)
            self.log(f"migration aborted (leader is retire target n{src})")
            if dst in self.peers:
                self._propose_member_change(
                    tuple(m for m in members if m != dst))
            return
        if dst not in members:
            # phase 1 (ADD) was lost with the old leader: re-propose it
            self._propose_member_change(members + (dst,))
            return
        if src in members:
            # phase 2 gate: retire src only once dst holds everything
            # committed — otherwise a post-migration majority could exclude
            # every holder of acknowledged writes
            if dst in self.insync and self.acked.get(dst, 0) >= self.cmt:
                self._propose_member_change(
                    tuple(m for m in members if m != src))
            return
        # both phases committed: the move is complete
        try:
            self.zk.delete(ranges_mod.migration_path(self.rid))
        except NoNode:
            pass
        self.obs.events.emit("migration_complete", rid=self.rid, src=src,
                             dst=dst)
        self.log(f"migration complete: n{src} -> n{dst}")

    def _apply_split(self, rec: LogRecord) -> None:
        """Apply a committed SPLIT: narrow our range, fork the child range
        locally (zero copy), and register the child's metadata.  Runs on
        every replica at the same log position, so all three forks carry
        identical state."""
        split_key = rec.key
        child_rid = rec.columns[0][1]
        if self.pending_split is not None \
                and self.pending_split[1] == child_rid:
            self.pending_split = None
        if split_key <= self.range.lo or not self.range.contains(split_key):
            return   # replay of a split this replica already performed
        child_hi = self.range.hi
        members = tuple(sorted((self.node.node_id,) + self.peers))
        self.range = KeyRange(self.rid, self.range.lo, split_key)
        child_range = KeyRange(child_rid, split_key, child_hi)
        child_store = self.store.detach_range(split_key, child_hi,
                                              fork_lsn=rec.lsn)
        for kc in [kc for kc in self.proposed_version
                   if not self.range.contains(kc[0])]:
            del self.proposed_version[kc]
        self.obs.events.emit("split_applied", node=self.node.node_id,
                             rid=self.rid, child_rid=child_rid,
                             split_key=split_key)
        self._jrec("split", epoch=lsn_epoch(rec.lsn), lsn=rec.lsn,
                   child=child_rid, split_key=split_key,
                   n_cohort=len(members))
        self.log(f"SPLIT applied at {split_key!r}: forked child r{child_rid}"
                 f" [{split_key!r}, {child_hi!r})")
        # registration is idempotent — the first applier wins, later
        # repliers (and the leader's open-writes self-heal) no-op
        ranges_mod.seed_child_epoch(self.zk, child_rid, lsn_epoch(rec.lsn))
        ranges_mod.set_range_meta(self.zk, child_rid, split_key, child_hi,
                                  members)
        ranges_mod.set_range_meta(self.zk, self.rid, self.range.lo,
                                  split_key, members)
        self.node.fork_child_replica(child_range, self.peers, child_store,
                                     fork_lsn=rec.lsn)
        self.node.cluster.on_range_table_changed()

    def _apply_member_change(self, rec: LogRecord) -> None:
        """Apply a committed MEMBER_CHANGE: adopt the new member set, or
        retire this replica if it is no longer part of it."""
        members = tuple(rec.columns[0][1])
        me = self.node.node_id
        self._pending_member_change = False
        self._jrec("member_change", epoch=lsn_epoch(rec.lsn), lsn=rec.lsn,
                   members=sorted(members))
        if me not in members:
            meta = ranges_mod.get_range_meta(self.zk, self.rid)
            if meta is not None and me in meta[2]:
                # stale record replayed through catch-up, superseded by a
                # later re-add: adopt the registered set instead
                self.peers = tuple(sorted(m for m in meta[2] if m != me))
                self._jrec("member_change", epoch=lsn_epoch(rec.lsn),
                           lsn=rec.lsn, members=sorted(meta[2]),
                           superseded=True)
                return
            self.log(f"retired from cohort (members now {members})")
            if self.role in (Role.LEADER, Role.TAKEOVER):
                # abdicate cleanly so the cohort elects without waiting
                # out our session
                try:
                    self.zk.delete(f"{self.base}/leader")
                except NoNode:
                    pass
            ranges_mod.set_range_meta(self.zk, self.rid, self.range.lo,
                                      self.range.hi, members)
            self.node.cluster.on_range_table_changed()
            self.node.retire_replica(self.rid)
            return
        new_peers = tuple(sorted(m for m in members if m != me))
        removed = set(self.peers) - set(new_peers)
        added = set(new_peers) - set(self.peers)
        self.peers = new_peers
        self.log(f"member change applied: members={members}")
        if self.role in (Role.LEADER, Role.TAKEOVER):
            for r in removed:
                self.insync.discard(r)
                self.acked.pop(r, None)
            for a in added:
                self.acked.setdefault(a, 0)
            ranges_mod.set_range_meta(self.zk, self.rid, self.range.lo,
                                      self.range.hi, members)
            self.node.cluster.on_range_table_changed()
            self._watch_peer_sessions()
            # the quorum size may have shrunk (commit can advance) and the
            # migration may have its next phase due; both re-enter the
            # commit path, so run them after this apply sweep finishes
            self.node.sim.schedule(0.0, self._advance_commit)
            self.node.sim.schedule(0.0, self._check_migration)

    # --- periodic async commit messages (§5) -----------------------------------
    def _arm_commit_timer(self) -> None:
        if self._commit_timer is not None:
            self._commit_timer.cancel()
        self._commit_timer = self.node.sim.schedule(
            self.cfg.commit_period, self._commit_tick)

    _IDLE_REBCAST_TICKS = 20   # slow keepalive so a dropped broadcast heals

    def _commit_tick(self) -> None:
        if self.role not in (Role.LEADER, Role.TAKEOVER):
            return
        if self.cmt != self._last_commit_bcast:
            # progress: persist the marker, and broadcast unless the
            # watermark already piggybacked on a proposal batch to every
            # insync follower (then the dedicated message is pure overhead)
            self._last_commit_bcast = self.cmt
            self._idle_ticks = 0
            self.node.wal.append(CommitMarker(self.rid, self.cmt), force=False)
            if self._piggy_sent < self.cmt:
                for f in self.insync:
                    self._send_batched(f, "on_commit", epoch=self.epoch,
                                       commit_lsn=self.cmt, nbytes=96)
        else:
            # idle range: skip the marker append and the broadcast, except
            # for a slow keepalive rebroadcast (messages only, no append) so
            # a follower that missed the single progress broadcast — e.g.
            # through a brief partition — still converges
            self._idle_ticks += 1
            if self._idle_ticks >= self._IDLE_REBCAST_TICKS:
                self._idle_ticks = 0
                for f in self.insync:
                    self._send_batched(f, "on_commit", epoch=self.epoch,
                                       commit_lsn=self.cmt, nbytes=96)
        self._check_migration()   # heartbeat-paced migration resume
        self._arm_commit_timer()

    _idle_ticks = 0

    def on_commit(self, epoch: int, commit_lsn: int) -> None:
        if self.role is not Role.FOLLOWER or epoch != self.epoch:
            return
        self._leader_seen = self.node.sim.now
        before = self.cmt
        self._apply_committed(min(commit_lsn, self.lst))
        if self.cmt > before:
            # persist only actual progress; a duplicate broadcast must not
            # re-append an identical marker
            self.node.wal.append(CommitMarker(self.rid, self.cmt), force=False)

    # ===================================================== reads (§3, §5)
    def _read_gate(self, consistent: bool) -> Optional[Result]:
        """Role/session gate shared by single and batched reads."""
        if consistent:
            # strong reads are served only by a live leader (§5)
            if self.role is not Role.LEADER or not self.node.has_session():
                return Result(ErrorCode.NOT_LEADER,
                              leader_hint=self.leader_id)
        else:
            # timeline reads: any replica with a recovered store (§8.1 —
            # available with just 1 node up)
            if self.role is Role.OFFLINE:
                return Result(ErrorCode.UNAVAILABLE)
        return None

    def _read_one(self, key: str, colname: str, consistent: bool,
                  reply: Callable) -> None:
        if not self.range.contains(key):
            # the key moved to a child range (split narrowed this range);
            # the client must refresh its range table.  A merely *pending*
            # split does not gate reads — the data is still here and the
            # barrier only has to keep writes from landing above it.
            self._minc("wrong_range_replies")
            reply(Result(ErrorCode.WRONG_RANGE))
            return
        if consistent:
            owner = self.txn.lock_owner(key)
            if owner is not None:
                # mid-2PC key: defer until the transaction resolves so a
                # strong read never observes in-doubt state (readers hold
                # no locks, so waiting cannot deadlock)
                self.txn.defer_read(owner, key, colname, reply)
                return
        self.reads_served += 1
        self._heat()
        # Store.get contract: deletes surface as tombstone cells, not None
        # — report NOT_FOUND but keep the tombstone's version so clients
        # can conditional-put over a deleted key
        cell = self.store.get(key, colname)
        assert cell is None or not (cell.deleted and cell.value is not None)
        if cell is None or cell.deleted:
            reply(Result(ErrorCode.NOT_FOUND,
                         version=cell.version if cell else 0))
        else:
            reply(Result(ErrorCode.OK, value=cell.value, version=cell.version))

    def client_read(self, key: str, colname: str, consistent: bool,
                    reply: Callable) -> None:
        gate = self._read_gate(consistent)
        if gate is not None:
            reply(gate)
            return
        if consistent and not self.lease_valid():
            # no (valid) lease: fall back to a read-index round — confirm
            # with a follower majority that this regime still stands, then
            # read locally.  With a lease the round trip is skipped entirely
            self._confirm_leadership(
                lambda ok: self._read_one(key, colname, consistent, reply)
                if ok and self.role is Role.LEADER
                else reply(Result(ErrorCode.NOT_LEADER,
                                  leader_hint=self.leader_id)))
            return
        self._read_one(key, colname, consistent, reply)

    def client_multi_read(self, pairs: list[tuple[str, str]],
                          consistent: bool, reply: Callable) -> None:
        """Batched read service: one message covers every (key, colname)
        this range serves for a client `multi_get` — the read-side
        analogue of proposal batching (per-message CPU overhead is paid
        once for the batch).  Replies with an ordered list of Results;
        a single Result means a whole-batch gate failure (retry/redirect).
        Individual deferred reads (2PC locks) hold only their own slot."""
        gate = self._read_gate(consistent)
        if gate is not None:
            reply(gate)
            return
        if consistent and not self.lease_valid():
            self._confirm_leadership(
                lambda ok: self._serve_multi_read(pairs, consistent, reply)
                if ok and self.role is Role.LEADER
                else reply(Result(ErrorCode.NOT_LEADER,
                                  leader_hint=self.leader_id)))
            return
        self._serve_multi_read(pairs, consistent, reply)

    def _serve_multi_read(self, pairs: list[tuple[str, str]],
                          consistent: bool, reply: Callable) -> None:
        results: list[Optional[Result]] = [None] * len(pairs)
        pending = [len(pairs)]

        def one(i: int) -> Callable:
            def got(res: Result) -> None:
                results[i] = res
                pending[0] -= 1
                if pending[0] == 0:
                    reply(results)
            return got

        for i, (key, colname) in enumerate(pairs):
            self._read_one(key, colname, consistent, one(i))

    # ================================== cross-range 2PC (core/txn.py)
    def client_txn2(self, groups: dict, reply: Callable,
                    trace=None) -> None:
        self.txn.client_txn2(groups, reply, trace=trace)

    def on_txn_prepare(self, txid: str, coord_rid: int, ops: list) -> None:
        self.txn.on_txn_prepare(txid, coord_rid, ops)

    def on_txn_vote(self, txid: str, prid: int, ok: bool, versions,
                    reason: str) -> None:
        self.txn.on_txn_vote(txid, prid, ok, versions, reason)

    def on_txn_decide(self, txid: str, coord_rid: int, commit: bool) -> None:
        self.txn.on_txn_decide(txid, coord_rid, commit)

    def on_txn_decided_ack(self, txid: str, prid: int) -> None:
        self.txn.on_txn_decided_ack(txid, prid)
