"""Cross-range transactions: a Paxos-backed 2PC coordinator with
per-range lock tables and log-based recovery.

The paper's §8.2 transactions are single-cohort (one Paxos round, no
locks).  This module layers classic two-phase commit over the per-range
Paxos cohorts so a transaction can span ranges, with one structural rule:
**every 2PC state transition is made durable by proposing it through the
participant's existing replication pipeline**.  Nothing about 2PC lives
outside the logs and the coordination service, so every failover inherits
exactly the state it needs:

- **PREPARE** (participant leader): validate conditionals, acquire
  per-key entries in a leader-side lock table, and log-commit a
  ``TXN_PREPARE`` record carrying the staged writes (values + versions
  assigned at prepare time, so all replicas stage identical state).  The
  YES vote is sent only once the record commits — a follower promoted
  mid-transaction replays the record and inherits both the locks and the
  staged writes from its log.

- **DECIDE** (coordinator = leader of the first participant range): on a
  full set of YES votes it log-commits a ``TXN_DECISION`` record in its
  own range's log — that commit is the transaction's commit point and
  the client is acked when it applies.  Abort decisions are *not* logged
  (presumed abort): an intent znode ``/txn/<txid>`` written before any
  prepare is the only trace, and a freshly elected leader of the
  coordinator range resolves every intent unaided — decision in the log
  ⇒ re-drive the commit; no decision ⇒ abort.

- **COMMIT/ABORT** (participant leader): log-committed ``TXN_COMMIT`` /
  ``TXN_ABORT`` records.  Applying a commit installs the staged writes
  into the store atomically (one record, one apply sweep — strong and
  timeline reads never observe a torn prefix within a range) and
  releases the locks on every replica at the same log position.

Concurrency control is **no-wait**: a write or prepare that hits a held
lock is refused immediately (``ErrorCode.LOCKED`` / a NO vote) instead of
queueing, which makes deadlock impossible by construction — the client's
jittered backoff breaks livelock symmetry.  Strong reads of a locked key
*defer* until the lock resolves (readers hold nothing, so waiting is
safe) which keeps in-doubt data invisible; timeline reads serve the last
committed state without waiting.

Log GC is the one part of the substrate that must cooperate: an
unresolved prepare (or a decision not yet acked by every participant)
pins a per-range GC floor in the WAL so the records a promoted leader
needs are never rolled away, and snapshot catch-up ships the same records
alongside SSTable data (`catchup_extras`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, TYPE_CHECKING

from .coordination import NoNode, NodeExists
from .types import ErrorCode, LogRecord, OpType, Result, WriteOp

if TYPE_CHECKING:
    from .replica import CohortReplica

TXN_ROOT = "/txn"


def intent_path(txid: str) -> str:
    return f"{TXN_ROOT}/{txid}"


@dataclass
class PreparedTxn:
    """Participant-side prepared state, reconstructible from the log."""
    txid: str
    coord_rid: int
    record: LogRecord      # the TXN_PREPARE record (re-shipped on catch-up)
    staged: tuple          # ((key, ((colname, value, version), ...)), ...)
    committed: bool = False  # record quorum-committed (vs merely proposed)

    @property
    def keys(self) -> tuple[str, ...]:
        return tuple(k for k, _cols in self.staged)

    @property
    def versions(self) -> tuple[tuple[str, str, int], ...]:
        return tuple((k, c, v) for k, cols in self.staged for c, _val, v in cols)


@dataclass
class _Coord:
    """One in-flight coordinator instance (volatile; an instance lost to a
    crash is resolved from the intent znode + the decision log instead)."""
    txid: str
    groups: dict                      # rid -> list[WriteOp]
    reply: Optional[Callable]
    t0: float
    state: str = "preparing"          # preparing | deciding
    votes: dict = field(default_factory=dict)   # rid -> versions tuple
    trace: Any = None                 # client OpTrace riding this txn


class TxnManager:
    """Per-replica transaction state machine: participant lock table and
    prepared set, plus the coordinator role when this replica's leader
    coordinates (the leader of a transaction's first participant range).
    Wired into CohortReplica's lifecycle/apply hooks."""

    def __init__(self, rep: "CohortReplica"):
        self.rep = rep
        # participant state
        self.locks: dict[str, str] = {}            # key -> owning txid
        self.prepared: dict[str, PreparedTxn] = {}
        self.resolved: dict[str, tuple[str, int]] = {}  # txid -> (outcome, coord_rid)
        self.deciding: set[str] = set()            # TXN_COMMIT/ABORT in flight
        self.deferred: dict[str, list[tuple]] = {}  # txid -> [(key, col, reply, t0)]
        # coordinator state
        self.active: dict[str, _Coord] = {}
        self.decided: dict[str, tuple[str, tuple[int, ...]]] = {}
        self.unacked: dict[str, set[int]] = {}
        self._decision_rec: dict[str, LogRecord] = {}
        self._next_txn = 0
        self._timer = None
        # stats
        self.prepares = 0
        self.commits = 0
        self.aborts = 0
        self.votes_no = 0
        self.lock_conflicts = 0
        self.reads_deferred = 0

    @property
    def tracer(self):
        return self.rep.obs.tracer

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Fresh replica start: all volatile state dropped; `recover`
        rebuilds the durable part from the log scan."""
        self._cancel_timer()
        self.locks.clear()
        self.prepared.clear()
        self.resolved.clear()
        self.deciding.clear()
        self.deferred.clear()
        self.active.clear()
        self.decided.clear()
        self.unacked.clear()
        self._decision_rec.clear()

    def stop(self) -> None:
        self._cancel_timer()
        self._fail_deferred()

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def recover(self, records: list[LogRecord], cmt: int,
                flushed: int) -> None:
        """Rebuild prepared/decided state from the committed log prefix
        (start()'s recovery scan).  A commit whose effects already reached
        SSTables (lsn <= flushed) only resolves bookkeeping — re-applying
        staged cells to the memtable would be redundant but harmless."""
        for rec in sorted((r for r in records if r.txn is not None
                           and r.lsn <= cmt), key=lambda r: r.lsn):
            if rec.op is OpType.TXN_PREPARE:
                txid, coord_rid, staged = rec.txn
                p = PreparedTxn(txid, coord_rid, rec, staged, committed=True)
                self.prepared[txid] = p
                for k in p.keys:
                    self.locks[k] = txid
            elif rec.op in (OpType.TXN_COMMIT, OpType.TXN_ABORT):
                self._resolve(rec, apply_staged=rec.lsn > flushed)
            elif rec.op is OpType.TXN_DECISION:
                txid, outcome, participants = rec.txn
                self.decided[txid] = (outcome, participants)
                self._decision_rec[txid] = rec
        self._set_gc_floor()

    def stage_from_record(self, rec: LogRecord) -> None:
        """Takeover rebuild: a not-yet-committed TXN record sits in the
        unresolved queue — restore the gating state it implies (locks for
        prepares, in-flight flags for decisions) before reopening."""
        if rec.op is OpType.TXN_PREPARE:
            txid, coord_rid, staged = rec.txn
            if txid not in self.prepared:
                self.prepared[txid] = PreparedTxn(txid, coord_rid, rec, staged)
            for k in self.prepared[txid].keys:
                self.locks[k] = txid
        elif rec.op in (OpType.TXN_COMMIT, OpType.TXN_ABORT):
            self.deciding.add(rec.txn[0])
        self._set_gc_floor()

    def on_leader_open(self) -> None:
        """The replica just opened for writes as leader: resume coordinator
        duties (presumed-abort orphan intents, re-drive logged decisions —
        resend duty is leader-only bookkeeping, rebuilt here from the
        surviving intents) and re-vote any in-doubt prepared txns."""
        rep = self.rep
        for name, (data, _cz) in rep.zk.get_children(TXN_ROOT).items():
            coord_rid, participants = data
            if coord_rid != rep.rid:
                continue
            if name in self.active or self._queued_decision(name):
                continue
            if name in self.decided:
                # logged decision with a live intent: some participant has
                # not acked yet — adopt the resend duty (the tick drives it)
                self.unacked.setdefault(name, set(participants))
                continue
            # intent with no logged decision: presumed abort (§ module doc)
            rep.log(f"txn {name}: presumed abort (intent without decision)")
            rep.obs.events.emit("txn_presumed_abort", txid=name,
                                rid=rep.rid, node=rep.node.node_id)
            rep._jrec("txn_decide", epoch=rep.epoch, txid=name,
                      outcome="abort", reason="presumed_abort")
            self.tracer.txn_mark(name, "abort")
            self.aborts += 1
            for rid in participants:
                self._send_decide(name, rid, commit=False)
            try:
                rep.zk.delete(intent_path(name))
            except NoNode:
                pass
        self._set_gc_floor()
        self._arm()

    def on_step_down(self) -> None:
        """Leader demoted: fail volatile coordinator instances (clients
        retry; undecided ⇒ the next leader presume-aborts the intent) and
        deferred reads.  Prepared state is NOT dropped — it is log-backed
        and this replica keeps maintaining it as a follower."""
        self._cancel_timer()
        for inst in list(self.active.values()):
            if inst.reply is not None:
                inst.reply(Result(ErrorCode.UNAVAILABLE))
        self.active.clear()
        self._fail_deferred()

    def drop_uncommitted(self) -> None:
        """Regime change truncated the unresolved queue tail: any prepare
        that was only *proposed* no longer gates anything (if it was in
        fact durable on a quorum the new regime re-delivers it).  Resend
        duty (`unacked`) belongs to whoever leads now, not to a joining
        follower — dropping it also releases this node's decision GC pins
        so follower logs keep rolling over."""
        for txid in [t for t, p in self.prepared.items() if not p.committed]:
            p = self.prepared.pop(txid)
            self._release_locks(p)
            self._flush_deferred(txid)
        self.deciding.clear()
        self.unacked.clear()
        self._set_gc_floor()

    def _fail_deferred(self) -> None:
        for waiters in list(self.deferred.values()):
            for _key, _col, reply, t0 in waiters:
                self._note_lock_wait(t0)
                reply(Result(ErrorCode.NOT_LEADER,
                             leader_hint=self.rep.leader_id))
        self.deferred.clear()

    # ---------------------------------------------------------- lock table
    def lock_owner(self, key: str) -> Optional[str]:
        return self.locks.get(key)

    def lock_conflict(self, keys, txid: Optional[str] = None) -> bool:
        return any(self.locks.get(k) not in (None, txid) for k in keys)

    def has_participant_state(self) -> bool:
        """Gate for range ops: a SPLIT barrier must not detach keys with
        staged-but-unresolved writes attached to them."""
        return bool(self.prepared)

    def defer_read(self, txid: str, key: str, colname: str,
                   reply: Callable) -> None:
        self.reads_deferred += 1
        self.deferred.setdefault(txid, []).append(
            (key, colname, reply, self.rep.node.sim.now))

    def _note_lock_wait(self, t0: float) -> None:
        """Account how long a strong read waited on an in-doubt 2PC key —
        the lock-wait dimension of the range's heat."""
        rep = self.rep
        wait = rep.node.sim.now - t0
        prof = rep.obs.profiler
        if prof.enabled:
            prof.lock_wait(rep.rid, wait)
        rep.obs.metrics.observe(rep.node.node_id, "lock_wait_s", wait)

    def _flush_deferred(self, txid: str) -> None:
        for key, colname, reply, t0 in self.deferred.pop(txid, []):
            self._note_lock_wait(t0)
            self.rep._read_one(key, colname, True, reply)

    def _release_locks(self, p: PreparedTxn) -> None:
        for k in p.keys:
            if self.locks.get(k) == p.txid:
                del self.locks[k]

    # --------------------------------------------------- participant: 2PC
    def on_txn_prepare(self, txid: str, coord_rid: int,
                       ops: list[WriteOp]) -> None:
        from .replica import Role
        rep = self.rep
        if rep.role is not Role.LEADER or not rep.open_for_writes \
                or not rep.node.has_session():
            self._vote(coord_rid, txid, ok=False, reason="not_leader")
            return
        if txid in self.prepared or txid in self.resolved:
            return  # duplicate; the commit-time vote / re-vote tick covers it
        if not all(rep._owns(op.key) for op in ops):
            self._vote(coord_rid, txid, ok=False, reason="wrong_range")
            return
        keys = {op.key for op in ops}
        if self.lock_conflict(keys):
            self.lock_conflicts += 1
            self._vote(coord_rid, txid, ok=False, reason="locked")
            return
        # validate conditionals and assign versions against the latest
        # *proposed* state (mirrors client_write §5.1 pipelining), staging
        # the final per-(key, col) cells; within the txn later ops see
        # earlier ones
        staged_cells: dict[tuple[str, str], tuple[Any, int]] = {}
        for op in ops:
            cur = staged_cells.get((op.key, op.colname), (None, None))[1]
            if cur is None:
                cur = rep.proposed_version.get((op.key, op.colname))
            if cur is None:
                cur = rep.store.current_version(op.key, op.colname)
            if op.is_conditional and op.expected_version != cur:
                self._vote(coord_rid, txid, ok=False,
                           reason="version_mismatch")
                return
            if op.op == OpType.MULTI_PUT:
                for c, v in (op.columns or ()):
                    base = staged_cells.get((op.key, c), (None, None))[1]
                    if base is None:
                        base = rep.proposed_version.get((op.key, c))
                    if base is None:
                        base = rep.store.current_version(op.key, c)
                    staged_cells[(op.key, c)] = (v, base + 1)
            elif op.op in (OpType.DELETE, OpType.COND_DELETE):
                staged_cells[(op.key, op.colname)] = (None, cur + 1)
            else:
                staged_cells[(op.key, op.colname)] = (op.value, cur + 1)
        by_key: dict[str, list[tuple[str, Any, int]]] = {}
        for (key, col), (val, ver) in staged_cells.items():
            by_key.setdefault(key, []).append((col, val, ver))
        staged = tuple((key, tuple(cols)) for key, cols in by_key.items())
        rec = rep.propose_record(OpType.TXN_PREPARE, txid,
                                 txn=(txid, coord_rid, staged))
        rep._jrec("txn_prepare", epoch=rep.epoch, lsn=rec.lsn, txid=txid,
                  coord=coord_rid)
        p = PreparedTxn(txid, coord_rid, rec, staged)
        self.prepared[txid] = p
        for k in p.keys:
            self.locks[k] = txid
        self.prepares += 1
        self._set_gc_floor()
        self._arm()

    def apply_record(self, rec: LogRecord) -> None:
        """A committed TXN record reached `_apply_committed` — runs on
        every replica at the same log position."""
        from .replica import Role
        rep = self.rep
        leaderish = rep.role in (Role.LEADER, Role.TAKEOVER)
        if rec.op is OpType.TXN_PREPARE:
            txid, coord_rid, staged = rec.txn
            p = self.prepared.get(txid)
            if p is None:
                p = PreparedTxn(txid, coord_rid, rec, staged)
                self.prepared[txid] = p
            p.committed = True
            for k in p.keys:
                self.locks[k] = txid
            rep._jrec("txn_prepared", epoch=rep.epoch, lsn=rec.lsn,
                      txid=txid)
            self._set_gc_floor()
            if leaderish and txid not in self.resolved \
                    and txid not in self.deciding:
                self._vote(coord_rid, txid, ok=True, versions=p.versions)
            self._arm()
        elif rec.op in (OpType.TXN_COMMIT, OpType.TXN_ABORT):
            self._resolve(rec, apply_staged=True)
            if leaderish:
                txid = rec.txn[0]
                self._ack_decided(txid)
        elif rec.op is OpType.TXN_DECISION:
            self._apply_decision(rec)

    def _resolve(self, rec: LogRecord, apply_staged: bool) -> None:
        """Apply a committed TXN_COMMIT/TXN_ABORT: install staged writes
        (commit) atomically, release locks, wake deferred readers."""
        txid = rec.txn[0]
        commit = rec.op is OpType.TXN_COMMIT
        self.tracer.txn_mark(txid, "resolve", self.rep.rid)
        self.rep._jrec("txn_resolve", epoch=self.rep.epoch, lsn=rec.lsn,
                       txid=txid, outcome="commit" if commit else "abort")
        self.deciding.discard(txid)
        p = self.prepared.pop(txid, None)
        if p is not None:
            self.resolved[txid] = ("commit" if commit else "abort",
                                   p.coord_rid)
            if commit:
                if apply_staged:
                    for key, cols in p.staged:
                        self.rep.store.apply(
                            LogRecord(self.rep.rid, rec.lsn, OpType.PUT, key,
                                      tuple(cols)))
                # the staged versions just advanced the store PAST any
                # `proposed_version` high-water mark left by earlier normal
                # writes; a stale lower entry would shadow the true version
                # forever (failing every later CAS, and letting
                # _bump_version mint duplicate versions).  The lock held
                # since prepare admission guarantees no newer proposal put
                # a higher entry there, so dropping is always correct.
                for key, cols in p.staged:
                    for colname, _val, _ver in cols:
                        self.rep.proposed_version.pop((key, colname), None)
            self._release_locks(p)
            if commit:
                self.commits += 1
            else:
                self.aborts += 1
        self._flush_deferred(txid)
        self._set_gc_floor()
        self._prune_done()

    def on_txn_decide(self, txid: str, coord_rid: int, commit: bool) -> None:
        from .replica import Role
        rep = self.rep
        if txid in self.resolved:
            self._ack_decided(txid)     # duplicate decide: re-ack only
            return
        if txid in self.deciding:
            return                      # resolution already proposed
        p = self.prepared.get(txid)
        if p is None:
            # never prepared here (abort raced the prepare, or long-resolved
            # state was GC'd after SSTable flush): nothing to undo — ack so
            # the coordinator can retire the intent
            self._ack_to(coord_rid, txid)
            return
        if rep.role is not Role.LEADER or not rep.open_for_writes \
                or not rep.node.has_session():
            return  # the coordinator re-sends to the actual leader
        self.deciding.add(txid)
        rep.propose_record(OpType.TXN_COMMIT if commit else OpType.TXN_ABORT,
                           txid, txn=(txid,))

    def _vote(self, coord_rid: int, txid: str, ok: bool, versions=(),
              reason: str = "") -> None:
        if not ok:
            self.votes_no += 1
        leader = self._leader_of(coord_rid)
        if leader is None:
            return      # re-vote tick (or prepare timeout) covers it
        self.rep._jrec("txn_vote", epoch=self.rep.epoch, txid=txid,
                       vote="yes" if ok else "no", reason=reason)
        self.rep.node.send(leader, coord_rid, "on_txn_vote",
                           nbytes=128 + 24 * len(versions), txid=txid,
                           prid=self.rep.rid, ok=ok,
                           versions=tuple(versions), reason=reason)

    def _ack_decided(self, txid: str) -> None:
        res = self.resolved.get(txid)
        if res is not None:
            self._ack_to(res[1], txid)

    def _ack_to(self, coord_rid: int, txid: str) -> None:
        leader = self._leader_of(coord_rid)
        if leader is None:
            return      # the coordinator's resend tick will retry us
        self.rep.node.send(leader, coord_rid, "on_txn_decided_ack",
                           nbytes=96, txid=txid, prid=self.rep.rid)

    # --------------------------------------------------- coordinator side
    def client_txn2(self, groups: dict[int, list[WriteOp]],
                    reply: Callable, trace=None) -> None:
        """Entry point for a multi-range transaction: this replica's
        leader (first participant range) coordinates."""
        from .replica import Role
        rep = self.rep
        if trace is not None:
            trace.t_cpu = rep.node.sim.now
        if rep.role is not Role.LEADER or not rep.node.has_session():
            reply(Result(ErrorCode.NOT_LEADER, leader_hint=rep.leader_id))
            return
        if not rep.open_for_writes:
            reply(Result(ErrorCode.UNAVAILABLE))
            return
        self._next_txn += 1
        txid = f"x{rep.rid}.{rep.epoch}.{self._next_txn}"
        try:
            # durable intent BEFORE any prepare can exist: recovery always
            # finds either this znode or nothing at all
            rep.zk.create(intent_path(txid),
                          data=(rep.rid, tuple(sorted(groups))))
        except NodeExists:
            reply(Result(ErrorCode.UNAVAILABLE))
            return
        inst = _Coord(txid, dict(groups), reply, rep.node.sim.now,
                      trace=trace)
        self.active[txid] = inst
        self.tracer.txn_begin(txid, rep.rid, sorted(groups))
        for rid, ops in groups.items():
            self._send_prepare(inst, rid, ops)
        self._arm()

    def _send_prepare(self, inst: _Coord, rid: int,
                      ops: list[WriteOp]) -> None:
        leader = self._leader_of(rid)
        if leader is None:
            return      # no leader right now: the prepare timeout aborts
        nbytes = 128 + sum(64 + len(op.key) for op in ops)
        self.tracer.txn_mark(inst.txid, "prepare_sent", rid)
        # batched per (coordinator, participant) node pair: prepares staged
        # in the same event (several ranges led by one node, or concurrent
        # transactions deciding together) share one wire message
        self.rep.node.send_batched(leader, rid, "on_txn_prepare",
                                   nbytes=nbytes, txid=inst.txid,
                                   coord_rid=self.rep.rid, ops=list(ops))

    def on_txn_vote(self, txid: str, prid: int, ok: bool, versions,
                    reason: str) -> None:
        from .replica import Role
        rep = self.rep
        if rep.role is not Role.LEADER or not rep.open_for_writes:
            return      # participants re-vote once a leader is open
        inst = self.active.get(txid)
        if inst is None:
            dec = self.decided.get(txid)
            if dec is not None:
                self._send_decide(txid, prid, commit=dec[0] == "commit")
            elif not self._queued_decision(txid):
                # unknown and undecided ⇒ it aborted (presumed abort)
                rep._jrec("txn_decide", epoch=rep.epoch, txid=txid,
                          outcome="abort", reason="presumed_abort")
                self._send_decide(txid, prid, commit=False)
            return
        if inst.state != "preparing":
            return
        if not ok:
            self._abort(inst, reason)
            return
        inst.votes[prid] = tuple(versions)
        self.tracer.txn_mark(txid, "vote", prid)
        if set(inst.votes) >= set(inst.groups):
            # all YES: log the decision — its commit IS the commit point
            inst.state = "deciding"
            rep._jrec("txn_decide", epoch=rep.epoch, txid=txid,
                      outcome="commit")
            # the decision record's force/commit milestones ARE the client
            # op's: the replica's batch instrumentation stamps
            # t_flush/t_forced/t_commit on the riding trace
            rep.propose_record(
                OpType.TXN_DECISION, txid,
                txn=(txid, "commit", tuple(sorted(inst.groups))),
                trace=inst.trace)

    def _apply_decision(self, rec: LogRecord) -> None:
        """A committed TXN_DECISION: registered on every replica of the
        coordinator range so any future leader can re-drive the commit."""
        from .replica import Role
        rep = self.rep
        txid, outcome, participants = rec.txn
        self.decided[txid] = (outcome, participants)
        self._decision_rec[txid] = rec
        rep._jrec("txn_decision", epoch=rep.epoch, lsn=rec.lsn, txid=txid,
                  outcome=outcome)
        self.tracer.txn_mark(txid, outcome)
        if rep.role in (Role.LEADER, Role.TAKEOVER):
            # resend duty is leader-only: followers never receive acks, so
            # tracking unacked there would never drain.  A promoted
            # follower rebuilds it from the intent znodes in
            # on_leader_open; the GC pin below is intent-scoped, so it
            # releases on followers too once the transaction completes.
            self.unacked[txid] = set(participants)
            inst = self.active.pop(txid, None)
            if inst is not None and inst.reply is not None:
                merged = tuple(v for vs in inst.votes.values() for v in vs)
                self.tracer.txn_mark(txid, "client_ack")
                inst.reply(Result(ErrorCode.OK, value=merged))
            for rid in sorted(participants):
                self._send_decide(txid, rid, commit=outcome == "commit")
        self._set_gc_floor()
        self._prune_done()
        self._arm()

    def _abort(self, inst: _Coord, reason: str) -> None:
        """Presumed abort: nothing logged — drop the intent, notify
        participants, bounce the client with a retryable/terminal code."""
        self.active.pop(inst.txid, None)
        self.aborts += 1
        self.rep._jrec("txn_decide", epoch=self.rep.epoch, txid=inst.txid,
                       outcome="abort", reason=reason)
        self.tracer.txn_mark(inst.txid, "abort")
        for rid in sorted(inst.groups):
            self._send_decide(inst.txid, rid, commit=False)
        try:
            self.rep.zk.delete(intent_path(inst.txid))
        except NoNode:
            pass
        code = {"version_mismatch": ErrorCode.VERSION_MISMATCH,
                "wrong_range": ErrorCode.WRONG_RANGE,
                "locked": ErrorCode.LOCKED}.get(reason, ErrorCode.UNAVAILABLE)
        if inst.reply is not None:
            inst.reply(Result(code))

    def _send_decide(self, txid: str, rid: int, commit: bool) -> None:
        leader = self._leader_of(rid)
        if leader is None:
            return      # resend tick retries while the intent survives
        # decides fan out to every participant the instant the decision
        # commits: participants led by the same node share one envelope
        self.rep.node.send_batched(leader, rid, "on_txn_decide", nbytes=96,
                                   txid=txid, coord_rid=self.rep.rid,
                                   commit=commit)

    def on_txn_decided_ack(self, txid: str, prid: int) -> None:
        pending = self.unacked.get(txid)
        if pending is None:
            return
        pending.discard(prid)
        if not pending:
            del self.unacked[txid]
            self._decision_rec.pop(txid, None)
            try:
                self.rep.zk.delete(intent_path(txid))
            except NoNode:
                pass
            self._set_gc_floor()

    def _queued_decision(self, txid: str) -> bool:
        return any(r.op is OpType.TXN_DECISION and r.txn[0] == txid
                   for r in self.rep.queue.values())

    def _leader_of(self, rid: int) -> Optional[int]:
        try:
            leader_id, _epoch = self.rep.zk.get(f"/ranges/{rid}/leader")
            return leader_id
        except NoNode:
            return None

    # ------------------------------------------------------- resolution tick
    def _arm(self) -> None:
        from .replica import Role
        if self._timer is None \
                and self.rep.role in (Role.LEADER, Role.TAKEOVER):
            self._timer = self.rep.node.sim.schedule(
                self.rep.cfg.txn_tick, self._tick)

    def _tick(self) -> None:
        from .replica import Role
        self._timer = None
        rep = self.rep
        if rep.role is not Role.LEADER or not rep.node.has_session():
            return      # re-armed by on_leader_open / apply hooks
        now = rep.node.sim.now
        # coordinator: time out stuck prepares, re-drive unacked decisions
        for inst in list(self.active.values()):
            if inst.state == "preparing" \
                    and now - inst.t0 > rep.cfg.txn_prepare_timeout:
                self._abort(inst, "timeout")
        for txid, pending in list(self.unacked.items()):
            dec = self.decided.get(txid)
            if dec is None:
                continue
            for rid in sorted(pending):
                self._send_decide(txid, rid, commit=dec[0] == "commit")
        # participant: re-vote in-doubt prepared txns (covers promoted
        # leaders whose original vote died with the old regime)
        if rep.open_for_writes:
            for txid, p in list(self.prepared.items()):
                if p.committed and txid not in self.deciding:
                    self._vote(p.coord_rid, txid, ok=True,
                               versions=p.versions)
        if self.active or self.unacked or self.prepared:
            self._arm()

    # --------------------------------------------------- log-GC cooperation
    _MAX_DONE = 4096   # cap on retained per-txn outcome bookkeeping

    def _set_gc_floor(self) -> None:
        """Pin the WAL GC floor at the lowest LSN 2PC recovery still needs:
        unresolved prepares, and decisions whose transaction has not
        completed (intent znode still present — the intent scopes the pin,
        so follower replicas release it too once every participant acked,
        and the sweep below keeps `_decision_rec` bounded by the number of
        in-flight transactions)."""
        zk = self.rep.zk
        for txid in [t for t in self._decision_rec
                     if t not in self.unacked
                     and not zk.exists(intent_path(t))]:
            del self._decision_rec[txid]
        lsns = [p.record.lsn for p in self.prepared.values()]
        lsns += [r.lsn for r in self._decision_rec.values()]
        floor = min(lsns) if lsns else None
        if floor != self._last_pin:
            # journal every floor *move* — the WAL's own gc_floor_pin /
            # gc_floor_release events fire only on the none<->some edges
            rep = self.rep
            if floor is None:
                rep._jrec("txn_unpin", epoch=rep.epoch)
            else:
                rep._jrec("txn_pin", epoch=rep.epoch, lsn=floor,
                          n_prepared=len(self.prepared),
                          n_decisions=len(self._decision_rec))
            self._last_pin = floor
        self.rep.node.wal.set_gc_floor(self.rep.rid, floor)

    _last_pin: Optional[int] = None

    def _prune_done(self) -> None:
        """Bound the per-transaction outcome maps.  `resolved` entries
        beyond the cap drop oldest-first (a duplicate decide for a
        forgotten txid is acked regardless); `decided` entries drop only
        once their intent is gone — while an intent lives, the outcome
        must survive for in-doubt resolution."""
        if len(self.resolved) > self._MAX_DONE:
            for txid in list(self.resolved)[:len(self.resolved)
                                            - self._MAX_DONE]:
                del self.resolved[txid]
        if len(self.decided) > self._MAX_DONE:
            excess = len(self.decided) - self._MAX_DONE
            zk = self.rep.zk
            for txid in list(self.decided):
                if excess <= 0:
                    break
                if txid in self.unacked or zk.exists(intent_path(txid)):
                    continue
                del self.decided[txid]
                self._decision_rec.pop(txid, None)
                excess -= 1

    def catchup_extras(self, upto: int) -> list[LogRecord]:
        """TXN records a snapshot-fed follower (SSTable catch-up path)
        must still receive: committed-but-unresolved prepares and
        uncompleted decisions, which carry state that data cells cannot
        (`_decision_rec` holds exactly the live-intent ones)."""
        recs = [p.record for p in self.prepared.values()
                if p.committed and p.record.lsn <= upto]
        recs += [r for r in self._decision_rec.values() if r.lsn <= upto]
        return sorted(recs, key=lambda r: r.lsn)
