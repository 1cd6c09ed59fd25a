"""Online consensus-invariant watchdog over the protocol journal.

Subscribes to `ProtocolJournal` and checks, on every entry, the
per-range invariants the replication protocol promises (paper §4-§8):

``single_leader_per_epoch``
    At most one node ever takes over a (range, epoch) pair — epochs are
    minted by an atomic counter, so two takeovers with the same epoch
    mean the fencing broke.
``lease_disjoint``
    Leader leases for a range never overlap across nodes: a node may
    not acquire a still-live lease while another node's skew-adjusted
    expiry is in the future (split-brain precursor).
``quorum_intersection``
    Elections are decided by a strict majority of the cohort, and the
    winner carries the maximal last-LSN among the candidates — the
    Paxos condition that makes any two quorums share a voter.
``takeover_completeness``
    A takeover's re-proposal queue covers every durable, never-truncated
    record of the unresolved window (cmt, lst]; a gap (``missing`` > 0)
    is the PR 6 "takeover wedge" — acked records the new regime will
    never re-commit.
``acked_durable``
    A follower's ack watermark never runs ahead of its own
    durable/committed evidence (WAL forces, completed catch-up, applied
    commit index) — an early ack is a durability lie the commit rule
    then counts.
``acked_committed_majority``
    The leader only advances the commit index to an LSN backed by
    durable/committed evidence on a strict majority of the cohort.
``commit_monotonic``
    A replica's applied commit index never regresses while the node
    stays up (crash recovery may lawfully rewind to the durable
    marker).
``log_matching``
    Same (range, lsn) ⇒ same record content on every replica that ever
    appends it (digest comparison; LSNs embed the epoch so a new
    regime can never lawfully reuse one).
``txn_decision_stable``
    A 2PC transaction's outcome never flips: every decision minted,
    applied, or resolved for a txid agrees with the first.
``gc_floor_safe``
    The WAL GC floor never passes — and is never released under — an
    unresolved committed TXN_PREPARE still awaiting its outcome.
``catchup_progress``
    A replica stuck in CATCHUP that keeps hearing leader lease beats
    (so the leader is alive and reachable) must be re-requesting data —
    beats without retries for `catchup_stall_s` is the PR 6 catch-up
    starvation shape.

Violations are structured dicts carrying the invariant name, the
entry that tripped it, a human-readable detail, and the implicated
journal window.  The watchdog is pure measurement: it never touches
the simulator clock or RNG, so enabling it keeps runs bit-identical.
"""

from __future__ import annotations

from typing import Optional

from .journal import ProtocolJournal


class InvariantWatchdog:
    MAX_VIOLATIONS = 1000
    # a session-fenced (flapped/crashed) leader may lawfully re-extend its
    # stale-epoch lease for a moment after the successor's takeover — the
    # renewal raced the followers' epoch switch; epoch fencing plus
    # depose-on-contact make the window unservable, so such claims are
    # exempt from lease_disjoint while the fence is fresh
    LEASE_HANDOFF_S = 5.0

    def __init__(self, journal: Optional[ProtocolJournal] = None,
                 enabled: bool = True,
                 catchup_stall_s: float = 2.0):
        self.enabled = enabled
        self.catchup_stall_s = catchup_stall_s
        self.violations: list[dict] = []
        self.entries_checked = 0
        # per-range protocol state rebuilt from the journal stream
        self._leaders: dict[tuple[int, int], dict] = {}   # (rid,epoch)->entry
        self._leases: dict[tuple[int, int], dict] = {}    # (rid,node)->entry
        self._commit_idx: dict[tuple[int, int], dict] = {}  # (node,rid)->entry
        self._digests: dict[tuple[int, int], dict] = {}   # (rid,lsn)->entry
        # (rid,node) -> highest durable/committed evidence: WAL flushes,
        # completed catch-up, applied commit index, takeover last-LSN.
        # Deliberately NOT fed by acks — acks are the claim under test.
        self._evidence: dict[tuple[int, int], int] = {}
        self._cohort_n: dict[int, int] = {}               # rid -> cohort size
        self._decisions: dict[str, dict] = {}             # txid -> entry
        # (node,rid) -> {txid: prepare lsn} committed-but-unresolved 2PC
        # prepares; uncommitted ones are dropped without a resolve entry
        # and must not pin anything, so only `txn_prepared` feeds this.
        self._prepares: dict[tuple[int, int], dict] = {}
        self._catchup: dict[tuple[int, int], dict] = {}   # (node,rid)->state
        self._regime: dict[int, int] = {}    # rid -> highest takeover epoch
        self._fence: dict[int, float] = {}   # node -> last flap/crash time
        self._fired: set = set()    # dedup key per violation site
        if journal is not None and self.enabled:
            journal.listeners.append(self.observe)

    # -- reporting ----------------------------------------------------------
    def _violate(self, invariant: str, entry: dict, detail: str,
                 window: Optional[list] = None, dedup=None) -> None:
        key = (invariant, dedup) if dedup is not None \
            else (invariant, len(self.violations))
        if key in self._fired:
            return
        self._fired.add(key)
        if len(self.violations) >= self.MAX_VIOLATIONS:
            return
        self.violations.append({
            "t": entry["t"],
            "invariant": invariant,
            "rid": entry.get("rid"),
            "node": entry.get("node"),
            "kind": entry["kind"],
            "detail": detail,
            "window": [dict(e) for e in (window or [entry])],
        })

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> dict:
        by_inv: dict[str, int] = {}
        for v in self.violations:
            by_inv[v["invariant"]] = by_inv.get(v["invariant"], 0) + 1
        return {"ok": self.ok,
                "entries_checked": self.entries_checked,
                "n_violations": len(self.violations),
                "by_invariant": dict(sorted(by_inv.items())),
                "violations": self.violations[:20]}

    @classmethod
    def replay(cls, entries, **kw) -> "InvariantWatchdog":
        """Offline mode: run the same checks over a journal dump
        (`ProtocolJournal.load_jsonl` output or live entries)."""
        wd = cls(None, enabled=True, **kw)
        for e in entries:
            wd.observe(e)
        return wd

    # -- the state machine --------------------------------------------------
    def observe(self, e: dict) -> None:
        if not self.enabled:
            return
        self.entries_checked += 1
        handler = getattr(self, "_on_" + e["kind"], None)
        if handler is not None:
            handler(e)

    def _bump_evidence(self, rid: int, node: int, lsn: int) -> None:
        key = (rid, node)
        if lsn > self._evidence.get(key, 0):
            self._evidence[key] = lsn

    # leadership / elections
    def _on_takeover(self, e: dict) -> None:
        rid, epoch = e["rid"], e["epoch"]
        if "n_cohort" in e:
            self._cohort_n[rid] = e["n_cohort"]
        prev = self._leaders.get((rid, epoch))
        if prev is not None and prev["node"] != e["node"]:
            self._violate(
                "single_leader_per_epoch", e,
                f"range {rid} epoch {epoch}: node {e['node']} took over "
                f"but node {prev['node']} already leads this epoch",
                window=[prev, e], dedup=(rid, epoch))
        else:
            self._leaders[(rid, epoch)] = e
        # the re-proposal queue must cover every durable record of the
        # unresolved window (cmt, lst] — a gap is the takeover wedge
        if e.get("missing", 0) > 0:
            self._violate(
                "takeover_completeness", e,
                f"range {rid} epoch {epoch}: takeover re-proposal queue "
                f"is missing {e['missing']} durable record(s) of the "
                f"unresolved window (cmt {e.get('cmt')}, lst "
                f"{e.get('lst')}] — acked records would be lost or "
                f"wedge the range (takeover wedge)",
                dedup=(rid, epoch, "takeover_gap"))
        # forced_upto jumps to lst at takeover: the local log is durable
        if e.get("lst"):
            self._bump_evidence(rid, e["node"], e["lst"])
        if epoch > self._regime.get(rid, 0):
            self._regime[rid] = epoch
            # a superseded regime whose holder's session provably expired
            # (the lawful election trigger) may still hold a live window;
            # it is fenced, so it no longer counts as a conflicting claim
            for (r, other), prev in list(self._leases.items()):
                if r == rid and prev.get("epoch", epoch) < epoch \
                        and self._fenced(other, e["t"]):
                    del self._leases[(r, other)]

    def _on_elect_decide(self, e: dict) -> None:
        rid = e["rid"]
        n = e.get("n_cohort")
        cands = e.get("candidates") or []
        if n:
            self._cohort_n[rid] = n
            if 2 * len(cands) <= n:
                self._violate(
                    "quorum_intersection", e,
                    f"range {rid}: election decided by {len(cands)} of "
                    f"{n} cohort members — not a strict majority, two "
                    f"such quorums need not intersect",
                    dedup=(rid, e.get("round")))
        w_lst, m_lst = e.get("winner_lst"), e.get("max_lst")
        if w_lst is not None and m_lst is not None and w_lst < m_lst:
            self._violate(
                "quorum_intersection", e,
                f"range {rid}: election winner {e.get('winner')} has "
                f"lst {w_lst} < candidate max {m_lst}; acked records "
                f"on the longer log would be lost",
                dedup=(rid, e.get("round"), "lst"))

    # leases
    def _fenced(self, node: int, t: float) -> bool:
        fence = self._fence.get(node)
        return fence is not None and 0.0 <= t - fence <= self.LEASE_HANDOFF_S

    def _on_lease_acquire(self, e: dict) -> None:
        rid, node = e["rid"], e["node"]
        if e.get("epoch", 0) < self._regime.get(rid, 0) \
                and self._fenced(node, e["t"]):
            # stale-regime renewal raced the epoch switch after this
            # node's session fence — lawful handoff noise, not a claim
            return
        if e["until"] <= e["t"] + 1e-9:
            # a delayed ack can grant an already-expired window (e.g. a
            # slow link stretching the round past duration - skew); the
            # holder never serves on it, so it is not a live claim
            return
        for (r, other), prev in list(self._leases.items()):
            if r != rid or other == node:
                continue
            if prev["until"] > e["t"] + 1e-9:
                self._violate(
                    "lease_disjoint", e,
                    f"range {rid}: node {node} acquired a lease at "
                    f"t={e['t']:.6f} while node {other}'s lease runs "
                    f"until {prev['until']:.6f} — overlapping leases "
                    f"allow two serving leaders (split-brain precursor)",
                    window=[prev, e],
                    dedup=(rid, node, other, round(prev["until"], 6)))
        cur = self._leases.get((rid, node))
        if cur is None or e["until"] >= cur["until"]:
            self._leases[(rid, node)] = e

    def _on_lease_lapse(self, e: dict) -> None:
        self._leases.pop((e["rid"], e["node"]), None)

    def _on_abdicate(self, e: dict) -> None:
        self._leases.pop((e["rid"], e["node"]), None)

    def _on_lease_heard(self, e: dict) -> None:
        if e.get("role") != "CATCHUP":
            return
        st = self._catchup.get((e["node"], e["rid"]))
        if st is None:
            return
        st["beats"] += 1
        ref = max(st["t_enter"], st["t_retry"])
        if e["t"] - ref > self.catchup_stall_s and st["beats"] >= 3:
            self._violate(
                "catchup_progress", e,
                f"range {e['rid']}: node {e['node']} has sat in CATCHUP "
                f"for {e['t'] - st['t_enter']:.2f}s hearing "
                f"{st['beats']} leader lease beats without re-requesting "
                f"data — catch-up retries are being starved",
                window=[st["enter"], e],
                dedup=(e["rid"], e["node"], round(st["t_enter"], 6)))

    # catch-up lifecycle
    def _on_catchup_enter(self, e: dict) -> None:
        self._catchup[(e["node"], e["rid"])] = {
            "t_enter": e["t"], "t_retry": e["t"], "beats": 0, "enter": e}

    def _on_catchup_retry(self, e: dict) -> None:
        st = self._catchup.get((e["node"], e["rid"]))
        if st is not None:
            st["t_retry"] = e["t"]

    def _on_catchup_exit(self, e: dict) -> None:
        self._catchup.pop((e["node"], e["rid"]), None)
        if e.get("lsn"):
            self._bump_evidence(e["rid"], e["node"], e["lsn"])

    # log / commit path
    def _on_append(self, e: dict) -> None:
        if "digest" not in e or e.get("lsn") is None:
            return
        key = (e["rid"], e["lsn"])
        prev = self._digests.get(key)
        if prev is None:
            self._digests[key] = e
        elif prev["digest"] != e["digest"]:
            self._violate(
                "log_matching", e,
                f"range {e['rid']} lsn {e['lsn']}: node {e['node']} "
                f"appended digest {e['digest']} but node "
                f"{prev['node']} holds {prev['digest']} — replicas "
                f"diverge at the same log position",
                window=[prev, e], dedup=key)

    def _on_flush(self, e: dict) -> None:
        self._bump_evidence(e["rid"], e["node"], e["lsn"])

    def _on_ack(self, e: dict) -> None:
        key = (e["rid"], e["node"])
        lsn = e["lsn"]
        if lsn > self._evidence.get(key, 0):
            self._violate(
                "acked_durable", e,
                f"range {e['rid']}: node {e['node']} acked watermark "
                f"{lsn} beyond its durable/committed evidence "
                f"{self._evidence.get(key, 0)} — a crash now loses an "
                f"acked record",
                dedup=key)

    def _support(self, rid: int, lsn: int) -> int:
        return sum(1 for (r, _m), wm in self._evidence.items()
                   if r == rid and wm >= lsn)

    def _on_commit(self, e: dict) -> None:
        n = e.get("n_cohort") or self._cohort_n.get(e["rid"])
        if not n:
            return
        support = self._support(e["rid"], e["lsn"])
        if 2 * support <= n:
            self._violate(
                "acked_committed_majority", e,
                f"range {e['rid']}: leader {e['node']} committed lsn "
                f"{e['lsn']} with durable evidence on only {support} of "
                f"{n} cohort members — acks are outrunning durability",
                dedup=(e["rid"], e["node"]))

    def _on_commit_idx(self, e: dict) -> None:
        key = (e["node"], e["rid"])
        prev = self._commit_idx.get(key)
        if prev is not None and e["lsn"] < prev["lsn"]:
            self._violate(
                "commit_monotonic", e,
                f"range {e['rid']}: node {e['node']} commit index "
                f"regressed {prev['lsn']} -> {e['lsn']} without a "
                f"crash",
                window=[prev, e], dedup=key)
        if prev is None or e["lsn"] >= prev["lsn"]:
            self._commit_idx[key] = e
        # committed-on-a-majority state is as good as durable: a dup
        # re-ack may advertise cmt before the local force lands
        self._bump_evidence(e["rid"], e["node"], e["lsn"])

    # membership
    def _on_member_change(self, e: dict) -> None:
        members = e.get("members")
        if members:
            self._cohort_n[e["rid"]] = len(members)

    def _on_split(self, e: dict) -> None:
        if e.get("n_cohort") and e.get("child") is not None:
            self._cohort_n[e["child"]] = e["n_cohort"]

    # 2PC
    def _on_txn_decide(self, e: dict) -> None:
        self._check_decision(e)

    def _on_txn_decision(self, e: dict) -> None:
        self._check_decision(e)

    def _on_txn_resolve(self, e: dict) -> None:
        self._check_decision(e)
        self._prepares.get((e["node"], e["rid"]), {}).pop(e["txid"], None)

    def _check_decision(self, e: dict) -> None:
        txid, outcome = e["txid"], e["outcome"]
        prev = self._decisions.get(txid)
        if prev is None:
            self._decisions[txid] = e
        elif prev["outcome"] != outcome:
            self._violate(
                "txn_decision_stable", e,
                f"txn {txid}: decision flipped "
                f"{prev['outcome']} -> {outcome} (first decided by node "
                f"{prev['node']}, contradicted by node {e['node']})",
                window=[prev, e], dedup=txid)

    # GC floor vs unresolved committed 2PC prepares
    def _on_txn_prepared(self, e: dict) -> None:
        self._prepares.setdefault((e["node"], e["rid"]), {})[
            e["txid"]] = e["lsn"]

    def _check_floor(self, e: dict, floor: int, tag: str) -> None:
        live = self._prepares.get((e["node"], e["rid"])) or {}
        if live and floor > min(live.values()):
            txid = min(live, key=live.get)
            self._violate(
                "gc_floor_safe", e,
                f"range {e['rid']} node {e['node']}: GC floor pinned at "
                f"{floor} above unresolved committed prepare of txn "
                f"{txid} at lsn {live[txid]} — the log could collect an "
                f"in-doubt transaction",
                dedup=(e["node"], e["rid"], txid, tag))

    def _check_release(self, e: dict, tag: str) -> None:
        live = self._prepares.get((e["node"], e["rid"])) or {}
        if live:
            txid = min(live, key=live.get)
            self._violate(
                "gc_floor_safe", e,
                f"range {e['rid']} node {e['node']}: GC pin released "
                f"while committed prepare of txn {txid} at lsn "
                f"{live[txid]} is still unresolved",
                dedup=(e["node"], e["rid"], txid, tag))

    def _on_txn_pin(self, e: dict) -> None:
        self._check_floor(e, e["lsn"], "pin")

    def _on_txn_unpin(self, e: dict) -> None:
        self._check_release(e, "unpin")

    def _on_gc_floor_pin(self, e: dict) -> None:
        if e.get("lsn") is not None:
            self._check_floor(e, e["lsn"], "wal_pin")

    def _on_gc_floor_release(self, e: dict) -> None:
        self._check_release(e, "wal_release")

    # node / replica lifecycle: volatile state resets
    def _on_node_crash(self, e: dict) -> None:
        node = e["node"]
        self._fence[node] = e["t"]
        for key in [k for k in self._commit_idx if k[0] == node]:
            del self._commit_idx[key]
        for key in [k for k in self._leases if k[1] == node]:
            del self._leases[key]
        for key in [k for k in self._catchup if k[0] == node]:
            del self._catchup[key]
        if e.get("lose_disk"):
            for key in [k for k in self._evidence if k[1] == node]:
                del self._evidence[key]
            for key in [k for k in self._prepares if k[0] == node]:
                del self._prepares[key]

    def _on_session_flap(self, e: dict) -> None:
        # the flapped node's ephemerals (leader claim included) vanish;
        # its lease window cannot fence anyone and it abdicates on
        # reconnect — do not hold the stale window against a successor
        node = e["node"]
        self._fence[node] = e["t"]
        for key in [k for k in self._leases if k[1] == node]:
            del self._leases[key]

    def _on_replica_retired(self, e: dict) -> None:
        node, rid = e["node"], e["rid"]
        self._commit_idx.pop((node, rid), None)
        self._leases.pop((rid, node), None)
        self._catchup.pop((node, rid), None)
        self._evidence.pop((rid, node), None)
        self._prepares.pop((node, rid), None)
