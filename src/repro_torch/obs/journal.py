"""Protocol flight recorder: a journal of consensus-relevant transitions.

Every replica-protocol state change — proposal append / ack / commit /
apply, election phases, lease acquire / renew / lapse / depose, CATCHUP
enter / exit, membership and split barriers, 2PC prepare / vote / decide
/ resolve, GC-floor pin / release — is recorded as one structured entry
keyed by ``(node, rid, epoch, lsn)`` plus kind-specific fields.

Like the tracer and the profiler, journaling is *pure measurement*: it
models zero sim-time cost and draws nothing from the simulator RNG, so a
journaled run is bit-identical to an un-journaled one.  The journal is
the substrate for two consumers:

- the online invariant watchdog (`obs/watchdog.py`) subscribes via
  `listeners` and checks per-range consensus invariants on every entry;
- the offline replayer/explainer (`benchmarks/explain.py`) reconstructs
  per-range timelines from a JSONL dump and renders root-cause
  narratives.

Journal entry kinds (producer sites in core/replica.py, core/txn.py,
core/node.py):

=================  ==========================================================
kind               meaning / extra fields
=================  ==========================================================
append             record entered a replica's log (leader mint, follower
                   on_propose, catch-up install); ``digest`` fingerprints
                   the record content for the log-matching invariant
flush              a replica's durable watermark advanced (WAL force done)
ack                follower sent a cumulative ack watermark to the leader
commit             leader advanced the commit decision to ``lsn`` via
                   majority acks
commit_idx         a replica's applied/committed index reached ``lsn``
elect_start        node entered candidacy (``round``, ``lst``)
elect_decide       election evaluated: ``candidates``, ``winner``,
                   ``n_cohort``, ``winner_lst``, ``max_lst``
takeover           new leader took over (``cmt``, ``lst``, ``have`` =
                   contiguous unresolved-window coverage, ``n_cohort``)
leader_open        leader re-opened the range for writes
abdicate           leader stepped down (``why``)
deposed            follower deposed a silent leader
lease_renew        leader sent a lease renewal round (``seq``)
lease_acquire      renewal reached a majority; ``until`` is the skew-safe
                   expiry the leader now trusts, ``grace`` marks the
                   takeover grace lease
lease_heard        follower refreshed its leader-liveness clock from a
                   lease beat (``role`` — CATCHUP beats feed the
                   starvation monitor)
lease_lapse        leader's lease expired without majority renewal
catchup_enter      replica entered CATCHUP (``leader``)
catchup_retry      CATCHUP replica re-requested missing data
catchup_exit       replica completed catch-up at ``lsn``
split              SPLIT barrier applied (``child``, ``split_key``)
member_change      MEMBER_CHANGE barrier applied (``members``)
txn_prepare        participant received a 2PC prepare (``txid``)
txn_prepared       participant's PREPARE record committed at ``lsn``
txn_vote           participant voted (``txid``, ``vote``)
txn_decide         a decision was minted (``txid``, ``outcome``, ``by``)
txn_decision       a decision record was applied (``txid``, ``outcome``)
txn_resolve        participant resolved staged state (``txid``,
                   ``outcome``)
txn_pin            2PC state pinned a WAL record against GC (``why``)
txn_unpin          the pin was released
gc_floor_pin       WAL GC floor pinned at ``lsn``  (from wal.on_gc_event)
gc_floor_release   WAL GC floor released
node_crash         node crashed (volatile replica state lost)
node_restart       node restarted
=================  ==========================================================
"""

from __future__ import annotations

import json
import zlib
from typing import Callable, Optional

# Kinds worth surfacing verbatim when annotating a latency window: the
# regime-change / fault / repair transitions.  Steady-state traffic
# (append/flush/ack/commit churn) is only counted, never listed.
NOTABLE_KINDS = frozenset((
    "elect_start", "elect_decide", "takeover", "leader_open", "abdicate",
    "deposed", "lease_lapse", "catchup_enter", "catchup_retry",
    "catchup_exit", "split", "member_change", "node_crash", "node_restart",
    "session_flap", "txn_decide", "gc_floor_pin", "replica_retired",
))


def record_digest(rec) -> int:
    """Stable content fingerprint of a log record for the log-matching
    invariant (same (rid, lsn) ⇒ same digest on every replica).  Uses
    crc32 over a canonical repr — `hash()` is salted per process and
    would break run-to-run comparability of exported journals."""
    txn = rec.txn
    if txn is not None:
        txn = repr(txn)
    canon = (rec.range_id, rec.lsn, rec.op.name, rec.key,
             repr(rec.columns), rec.txn_tail, txn)
    return zlib.crc32(repr(canon).encode())


class ProtocolJournal:
    """Append-only, bounded journal of protocol transitions.

    `record()` is the single producer entry point; `listeners` receive
    every entry (even past the storage cap, so the watchdog never goes
    blind on a long run)."""

    def __init__(self, sim, enabled: bool = True, cap: int = 400_000):
        self.sim = sim
        self.enabled = enabled
        self.cap = cap
        self.entries: list[dict] = []
        self.dropped = 0
        self.listeners: list[Callable[[dict], None]] = []

    def record(self, kind: str, node: int, rid: Optional[int] = None,
               epoch: Optional[int] = None, lsn: Optional[int] = None,
               **fields) -> None:
        if not self.enabled:
            return
        e = {"t": self.sim.now, "kind": kind, "node": node}
        if rid is not None:
            e["rid"] = rid
        if epoch is not None:
            e["epoch"] = epoch
        if lsn is not None:
            e["lsn"] = lsn
        e.update(fields)
        if len(self.entries) < self.cap:
            self.entries.append(e)
        else:
            self.dropped += 1
        for fn in self.listeners:
            fn(e)

    # -- consumers ----------------------------------------------------------
    def export(self, t0: float = 0.0, rid: Optional[int] = None,
               kinds: Optional[set] = None) -> list[dict]:
        """Entries at/after `t0` (times shifted relative to `t0`),
        optionally filtered to one range / a kind set."""
        out = []
        for e in self.entries:
            if e["t"] < t0:
                continue
            if rid is not None and e.get("rid") != rid:
                continue
            if kinds is not None and e["kind"] not in kinds:
                continue
            d = dict(e)
            d["t"] = round(d["t"] - t0, 6)
            out.append(d)
        return out

    def window(self, t_lo: float, t_hi: float,
               rid: Optional[int] = None) -> list[dict]:
        """Entries with t in [t_lo, t_hi] (absolute sim time, unshifted):
        the 'implicated journal window' attached to violations and used
        to annotate slow traces."""
        return [e for e in self.entries
                if t_lo <= e["t"] <= t_hi
                and (rid is None or e.get("rid") == rid)]

    def window_summary(self, t_lo: float, t_hi: float,
                       rid: Optional[int] = None,
                       max_notable: int = 8) -> dict:
        """Compact annotation of a latency window: per-kind entry counts
        plus the notable (regime-change / fault / repair) entries
        verbatim.  This is what `--report` prints under a slow trace."""
        win = self.window(t_lo, t_hi, rid)
        by_kind: dict[str, int] = {}
        notable = []
        for e in win:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
            if e["kind"] in NOTABLE_KINDS and len(notable) < max_notable:
                notable.append(dict(e))
        return {"n_entries": len(win),
                "by_kind": dict(sorted(by_kind.items())),
                "notable": notable}

    def txn_entries(self, txid: str) -> list[dict]:
        """Every journal entry of one 2PC transaction, in order — the
        txid-keyed chain annotation for slow-transaction reports."""
        return [e for e in self.entries if e.get("txid") == txid]

    def to_jsonl(self, t0: float = 0.0, rid: Optional[int] = None,
                 kinds: Optional[set] = None) -> str:
        """One JSON object per line, stable field order (`t`, `kind`,
        `node`, `rid`, `epoch`, `lsn`, then the rest sorted by name) so
        dumps diff cleanly run-to-run — same contract as
        `EventLog.to_jsonl`."""
        head = ("t", "kind", "node", "rid", "epoch", "lsn")
        lines = []
        for e in self.export(t0=t0, rid=rid, kinds=kinds):
            ordered = {k: e[k] for k in head if k in e}
            ordered.update({k: e[k] for k in sorted(e) if k not in head})
            lines.append(json.dumps(ordered, default=str))
        return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def load_jsonl(text: str) -> list[dict]:
        """Parse a dump produced by `to_jsonl` back into entry dicts."""
        return [json.loads(line) for line in text.splitlines() if line.strip()]
