"""Sim-time distributed tracing for the write path and 2PC.

A trace is born at the client (`Tracer.maybe_start`), rides the request
payload to the leader, and collects milestone timestamps as the op moves
through the pipeline.  Milestones are virtual-clock stamps only — tracing
adds zero modeled sim-time cost, so a traced run is bit-identical to an
untraced one (sampling is decided by a deterministic accumulator, never
by the simulator RNG).

Milestones for a Spinnaker strong write::

    t_issue   client accepts the op (includes retries/backoff thereafter)
    t_send    last attempt leaves the client
    t_recv    leader node receives the request
    t_cpu     CPU service done; replica handler runs (record admitted)
    t_flush   proposal batch holding the record is flushed to followers
    t_forced  leader's WAL force covering the record is durable
    t_commit  commit rule satisfied (leader force + majority ack); applied
    t_acked   ack handed to the per-client reply envelope (coalesced acks
              for one batch leave as one message; the flush is same-instant,
              so this stage measures coalescing delay — by design ~0)
    t_done    client receives the ack

Consecutive milestones define stages that sum exactly to end-to-end
latency: client_queue, net_req, cpu, batch_wait, wal_force, commit_wait,
ack_coalesce, reply_net.  The Cassandra baseline uses a shorter chain (no
proposal batch / quorum round): client_queue, net_req, cpu, durable_wait,
reply_net.

2PC transactions get a parallel txid-keyed chain (`TxnTrace`):
prepare_sent → vote → decide → per-participant resolve.  The chains
double as a correctness audit: `audit_writes` / `audit_txns` verify that
every acked traced write (and every committed 2PC txn) carries the full
chain — a structural check that survives leader kills because the trace
objects live outside any node.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# stage name -> (start milestone, end milestone), in pipeline order
SPINNAKER_CHAIN = (
    ("client_queue", "t_issue", "t_send"),
    ("net_req", "t_send", "t_recv"),
    ("cpu", "t_recv", "t_cpu"),
    ("batch_wait", "t_cpu", "t_flush"),
    ("wal_force", "t_flush", "t_forced"),
    ("commit_wait", "t_forced", "t_commit"),
    ("ack_coalesce", "t_commit", "t_acked"),
    ("reply_net", "t_acked", "t_done"),
)

CASSANDRA_CHAIN = (
    ("client_queue", "t_issue", "t_send"),
    ("net_req", "t_send", "t_recv"),
    ("cpu", "t_recv", "t_cpu"),
    ("durable_wait", "t_cpu", "t_commit"),
    ("reply_net", "t_commit", "t_done"),
)

_CHAINS = {"spinnaker": SPINNAKER_CHAIN, "cassandra": CASSANDRA_CHAIN}

# client paths whose acked ops must carry the full server-side chain
_WRITE_PATHS = ("write", "txn")


@dataclass
class OpTrace:
    """One sampled client operation; all times are sim-time seconds."""
    trace_id: int
    kind: str                 # workload label ("write", "rmw", "txn_cross"…)
    path: str                 # client path: "write" | "read" | "txn"
    key: str
    system: str               # "spinnaker" | "cassandra"
    t_issue: float
    t_send: Optional[float] = None
    t_recv: Optional[float] = None
    t_cpu: Optional[float] = None
    t_flush: Optional[float] = None
    t_forced: Optional[float] = None
    t_commit: Optional[float] = None
    t_acked: Optional[float] = None
    t_done: Optional[float] = None
    attempts: int = 0
    node: Optional[int] = None      # node that served the final attempt
    lsn: Optional[int] = None
    ok: Optional[bool] = None
    code: Optional[str] = None

    def mark_recv(self, t: float, node_id: int) -> None:
        self.t_recv = t
        self.node = node_id

    @property
    def e2e(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_issue

    def _chain(self):
        chain = _CHAINS[self.system]
        if self.path not in _WRITE_PATHS:
            # reads never touch the WAL: everything past the server's
            # receive collapses into one "server" stage
            return chain[:2] + (("server", "t_recv", "t_done"),)
        return chain

    def missing(self) -> list[str]:
        """Milestones the op's chain requires but that were never marked."""
        need = {m for _, a, b in self._chain() for m in (a, b)}
        return sorted(m for m in need if getattr(self, m) is None)

    def complete(self) -> bool:
        return not self.missing()

    def stages(self) -> Optional[dict[str, float]]:
        """Per-stage durations; None unless every milestone is present.

        Durations are clamped at 0 (a retried op can leave a stale earlier
        mark) but always rescaled nowhere — they sum to e2e exactly when
        the milestones are monotone, which is the steady-state case the
        breakdown report runs under."""
        if not self.complete():
            return None
        out = {}
        for name, a, b in self._chain():
            out[name] = max(0.0, getattr(self, b) - getattr(self, a))
        return out


@dataclass
class TxnTrace:
    """Chain of one 2PC transaction, keyed by txid (cluster-global, so it
    survives coordinator crashes and observes the recovery re-drive)."""
    txid: str
    t_start: float
    coordinator: int
    participants: tuple[int, ...]
    prepare_sent: dict[int, float] = field(default_factory=dict)
    voted: dict[int, float] = field(default_factory=dict)
    t_decided: Optional[float] = None
    outcome: Optional[str] = None          # "commit" | "abort"
    resolved: dict[int, float] = field(default_factory=dict)
    t_client_ack: Optional[float] = None

    def missing(self) -> list[str]:
        out = []
        for rid in self.participants:
            if rid not in self.prepare_sent:
                out.append(f"prepare_sent[{rid}]")
            if rid not in self.voted:
                out.append(f"vote[{rid}]")
        if self.t_decided is None:
            out.append("decide")
        for rid in self.participants:
            if rid not in self.resolved:
                out.append(f"resolve[{rid}]")
        return out

    def complete(self) -> bool:
        return not self.missing()


# Hard ceiling on retained traces: a leaked unbounded list would defeat
# the "cheap enough to leave on" goal.  Drops are counted, never silent.
MAX_TRACES = 200_000


class Tracer:
    """Per-cluster trace collector.

    Sampling is an error-diffusion accumulator over the op sequence
    (``acc += rate; sample when acc >= 1``): deterministic, rate-exact in
    the long run, and independent of the simulator RNG stream, so
    enabling or disabling tracing cannot perturb the simulation."""

    def __init__(self, sim, system: str, sample: float = 1.0,
                 enabled: bool = True):
        self.sim = sim
        self.system = system
        self.sample = max(0.0, min(1.0, sample))
        self.enabled = enabled
        self.traces: list[OpTrace] = []      # finished ops
        self.txns: dict[str, TxnTrace] = {}
        self.dropped = 0
        self._acc = 0.0
        self._next_id = 0

    # -- client ops ---------------------------------------------------

    def maybe_start(self, kind: str, path: str, key: str
                    ) -> Optional[OpTrace]:
        if not self.enabled or self.sample <= 0.0:
            return None
        self._acc += self.sample
        if self._acc < 1.0:
            return None
        self._acc -= 1.0
        self._next_id += 1
        return OpTrace(trace_id=self._next_id, kind=kind, path=path,
                       key=key, system=self.system, t_issue=self.sim.now)

    def finish(self, tr: OpTrace, ok: bool, code: Optional[str]) -> None:
        tr.t_done = self.sim.now
        tr.ok = ok
        tr.code = code
        if len(self.traces) >= MAX_TRACES:
            self.dropped += 1
            return
        self.traces.append(tr)

    # -- 2PC chains ---------------------------------------------------

    def txn_begin(self, txid: str, coordinator: int,
                  participants) -> Optional[TxnTrace]:
        if not self.enabled:
            return None
        tr = TxnTrace(txid=txid, t_start=self.sim.now,
                      coordinator=coordinator,
                      participants=tuple(sorted(participants)))
        self.txns[txid] = tr
        return tr

    def txn_mark(self, txid: str, what: str, rid: Optional[int] = None
                 ) -> None:
        tr = self.txns.get(txid)
        if tr is None:
            return
        now = self.sim.now
        if what == "prepare_sent":
            tr.prepare_sent[rid] = now
        elif what == "vote":
            tr.voted[rid] = now
        elif what in ("commit", "abort"):
            tr.t_decided = now if tr.t_decided is None else tr.t_decided
            tr.outcome = what
        elif what == "resolve":
            tr.resolved[rid] = now
        elif what == "client_ack":
            tr.t_client_ack = now

    # -- audits -------------------------------------------------------

    def audit_writes(self) -> dict:
        """Every acked traced write must carry the full milestone chain."""
        acked = [t for t in self.traces
                 if t.ok and t.path in _WRITE_PATHS]
        bad = [{"trace_id": t.trace_id, "kind": t.kind, "key": t.key,
                "missing": t.missing()}
               for t in acked if not t.complete()]
        return {"acked_writes_traced": len(acked),
                "incomplete": len(bad),
                "violations": bad[:20],
                "dropped": self.dropped,
                "ok": not bad}

    def audit_txns(self) -> dict:
        """Every *committed* 2PC txn must show prepare → vote → decide →
        per-participant resolve.  Stronger than "every acked txn": after
        the post-run settle even orphaned decisions must have re-driven
        resolution on all participants."""
        committed = [t for t in self.txns.values()
                     if t.outcome == "commit"]
        bad = [{"txid": t.txid, "missing": t.missing()}
               for t in committed if not t.complete()]
        return {"committed_txns": len(committed),
                "acked_txns": sum(1 for t in committed
                                  if t.t_client_ack is not None),
                "incomplete": len(bad),
                "violations": bad[:20],
                "ok": not bad}


# -- breakdown report -------------------------------------------------


def _percentile(sorted_vals, p: float) -> float:
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1, int(p / 100.0 * len(sorted_vals)))
    return sorted_vals[i]


def stage_breakdown(traces, kind: str = "write",
                    band: tuple[float, float] = (45.0, 55.0),
                    top_n: int = 10) -> dict:
    """Decompose the p50 of `kind` ops into per-stage contributions.

    Stage means are taken over the traces whose end-to-end latency falls
    in the [p45, p55) rank band, so the stage sums reconstruct the median
    op (a plain mean over all traces would reconstruct the *mean*, which
    p99 stragglers dominate).  Returns stage means in ms plus the top
    `top_n` slowest complete traces with their own stage splits."""
    done = [t for t in traces
            if t.kind == kind and t.ok and t.complete()
            and t.e2e is not None]
    if not done:
        return {"kind": kind, "n_traces": 0}
    done.sort(key=lambda t: (t.e2e, t.trace_id))
    n = len(done)
    lo = int(band[0] / 100.0 * n)
    hi = max(lo + 1, int(band[1] / 100.0 * n))
    mid = done[lo:hi]
    stage_names = [s for s, _, _ in mid[0]._chain()]
    sums = {s: 0.0 for s in stage_names}
    for t in mid:
        for s, v in t.stages().items():
            sums[s] += v
    stages_ms = {s: sums[s] / len(mid) * 1e3 for s in stage_names}
    e2es = [t.e2e for t in done]
    slowest = [{
        "trace_id": t.trace_id, "key": t.key, "node": t.node,
        "attempts": t.attempts, "e2e_ms": t.e2e * 1e3,
        # absolute sim-time bounds, so consumers can pull the implicated
        # protocol-journal window for root-cause annotation
        "t_issue": t.t_issue, "t_done": t.t_done,
        "stages_ms": {s: v * 1e3 for s, v in t.stages().items()},
    } for t in done[-top_n:]][::-1]
    return {
        "kind": kind,
        "n_traces": n,
        "p50_ms": _percentile(e2es, 50) * 1e3,
        "p99_ms": _percentile(e2es, 99) * 1e3,
        "stages_p50_ms": stages_ms,
        "stage_sum_p50_ms": sum(stages_ms.values()),
        "band_mean_e2e_ms": sum(t.e2e for t in mid) / len(mid) * 1e3,
        "top_slowest": slowest,
    }
