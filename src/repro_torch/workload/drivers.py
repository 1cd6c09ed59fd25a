"""Load drivers running inside the discrete-event `Simulator`.

Adapters translate a generator `Op` into one async call against a store's
client library; drivers decide *when* ops are issued:

- `ClosedLoopDriver`: N virtual clients, each with at most one op in
  flight (the paper's §C methodology — load grows with the client count);
- `OpenLoopDriver`: Poisson arrivals at a target rate, independent of
  completion times — the driver that exposes latency collapse at
  saturation and availability gaps during failures (Figs. 9-10).

Both record completions into an `OpLog`.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core.cluster import key_of
from ..core.types import OpType, WriteOp
from .generators import Op, OpKind, OpStream
from .metrics import OpLog


class SpinnakerAdapter:
    """Maps Ops onto the Spinnaker client library.

    reads: strong (leader) when `consistent`, else timeline with an
    optional monotonic session guarantee; RMW = strong read then a
    *conditional* put at the version just read, retried on conflict —
    the atomic path, not the racy read-then-blind-put it used to be;
    COND = one-shot conditional_put at the version just seen.

    Concurrency outcomes are surfaced in driver metrics: `rmw_conflicts`
    counts CAS rejections, `rmw_retries` the re-reads they triggered,
    `rmw_giveups` the RMWs that exhausted their retry budget (still a
    *successful* concurrency outcome — some other client won — but
    reported so contention is visible).
    """

    RMW_RETRIES = 4        # re-read budget per RMW before giving up the race

    def __init__(self, client, consistent: bool = True,
                 monotonic: bool = False, colname: str = "c"):
        self.client = client
        self.consistent = consistent
        self.monotonic = monotonic
        self.colname = colname
        self.rmw_conflicts = 0
        self.rmw_retries = 0
        self.rmw_giveups = 0

    def kind_name(self, op: Op) -> str:
        if op.kind == OpKind.READ:
            return "read" if self.consistent else "timeline_read"
        return {OpKind.WRITE: "write", OpKind.RMW: "rmw",
                OpKind.COND: "cond_put", OpKind.TXN: "txn"}[op.kind]

    def metrics(self) -> dict:
        return {"rmw_conflicts": self.rmw_conflicts,
                "rmw_retries": self.rmw_retries,
                "rmw_giveups": self.rmw_giveups,
                "lock_retries": self.client.lock_retries,
                "wrong_range_redirects": self.client.wrong_range_redirects}

    def issue(self, op: Op, done: Callable[[bool], None]) -> None:
        key = key_of(op.key_index)
        col = self.colname
        value = b"x" * op.value_size
        c = self.client
        # label the sampled trace with the workload kind, not the wire kind
        c.next_trace_kind = self.kind_name(op)
        if op.kind == OpKind.READ:
            # NOT_FOUND is a successful read of an absent key
            c.get(key, col, self.consistent,
                  lambda r: done(r.ok or r.code.value == "not_found"),
                  monotonic=self.monotonic)
        elif op.kind == OpKind.WRITE:
            c.put(key, col, value, lambda r: done(r.ok))
        elif op.kind == OpKind.RMW:
            self._rmw(key, col, value, done, tries=0)
        elif op.kind == OpKind.TXN:
            # plain adapter has no partner-key policy: a TXN op degrades
            # to an atomic RMW on its key (TxnAdapter does the real thing)
            self._rmw(key, col, value, done, tries=0)
        else:  # COND: optimistic concurrency at the observed version
            def after_read(r):
                if not (r.ok or r.code.value == "not_found"):
                    done(False)
                    return
                ver = r.version or 0
                # a VERSION_MISMATCH is a *successful* CAS rejection
                # (another client won the race), not unavailability
                c.next_trace_kind = "cond_put"
                c.conditional_put(
                    key, col, value, ver,
                    lambda r2: done(r2.ok
                                    or r2.code.value == "version_mismatch"))
            c.get(key, col, True, after_read)

    def _rmw(self, key: str, col: str, value, done: Callable[[bool], None],
             tries: int) -> None:
        """Atomic read-modify-write: conditional put at the read version,
        re-read + retry on conflict (bounded)."""
        c = self.client

        def after_read(r):
            if not (r.ok or r.code.value == "not_found"):
                done(False)
                return
            ver = r.version or 0

            def after_cas(r2):
                if r2.ok:
                    done(True)
                elif r2.code.value == "version_mismatch":
                    self.rmw_conflicts += 1
                    if tries < self.RMW_RETRIES:
                        self.rmw_retries += 1
                        self._rmw(key, col, value, done, tries + 1)
                    else:
                        self.rmw_giveups += 1
                        done(True)     # lost the race cleanly
                else:
                    done(False)

            c.next_trace_kind = "rmw"
            c.conditional_put(key, col, value, ver, after_cas)

        c.next_trace_kind = "rmw"
        c.get(key, col, True, after_read)


class AckLedgerAdapter(SpinnakerAdapter):
    """SpinnakerAdapter that additionally records the highest acknowledged
    version per written key.

    The ledger is the audit trail behind the rebalance scenarios' "no lost
    acknowledged writes" check: after a run that splits/migrates ranges
    under load (with leader kills mixed in), every ledger entry must be
    readable at >= its acked version — a write the cluster confirmed can
    never disappear, no matter where its key lives now."""

    def __init__(self, client, ledger: dict, **kw):
        super().__init__(client, **kw)
        self.ledger = ledger            # key_index -> max acked version

    def issue(self, op: Op, done: Callable[[bool], None]) -> None:
        if op.kind != OpKind.WRITE:
            super().issue(op, done)
            return
        key = key_of(op.key_index)

        def on_put(r):
            if r.ok and r.version is not None:
                prev = self.ledger.get(op.key_index, 0)
                self.ledger[op.key_index] = max(prev, r.version)
            done(r.ok)

        self.client.next_trace_kind = "write"
        self.client.put(key, self.colname, b"x" * op.value_size, on_put)


class TxnAdapter(SpinnakerAdapter):
    """SpinnakerAdapter whose TXN ops are *balance transfers* between the
    op's key and a partner key — the workload behind `--scenario txn`.

    A transfer strong-reads both accounts (one range-aware multi_get),
    then issues a conditional transaction moving `amount` from one to the
    other at the versions just read.  Partner choice is deterministic per
    key: a `txn_cross_frac` fraction of transfers picks a partner in a
    *different* range (resolved against the client's live range table, so
    it really exercises the 2PC path), the rest a same-range partner (the
    §8.2 single-cohort fast path).  OpLog kinds `txn_cross` / `txn_local`
    keep the two latency populations separate.

    Every acked transfer is ledgered ((key, version) pairs) and the whole
    workload preserves the global balance sum — the two facts the
    post-run audit checks: no acknowledged transaction lost, no partial
    commit visible."""

    def __init__(self, client, num_keys: int, cross_frac: float = 0.5,
                 amount: int = 1, ledger: Optional[list] = None, **kw):
        super().__init__(client, **kw)
        self.num_keys = num_keys
        self.cross_frac = cross_frac
        self.amount = amount
        self.ledger = ledger if ledger is not None else []
        self.txn_attempts = 0
        self.txn_commits = 0
        # clean CAS aborts (version mismatch at prepare/validate).  Lock
        # bounces never reach this callback — the client retries LOCKED
        # internally; they surface as `lock_retries` in metrics().
        self.txn_aborts = 0
        self.txn_failures = 0        # availability failures (timeouts)

    def metrics(self) -> dict:
        out = super().metrics()
        out.update({"txn_attempts": self.txn_attempts,
                    "txn_commits": self.txn_commits,
                    "txn_aborts": self.txn_aborts,
                    "txn_failures": self.txn_failures,
                    "txn_abort_rate": self.txn_aborts
                    / max(1, self.txn_attempts),
                    "txn2_issued": self.client.txn2_issued,
                    "mread_batches": self.client.mread_batches})
        return out

    def _is_cross(self, op: Op) -> bool:
        if self.cross_frac <= 0.0:
            return False
        if self.cross_frac >= 1.0:
            return True
        # deterministic per key (kind_name and issue must agree)
        return ((op.key_index * 2654435761 + 12345) % 1000) / 1000.0 \
            < self.cross_frac

    def kind_name(self, op: Op) -> str:
        if op.kind == OpKind.TXN:
            return "txn_cross" if self._is_cross(op) else "txn_local"
        return super().kind_name(op)

    def _partner(self, idx: int, cross: bool) -> int:
        """Partner account: same range as `idx` for local transfers, a
        different range for cross ones (checked against the cached range
        table; bounded probe walk)."""
        table = self.client.range_table
        home = table.lookup(key_of(idx))
        if cross:
            step = max(1, self.num_keys // 7)
            cand = (idx + self.num_keys // 2) % self.num_keys
            for _ in range(8):
                if cand != idx and table.lookup(key_of(cand)) != home:
                    return cand
                cand = (cand + step) % self.num_keys
            return cand                      # single-range keyspace: degrade
        for cand in (idx + 1, idx - 1):
            if 0 <= cand < self.num_keys \
                    and table.lookup(key_of(cand)) == home:
                return cand
        return idx                           # 1-key range: degenerate no-op

    def issue(self, op: Op, done: Callable[[bool], None]) -> None:
        if op.kind != OpKind.TXN:
            super().issue(op, done)
            return
        k1i = op.key_index
        k2i = self._partner(k1i, self._is_cross(op))
        if k2i == k1i:
            done(True)
            return
        k1, k2, col = key_of(k1i), key_of(k2i), self.colname
        c = self.client
        self.txn_attempts += 1

        def after_read(rs):
            r1, r2 = rs
            if not all(r.ok or r.code.value == "not_found" for r in rs):
                self.txn_failures += 1
                done(False)
                return
            b1 = r1.value if isinstance(r1.value, int) else 0
            b2 = r2.value if isinstance(r2.value, int) else 0
            ops = [WriteOp(OpType.COND_PUT, k1, col, b1 - self.amount,
                           expected_version=r1.version or 0),
                   WriteOp(OpType.COND_PUT, k2, col, b2 + self.amount,
                           expected_version=r2.version or 0)]

            def after_txn(res):
                if res.ok:
                    self.txn_commits += 1
                    self.ledger.append(((k1, (r1.version or 0) + 1),
                                        (k2, (r2.version or 0) + 1)))
                    done(True)
                elif res.code.value == "version_mismatch":
                    self.txn_aborts += 1
                    done(True)       # clean concurrency abort, nothing lost
                else:
                    self.txn_failures += 1
                    done(False)

            c.next_trace_kind = self.kind_name(op)
            c.transaction(ops, after_txn)

        c.next_trace_kind = self.kind_name(op)
        c.multi_get([(k1, col), (k2, col)], True, after_read)


class CassandraAdapter:
    """Maps Ops onto the Cassandra baseline client; there is no CAS (and
    no transactions), so COND — and TXN — degrade to read-then-write on
    the op's own key (the consistency gap §9 points at)."""

    def __init__(self, client, quorum: bool = True, colname: str = "c"):
        self.client = client
        self.quorum = quorum
        self.colname = colname

    def kind_name(self, op: Op) -> str:
        base = {OpKind.READ: "read", OpKind.WRITE: "write",
                OpKind.RMW: "rmw", OpKind.COND: "cond_put",
                OpKind.TXN: "txn"}[op.kind]
        return base if self.quorum else f"eventual_{base}"

    def issue(self, op: Op, done: Callable[[bool], None]) -> None:
        key = key_of(op.key_index)
        col = self.colname
        value = b"x" * op.value_size
        c = self.client
        label = self.kind_name(op)
        c.next_trace_kind = label

        def write_leg(r):
            if not (r.ok or r.code.value == "not_found"):
                done(False)
                return
            c.next_trace_kind = label
            c.write(key, col, value, self.quorum, lambda r2: done(r2.ok))

        if op.kind == OpKind.READ:
            c.read(key, col, self.quorum,
                   lambda r: done(r.ok or r.code.value == "not_found"))
        elif op.kind == OpKind.WRITE:
            c.write(key, col, value, self.quorum, lambda r: done(r.ok))
        else:  # RMW, COND, and TXN all become read-then-write
            c.read(key, col, self.quorum, write_leg)


class ClosedLoopDriver:
    """N clients, one outstanding op each; think_time inserts client-side
    pauses between completion and the next issue."""

    def __init__(self, sim, adapter, stream: OpStream, log: OpLog,
                 n_clients: int = 8, think_time: float = 0.0):
        self.sim = sim
        self.adapter = adapter
        self.stream = stream
        self.log = log
        self.n_clients = n_clients
        self.think_time = think_time
        self._t_end = 0.0
        self.issued = 0

    def run(self, duration: float, warmup: float = 0.0) -> None:
        """Drive for warmup+duration sim-seconds; ops completing during
        warmup are not recorded."""
        t_rec = self.sim.now + warmup
        self._t_end = t_rec + duration
        for _ in range(self.n_clients):
            self._loop(t_rec)
        self.sim.run(until=self._t_end)

    def _loop(self, t_rec: float) -> None:
        if self.sim.now >= self._t_end:
            return
        op = self.stream.next_op()
        kind = self.adapter.kind_name(op)
        t0 = self.sim.now
        self.issued += 1

        def done(ok: bool):
            if t0 >= t_rec and self.sim.now <= self._t_end:
                self.log.record(self.sim.now, kind, ok, self.sim.now - t0)
            if ok and op.kind != OpKind.READ:
                self.stream.insert_horizon = max(
                    self.stream.insert_horizon, op.key_index + 1)
            if self.think_time > 0:
                self.sim.schedule(self.think_time, self._loop, t_rec)
            else:
                self._loop(t_rec)

        self.adapter.issue(op, done)


class OpenLoopDriver:
    """Poisson arrivals at `rate` ops/s; completions never gate arrivals.

    `max_outstanding` bounds in-flight ops so a dead cluster cannot grow
    the event heap without limit — arrivals past the bound are recorded as
    failed (shed), which is what a real open-loop generator reports."""

    def __init__(self, sim, adapter, stream: OpStream, log: OpLog,
                 rate: float, max_outstanding: int = 10_000):
        self.sim = sim
        self.adapter = adapter
        self.stream = stream
        self.log = log
        self.rate = rate
        self.max_outstanding = max_outstanding
        self.outstanding = 0
        self.shed = 0
        self._t_end = 0.0

    def run(self, duration: float, warmup: float = 0.0) -> None:
        t_rec = self.sim.now + warmup
        self._t_end = t_rec + duration
        self._arrive(t_rec)
        self.sim.run(until=self._t_end)

    def _arrive(self, t_rec: float) -> None:
        if self.sim.now >= self._t_end:
            return
        gap = self.stream.next_gap(self.rate)
        op = self.stream.next_op()
        kind = self.adapter.kind_name(op)
        t0 = self.sim.now

        if self.outstanding >= self.max_outstanding:
            self.shed += 1
            if t0 >= t_rec:
                self.log.record(t0, kind, False, 0.0)
        else:
            self.outstanding += 1

            def done(ok: bool):
                self.outstanding -= 1
                if t0 >= t_rec and self.sim.now <= self._t_end:
                    self.log.record(self.sim.now, kind, ok,
                                    self.sim.now - t0)
                if ok and op.kind != OpKind.READ:
                    self.stream.insert_horizon = max(
                        self.stream.insert_horizon, op.key_index + 1)

            self.adapter.issue(op, done)
        self.sim.schedule(gap, self._arrive, t_rec)
