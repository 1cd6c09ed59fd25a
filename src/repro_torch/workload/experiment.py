"""Experiment plumbing: build a cluster, preload the keyspace, drive a
workload (optionally under a fault schedule), and emit a JSON-serializable
result block.

These are the functions `benchmarks/spinnaker_bench.py` composes into the
paper's §9 comparisons; they are importable on their own so tests and
notebooks can run one-off scenarios.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Optional

from ..baselines.cassandra import CassandraCluster, CassandraConfig
from ..core import ranges as ranges_mod
from ..core.cluster import ClusterConfig, SpinnakerCluster, key_of
from ..core.node import NodeConfig
from ..core.replica import ReplicaConfig
from ..core.sim import DiskParams, NetParams, Simulator
from ..obs import ObsConfig, stage_breakdown
from .drivers import (AckLedgerAdapter, CassandraAdapter, ClosedLoopDriver,
                      OpenLoopDriver, SpinnakerAdapter, TxnAdapter)
from .generators import OpStream, WorkloadSpec
from .metrics import OpLog
from .scenario import FaultSchedule, parse_schedule

_DISKS = {"hdd": DiskParams.hdd, "ssd": DiskParams.ssd,
          "mem": DiskParams.memory}


@dataclass
class ExperimentConfig:
    """Everything one run needs besides the WorkloadSpec."""
    n_nodes: int = 5
    disk: str = "ssd"                 # hdd | ssd | mem
    seed: int = 0
    commit_period: float = 0.05       # leader's periodic commit broadcast
    # proposal/mutation batching (both systems, so comparisons stay fair)
    batch: str = "adaptive"           # adaptive | off
    batch_max_records: int = 32
    batch_deadline: float = 0.5e-3
    # server-side ingress batching (both systems — recvmmsg-style: drain
    # everything that arrived while the CPU was busy as one batch job)
    ingress_batch: bool = True
    # admission control: shed client requests once the node's CPU backlog
    # (queue delay + staged ingress work) exceeds this many seconds of
    # service time; None disables the gate
    admission_limit: Optional[float] = None
    # base ranges per node (finer pre-split spreads range leadership so
    # zipfian hot keys land on different leaders — see ClusterConfig)
    ranges_per_node: int = 1
    # leader leases (chaos scenarios compare lease-on failover against the
    # lease-off quorum-read / stall behaviour)
    lease_enabled: bool = True
    lease_duration: float = 1.0
    # driver
    driver: str = "closed"            # closed | open
    n_clients: int = 16
    open_rate: float = 2000.0         # ops/s, open-loop only
    warmup: float = 1.0
    duration: float = 5.0
    window: float = 0.5               # timeline bucket width
    preload_keys: int = 0             # 0 = spec.num_keys, capped below
    preload_cap: int = 2000
    # align the cluster's range pre-split with the workload keyspace (on
    # mismatch the whole workload lands in range 0 and measures one cohort,
    # not the cluster); set False to keep the static default pre-split
    align_presplit: bool = True
    # observability: fraction of client ops traced (deterministic
    # error-diffusion sampling; 0 disables) and the metrics scrape period
    # (0 leaves the registry scrape-on-demand only)
    trace_sample: float = 1.0
    metrics_interval: float = 0.0
    # component-attributed resource profiler (pure accounting — zero
    # modeled cost); profile_interval > 0 records a utilization timeline
    profile: bool = True
    profile_interval: float = 0.0
    # protocol flight recorder + invariant watchdog (pure measurement —
    # a journaled run is bit-identical to an un-journaled one; the bench
    # watchdog scenario gates exactly that)
    journal: bool = True
    device: str = "cuda"             # where OpStream samples its ops


def build_spinnaker(cfg: ExperimentConfig, num_keys: Optional[int] = None):
    """`num_keys` overrides the range-boundary pre-split: pass the
    workload's keyspace size to spread load across all cohorts (with the
    default 100k boundaries a small-keyspace workload lands entirely in
    range 0 and measures one cohort, not the cluster)."""
    sim = Simulator(seed=cfg.seed)
    ccfg = ClusterConfig(
        n_nodes=cfg.n_nodes,
        ranges_per_node=cfg.ranges_per_node,
        node=NodeConfig(replica=ReplicaConfig(
            commit_period=cfg.commit_period, batch=cfg.batch,
            batch_max_records=cfg.batch_max_records,
            batch_deadline=cfg.batch_deadline,
            lease_enabled=cfg.lease_enabled,
            lease_duration=cfg.lease_duration),
                        disk=_DISKS[cfg.disk](),
                        ingress_batch=cfg.ingress_batch,
                        admission_limit=cfg.admission_limit),
        obs=ObsConfig(trace_sample=cfg.trace_sample,
                      metrics_interval=cfg.metrics_interval,
                      profile=cfg.profile,
                      profile_interval=cfg.profile_interval,
                      journal=cfg.journal,
                      watchdog=cfg.journal))
    if num_keys is not None:
        ccfg.num_keys = num_keys
    cluster = SpinnakerCluster(sim, ccfg)
    cluster.start()
    cluster.settle()
    return sim, cluster


def build_cassandra(cfg: ExperimentConfig):
    sim = Simulator(seed=cfg.seed)
    cluster = CassandraCluster(
        sim, CassandraConfig(n_nodes=cfg.n_nodes, disk=_DISKS[cfg.disk](),
                             batch=cfg.batch,
                             ingress_batch=cfg.ingress_batch,
                             batch_max_records=cfg.batch_max_records,
                             batch_deadline=cfg.batch_deadline,
                             obs=ObsConfig(
                                 trace_sample=cfg.trace_sample,
                                 metrics_interval=cfg.metrics_interval,
                                 profile=cfg.profile,
                                 profile_interval=cfg.profile_interval)))
    return sim, cluster


def _aligned_presplit(cfg: ExperimentConfig,
                      spec: WorkloadSpec) -> Optional[int]:
    """Pre-split footgun guard: with the default 100k boundaries a smaller
    workload keyspace lands entirely in range 0, silently measuring one
    cohort.  By default the pre-split is auto-aligned to the workload's
    keyspace (with a warning); `cfg.align_presplit=False` keeps the static
    default for experiments that want the mismatch on purpose."""
    default_presplit = ClusterConfig.num_keys
    if spec.num_keys == default_presplit:
        return None
    if not cfg.align_presplit:
        warnings.warn(
            f"workload keyspace ({spec.num_keys} keys) does not match the "
            f"cluster pre-split ({default_presplit}); the load will "
            "concentrate in range 0 (align_presplit=False keeps this)",
            stacklevel=3)
        return None
    warnings.warn(
        f"aligning cluster pre-split to the workload keyspace "
        f"({spec.num_keys} keys, default pre-split {default_presplit}); "
        "set align_presplit=False to keep the static pre-split",
        stacklevel=3)
    return spec.num_keys


def _preload(sim, put, n_keys: int, deadline: float = 120.0) -> None:
    """Write keys 0..n_keys-1 so reads hit existing data."""
    done = [0]
    for i in range(n_keys):
        put(key_of(i), lambda r: done.__setitem__(0, done[0] + 1))
    limit = sim.now + deadline
    while done[0] < n_keys and sim.now < limit:
        sim.run(until=sim.now + 0.25)
    if done[0] < n_keys:
        raise RuntimeError(f"preload incomplete: {done[0]}/{n_keys}")


def _drive(sim, adapter, spec: WorkloadSpec, cfg: ExperimentConfig,
           schedule: Optional[FaultSchedule], cluster,
           preloaded: int) -> tuple[OpLog, float, object]:
    stream = OpStream(spec, seed=cfg.seed + 1, device=cfg.device)
    if spec.key_dist == "latest":
        # 'latest' skews toward recent inserts: start the horizon at the
        # preloaded prefix; drivers advance it on successful writes
        stream.insert_horizon = max(1, preloaded)
    log = OpLog()
    if schedule is not None:
        # schedule times are relative to the measured interval's start;
        # applied faults (and honest skips) land in the cluster event log
        # so fig9/10 timelines carry their own annotations
        obs = getattr(cluster, "obs", None)
        on_event = (None if obs is None
                    else lambda msg: obs.events.emit("fault", detail=msg))
        schedule.install(sim, cluster, at=sim.now + cfg.warmup,
                         on_event=on_event)
    if cfg.driver == "open":
        drv = OpenLoopDriver(sim, adapter, stream, log, rate=cfg.open_rate)
    else:
        drv = ClosedLoopDriver(sim, adapter, stream, log,
                               n_clients=cfg.n_clients)
    t_start = sim.now + cfg.warmup
    drv.run(cfg.duration, warmup=cfg.warmup)
    return log, t_start, drv


def _result(log: OpLog, cfg: ExperimentConfig, read_kind: str,
            write_kind: str, schedule: Optional[FaultSchedule],
            t_start: float) -> dict:
    out = {
        "reads": log.summary(read_kind, duration=cfg.duration),
        "writes": log.summary(write_kind, duration=cfg.duration),
        "total_ops": len(log),
        "duration_s": cfg.duration,
        "throughput": sum(h.total for h in log.hists.values()) / cfg.duration,
    }
    if schedule is not None:
        out["fault_events"] = list(schedule.applied)
        out["timeline"] = {}
        for kind in (read_kind, write_kind):
            rows = []
            for w in log.windows(cfg.window, kind=kind, t0=t_start,
                                 t1=t_start + cfg.duration):
                d = vars(w).copy()
                # report windows relative to the measured interval's start
                d["t_start"] = round(d["t_start"] - t_start, 6)
                d["t_end"] = round(d["t_end"] - t_start, 6)
                rows.append(d)
            out["timeline"][kind] = rows
    return out


def run_spinnaker_workload(spec: WorkloadSpec,
                           cfg: Optional[ExperimentConfig] = None,
                           consistent_reads: bool = True,
                           monotonic: bool = False,
                           schedule: Optional[FaultSchedule | str] = None
                           ) -> dict:
    """One Spinnaker run; returns the JSON-ready result block."""
    cfg = cfg or ExperimentConfig()
    if isinstance(schedule, str):
        schedule = parse_schedule(schedule)
    sim, cluster = build_spinnaker(cfg, num_keys=_aligned_presplit(cfg, spec))
    loader = cluster.make_client("preload")
    n_pre = min(cfg.preload_keys or spec.num_keys, cfg.preload_cap,
                spec.num_keys)
    _preload(sim, lambda k, cb: loader.put(k, "c", b"x" * spec.value_size,
                                           cb), n_pre)
    adapter = SpinnakerAdapter(cluster.make_client("bench"),
                               consistent=consistent_reads,
                               monotonic=monotonic)
    log, t_start, _drv = _drive(sim, adapter, spec, cfg, schedule, cluster,
                                n_pre)
    read_kind = "read" if consistent_reads else "timeline_read"
    out = _result(log, cfg, read_kind, "write", schedule, t_start)
    # concurrency outcomes (atomic RMW conflicts/retries, lock bounces)
    out["driver"] = adapter.metrics()
    if spec.rmw_frac:
        out["rmw"] = log.summary("rmw", duration=cfg.duration)
    out["trace_audit"] = cluster.obs.tracer.audit_writes()
    if schedule is not None:
        out["cluster_events"] = cluster.obs.events.export(t0=t_start)
    return out


def run_spinnaker_saturation(spec: WorkloadSpec,
                             cfg: Optional[ExperimentConfig] = None,
                             rates: Optional[list[float]] = None,
                             dwell: float = 2.0,
                             settle: float = 0.3) -> dict:
    """Open-loop rate-ramp on ONE cluster (§C saturation methodology).

    For each offered rate, Poisson arrivals are driven for `settle+dwell`
    sim-seconds (the settle prefix at the new rate is not recorded) and the
    achieved write throughput + latency percentiles are sampled.  The
    saturation knee is where achieved throughput stops tracking the offered
    rate and the latency percentiles collapse; comparing curves with
    `cfg.batch` "off" vs "adaptive" isolates what proposal batching buys.
    """
    cfg = cfg or ExperimentConfig()
    rates = rates or [1000, 2000, 5000, 10000, 20000, 40000]
    # align range boundaries with the workload keyspace so the ramp loads
    # every cohort, not just range 0
    sim, cluster = build_spinnaker(cfg, num_keys=spec.num_keys)
    loader = cluster.make_client("preload")
    n_pre = min(cfg.preload_keys or spec.num_keys, cfg.preload_cap,
                spec.num_keys)
    _preload(sim, lambda k, cb: loader.put(k, "c", b"x" * spec.value_size,
                                           cb), n_pre)
    adapter = SpinnakerAdapter(cluster.make_client("bench"), consistent=True)
    stream = OpStream(spec, seed=cfg.seed + 1, device=cfg.device)
    stream.insert_horizon = max(1, n_pre)
    points = []
    for rate in rates:
        log = OpLog()
        drv = OpenLoopDriver(sim, adapter, stream, log, rate=rate)
        drv.run(dwell, warmup=settle)
        w = log.summary("write", duration=dwell)
        points.append({
            "offered_rate": rate,
            "achieved_tput": w["count"] / dwell,
            "write_p50_ms": w["p50_ms"],
            "write_p99_ms": w["p99_ms"],
            "errors": w["errors"],
            "shed": drv.shed,
        })
    # leader-side batching telemetry, aggregated over the whole ramp
    flushes = records = 0
    for node in cluster.nodes.values():
        for rep in node.replicas.values():
            flushes += rep.batches_flushed
            records += rep.batched_records
    return {
        "batch": cfg.batch,
        "disk": cfg.disk,
        "points": points,
        "peak_write_tput": max((p["achieved_tput"] for p in points),
                               default=0.0),
        "mean_batch_records": records / flushes if flushes else 0.0,
    }


def run_spinnaker_rebalance(spec: WorkloadSpec,
                            cfg: Optional[ExperimentConfig] = None,
                            schedule: Optional[FaultSchedule | str] = None,
                            kill_leader: bool = True,
                            autobalance: bool = False) -> dict:
    """Elastic-range scenario: drive zipfian write-heavy load while the
    hottest range live-splits, one of its replicas migrates to the least
    loaded node, and (by default) the range leader is killed mid-migration.

    Every acknowledged write is ledgered (key -> max acked version); after
    the run the ledger is audited with strong reads — a single lost
    acknowledged write fails the scenario.  The result block also records
    write availability through the events, tail latency, the final range
    table, and whether the migration resolved unaided.
    """
    cfg = cfg or ExperimentConfig()
    if isinstance(schedule, str):
        schedule = parse_schedule(schedule)
    sim, cluster = build_spinnaker(cfg, num_keys=_aligned_presplit(cfg, spec))
    n_base = len(cluster.ranges)
    loader = cluster.make_client("preload")
    n_pre = min(cfg.preload_keys or spec.num_keys, cfg.preload_cap,
                spec.num_keys)
    _preload(sim, lambda k, cb: loader.put(k, "c", b"x" * spec.value_size,
                                           cb), n_pre)
    # zipfian's hottest key is index 0; its range is the one to shed
    hot_rid = cluster.range_of(key_of(0))
    if schedule is None:
        d = cfg.duration
        lines = [f"at {d * 0.2:.2f}s split range {hot_rid}",
                 f"at {d * 0.45:.2f}s move range {hot_rid}"]
        if kill_leader:
            # mid-migration: right after the move starts, before the
            # destination can be in-sync and the source retired
            lines.append(f"at {d * 0.45 + 0.25:.2f}s crash leader of "
                         f"{hot_rid}")
            lines.append(f"at {d * 0.8:.2f}s restart crashed")
        if autobalance:
            lines.insert(0, "at 0.0s autobalance on")
        schedule = parse_schedule("\n".join(lines))

    ledger: dict[int, int] = {}
    adapter = AckLedgerAdapter(cluster.make_client("bench"), ledger,
                               consistent=True)
    log, t_start, drv = _drive(sim, adapter, spec, cfg, schedule, cluster,
                               n_pre)
    out = _result(log, cfg, "read", "write", schedule, t_start)
    # ops still in flight when the run ended: with capped-backoff retries
    # an op stuck on an unavailable range never reaches its retry budget
    # inside a short run, so it would otherwise vanish from the error count
    # and leave the availability gate vacuous.  A healthy run carries only
    # the natural in-flight tail (a handful of ops).
    stalled = getattr(drv, "outstanding", 0)

    # -- post-run audit ------------------------------------------------------
    sim.run_for(3.0)          # let in-flight recovery/migration finish
    cluster.settle(timeout=30.0)
    auditor = cluster.make_client("audit")
    lost = []
    for idx, ver in sorted(ledger.items()):
        r = auditor.sync_get(key_of(idx), "c", consistent=True)
        if not r.ok or (r.version or 0) < ver:
            lost.append({"key": idx, "acked_version": ver,
                         "read": r.code.value, "read_version": r.version})
    # writes must land on both sides of every split boundary
    serving = {}
    for rid, kr in sorted(cluster.ranges.items()):
        r = auditor.sync(auditor.put, kr.lo, "c", b"probe")
        serving[rid] = bool(r.ok)
    intents = [rid for rid in cluster.ranges
               if cluster.zk.exists(ranges_mod.migration_path(rid))]
    non_empty = 0
    for rid, kr in cluster.ranges.items():
        rep = cluster.leader_replica(rid)
        if rep is not None and rep.store.keys_in_range(kr.lo, kr.hi):
            non_empty += 1
    w = out["writes"]
    attempts = w["count"] + w["errors"] + stalled
    out["rebalance"] = {
        "n_ranges_start": n_base,
        "n_ranges_end": len(cluster.ranges),
        "range_table": {rid: [kr.lo, kr.hi, list(cluster.members[rid])]
                        for rid, kr in sorted(cluster.ranges.items())},
        "hot_rid": hot_rid,
        "acked_writes_ledgered": len(ledger),
        "lost_acked_writes": lost,
        "all_ranges_serving_writes": all(serving.values()),
        "serving": serving,
        "non_empty_ranges": non_empty,
        "unresolved_migrations": intents,
        "stalled_ops_at_end": stalled,
        "write_availability": (w["count"] / attempts) if attempts else 1.0,
        "wrong_range_redirects": adapter.client.wrong_range_redirects,
        "balancer_actions": list(cluster.balancer.actions)
        if cluster.balancer is not None else [],
    }
    out["trace_audit"] = cluster.obs.tracer.audit_writes()
    if schedule is not None:
        out["cluster_events"] = cluster.obs.events.export(t0=t_start)
    return out


def _slow_txn_chains(cluster, top_n: int = 5) -> list[dict]:
    """Slowest decided 2PC transactions, keyed by txid: the milestone
    chain (ms relative to t_start) plus the txid's own journal entries —
    the `--report` drill-down for 'why was this transfer slow'."""
    journal = cluster.obs.journal
    ranked = []
    for tr in cluster.obs.tracer.txns.values():
        stamps = [s for s in ([tr.t_decided, tr.t_client_ack]
                              + list(tr.prepare_sent.values())
                              + list(tr.voted.values())
                              + list(tr.resolved.values())) if s is not None]
        if tr.outcome is None or not stamps:
            continue
        ranked.append((max(stamps) - tr.t_start, tr))
    ranked.sort(key=lambda x: (-x[0], x[1].txid))
    out = []
    for e2e, tr in ranked[:top_n]:
        def rel(t, _t0=tr.t_start):
            return None if t is None else round((t - _t0) * 1e3, 3)
        out.append({
            "txid": tr.txid,
            "coordinator": tr.coordinator,
            "participants": list(tr.participants),
            "outcome": tr.outcome,
            "t_start": round(tr.t_start, 6),
            "e2e_ms": round(e2e * 1e3, 3),
            "prepare_sent_ms": {r: rel(t)
                                for r, t in sorted(tr.prepare_sent.items())},
            "vote_ms": {r: rel(t) for r, t in sorted(tr.voted.items())},
            "decide_ms": rel(tr.t_decided),
            "resolve_ms": {r: rel(t) for r, t in sorted(tr.resolved.items())},
            "client_ack_ms": rel(tr.t_client_ack),
            "journal": journal.txn_entries(tr.txid) if journal.enabled
            else [],
        })
    return out


def run_spinnaker_txn(spec: WorkloadSpec,
                      cfg: Optional[ExperimentConfig] = None,
                      cross_frac: Optional[float] = None,
                      schedule: Optional[FaultSchedule | str] = None,
                      initial_balance: int = 1_000,
                      amount: int = 1) -> dict:
    """Cross-range transaction scenario (PR 4): drive a read/transfer mix
    where TXN ops move `amount` between two accounts — a fraction across
    ranges (Paxos-backed 2PC) and the rest inside one range (the §8.2
    fast path) — optionally under a fault schedule (e.g. ``crash txn
    coordinator`` for a mid-2PC leader kill).  The cross fraction comes
    from ``spec.txn_cross_frac`` unless `cross_frac` overrides it.

    Two audits close the run:

    - **no acknowledged transaction lost**: every acked transfer's
      (key, version) pairs must be readable at >= the acked version;
    - **no partial commit**: transfers are zero-sum, so the strong-read
      balance total over the whole keyspace must equal the preloaded
      total — a single torn transfer (one leg applied, the other not)
      breaks it.

    The op mix must carry only read/txn mass: blind writes would clobber
    balances and make the sum audit vacuous."""
    cfg = cfg or ExperimentConfig()
    if cross_frac is None:
        cross_frac = spec.txn_cross_frac
    if spec.write_frac or spec.rmw_frac or spec.cond_frac:
        raise ValueError("txn scenario needs a read/txn-only mix "
                         "(blind writes would break the balance-sum audit)")
    if isinstance(schedule, str):
        schedule = parse_schedule(schedule)
    sim, cluster = build_spinnaker(cfg, num_keys=_aligned_presplit(cfg, spec))
    loader = cluster.make_client("preload")
    n_pre = min(cfg.preload_keys or spec.num_keys, cfg.preload_cap,
                spec.num_keys)
    _preload(sim, lambda k, cb: loader.put(k, "c", initial_balance, cb),
             n_pre)
    ledger: list = []
    adapter = TxnAdapter(cluster.make_client("bench"), spec.num_keys,
                         cross_frac=cross_frac, amount=amount,
                         ledger=ledger, consistent=True)
    log, t_start, drv = _drive(sim, adapter, spec, cfg, schedule, cluster,
                               n_pre)
    out = {
        "reads": log.summary("read", duration=cfg.duration),
        "txn_local": log.summary("txn_local", duration=cfg.duration),
        "txn_cross": log.summary("txn_cross", duration=cfg.duration),
        "total_ops": len(log),
        "duration_s": cfg.duration,
        "throughput": sum(h.total for h in log.hists.values()) / cfg.duration,
    }
    if schedule is not None:
        out["fault_events"] = list(schedule.applied)
        out["timeline"] = {}
        for kind in ("txn_cross", "txn_local"):
            rows = []
            for w in log.windows(cfg.window, kind=kind, t0=t_start,
                                 t1=t_start + cfg.duration):
                d = vars(w).copy()
                d["t_start"] = round(d["t_start"] - t_start, 6)
                d["t_end"] = round(d["t_end"] - t_start, 6)
                rows.append(d)
            out["timeline"][kind] = rows

    # -- post-run audit ------------------------------------------------------
    sim.run_for(3.0)          # drain in-flight 2PC resolution / elections
    cluster.settle(timeout=30.0)
    auditor = cluster.make_client("audit")
    lost = []
    for legs in ledger:
        for key, ver in legs:
            r = auditor.sync_get(key, "c", consistent=True)
            if not r.ok or (r.version or 0) < ver:
                lost.append({"key": key, "acked_version": ver,
                             "read": r.code.value, "read_version": r.version})
    balance = 0
    for lo in range(0, spec.num_keys, 64):
        pairs = [(key_of(i), "c")
                 for i in range(lo, min(lo + 64, spec.num_keys))]
        rs = auditor.sync(auditor.multi_get, pairs, True)
        balance += sum(r.value for r in rs if r.ok
                       and isinstance(r.value, int))
    expected = n_pre * initial_balance
    leftover_locks = sum(len(rep.txn.locks)
                         for node in cluster.nodes.values()
                         for rep in node.replicas.values())
    leftover_prepared = sum(len(rep.txn.prepared)
                            for node in cluster.nodes.values()
                            for rep in node.replicas.values())
    srv = {"prepares": 0, "commits": 0, "aborts": 0, "votes_no": 0,
           "reads_deferred": 0, "lock_conflicts": 0}
    for node in cluster.nodes.values():
        for rep in node.replicas.values():
            for k in srv:
                srv[k] += getattr(rep.txn, k)
    out["txn"] = {
        "cross_frac": cross_frac,
        **adapter.metrics(),
        "acked_txns_ledgered": len(ledger),
        "lost_acked_txns": lost,
        "balance_expected": expected,
        "balance_read": balance,
        "partial_commit": balance != expected,
        "unresolved_intents": sorted(cluster.zk.get_children("/txn")),
        "leftover_locks": leftover_locks,
        "leftover_prepared": leftover_prepared,
        "server": srv,
        # audited after the settle: every committed 2PC txn must show the
        # full prepare -> vote -> decide -> per-participant resolve chain
        "trace_audit": cluster.obs.tracer.audit_txns(),
        "slow_txn_chains": _slow_txn_chains(cluster),
    }
    out["trace_audit"] = cluster.obs.tracer.audit_writes()
    if schedule is not None:
        out["cluster_events"] = cluster.obs.events.export(t0=t_start)
    return out


def run_cassandra_workload(spec: WorkloadSpec,
                           cfg: Optional[ExperimentConfig] = None,
                           quorum: bool = True,
                           schedule: Optional[FaultSchedule | str] = None
                           ) -> dict:
    """One Cassandra-baseline run (quorum or eventual consistency)."""
    cfg = cfg or ExperimentConfig()
    if isinstance(schedule, str):
        schedule = parse_schedule(schedule)
    sim, cluster = build_cassandra(cfg)
    loader = cluster.make_client("preload")
    n_pre = min(cfg.preload_keys or spec.num_keys, cfg.preload_cap,
                spec.num_keys)
    _preload(sim, lambda k, cb: loader.write(k, "c", b"x" * spec.value_size,
                                             True, cb), n_pre)
    adapter = CassandraAdapter(cluster.make_client("bench"), quorum=quorum)
    log, t_start, _drv = _drive(sim, adapter, spec, cfg, schedule, cluster,
                                n_pre)
    prefix = "" if quorum else "eventual_"
    out = _result(log, cfg, f"{prefix}read", f"{prefix}write", schedule,
                  t_start)
    out["trace_audit"] = cluster.obs.tracer.audit_writes()
    if schedule is not None:
        out["cluster_events"] = cluster.obs.events.export(t0=t_start)
    return out


def run_spinnaker_profiled(spec: WorkloadSpec,
                           cfg: Optional[ExperimentConfig] = None,
                           consistent_reads: bool = True) -> dict:
    """One Spinnaker run with the full resource profile attached: the
    usual workload result block plus `out["profile"]` — per-node x
    per-component busy-time attribution, utilization timeline, and
    per-range heat (`Profiler.summary()`)."""
    cfg = cfg or ExperimentConfig()
    sim, cluster = build_spinnaker(cfg, num_keys=_aligned_presplit(cfg, spec))
    loader = cluster.make_client("preload")
    n_pre = min(cfg.preload_keys or spec.num_keys, cfg.preload_cap,
                spec.num_keys)
    _preload(sim, lambda k, cb: loader.put(k, "c", b"x" * spec.value_size,
                                           cb), n_pre)
    adapter = SpinnakerAdapter(cluster.make_client("bench"),
                               consistent=consistent_reads)
    log, t_start, _drv = _drive(sim, adapter, spec, cfg, None, cluster, n_pre)
    read_kind = "read" if consistent_reads else "timeline_read"
    out = _result(log, cfg, read_kind, "write", None, t_start)
    out["trace_audit"] = cluster.obs.tracer.audit_writes()
    cluster.obs.stop()
    out["profile"] = cluster.obs.profiler.summary()
    if cfg.metrics_interval > 0:
        out["metrics"] = cluster.obs.metrics.summary()
    return out


def run_cassandra_profiled(spec: WorkloadSpec,
                           cfg: Optional[ExperimentConfig] = None,
                           quorum: bool = True) -> dict:
    """Cassandra-baseline counterpart of `run_spinnaker_profiled`."""
    cfg = cfg or ExperimentConfig()
    sim, cluster = build_cassandra(cfg)
    loader = cluster.make_client("preload")
    n_pre = min(cfg.preload_keys or spec.num_keys, cfg.preload_cap,
                spec.num_keys)
    _preload(sim, lambda k, cb: loader.write(k, "c", b"x" * spec.value_size,
                                             True, cb), n_pre)
    adapter = CassandraAdapter(cluster.make_client("bench"), quorum=quorum)
    log, t_start, _drv = _drive(sim, adapter, spec, cfg, None, cluster, n_pre)
    prefix = "" if quorum else "eventual_"
    out = _result(log, cfg, f"{prefix}read", f"{prefix}write", None, t_start)
    out["trace_audit"] = cluster.obs.tracer.audit_writes()
    cluster.obs.stop()
    out["profile"] = cluster.obs.profiler.summary()
    if cfg.metrics_interval > 0:
        out["metrics"] = cluster.obs.metrics.summary()
    return out


def _breakdown_block(cluster, log, cfg: ExperimentConfig,
                     write_kind: str) -> dict:
    """Latency-breakdown result block shared by both systems: per-stage
    p50 decomposition from the traces, cross-checked against the OpLog's
    independently measured percentiles."""
    cluster.obs.stop()      # flush the tail scrape before summarizing
    bd = stage_breakdown(cluster.obs.tracer.traces, kind=write_kind)
    # annotate each slowest trace with the implicated protocol-journal
    # window (what the trace's range was going through while the op ran)
    journal = getattr(cluster.obs, "journal", None)
    if journal is not None and journal.enabled:
        for t in bd.get("top_slowest", []):
            rid = cluster.range_of(t["key"])
            t["rid"] = rid
            t["journal"] = journal.window_summary(t["t_issue"], t["t_done"],
                                                  rid)
    w = log.summary(write_kind, duration=cfg.duration)
    bd["measured_write_p50_ms"] = w["p50_ms"]
    bd["measured_write_p99_ms"] = w["p99_ms"]
    bd["write_throughput"] = w.get("throughput", 0.0)
    bd["trace_audit"] = cluster.obs.tracer.audit_writes()
    if cfg.metrics_interval > 0:
        bd["metrics"] = cluster.obs.metrics.summary()
    return bd


def run_spinnaker_breakdown(spec: WorkloadSpec,
                            cfg: Optional[ExperimentConfig] = None) -> dict:
    """Strong-write latency breakdown: drive the mix with full tracing and
    decompose write p50 into client_queue / net_req / cpu / batch_wait /
    wal_force / commit_wait / reply_net stage contributions."""
    cfg = cfg or ExperimentConfig()
    sim, cluster = build_spinnaker(cfg, num_keys=_aligned_presplit(cfg, spec))
    loader = cluster.make_client("preload")
    n_pre = min(cfg.preload_keys or spec.num_keys, cfg.preload_cap,
                spec.num_keys)

    def pre_put(k, cb):
        # keep preload's burst writes out of the "write" trace population
        # (2000 simultaneous ops would pollute the stage rank band)
        loader.next_trace_kind = "preload"
        loader.put(k, "c", b"x" * spec.value_size, cb)

    _preload(sim, pre_put, n_pre)
    adapter = SpinnakerAdapter(cluster.make_client("bench"), consistent=True)
    log, _t_start, _drv = _drive(sim, adapter, spec, cfg, None, cluster,
                                 n_pre)
    return _breakdown_block(cluster, log, cfg, "write")


def _restart_stragglers(cluster) -> list[int]:
    """Defensively restart nodes a schedule left down (generated schedules
    restart their own crashes; this keeps hand-written ones honest)."""
    revived = []
    for nid, node in sorted(cluster.nodes.items()):
        if not node.up:
            cluster.restart_node(nid)
            revived.append(nid)
    return revived


def _aggregate_robustness(clients) -> dict:
    agg = {"retries": 0, "backoff_time_s": 0.0, "attempt_timeouts": 0,
           "retry_exhausted": 0, "error_counts": {}}
    for c in clients:
        s = c.robustness_summary()
        agg["retries"] += s["retries"]
        agg["backoff_time_s"] = round(
            agg["backoff_time_s"] + s["backoff_time_s"], 6)
        agg["attempt_timeouts"] += s["attempt_timeouts"]
        agg["retry_exhausted"] += s["retry_exhausted"]
        for code, n in s["error_counts"].items():
            agg["error_counts"][code] = agg["error_counts"].get(code, 0) + n
    agg["error_counts"] = dict(sorted(agg["error_counts"].items()))
    return agg


def run_spinnaker_chaos(seed: int = 0,
                        cfg: Optional[ExperimentConfig] = None,
                        schedule: Optional[FaultSchedule | str] = None,
                        duration: float = 18.0,
                        n_history_clients: int = 4,
                        history_keys: int = 24,
                        probe_period: float = 0.25,
                        recovery_bound: float = 4.0,
                        write_frac: float = 0.5,
                        export_journal: bool = False) -> dict:
    """One chaos run: drive history clients + per-range probe writers
    under a (generated or supplied) gray-failure schedule, then audit.

    Four audits close the run, all of which must pass for `ok`:

    - **linearizability** (`chaos.linearizability`): the recorded client
      history is checked per cell — no duplicate or reordered commit
      versions, no stale strong reads, no reads from the future;
    - **availability** (`chaos.availability`): the applied fault timeline
      is replayed into per-cohort majority-healthy windows; each window
      longer than `recovery_bound` must keep serving the cohort's probe
      writes within that bound (a minority-partitioned leader stalling a
      healthy majority fails exactly here);
    - **no lost acked writes**: every acknowledged (cell, version) must
      read back at >= that version after the run settles;
    - **trace audit**: sampled write traces show no torn commit chains.
    """
    from ..chaos import (HistoryRecorder, audit_availability,
                         check_linearizability, generate_chaos_schedule)

    cfg = cfg or ExperimentConfig(seed=seed, duration=duration)
    num_keys = max(history_keys, 2 * cfg.n_nodes)
    sim, cluster = build_spinnaker(cfg, num_keys=num_keys)
    loader = cluster.make_client("preload")
    _preload(sim, lambda k, cb: loader.put(k, "c", b"seed", cb), num_keys)

    sched_text = None
    if schedule is None:
        schedule = generate_chaos_schedule(
            seed, n_nodes=cfg.n_nodes, duration=duration,
            n_ranges=len(cluster.ranges))
    if isinstance(schedule, str):
        sched_text = schedule
        schedule = parse_schedule(schedule)
    cohorts = {rid: tuple(m) for rid, m in cluster.members.items()}

    # one probe key per base range (lowest preloaded key the range owns)
    probe_keys = {}
    for i in range(num_keys):
        rid = cluster.range_of(key_of(i))
        probe_keys.setdefault(rid, key_of(i))

    t0 = sim.now + 0.2           # schedule-relative time origin
    on_event = (lambda msg: cluster.obs.events.emit("fault", detail=msg))
    schedule.install(sim, cluster, at=t0, on_event=on_event)

    stop = [False]
    clients = []

    # history clients: closed-loop read/write mix over the shared keyspace
    recorders = []
    import random as _random
    for ci in range(n_history_clients):
        client = cluster.make_client(f"hist{ci}")
        clients.append(client)
        rec = HistoryRecorder(client, sim,
                              base_versions={(key_of(i), "c"): 1
                                             for i in range(num_keys)})
        recorders.append(rec)
        rng = _random.Random(seed * 1009 + ci)

        def loop(rec=rec, rng=rng):
            if stop[0]:
                return
            key = key_of(rng.randrange(history_keys))
            if rng.random() < write_frac:
                rec.put(key, "c", lambda r: loop())
            else:
                rec.get(key, "c", lambda r: loop())

        sim.schedule(0.01 * ci, loop)

    # probe writers: open-loop, one per cohort, fresh op every period so
    # recovery is observed promptly even while older probes back off
    probe_acks: dict[int, list] = {rid: [] for rid in cohorts}
    probe_recs = {}

    def make_probe(rid, key, rec):
        # factory so each cohort's tick chain re-schedules *itself* (a bare
        # `tick` in the loop body would late-bind to the last iteration)
        def tick():
            if stop[0]:
                return
            rec.put(key, "probe",
                    lambda r: (r.ok and probe_acks[rid].append(
                        round(sim.now - t0, 6))))
            sim.schedule(probe_period, tick)
        return tick

    for rid, key in sorted(probe_keys.items()):
        client = cluster.make_client(f"probe{rid}")
        clients.append(client)
        rec = HistoryRecorder(client, sim)
        probe_recs[rid] = rec
        sim.schedule(0.05, make_probe(rid, key, rec))

    sim.run(until=t0 + duration)
    stop[0] = True

    # -- post-run: heal, revive, settle, audit -------------------------------
    cluster.heal()
    revived = _restart_stragglers(cluster)
    sim.run_for(3.0)             # drain in-flight retries / elections
    cluster.settle(timeout=30.0)
    sim.run_for(1.0)

    history = [op for rec in recorders for op in rec.history]
    probe_history = [op for rec in probe_recs.values() for op in rec.history]
    base = {(key_of(i), "c"): 1 for i in range(num_keys)}
    violations = check_linearizability(history + probe_history, base)

    availability = audit_availability(
        schedule.applied_events, cohorts, probe_acks, t_end=duration,
        recovery_bound=recovery_bound, n_nodes=cfg.n_nodes)

    auditor = cluster.make_client("audit")
    acked_max: dict[tuple, int] = {}
    for op in history + probe_history:
        if op.kind == "write" and op.ok and op.version is not None:
            cell = (op.key, op.col)
            acked_max[cell] = max(acked_max.get(cell, 0), op.version)
    lost = []
    for (key, col), ver in sorted(acked_max.items()):
        r = auditor.sync_get(key, col, consistent=True)
        if not r.ok or (r.version or 0) < ver:
            lost.append({"key": key, "col": col, "acked_version": ver,
                         "read": r.code.value, "read_version": r.version})

    trace_audit = cluster.obs.tracer.audit_writes()
    watchdog = cluster.obs.watchdog.summary()
    ok = (not violations and availability["ok"] and not lost
          and trace_audit.get("ok", True) and watchdog["ok"])
    extra = {}
    if export_journal:
        # full flight-recorder dump for the offline explainer
        # (benchmarks/explain.py) — opt-in, it dwarfs the result dict
        extra["journal_jsonl"] = cluster.obs.journal.to_jsonl()
    return {
        **extra,
        "seed": seed,
        "lease_enabled": cfg.lease_enabled,
        "duration_s": duration,
        "schedule": sched_text,
        "fault_events": list(schedule.applied),
        "history_ops": len(history),
        "probe_writes_acked": {rid: len(a)
                               for rid, a in sorted(probe_acks.items())},
        "linearizability": {"ok": not violations, "violations": violations},
        "availability": availability,
        "lost_acked_writes": lost,
        "revived_stragglers": revived,
        "client_robustness": _aggregate_robustness(clients),
        "trace_audit": trace_audit,
        "watchdog": watchdog,
        "ok": ok,
    }


def run_spinnaker_minority_leader(lease_enabled: bool = True,
                                  seed: int = 0,
                                  partition_at: float = 1.0,
                                  heal_at: float = 9.0,
                                  t_end: float = 14.0,
                                  probe_period: float = 0.1) -> dict:
    """The chaos harness's signature scenario: symmetric-partition a
    range's leader into the minority while its ZooKeeper session (direct,
    not routed through the data network) stays alive.

    Without leases the stale leader keeps the leadership znode, the
    majority side never re-elects, and the range stalls until the
    partition heals — the availability red flag.  With time-bounded
    leases the majority followers depose the silent leader after its
    lease window provably lapsed and fail over within
    `lease_duration + election` seconds; the cut-off leader abdicates and
    fences its own strong path.  Returns failover / stall measurements
    from the cluster event log plus client-observed write gaps."""
    cfg = ExperimentConfig(seed=seed, lease_enabled=lease_enabled)
    num_keys = 20
    sim, cluster = build_spinnaker(cfg, num_keys=num_keys)
    loader = cluster.make_client("preload")
    _preload(sim, lambda k, cb: loader.put(k, "c", b"seed", cb), num_keys)

    rid = 0
    probe_key = next(key_of(i) for i in range(num_keys)
                     if cluster.range_of(key_of(i)) == rid)
    old = cluster.leader_replica(rid)
    old_leader, old_epoch = old.node.node_id, old.epoch
    lease_duration = old.cfg.lease_duration

    t0 = sim.now
    others = {n for n in cluster.nodes if n != old_leader}
    sim.schedule(partition_at, lambda: cluster.partition({old_leader},
                                                         others))
    sim.schedule(heal_at, cluster.heal)

    acks: list[float] = []
    stop = [False]
    client = cluster.make_client("probe")

    def tick():
        if stop[0]:
            return
        client.put(probe_key, "probe", b"p",
                   lambda r: (r.ok and acks.append(sim.now - t0)))
        sim.schedule(probe_period, tick)

    sim.schedule(0.0, tick)

    # sample the cut-off leader's state well after its lease must have
    # lapsed (evidence of self-fencing, recorded mid-partition)
    sample = {}

    def snap():
        rep = cluster.nodes[old_leader].replicas.get(rid)
        from ..core.replica import Role
        sample["old_leader_role"] = rep.role.name if rep else "GONE"
        sample["old_leader_lease_valid"] = (
            bool(rep.lease_valid()) if rep else False)

    sim.schedule(partition_at + lease_duration + 1.0, snap)

    sim.run(until=t0 + t_end)
    stop[0] = True
    cluster.settle(timeout=30.0)

    failover_s = None
    for ev in cluster.obs.events.events:
        if (ev["kind"] == "leader_open" and ev.get("rid") == rid
                and ev.get("epoch", 0) > old_epoch
                and ev["t"] >= t0 + partition_at):
            failover_s = round(ev["t"] - (t0 + partition_at), 6)
            break

    gap_after_partition = None
    for t in acks:
        if t > partition_at:
            gap_after_partition = round(t - partition_at, 6)
            break
    return {
        "lease_enabled": lease_enabled,
        "lease_duration_s": lease_duration,
        "partition_at_s": partition_at,
        "heal_at_s": heal_at,
        "old_leader": old_leader,
        "failover_s": failover_s,          # None: no re-election happened
        "stalled_until_heal": failover_s is None
        or failover_s > heal_at - partition_at,
        "first_ack_gap_s": gap_after_partition,
        "probe_acks": len(acks),
        **sample,
    }


def run_cassandra_breakdown(spec: WorkloadSpec,
                            cfg: Optional[ExperimentConfig] = None) -> dict:
    """Same decomposition for the Cassandra baseline (quorum writes):
    client_queue / net_req / cpu / durable_wait / reply_net."""
    cfg = cfg or ExperimentConfig()
    sim, cluster = build_cassandra(cfg)
    loader = cluster.make_client("preload")
    n_pre = min(cfg.preload_keys or spec.num_keys, cfg.preload_cap,
                spec.num_keys)

    def pre_put(k, cb):
        loader.next_trace_kind = "preload"
        loader.write(k, "c", b"x" * spec.value_size, True, cb)

    _preload(sim, pre_put, n_pre)
    adapter = CassandraAdapter(cluster.make_client("bench"), quorum=True)
    log, _t_start, _drv = _drive(sim, adapter, spec, cfg, None, cluster,
                                 n_pre)
    return _breakdown_block(cluster, log, cfg, "write")
