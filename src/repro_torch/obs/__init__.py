"""Observability layer: sim-time tracing, per-node metrics, event log.

One `Observability` instance hangs off each cluster (`cluster.obs`);
components reach it as `node.cluster.obs`.  Everything here is pure
measurement — no modeled sim-time cost, no simulator-RNG draws — so a
run with observability on is bit-identical to one with it off.
"""

from __future__ import annotations

from dataclasses import dataclass

from .events import EventLog
from .journal import ProtocolJournal, record_digest
from .metrics import MetricsRegistry
from .profile import Profiler, format_profile_report
from .trace import (OpTrace, Tracer, TxnTrace, stage_breakdown,
                    CASSANDRA_CHAIN, SPINNAKER_CHAIN)
from .watchdog import InvariantWatchdog

__all__ = [
    "ObsConfig", "Observability", "Tracer", "OpTrace", "TxnTrace",
    "EventLog", "MetricsRegistry", "Profiler", "format_profile_report",
    "stage_breakdown", "ProtocolJournal", "InvariantWatchdog",
    "record_digest",
    "SPINNAKER_CHAIN", "CASSANDRA_CHAIN", "install_node_gauges",
]


@dataclass
class ObsConfig:
    """Knobs carried by the cluster config.

    `trace_sample` is the fraction of client ops traced (error-diffusion
    sampling — see `Tracer`); 2PC chains are always traced when enabled
    since the completeness audit must see *every* committed transaction.
    `metrics_interval` <= 0 leaves the scrape ticker unarmed (on-demand
    `scrape()` only), so plain unit-test clusters carry no timers.

    `profile` enables the component-attributed resource profiler (pure
    accounting — a profiled run is bit-identical to an unprofiled one);
    `profile_interval` > 0 additionally records a per-interval
    utilization timeline (one timer, no RNG draws).

    `journal` enables the protocol flight recorder (obs/journal.py);
    `watchdog` additionally runs the online invariant checker over it —
    both pure measurement, bit-identical on/off."""
    enabled: bool = True
    trace_sample: float = 1.0
    metrics_interval: float = 0.0
    profile: bool = True
    profile_interval: float = 0.0
    journal: bool = True
    watchdog: bool = True


class Observability:
    def __init__(self, sim, system: str, cfg: ObsConfig | None = None):
        self.cfg = cfg or ObsConfig()
        self.sim = sim
        self.tracer = Tracer(sim, system, sample=self.cfg.trace_sample,
                             enabled=self.cfg.enabled)
        self.events = EventLog(sim)
        self.metrics = MetricsRegistry(sim, interval=self.cfg.metrics_interval)
        self.profiler = Profiler(sim, system,
                                 enabled=self.cfg.enabled and self.cfg.profile,
                                 interval=self.cfg.profile_interval)
        self.journal = ProtocolJournal(
            sim, enabled=self.cfg.enabled and self.cfg.journal)
        self.watchdog = InvariantWatchdog(
            self.journal,
            enabled=self.cfg.enabled and self.cfg.journal
            and self.cfg.watchdog)

    def start(self) -> None:
        if self.cfg.enabled and self.cfg.metrics_interval > 0:
            self.metrics.start()
        self.profiler.start()

    def stop(self) -> None:
        """End-of-run flush: final metrics scrape + final profiler
        utilization snapshot.  Idempotent."""
        self.metrics.stop()
        self.profiler.stop()


def install_node_gauges(obs: Observability, node) -> None:
    """Register the per-node gauge set for a Spinnaker node.

    Gauges close over the live node object, so they keep reporting across
    crash/restart cycles (a crashed node reads as an idle one)."""
    m = obs.metrics
    nid = node.node_id
    sim = node.sim
    m.add_gauge(nid, "cpu_queue_s", node.cpu.queue_delay)
    m.add_gauge(nid, "disk_queue", node.disk.queue_depth)
    m.add_gauge(nid, "wal_forces", lambda: node.disk.forces)
    m.add_gauge(nid, "wal_bytes_forced", lambda: node.disk.bytes_forced)
    m.add_gauge(nid, "gc_floor_pins",
                lambda: len(getattr(node.wal, "gc_floor", {})))
    m.add_gauge(nid, "commit_queue_lag", lambda: sum(
        sum(1 for l in rep.queue if l > rep.cmt)
        for rep in node.replicas.values()))
    m.add_gauge(nid, "lock_table_keys", lambda: sum(
        len(rep.txn.locks) for rep in node.replicas.values()
        if getattr(rep, "txn", None) is not None))
    m.add_gauge(nid, "indoubt_2pc", lambda: sum(
        len(rep.txn.prepared) + len(rep.txn.active)
        for rep in node.replicas.values()
        if getattr(rep, "txn", None) is not None))
