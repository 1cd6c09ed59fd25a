"""Workload engine (paper §9): YCSB-style load generation, open/closed-loop
drivers on the discrete-event simulator, a fault-schedule DSL, and the
experiment plumbing behind `benchmarks/spinnaker_bench.py`.

Layers:

- `generators` — key/op/value/inter-arrival sampling, with torch on the
  card, so millions of ops are pre-sampled in batches instead of per-op
  Python;
- `metrics`   — log-binned latency histograms, p50/p95/p99, and sliding-
  window throughput/availability timelines (Figs. 9-10);
- `drivers`   — closed-loop (N clients) and open-loop (Poisson) drivers
  plus adapters for the Spinnaker and Cassandra client libraries;
- `scenario`  — declarative fault timelines ("at 10s crash node 2 ...");
- `experiment`— build-cluster/preload/drive/collect, one call per curve.
"""

from .drivers import (AckLedgerAdapter, CassandraAdapter, ClosedLoopDriver,
                      OpenLoopDriver, SpinnakerAdapter, TxnAdapter)
from .generators import Op, OpKind, OpStream, WorkloadSpec
from .metrics import LatencyHistogram, OpLog, WindowSummary
from .scenario import FaultEvent, FaultSchedule, parse_schedule
from .experiment import (ExperimentConfig, run_cassandra_breakdown,
                         run_cassandra_profiled, run_cassandra_workload,
                         run_spinnaker_breakdown, run_spinnaker_chaos,
                         run_spinnaker_minority_leader,
                         run_spinnaker_profiled, run_spinnaker_rebalance,
                         run_spinnaker_saturation, run_spinnaker_txn,
                         run_spinnaker_workload)

__all__ = [
    "AckLedgerAdapter",
    "CassandraAdapter",
    "ClosedLoopDriver",
    "ExperimentConfig",
    "FaultEvent",
    "FaultSchedule",
    "LatencyHistogram",
    "Op",
    "OpKind",
    "OpLog",
    "OpenLoopDriver",
    "OpStream",
    "SpinnakerAdapter",
    "TxnAdapter",
    "WindowSummary",
    "WorkloadSpec",
    "parse_schedule",
    "run_cassandra_breakdown",
    "run_cassandra_profiled",
    "run_cassandra_workload",
    "run_spinnaker_breakdown",
    "run_spinnaker_chaos",
    "run_spinnaker_minority_leader",
    "run_spinnaker_profiled",
    "run_spinnaker_rebalance",
    "run_spinnaker_saturation",
    "run_spinnaker_txn",
    "run_spinnaker_workload",
]
