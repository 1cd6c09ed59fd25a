"""Chaos harness: safety and liveness auditors plus seeded fault-schedule
generation for the gray-failure DSL (`workload/scenario.py`).

- `linearizability`: per-cell checker over client operation histories —
  Spinnaker cells are versioned registers, so commit versions give a total
  write order and the check reduces to interval sweeps (WGL specialized).
- `availability`: replays the *applied* fault timeline into per-cohort
  majority-healthy windows and demands writes succeed within a recovery
  bound inside each one (red-flags a minority-partitioned leader stalling
  a range the majority could serve).
- `schedule`: seeded random generator composing crash/partition/gray-
  failure episodes into DSL text, for reproducible chaos sweeps.
"""

from .availability import (CohortHealthTimeline, audit_availability,
                           majority_healthy_windows)
from .linearizability import HistOp, HistoryRecorder, check_linearizability
from .schedule import generate_chaos_schedule

__all__ = [
    "HistOp",
    "HistoryRecorder",
    "check_linearizability",
    "CohortHealthTimeline",
    "majority_healthy_windows",
    "audit_availability",
    "generate_chaos_schedule",
]
