"""The workload package's latency metrics: log-binned histograms and
sliding-window timelines (`metrics.py`, a copy of the reference's).

Only what the datastore reaches is here: `obs/metrics.py` imports
`LatencyHistogram` from it.  The generators, drivers, scenarios and the
experiment runner of `repro.workload` come with the workload slice.
"""

from .metrics import LatencyHistogram, OpLog, WindowSummary

__all__ = ["LatencyHistogram", "OpLog", "WindowSummary"]
