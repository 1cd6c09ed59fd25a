"""Per-node metrics registry: counters + gauges scraped into time series.

Counters are bumped at the instrumentation site (`inc`); gauges are
callbacks registered once (`add_gauge`) and evaluated on a sim-time
scrape tick; histograms are log-binned distributions fed by `observe`
(queue waits, lock holds) that scrape their cumulative sample count
like a counter and export full percentiles in `summary()`.  Each scrape
appends one `(t, value)` sample per metric to its series, which is what
the fig9/10-style timeline plots want.

Metric names are flat strings; the exported key is ``n<node>.<name>``
(e.g. ``n2.wal_forces``).  Counters are exported cumulatively — rates
are a post-processing step, like any scrape-based system.

The scrape tick is only armed when `start()` is called (the experiment
runner does this when `metrics_interval > 0`), so clusters built by unit
tests carry no perpetual timers and `run_until_idle` still terminates.
"""

from __future__ import annotations

from typing import Callable, Optional


class MetricsRegistry:
    def __init__(self, sim, interval: float = 0.0):
        self.sim = sim
        self.interval = interval
        self.counters: dict[tuple, float] = {}       # (node, name) -> value
        self.gauges: dict[tuple, Callable[[], float]] = {}
        self.histograms: dict[tuple, object] = {}    # (node, name) -> hist
        self.series: dict[tuple, list] = {}          # (node, name) -> [(t,v)]
        self._running = False
        self._last_scrape_t = -1.0

    # -- instrumentation surface --------------------------------------

    def inc(self, node, name: str, v: float = 1.0) -> None:
        key = (node, name)
        self.counters[key] = self.counters.get(key, 0.0) + v

    def add_gauge(self, node, name: str, fn: Callable[[], float]) -> None:
        self.gauges[(node, name)] = fn

    def observe(self, node, name: str, v: float) -> None:
        """Record one sample into a log-binned histogram metric."""
        key = (node, name)
        h = self.histograms.get(key)
        if h is None:
            # lazy import: obs must not import the workload package at
            # module load (workload -> experiment -> obs would cycle)
            from ..workload.metrics import LatencyHistogram
            h = self.histograms[key] = LatencyHistogram()
        h.add(v)

    # -- scraping -----------------------------------------------------

    def start(self, interval: Optional[float] = None) -> None:
        if interval is not None:
            self.interval = interval
        if self._running or self.interval <= 0:
            return
        self._running = True
        self.sim.schedule(self.interval, self._tick)

    def stop(self) -> None:
        """Disarm the ticker, emitting one final scrape first so short
        runs and the tail interval aren't dropped from the series."""
        if self._running and self.interval > 0 \
                and self.sim.now > self._last_scrape_t:
            self.scrape()
        self._running = False

    def _tick(self) -> None:
        if not self._running:
            return
        self.scrape()
        self.sim.schedule(self.interval, self._tick)

    def scrape(self) -> None:
        """Append one sample per metric at the current sim time."""
        now = self.sim.now
        self._last_scrape_t = now
        for key, val in self.counters.items():
            self.series.setdefault(key, []).append((now, val))
        for key, h in self.histograms.items():
            self.series.setdefault(key, []).append((now, h.total))
        for key, fn in self.gauges.items():
            try:
                v = float(fn())
            except Exception:
                continue        # a gauge over crashed-node state is absent
            self.series.setdefault(key, []).append((now, v))

    # -- export -------------------------------------------------------

    def export(self) -> dict[str, list]:
        return {f"n{node}.{name}": [(round(t, 6), v) for t, v in pts]
                for (node, name), pts in sorted(self.series.items(),
                                                key=lambda kv: str(kv[0]))}

    def summary(self) -> dict[str, dict]:
        """Mean/max per series — the compact form for JSON artifacts."""
        out = {}
        for (node, name), pts in sorted(self.series.items(),
                                        key=lambda kv: str(kv[0])):
            vals = [v for _, v in pts]
            if not vals:
                continue
            out[f"n{node}.{name}"] = {
                "last": vals[-1],
                "mean": sum(vals) / len(vals),
                "max": max(vals),
            }
        for (node, name), h in sorted(self.histograms.items(),
                                      key=lambda kv: str(kv[0])):
            if not h.total:
                continue
            s = h.summary()
            out[f"n{node}.{name}"] = {
                "count": s["count"], "mean_ms": s["mean_ms"],
                "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"],
            }
        return out
