"""Latency histograms and sliding-window timelines.

`LatencyHistogram` keeps log-spaced bins (bounded memory at millions of
ops) and answers percentiles by CDF interpolation; `OpLog` tags every
completed op with (time, kind, ok, latency) and can slice the run into
fixed windows — throughput, error rate, and percentiles per window — which
is exactly the shape of the paper's Figs. 9-10 (availability and latency
through a failure).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# 1 µs .. 1000 s, 240 bins per decade.  30/decade (7.97% bin growth) was
# too coarse for tail reporting: a tight p95/p99 pair would collapse into
# one bin and read back as the identical edge value.  240/decade keeps the
# quantization error under 1% while the histogram stays ~17 KB.
_LO, _HI, _PER_DECADE = 1e-6, 1e3, 240


class LatencyHistogram:
    """Log-binned latency histogram with interpolated percentiles."""

    def __init__(self):
        decades = math.log10(_HI / _LO)
        self.n_bins = int(decades * _PER_DECADE) + 2
        self.counts = np.zeros(self.n_bins, dtype=np.int64)
        self.total = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def _bin(self, v: float) -> int:
        if v <= _LO:
            return 0
        idx = int(math.log10(v / _LO) * _PER_DECADE) + 1
        return min(idx, self.n_bins - 1)

    def add(self, v: float) -> None:
        self.counts[self._bin(v)] += 1
        self.total += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def merge(self, other: "LatencyHistogram") -> None:
        self.counts += other.counts
        self.total += other.total
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else math.nan

    def percentile(self, p: float) -> float:
        """p in [0, 100]; returns the bin's upper edge (<1% log error)."""
        if not self.total:
            return math.nan
        target = p / 100.0 * self.total
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, max(target, 1)))
        idx = min(idx, self.n_bins - 1)
        edge = _LO * 10 ** (idx / _PER_DECADE)
        return float(min(max(edge, self.min), self.max))

    def summary(self) -> dict:
        return {
            "count": int(self.total),
            "mean_ms": self.mean * 1e3,
            "p50_ms": self.percentile(50) * 1e3,
            "p95_ms": self.percentile(95) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "min_ms": (self.min if self.total else math.nan) * 1e3,
            "max_ms": self.max * 1e3,
        }


@dataclass
class WindowSummary:
    """One sliding-window sample of a timeline."""
    t_start: float
    t_end: float
    kind: str
    throughput: float          # successful ops/s
    error_rate: float          # failed / issued
    p50_ms: float
    p95_ms: float
    p99_ms: float


class OpLog:
    """Append-only record of completed ops; the single sink every driver
    writes into.

    Columns live in pre-allocated numpy arrays (doubling growth) with
    kinds interned to small int codes, so `count` and `windows` are
    vectorized scans instead of per-row Python loops — material at the
    10^5+ ops a saturation run produces."""

    def __init__(self):
        self._cap = 1024
        self._n = 0
        self._t = np.empty(self._cap, dtype=np.float64)
        self._lat = np.empty(self._cap, dtype=np.float64)
        self._kc = np.empty(self._cap, dtype=np.int32)     # kind codes
        self._okv = np.empty(self._cap, dtype=bool)
        self._code_of: dict[str, int] = {}
        self._name_of: list[str] = []
        self.hists: dict[str, LatencyHistogram] = {}

    def _grow(self) -> None:
        self._cap *= 2
        for name in ("_t", "_lat", "_kc", "_okv"):
            old = getattr(self, name)
            new = np.empty(self._cap, dtype=old.dtype)
            new[:self._n] = old[:self._n]
            setattr(self, name, new)

    def record(self, t_done: float, kind: str, ok: bool,
               latency: float) -> None:
        if self._n == self._cap:
            self._grow()
        code = self._code_of.get(kind)
        if code is None:
            code = self._code_of[kind] = len(self._name_of)
            self._name_of.append(kind)
        i = self._n
        self._t[i] = t_done
        self._lat[i] = latency
        self._kc[i] = code
        self._okv[i] = ok
        self._n = i + 1
        if ok:
            self.hists.setdefault(kind, LatencyHistogram()).add(latency)

    def __len__(self) -> int:
        return self._n

    def count(self, kind: Optional[str] = None, ok: Optional[bool] = None
              ) -> int:
        n = self._n
        if n == 0:
            return 0
        mask = np.ones(n, dtype=bool)
        if kind is not None:
            code = self._code_of.get(kind)
            if code is None:
                return 0
            mask &= self._kc[:n] == code
        if ok is not None:
            mask &= self._okv[:n] == ok
        return int(mask.sum())

    def summary(self, kind: str, duration: Optional[float] = None) -> dict:
        h = self.hists.get(kind)
        out = h.summary() if h else LatencyHistogram().summary()
        out["errors"] = self.count(kind=kind, ok=False)
        if duration:
            out["throughput"] = out["count"] / duration
        return out

    def windows(self, width: float, kind: Optional[str] = None,
                t0: Optional[float] = None, t1: Optional[float] = None
                ) -> list[WindowSummary]:
        """Slice [t0, t1) into `width`-second windows (Figs. 9-10 series).
        The final window is clamped to `t1`, and its throughput divides by
        the clamped width — a 0.5 s tail no longer reads as half the rate
        it actually sustained."""
        n = self._n
        if n == 0:
            return []
        t = self._t[:n]
        lat = self._lat[:n]
        ok = self._okv[:n]
        sel = np.ones(n, dtype=bool)
        if kind is not None:
            code = self._code_of.get(kind)
            if code is None:
                return []
            sel &= self._kc[:n] == code
        t0 = float(t.min()) if t0 is None else t0
        t1 = float(t.max()) + 1e-9 if t1 is None else t1
        out = []
        w0 = t0
        while w0 < t1:
            w1 = min(w0 + width, t1)
            m = sel & (t >= w0) & (t < w1)
            good = m & ok
            n_issued = int(m.sum())
            n_ok = int(good.sum())
            if n_ok:
                ls = np.sort(lat[good])
                pct = lambda p: float(
                    ls[min(len(ls) - 1, int(p / 100 * len(ls)))]) * 1e3
                p50, p95, p99 = pct(50), pct(95), pct(99)
            else:
                p50 = p95 = p99 = math.nan
            out.append(WindowSummary(
                t_start=w0, t_end=w1, kind=kind or "all",
                throughput=n_ok / (w1 - w0),
                error_rate=(n_issued - n_ok) / n_issued if n_issued else 0.0,
                p50_ms=p50, p95_ms=p95, p99_ms=p99))
            w0 += width
        return out
