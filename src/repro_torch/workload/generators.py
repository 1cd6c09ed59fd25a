"""YCSB-style workload generators, sampled with torch on the card.

The hot inner loops — Zipfian CDF inversion, op-mix choice, value sizing,
Poisson inter-arrival sampling — run as a few tensor ops that fill a whole
batch of ops at a time, copied to the host once per batch; the per-op
Python path is an array index into those host buffers.  Key distributions:

- `uniform`: every key equally likely;
- `zipfian`: rank r drawn with P(r) ∝ 1/r^theta (YCSB theta=0.99), with a
  bijective multiplicative scramble so hot ranks spread over the keyspace
  (and therefore over range partitions) instead of piling on node 0;
- `latest`: zipfian over recency — hot keys are the most recently written,
  skewing toward the tail of the keyspace.

The uniform draws come from one `torch.Generator`, so a stream is
reproducible from its seed on one device; it is not the JAX package's
stream (threefry), and a CPU stream is not a CUDA stream.  Given the same
uniform draws, `sample_transform` gives the JAX package's ranks, ops and
sizes exactly (f32 where the reference is f32).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve


class OpKind(enum.IntEnum):
    READ = 0
    WRITE = 1
    RMW = 2         # read-modify-write: strong read, then conditional put
    COND = 3        # conditional put at the last-read version
    TXN = 4         # multi-key transaction (adapter picks the partner keys)


@dataclass(frozen=True)
class Op:
    kind: OpKind
    key_index: int
    value_size: int


@dataclass
class WorkloadSpec:
    """One workload = key distribution + op mix + value sizing."""
    num_keys: int = 10_000
    key_dist: str = "zipfian"          # uniform | zipfian | latest
    zipf_theta: float = 0.99
    scramble: bool = True
    # op mix (normalized at build time)
    read_frac: float = 0.80
    write_frac: float = 0.15
    rmw_frac: float = 0.03
    cond_frac: float = 0.02
    txn_frac: float = 0.0              # multi-key transactions
    # fraction of TXN ops that deliberately span ranges (the adapter
    # resolves partner keys against the live range table, so "cross"
    # means a real 2PC and "local" the single-cohort fast path)
    txn_cross_frac: float = 0.5
    # value sizes (bytes)
    value_size: int = 4096
    value_size_dist: str = "fixed"     # fixed | uniform
    value_size_min: int = 256

    def mix(self) -> np.ndarray:
        m = np.array([self.read_frac, self.write_frac, self.rmw_frac,
                      self.cond_frac, self.txn_frac], dtype=np.float64)
        s = m.sum()
        if s <= 0:
            raise ValueError("op mix must have positive mass")
        return m / s


def _coprime_multiplier(n: int) -> int:
    """Odd multiplicative-hash constant coprime to n (bijective mod n)."""
    a = 2654435761 % n
    while a < 2 or math.gcd(a, n) != 1:
        a = (a + 1) % n or 3
    return a


def _zipf_cdf(n: int, theta: float, device) -> torch.Tensor:
    # one-time precompute in f64 on the host; inversion happens on `device`
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-theta)
    c = np.cumsum(w)
    return torch.from_numpy((c / c[-1]).astype(np.float32)).to(device)


def sample_transform(u_keys: torch.Tensor, u_ops: torch.Tensor,
                     sizes: Optional[torch.Tensor], u_gaps: torch.Tensor,
                     cdf: Optional[torch.Tensor], mix_cdf: torch.Tensor,
                     num_keys: int, vfix: int):
    """Uniform draws -> (key ranks, op kinds, value sizes, gaps), int32 x3
    and f32.  `sizes` holds the drawn value sizes, or None for `vfix`."""
    if cdf is None:                       # uniform keys
        ranks = torch.floor(u_keys * num_keys).to(torch.int32)
    else:                                 # zipfian CDF inversion
        ranks = torch.searchsorted(cdf, u_keys).to(torch.int32)
    ranks = ranks.clamp(0, num_keys - 1)
    ops = torch.searchsorted(mix_cdf, u_ops).to(torch.int32)
    if sizes is None:
        vsz = torch.full_like(ranks, vfix)
    else:
        vsz = sizes.to(torch.int32)
    # unit-rate exponential gaps; the driver scales by 1/rate
    gaps = -torch.log1p(-u_gaps)
    return ranks, ops, vsz, gaps.to(torch.float32)


def _sample_batch(gen: torch.Generator, cdf: Optional[torch.Tensor],
                  mix_cdf: torch.Tensor, num_keys: int, vfix: int,
                  vmin: int, vmax: int, batch: int):
    """One sampling step on `gen`'s device: (key ranks, op kinds, value
    sizes, gaps).  The draws are taken in a fixed order: keys, ops, sizes
    (only when they vary), gaps."""
    dev = mix_cdf.device
    u_keys = torch.rand(batch, generator=gen, device=dev)
    u_ops = torch.rand(batch, generator=gen, device=dev)
    sizes = None
    if vmax > vmin:
        sizes = torch.randint(vmin, vmax + 1, (batch,), generator=gen,
                              device=dev)
    u_gaps = torch.rand(batch, generator=gen, device=dev)
    return sample_transform(u_keys, u_ops, sizes, u_gaps, cdf, mix_cdf,
                            num_keys, vfix)


class OpStream:
    """Iterator of `Op`s backed by batch sampling on `device`.

    `next_op()` costs an array read; a new batch is drawn every `batch`
    ops and copied to the host in one transfer.  Streams with the same
    (spec, seed, device) are identical, which makes every run
    reproducible.  `device` defaults to the card and raises without one.
    """

    def __init__(self, spec: WorkloadSpec, seed: int = 0, batch: int = 8192,
                 device="cuda"):
        if spec.num_keys < 1:
            raise ValueError("num_keys must be >= 1")
        if spec.key_dist not in ("uniform", "zipfian", "latest"):
            raise ValueError(f"unknown key_dist {spec.key_dist!r}")
        self.spec = spec
        self.batch = batch
        self.device = resolve(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._cdf = None
        if spec.key_dist in ("zipfian", "latest"):
            self._cdf = _zipf_cdf(spec.num_keys, spec.zipf_theta,
                                  self.device)
        self._mix_cdf = torch.tensor(np.cumsum(spec.mix()),
                                     dtype=torch.float32, device=self.device)
        self._mult = _coprime_multiplier(spec.num_keys) \
            if (spec.scramble and spec.key_dist == "zipfian"
                and spec.num_keys > 1) else 1
        self._offset = (seed * 40503 + 12345) % spec.num_keys
        if spec.value_size_dist == "uniform":
            self._vmin, self._vmax = spec.value_size_min, spec.value_size
        else:
            self._vmin = self._vmax = spec.value_size
        self._i = self.batch          # force refill on first use
        self._keys = self._ops = self._vsz = self._gaps = None
        self.sampled = 0
        # `latest` support: the most recently inserted key index; drivers
        # bump this on successful writes
        self.insert_horizon = spec.num_keys

    def _refill(self) -> None:
        ranks, ops, vsz, gaps = _sample_batch(
            self._gen, self._cdf, self._mix_cdf, self.spec.num_keys,
            self.spec.value_size, self._vmin, self._vmax, self.batch)
        # one device-to-host copy: the f32 gaps ride along as their bits
        host = torch.stack([ranks, ops, vsz, gaps.view(torch.int32)]) \
            .cpu().numpy()
        keys = host[0]
        if self._mult > 1:
            # bijective scramble rank -> key in int64 on the host (the
            # product overflows int32 for large keyspaces)
            keys = ((keys.astype(np.int64) * self._mult + self._offset)
                    % self.spec.num_keys).astype(np.int32)
        self._keys = keys
        self._ops = host[1]
        self._vsz = host[2]
        self._gaps = host[3].view(np.float32)
        self._i = 0
        self.sampled += self.batch

    def _key_index(self, rank: int) -> int:
        if self.spec.key_dist == "latest":
            # rank 0 = newest key; clip to the current horizon
            return max(0, min(self.insert_horizon, self.spec.num_keys) - 1
                       - rank)
        return int(rank)

    def next_op(self) -> Op:
        if self._i >= self.batch:
            self._refill()
        i = self._i
        self._i += 1
        return Op(kind=OpKind(int(self._ops[i])),
                  key_index=self._key_index(int(self._keys[i])),
                  value_size=int(self._vsz[i]))

    def next_gap(self, rate: float) -> float:
        """Next Poisson inter-arrival time at `rate` ops/s."""
        if self._i >= self.batch:
            self._refill()
        g = float(self._gaps[self._i]) / rate
        # gaps ride along with ops in the same buffer; consuming a gap does
        # not consume the op at the same slot (open-loop drivers call
        # next_gap then next_op, which advances the cursor once)
        return g

    def __iter__(self) -> Iterator[Op]:
        while True:
            yield self.next_op()
