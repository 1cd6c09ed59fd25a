"""The statistical checks of the JAX package's stream tests
(`tests/test_workload.py`), run on the port's `OpStream` on any device.
Shared by `test_torch_workload.py` (CPU) and `test_torch_gpu.py` (the
card); imports torch and the port only."""

import collections

import numpy as np
import pytest
import torch

from repro_torch.workload.generators import (OpKind, OpStream, WorkloadSpec,
                                             _sample_batch, _zipf_cdf,
                                             sample_transform)


def stream_deterministic_from_seed(device):
    spec = WorkloadSpec(num_keys=500)
    s1 = OpStream(spec, seed=7, device=device)
    s2 = OpStream(spec, seed=7, device=device)
    ops1 = [s1.next_op() for _ in range(5000)]
    ops2 = [s2.next_op() for _ in range(5000)]
    assert ops1 == ops2
    s3 = OpStream(spec, seed=8, device=device)
    assert [s3.next_op() for _ in range(5000)] != ops1


def op_mix_proportions(device):
    spec = WorkloadSpec(num_keys=100, read_frac=0.5, write_frac=0.3,
                        rmw_frac=0.1, cond_frac=0.1)
    s = OpStream(spec, seed=0, device=device)
    kinds = collections.Counter(s.next_op().kind for _ in range(20000))
    assert kinds[OpKind.READ] / 20000 == pytest.approx(0.5, abs=0.02)
    assert kinds[OpKind.WRITE] / 20000 == pytest.approx(0.3, abs=0.02)
    assert kinds[OpKind.RMW] / 20000 == pytest.approx(0.1, abs=0.01)
    assert kinds[OpKind.COND] / 20000 == pytest.approx(0.1, abs=0.01)


def zipfian_skew_and_scramble(device):
    n = 1000
    spec = WorkloadSpec(num_keys=n, key_dist="zipfian", zipf_theta=0.99)
    s = OpStream(spec, seed=3, device=device)
    keys = collections.Counter(s.next_op().key_index for _ in range(30000))
    top = keys.most_common(1)[0][1] / 30000
    # YCSB theta=0.99 over 1000 keys: hottest key ~1/H_n ≈ 13%
    assert 0.08 < top < 0.20
    # the scramble spreads the hot ranks: the hottest two keys are apart
    (k1, _), (k2, _) = keys.most_common(2)
    assert abs(k1 - k2) > 1
    u = OpStream(WorkloadSpec(num_keys=n, key_dist="uniform"), seed=3,
                 device=device)
    ukeys = collections.Counter(u.next_op().key_index for _ in range(30000))
    assert ukeys.most_common(1)[0][1] / 30000 < 0.01
    assert all(0 <= k < n for k in keys)


def latest_distribution_tracks_horizon(device):
    spec = WorkloadSpec(num_keys=1000, key_dist="latest")
    s = OpStream(spec, seed=0, device=device)
    keys = [s.next_op().key_index for _ in range(5000)]
    assert np.median(keys) > 800
    s.insert_horizon = 100     # as if only 100 keys were inserted so far
    keys2 = [s.next_op().key_index for _ in range(5000)]
    assert max(keys2) <= 99


def value_size_distributions(device):
    fixed = OpStream(WorkloadSpec(num_keys=10, value_size=777), seed=0,
                     device=device)
    assert {fixed.next_op().value_size for _ in range(100)} == {777}
    uni = OpStream(WorkloadSpec(num_keys=10, value_size=4096,
                                value_size_dist="uniform",
                                value_size_min=100), seed=0, device=device)
    sizes = [uni.next_op().value_size for _ in range(2000)]
    assert min(sizes) >= 100 and max(sizes) <= 4096
    assert len(set(sizes)) > 100


def poisson_gaps_mean(device):
    s = OpStream(WorkloadSpec(num_keys=10), seed=1, device=device)
    gaps = []
    for _ in range(5000):
        gaps.append(s.next_gap(rate=100.0))
        s.next_op()
    assert np.mean(gaps) == pytest.approx(1 / 100.0, rel=0.1)


STREAM_CHECKS = [stream_deterministic_from_seed, op_mix_proportions,
                 zipfian_skew_and_scramble,
                 latest_distribution_tracks_horizon,
                 value_size_distributions, poisson_gaps_mean]

# (num_keys, key_dist, value sizes (vmin, vmax) or None for fixed)
TRANSFORM_CASES = [(1000, "zipfian", None), (50_000_000, "uniform", None),
                   (7, "zipfian", (256, 4096)), (1, "uniform", None)]


def batch_draws(case, device, seed=0, batch=4096):
    """`_sample_batch`'s four outputs on `device`, and the uniform draws
    it took, replayed from a generator with the same seed."""
    n, dist, sizes = case
    vmin, vmax = sizes or (512, 512)
    spec = WorkloadSpec(num_keys=n, key_dist=dist)
    cdf = _zipf_cdf(n, 0.99, device) if dist != "uniform" else None
    mix = torch.tensor(np.cumsum(spec.mix()), dtype=torch.float32,
                       device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = _sample_batch(gen, cdf, mix, n, 512, vmin, vmax, batch)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = [torch.rand(batch, generator=gen, device=device),
             torch.rand(batch, generator=gen, device=device), None]
    if vmax > vmin:
        draws[2] = torch.randint(vmin, vmax + 1, (batch,), generator=gen,
                                 device=device)
    draws.append(torch.rand(batch, generator=gen, device=device))
    return out, draws, (cdf, mix, n)


def transform_on(device, draws, cdf, mix, n):
    to = [None if d is None else d.to(device) for d in draws]
    cdf = None if cdf is None else cdf.to(device)
    return [t.cpu() for t in sample_transform(*to, cdf, mix.to(device), n,
                                              512)]


def assert_transforms_equal(got, want):
    """Ranks, ops and sizes exactly; gaps within an ulp of log1p."""
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=1e-7)
