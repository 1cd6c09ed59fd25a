"""The port's CUDA kernels against their plain versions on the card, and
the model and engine through them.  Skips without a card; run there with
`PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py`."""

import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.w8a16 import ops as w8_ops
from repro_torch.kernels.w8a16.ref import w8a16_ref
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                prefill)
from repro_torch.launch.shapes import make_batch
from repro_torch.models.model import hybrid_attn_mask, init_quantized_params
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
from repro_torch.train.step import loss_and_grads
from repro_torch.workload.generators import OpStream, WorkloadSpec
from repro_torch.models.moe import init_moe
from repro_torch.models.quant import quantize_weight
from repro_torch.obs import spans
from torch_dist_workers import gpu_ep_moe, gpu_gpipe, gpu_sharded, run_ranks
from torch_stream_checks import (STREAM_CHECKS, TRANSFORM_CASES,
                                 assert_transforms_equal, batch_draws,
                                 transform_on)
from torch_w8a16_cases import INT8_MATMUL_SHAPES, ROWS, SERVE_CHAT

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, H, Hkv, Sq, Sk, hd, causal, window): tests/test_kernels.py FA_SHAPES,
# every head dim the configs use, and a row set with no visible key
FA_CASES = [
    (1, 4, 4, 64, 64, 32, True, 0), (2, 8, 2, 96, 96, 64, True, 0),
    (1, 4, 1, 128, 128, 32, True, 0), (1, 2, 2, 80, 80, 32, True, 0),
    (1, 4, 2, 64, 64, 32, True, 24), (1, 2, 2, 48, 48, 16, False, 0),
    (1, 6, 2, 100, 100, 96, True, 0), (1, 4, 4, 70, 70, 112, True, 0),
    (1, 4, 2, 130, 130, 128, True, 40), (1, 2, 2, 70, 70, 256, True, 0),
    (1, 2, 2, 48, 16, 16, False, 8), (2, 15, 5, 200, 200, 64, True, 0),
]
# (B, H, Hkv, T, hd, length, window): DA_SHAPES, head dims, length > T
DA_CASES = [
    (2, 4, 4, 128, 32, 100, 0), (1, 8, 2, 256, 64, 256, 0),
    (2, 4, 1, 64, 32, 1, 0), (1, 4, 4, 160, 32, 130, 0),
    (1, 4, 2, 256, 32, 200, 96), (2, 12, 4, 100, 96, 77, 0),
    (1, 4, 4, 90, 112, 90, 0), (2, 96, 8, 200, 128, 150, 0),
    (1, 4, 2, 80, 256, 70, 30), (8, 15, 5, 512, 64, 700, 0),
    (8, 15, 5, 512, 64, 0, 0),
    # the split's edges: length 1 of a long cache, one row past a split
    # boundary (385: 6 splits of 2 bf16 tiles, the fourth holding one row), a
    # window inside one split, length > T with a window wider
    # than the cache, one split (B * Hkv = 1056), f32/bf16 at hd 256
    (2, 8, 1, 4096, 64, 1, 0), (8, 15, 5, 2048, 64, 705, 0),
    (8, 15, 5, 2048, 64, 385, 0),
    (8, 15, 5, 2048, 64, 1500, 20), (2, 4, 2, 1100, 32, 1500, 600),
    (33, 32, 32, 64, 16, 64, 0), (2, 8, 2, 1100, 256, 1090, 0),
]
# (b, s, h, p, n, chunk, strong decay): tests/test_kernels.py SSD_SHAPES,
# Mamba2-2.7B's and Zamba2-7B's shapes, and A = -16, dt = 0.1, where
# exp(cum_i - cum_j) above the diagonal overflows
SSD_CASES = [
    (1, 64, 4, 16, 16, 16, False), (2, 128, 8, 32, 32, 32, False),
    (1, 96, 2, 16, 64, 32, False), (1, 64, 8, 64, 16, 64, False),
    (2, 2048, 80, 64, 128, 128, False), (2, 512, 112, 64, 64, 128, False),
    (1, 512, 8, 64, 128, 128, True),
    # the main paths' f32 forwards at S=256: Mamba2-2.7B, Zamba2-7B
    (2, 256, 80, 64, 128, 128, False), (2, 256, 112, 64, 64, 128, False),
]
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, H, Hkv, Sq, Sk, hd, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (B, H, Sq, hd), DTYPES[dtype], cuda)
    k = _randn(gen, (B, Hkv, Sk, hd), DTYPES[dtype], cuda)
    v = _randn(gen, (B, Hkv, Sk, hd), DTYPES[dtype], cuda)
    var = fa_ops.variant(DTYPES[dtype], hd)
    before, by_var = fa_ops.launches, fa_ops.launches_by_variant[var]
    out = fa_ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert fa_ops.launches_by_variant[var] == by_var + 1
    ref = fa_ops.PLAIN[var](q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# (B, H, Hkv, Sq, Sk, hd, causal, window): bf16 cases of the wgmma kernel
# at every head dim it takes, GQA, ragged Sq / Sk, windows, and rows with
# no visible key
WGMMA_CASES = [
    (2, 15, 5, 2048, 2048, 64, True, 0), (2, 15, 5, 2000, 2000, 64, True, 0),
    (2, 15, 5, 2048, 2048, 64, True, 256), (1, 56, 8, 2048, 2048, 128, True,
                                            0),
    (1, 4, 2, 130, 130, 128, True, 40), (1, 6, 2, 300, 200, 128, False, 0),
    (1, 4, 4, 200, 300, 64, True, 0), (1, 2, 2, 48, 16, 64, False, 8),
    (1, 2, 1, 40, 40, 128, False, 8), (3, 8, 8, 1, 77, 64, False, 0),
    # hd 112, 96 and 256: Zamba2-7B's, Phi-3-Vision-4.2B's and Gemma-7B's
    # prefill shapes, then GQA, ragged, window and no-visible-key cases
    (2, 32, 32, 2048, 2048, 112, True, 32768),
    (2, 32, 32, 2048, 2048, 96, True, 0), (2, 16, 16, 2048, 2048, 256, True,
                                           0),
    (1, 8, 2, 200, 200, 96, True, 0), (1, 4, 4, 130, 130, 112, True, 40),
    (1, 6, 2, 300, 200, 112, False, 0), (1, 4, 2, 130, 130, 256, True, 40),
    (1, 8, 2, 200, 300, 256, True, 0), (1, 2, 2, 48, 16, 96, False, 8),
    (1, 2, 2, 48, 16, 256, False, 8),
]


# (B, H, Hkv, Sq, Sk, hd, causal, window): the fma kernel's edges at every
# head dim it takes in f32 (chip_smoke.py's FMA_EDGES): Sq and Sk off the
# 16-, 32- and 64-row query tiles and the 32-key tile, bidirectional
# Sk < Sq, a window inside one key tile, GQA 4:1, rows that see no key,
# and S = 64 at 30 and 64 (b, h) pairs
FMA_EDGES = [
    case for hd in (16, 32, 64, 96, 112, 128, 256) for case in (
        (1, 4, 2, 77, 77, hd, True, 0), (2, 32, 8, 300, 300, hd, True, 0),
        (1, 40, 10, 100, 77, hd, True, 20), (1, 2, 2, 70, 45, hd, False, 0),
        (1, 2, 2, 100, 100, hd, True, 5), (1, 8, 2, 100, 100, hd, True, 0),
        (1, 2, 2, 48, 16, hd, False, 8), (2, 15, 5, 64, 64, hd, True, 0),
        (2, 32, 8, 64, 64, hd, True, 0))]


@pytest.mark.parametrize("case", FMA_EDGES)
def test_flash_fma_kernel_on_every_tiling(cuda, case):
    """The fma kernel in f32 (and in bf16 at hd 16 and 32) on the tiling
    ops.fma_tiling picks and on each of 64, 32 and 16 query rows a block
    with one and two warps a row group, against its plain version; rows
    that see no key give 0."""
    B, H, Hkv, Sq, Sk, hd, causal, window = case
    dtypes = ["float32"] + (["bfloat16"] if hd <= 32 else [])
    for dtype in dtypes:
        gen = torch.Generator(device=cuda).manual_seed(3)
        q = _randn(gen, (B, H, Sq, hd), DTYPES[dtype], cuda)
        k = _randn(gen, (B, Hkv, Sk, hd), DTYPES[dtype], cuda)
        v = _randn(gen, (B, Hkv, Sk, hd), DTYPES[dtype], cuda)
        ref = fa_ops.PLAIN["fma"](q, k, v, causal=causal, window=window)
        for tiling in [None] + list(itertools.product(fa_ops.Q_TILES,
                                                      fa_ops.HD_SPLITS)):
            out = fa_ops._launch("fma", q, k, v, causal, window, tiling)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all()
            torch.testing.assert_close(out.float(), ref.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
            if not causal and window and Sq > Sk + window - 1:
                dead = out[:, :, Sk + window - 1:]
                assert torch.equal(dead, torch.zeros_like(dead))


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_wgmma_kernel_matches_plain(cuda, case):
    B, H, Hkv, Sq, Sk, hd, causal, window = case
    assert fa_ops.variant(torch.bfloat16, hd) == "wgmma"
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, (B, H, Sq, hd), torch.bfloat16, cuda)
    k = _randn(gen, (B, Hkv, Sk, hd), torch.bfloat16, cuda)
    v = _randn(gen, (B, Hkv, Sk, hd), torch.bfloat16, cuda)
    before = fa_ops.launches_by_variant["wgmma"]
    out = fa_ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches_by_variant["wgmma"] == before + 1
    assert torch.isfinite(out.float()).all()
    ref = fa_ops.PLAIN["wgmma"](q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    if not causal and window and Sq > Sk + window - 1:   # no visible key
        dead = out[:, :, Sk + window - 1:]
        assert torch.equal(dead, torch.zeros_like(dead))


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-2.7b", "zamba2-7b"])
def test_bf16_prefill_launches_each_variant(cuda, arch):
    """A bf16 prefill of each family: dense at head dim 64 through the
    wgmma flash kernel, Mamba2 through the tensor-core scan (three
    launches a layer), the hybrid through both the tensor-core scan and
    (head dim 32) the FMA flash kernel."""
    extra = {"head_dim": 64} if arch == "smollm-360m" else {}
    cfg = smoke_config(arch).scaled(dtype="bfloat16", attn_impl="pallas",
                                    **extra)
    params = init_params(cfg, seed=0, device=cuda)
    S = 2 * cfg.ssm_chunk if cfg.family != "dense" else 100
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S))).to(cuda)
    fa_ops.zero_launches()
    ssd_ops.zero_launches()
    logits = prefill(params, {"tokens": tokens}, cfg, S)
    torch.cuda.synchronize()
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    plain = prefill(params, {"tokens": tokens}, cfg.scaled(attn_impl="xla"),
                    S)
    rel = float((logits - plain).abs().max() / plain.abs().max())
    assert rel < 0.1
    slots = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    expected_fa = {"dense": {"wgmma": cfg.num_layers, "fma": 0},
                   "ssm": {"wgmma": 0, "fma": 0},
                   "hybrid": {"wgmma": 0, "fma": slots}}[cfg.family]
    ssd_layers = cfg.num_layers if cfg.family != "dense" else 0
    assert fa_ops.launches_by_variant == expected_fa
    assert ssd_ops.launches_by_variant == {"tc": 3 * ssd_layers, "fma": 0}
    assert fa_ops.launches == sum(expected_fa.values())
    assert ssd_ops.launches == 3 * ssd_layers


@pytest.mark.parametrize("arch,hd", [("zamba2-7b", 112),
                                     ("phi-3-vision-4.2b", 96),
                                     ("gemma-7b", 256)])
def test_bf16_prefill_at_wide_head_dims_launches_wgmma(cuda, arch, hd):
    """The smoke configs of the archs whose bf16 attention is at head dims
    112, 96 and 256, at those head dims: one wgmma flash launch a layer or
    shared-attention slot, none of the FMA kernel, logits near the eager
    path's."""
    cfg = smoke_config(arch).scaled(dtype="bfloat16", attn_impl="pallas",
                                    head_dim=hd)
    params = init_params(cfg, seed=0, device=cuda)
    S = 2 * cfg.ssm_chunk if cfg.family == "hybrid" else 100
    batch = make_batch(cfg, np.random.default_rng(1), 2, S, device=cuda)
    fa_ops.zero_launches()
    logits = prefill(params, batch, cfg, S)
    torch.cuda.synchronize()
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    slots = sum(hybrid_attn_mask(cfg)) if cfg.family == "hybrid" \
        else cfg.num_layers
    assert fa_ops.launches_by_variant == {"wgmma": slots, "fma": 0}
    plain = prefill(params, batch, cfg.scaled(attn_impl="xla"), S)
    rel = float((logits - plain).abs().max() / plain.abs().max())
    assert rel < 0.1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DA_CASES)
def test_decode_kernel_matches_plain(cuda, case, dtype):
    B, H, Hkv, T, hd, length, window = case
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, (B, H, hd), DTYPES[dtype], cuda)
    k = _randn(gen, (B, Hkv, T, hd), DTYPES[dtype], cuda)
    v = _randn(gen, (B, Hkv, T, hd), DTYPES[dtype], cuda)
    length = torch.tensor(length, dtype=torch.int32, device=cuda)
    before = da_ops.launches
    out = da_ops.decode_attention(q, k, v, length, window=window)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    ref = decode_attention_ref(q, k, v, length, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_decode_kernel_at_deepseek_heads_over_16k_tokens(cuda):
    """DeepSeek-Coder-33B's heads (56 q, 8 kv, hd 128) over its published
    16K context, bf16, split by `ops.num_splits` over the SMs.  Over 16K
    rows |o| ~ sqrt(e / len) ~ 0.013, so the limit is scaled to it: a
    dropped split (an eighth of the rows at 16 units) moves o by ~0.003
    an element and ~0.01 at the maximum, far above atol 2e-3."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (2, 56, 128), torch.bfloat16, cuda)
    k = _randn(gen, (2, 8, 16384, 128), torch.bfloat16, cuda)
    v = _randn(gen, (2, 8, 16384, 128), torch.bfloat16, cuda)
    for length in (16384, 9000, 1):
        len_t = torch.tensor(length, dtype=torch.int32, device=cuda)
        out = da_ops.decode_attention(q, k, v, len_t)
        ref = decode_attention_ref(q, k, v, len_t)
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                                   atol=2e-3)


def test_decode_workspace_is_reused_across_calls_and_shapes(cuda):
    """One cached workspace per (device, shape): calls of one shape with
    other lengths reuse it and stay right, another shape gets its own,
    and every call leaves the ticket counters at zero."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    shapes = [(8, 15, 5, 2048, 64), (2, 56, 8, 1024, 128),
              (8, 15, 5, 2048, 64)]
    for B, H, Hkv, T, hd in shapes:
        q = _randn(gen, (B, H, hd), torch.float32, cuda)
        k = _randn(gen, (B, Hkv, T, hd), torch.float32, cuda)
        v = _randn(gen, (B, Hkv, T, hd), torch.float32, cuda)
        for length, window in ((T, 0), (37, 0), (T - 5, 64), (3, 0)):
            len_t = torch.tensor(length, dtype=torch.int32, device=cuda)
            out = da_ops.decode_attention(q, k, v, len_t, window=window)
            ref = decode_attention_ref(q, k, v, len_t, window=window)
            torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
            for _, _, counters in da_ops._WORKSPACES.values():
                assert int(counters.abs().sum()) == 0
    keys = {key[1:] for key in da_ops._WORKSPACES}
    f32_ring = {hd: da_ops.ring_bytes(hd, torch.float32) for hd in (64, 128)}
    assert (40, da_ops.num_splits(40, 2048, f32_ring[64]), 4, 64) in keys
    assert (16, da_ops.num_splits(16, 1024, f32_ring[128]), 8, 128) in keys


def test_each_wrapper_counts_its_launches(cuda):
    """One launch per decode call; three per ssd_scan call of either
    variant; none for a call that raises."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, (2, 6, 64), torch.bfloat16, cuda)
    k = _randn(gen, (2, 2, 128, 64), torch.bfloat16, cuda)
    da_ops.zero_launches()
    for length in (1, 50, 128):
        da_ops.decode_attention(q, k, k, length)
    with pytest.raises(TypeError):
        da_ops.decode_attention(q.half(), k.half(), k.half(), 3)
    assert da_ops.launches == 3
    assert da_ops.launches_by_variant == {"split": 3}
    ssd_ops.zero_launches()
    for dtype in (torch.float32, torch.bfloat16, torch.float32):
        x, dt, A, B, C = ssd_inputs((1, 64, 4, 16, 16, 16, False), dtype,
                                    cuda)
        ssd_ops.ssd_scan(x, dt, A, B, C, chunk=16)
    assert ssd_ops.launches_by_variant == {"tc": 3, "fma": 6}
    assert ssd_ops.launches == 9


def ssd_inputs(case, dtype, device, seed=0):
    """The reference's SSD test inputs (x, B, C normal; dt uniform in
    [0.001, 0.1]; A uniform in [-2, -0.5]) or, with strong decay, A = -16
    and dt = 0.1."""
    b, s, h, p, n, chunk, strong = case
    gen = torch.Generator(device=device).manual_seed(seed)
    x = _randn(gen, (b, s, h, p), dtype, device)
    if strong:
        dt = torch.full((b, s, h), 0.1, device=device)
        A = torch.full((h,), -16.0, device=device)
    else:
        dt = 0.001 + 0.099 * torch.rand((b, s, h), generator=gen,
                                        device=device)
        A = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=device))
    B = _randn(gen, (b, s, n), dtype, device)
    C = _randn(gen, (b, s, n), dtype, device)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, case, dtype):
    x, dt, A, B, C = ssd_inputs(case, DTYPES[dtype], cuda)
    var = ssd_ops.variant(DTYPES[dtype], case[3], case[4], case[5])
    assert var == ("tc" if dtype == "bfloat16" else "fma")
    before, by_var = ssd_ops.launches, ssd_ops.launches_by_variant[var]
    y, _ = ssd_ops.ssd(x, dt, A, B[:, :, None], C[:, :, None],
                       chunk=case[5])
    torch.cuda.synchronize()
    n = ssd_ops.LAUNCHES_PER_CALL[var]
    assert ssd_ops.launches == before + n
    assert ssd_ops.launches_by_variant[var] == by_var + n
    assert y.dtype == x.dtype and torch.isfinite(y.float()).all()
    ref = ssd_ops.PLAIN[var](x, dt, A, B, C, case[5])
    torch.testing.assert_close(y.float(), ref.float(), rtol=SSD_TOL[dtype],
                               atol=SSD_TOL[dtype])


def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C = ssd_inputs((1, 64, 2, 16, 16, 16, False),
                                torch.float32, cuda)
    before = ssd_ops.launches
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ops.ssd_scan(x[:, :40], dt[:, :40], A, B[:, :40], C[:, :40],
                         chunk=16)
    B2 = torch.stack([B, B], dim=2)
    with pytest.raises(ValueError, match="one B/C group"):
        ssd_ops.ssd(x, dt, A, B2, B2, chunk=16)
    x48 = torch.zeros(1, 64, 2, 48, device=cuda)            # head dim 48
    with pytest.raises(ValueError, match="unsupported"):
        ssd_ops.ssd_scan(x48, dt, A, B, C, chunk=16)
    B256 = torch.zeros(1, 64, 256, device=cuda)              # state 256
    with pytest.raises(ValueError, match="unsupported"):
        ssd_ops.ssd_scan(x, dt, A, B256, B256, chunk=16)
    with pytest.raises(ValueError, match="unsupported"):
        ssd_ops.ssd_scan(x, dt, A, B, C, chunk=8)
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(x, dt.double(), A, B, C, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3),
                         dt, A, B, C, chunk=16)
    assert ssd_ops.launches == before


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)          # head dim 48
    with pytest.raises(ValueError, match="unsupported"):
        fa_ops.flash_attention_bhsd(q, q, q)
    # bf16 at hd 96, 112 and 256 is the wgmma kernel's alone
    for hd in (96, 112, 256):
        q = torch.zeros(1, 2, 8, hd, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(RuntimeError, match="fma"):
            fa_ops._launch("fma", q, q, q, True, 0)
    q = torch.zeros(1, 2, 64, dtype=torch.float16, device=cuda)
    k = torch.zeros(1, 1, 8, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        da_ops.decode_attention(q, k, k, 3)
    k = torch.zeros(1, 1, 64, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        da_ops.decode_attention(q.float(), k, k, 3)


def test_model_decode_matches_forward_through_the_kernels(cuda):
    cfg = smoke_config("smollm-360m").scaled(dtype="float32",
                                             attn_impl="pallas")
    params = init_params(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24))).to(cuda)
    d0, f0 = da_ops.launches, fa_ops.launches
    ref, _, _ = forward(params, {"tokens": tokens}, cfg)
    cache = init_cache(cfg, 2, 24, device=cuda)
    outs = []
    for t in range(24):
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], cfg)
        outs.append(logits)
    torch.testing.assert_close(torch.stack(outs, 1), ref, rtol=2e-3,
                               atol=2e-3)
    assert fa_ops.launches == f0 + cfg.num_layers
    assert da_ops.launches == d0 + 24 * cfg.num_layers


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_models_decode_matches_forward_through_the_kernels(cuda, arch):
    cfg = smoke_config(arch).scaled(dtype="float32", attn_impl="pallas")
    params = init_params(cfg, seed=0, device=cuda)
    S = 2 * cfg.ssm_chunk                            # carries the state once
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S))).to(cuda)
    s0, d0, f0 = ssd_ops.launches, da_ops.launches, fa_ops.launches
    ref, _, _ = forward(params, {"tokens": tokens}, cfg)
    cache = init_cache(cfg, 2, S, device=cuda)
    outs = []
    for t in range(S):
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], cfg)
        outs.append(logits)
    torch.testing.assert_close(torch.stack(outs, 1), ref, rtol=2e-3,
                               atol=2e-3)
    assert ssd_ops.launches == s0 + 3 * cfg.num_layers     # 3 per call
    slots = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    assert fa_ops.launches == f0 + slots
    assert da_ops.launches == d0 + S * slots


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b"])
def test_moe_models_through_the_kernels_match_eager(cuda, arch, quantized):
    """The MoE smoke configs at head dim 128, f32, dense or int8 weights:
    the forward through flash fma and 8 decode steps through the split
    kernel, each against the eager path on the card within the
    whole-model tolerance 2e-4."""
    cfg = smoke_config(arch).scaled(dtype="float32", attn_impl="pallas",
                                    head_dim=128)
    init = init_quantized_params if quantized else init_params
    params = init(cfg, seed=0, device=cuda)
    eager = cfg.scaled(attn_impl="xla")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16))).to(cuda)
    d0, f0 = da_ops.launches, fa_ops.launches
    out, aux, _ = forward(params, {"tokens": tokens}, cfg)
    ref, ref_aux, _ = forward(params, {"tokens": tokens}, eager)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 and float(aux) > 0
    assert fa_ops.launches == f0 + cfg.num_layers
    cache = init_cache(cfg, 2, 16, device=cuda)
    cache_e = init_cache(cfg, 2, 16, device=cuda)
    for t in range(8):
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], cfg)
        ref, cache_e = decode_step(params, cache_e, tokens[:, t:t + 1],
                                   eager)
        torch.testing.assert_close(logits, ref, rtol=2e-4, atol=2e-4)
    assert da_ops.launches == d0 + 8 * cfg.num_layers


def test_engine_tokens_equal_with_kernels_and_plain(cuda):
    cfg = smoke_config("smollm-360m").scaled(dtype="float32",
                                             attn_impl="pallas")
    params = init_params(cfg, seed=1, device=cuda)
    outs = []
    for impl in ("pallas", "xla"):
        eng = ServingEngine(cfg.scaled(attn_impl=impl), params,
                            ServeConfig(slots=2, max_seq=24), device=cuda)
        for i, p in enumerate(([5, 6, 7], [1, 2], [9, 10, 11, 12])):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=12))
        eng.run_until_drained()
        assert int(eng.cache["pos"]) > 24         # past the cache end
        outs.append({r: q.output for r, q in eng.finished.items()})
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the W8A16 GEMM
# ---------------------------------------------------------------------------


def _w8a16_inputs(lead, M, K, N, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = quantize_weight(torch.randn(lead + (K, N), generator=gen,
                                    device=device) * K ** -0.5)
    x = torch.randn(lead + (M, K), generator=gen, device=device
                    ).to(torch.bfloat16)
    return x, w


def _f32_product(x, w):
    return x.float() @ (w["q"].float() * w["s"][..., None, :])


@pytest.mark.parametrize("name", list(SERVE_CHAT))
def test_w8a16_kernel_at_serve_chat_shapes(cuda, name):
    """Phi-3.5-MoE's serve-chat shapes: against the f32 product no less
    accurate than the path it replaces (wcast + matmul), within bf16's
    kernel tolerance of the largest entry, and two calls equal bit for
    bit."""
    E, M, K, N = SERVE_CHAT[name]
    x, w = _w8a16_inputs((E,) if E else (), M, K, N, cuda)
    before = w8_ops.launches_by_variant["mma"]
    y = w8_ops.w8a16_matmul(x, w)
    assert torch.equal(y, w8_ops.w8a16_matmul(x, w))
    assert w8_ops.launches_by_variant["mma"] == before + 2
    ref = _f32_product(x, w)
    err = float((y.float() - ref).abs().max())
    plain = float((w8a16_ref(x, w).float() - ref).abs().max())
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert err <= plain, (err, plain)
    assert err <= TOL["bfloat16"] * float(ref.abs().max())


@pytest.mark.parametrize("K,N", INT8_MATMUL_SHAPES)
def test_w8a16_kernel_on_every_int8_shape_of_the_configs(cuda, K, N):
    _, w = _w8a16_inputs((), 1, K, N, cuda)
    for i, M in enumerate(ROWS):
        x = _w8a16_inputs((), M, K, 16, cuda, seed=i + 1)[0]
        y = w8_ops.w8a16_matmul(x, w)
        ref = _f32_product(x, w)
        torch.testing.assert_close(
            y.float(), ref, rtol=0,
            atol=TOL["bfloat16"] * float(ref.abs().max()))
        assert torch.equal(y, w8_ops.w8a16_matmul(x, w)), M


def test_w8a16_kernel_on_other_cuts_and_ragged_edges(cuda):
    """Column and k tiles cut at the edge (N % 128, K % 64 nonzero), rows
    past one tile, and the same product over other block counts: equal
    to the f32 product, and every cut's counters left at zero."""
    from repro_torch.kernels.w8a16 import ref as w8_ref
    x, w = _w8a16_inputs((3,), 17, 200, 272, cuda)
    ref = _f32_product(x, w)
    _, _, total = w8_ref.iterations(3, 200, 272)
    for blocks in (1, 2, 5, 7, total):
        y = w8_ops._launch(x, w["q"], w["s"], blocks)
        torch.testing.assert_close(y.float(), ref, rtol=0,
                                   atol=TOL["bfloat16"] * float(
                                       ref.abs().max()))
        _, counters = w8_ops._SCRATCH[x.device]
        assert int(counters.abs().sum()) == 0


def test_w8a16_raises_on_what_the_kernel_does_not_take(cuda):
    x, w = _w8a16_inputs((), 65, 256, 128, cuda)
    before = w8_ops.launches
    with pytest.raises(ValueError, match="unsupported"):
        w8_ops.w8a16_matmul(x, w)
    x, w = _w8a16_inputs((), 4, 256, 24, cuda)              # N % 16
    with pytest.raises(ValueError, match="unsupported"):
        w8_ops.w8a16_matmul(x, w)
    x, w = _w8a16_inputs((), 4, 256, 128, cuda)
    with pytest.raises(TypeError):
        w8_ops.w8a16_matmul(x.float(), w)
    with pytest.raises(ValueError, match="contiguous"):
        w8_ops.w8a16_matmul(x, {"q": w["q"].t().contiguous().t(),
                                "s": w["s"]})
    with pytest.raises(ValueError, match="bad shapes"):
        w8_ops.w8a16_matmul(x[:, :128], w)
    assert w8_ops.launches == before


def test_w8a16_launches_7_a_layer_in_a_full_width_phi_decode_step(cuda):
    """Phi-3.5-MoE at full width, 2 layers, int8, bf16, 32 slots: a decode
    step runs its 7 int8 matmuls a layer (wq, wk, wv, wo and the three
    expert stacks) on the kernel, counted by the launch counter and the
    tracer; a 2 x 512 prefill (160 rows an expert) runs none there."""
    cfg = get_config("phi3.5-moe-42b-a6.6b").scaled(
        num_layers=2, attn_impl="pallas")
    params = init_quantized_params(cfg, seed=0, device=cuda)
    cache = init_cache(cfg, 32, 64, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (32, 1))).to(cuda)
    before = w8_ops.launches
    spans.enable()
    logits, _ = decode_step(params, cache, tokens, cfg)
    counters = spans.collect()["counters"]
    assert torch.isfinite(logits).all()
    assert w8_ops.launches == before + 7 * cfg.num_layers
    assert counters["quant.kernel_calls"] == 7 * cfg.num_layers
    assert "quant.dequant_calls" not in counters
    spans.enable()
    prefill(params, {"tokens": tokens.reshape(2, 16).repeat(1, 32)}, cfg,
            512)
    counters = spans.collect()["counters"]
    assert w8_ops.launches == before + 7 * cfg.num_layers
    assert counters["quant.dequant_calls"] == 7 * cfg.num_layers
    assert "quant.kernel_calls" not in counters


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-2.7b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """chip_smoke.py's phase 9(d) at the smoke configs: one f32 step on
    the card against the CPU (microbatches 1 and 2, int8 compression):
    loss 1e-5, grad_norm 1e-4, new params rtol = atol = 2e-5, the same
    int8 round trip of the same grads; no kernel launches."""
    da_ops.zero_launches()
    fa_ops.zero_launches()
    ssd_ops.zero_launches()
    report = _chip_smoke().train_card_vs_cpu(smoke_config(arch), cuda, B=2,
                                             S=64)
    assert set(report) == {"microbatches 1", "microbatches 2",
                           "grad_compression"}
    assert da_ops.launches == fa_ops.launches == ssd_ops.launches == 0


def test_kernels_refuse_a_gradient_on_the_card(cuda):
    cfg = smoke_config("smollm-360m").scaled(dtype="bfloat16",
                                             attn_impl="pallas")
    params = init_params(cfg, seed=0, device=cuda)
    tokens = torch.zeros((1, 16), dtype=torch.int32, device=cuda)
    before = fa_ops.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        loss_and_grads(params, {"tokens": tokens, "labels": tokens}, cfg)
    assert fa_ops.launches == before


# ---------------------------------------------------------------------------
# the workload generator on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("check", STREAM_CHECKS, ids=lambda f: f.__name__)
def test_port_stream_statistics_on_the_card(cuda, check):
    """The reference's stream tests on the card's stream: deterministic
    from the seed; mix, zipf, latest, sizes and gap statistics."""
    check(cuda)


@pytest.mark.parametrize("case", TRANSFORM_CASES)
def test_card_transform_equals_the_cpus_on_the_same_uniforms(cuda, case):
    out, draws, (cdf, mix, n) = batch_draws(case, cuda, seed=4)
    assert all(t.device.type == "cuda" for t in out)
    assert_transforms_equal([t.cpu() for t in out],
                            transform_on("cpu", draws, cdf, mix, n))


def test_default_stream_samples_on_the_card(cuda):
    s = OpStream(WorkloadSpec(num_keys=1000))
    assert s.device.type == "cuda" and s._cdf.device.type == "cuda"
    assert s._mix_cdf.device.type == "cuda"
    assert s._gen.device.type == "cuda"
    s.next_op()
    assert s.sampled == s.batch


# ---------------------------------------------------------------------------
# repro_torch.dist over NCCL, one rank per card
# ---------------------------------------------------------------------------


def test_gpipe_over_nccl_ranks(cuda, tmp_path):
    """GPipe with one stage per card (send/recv over NCCL; a ring of one
    on a single card) against the stages in sequence, 1e-5."""
    for r in run_ranks(gpu_gpipe, torch.cuda.device_count(), tmp_path,
                       timeout=300, backend="nccl"):
        assert r["device"].startswith("cuda") and r["err"] <= 1e-5


def test_ep_moe_over_nccl_ranks(cuda, tmp_path):
    """The expert-parallel all-to-all MoE on a mesh of every card
    (kimi-k2 smoke, 8 experts, cf 8, as tests/test_quant_and_dist.py):
    shard_map and gspmd on each rank's rows equal the single-device path
    within 1e-5, and the grads through the all-to-alls, summed over the
    ranks, are finite and the single-device grads."""
    cfg = smoke_config("kimi-k2-1t-a32b").scaled(
        dtype="float32", num_experts=8, moe_d_ff=64, capacity_factor=8.0,
        shared_expert_d_ff=0)
    params = {k: v.numpy() for k, v in init_moe(
        torch.Generator().manual_seed(0), cfg, torch.float32).items()}
    for r in run_ranks(gpu_ep_moe, torch.cuda.device_count(), tmp_path, cfg,
                       params, timeout=300, backend="nccl"):
        assert r["device"].startswith("cuda")
        assert r["err_sm"] <= 1e-5 and r["err_gs"] <= 1e-5
        assert r["grads_finite"]
        for err, scale in r["err_grads"]:
            assert err <= 1e-5 * max(scale, 1.0)


def test_sharded_parameters_over_nccl_ranks(cuda, tmp_path):
    """Phase 14(d) at smoke widths, TP over every card: a train step with
    each rank's blocks of the state equals the replicated one (1e-5), and
    a bf16 prefill and 4 decode steps on the local heads launch flash
    wgmma and decode split and agree with the replicated path at the
    bf16 tolerance."""
    for r in run_ranks(gpu_sharded, torch.cuda.device_count(), tmp_path,
                       timeout=300, backend="nccl"):
        np.testing.assert_allclose(r["sharded"], r["plain"], rtol=1e-5)
        assert r["serve_err"] <= TOL["bfloat16"]
        assert r["launches"]["flash.wgmma"] > 0
        assert r["launches"]["decode.split"] > 0


def test_dryrun_memory_of_a_card_step(cuda):
    """Phase 14(c) at smoke widths: the dry-run's argument_bytes of a
    train step on a world of one equal the card's train state and batch
    bytes, and FlopCounterMode counts the same FLOPs for the step on the
    card as the dry-run's fake step does."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.train.optim import OptimizerConfig
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)
    from repro_torch.tree import tree_leaves
    cfg = smoke_config("smollm-360m")
    spec = ShapeSpec("card_step", "train", 64, 4)
    tcfg = TrainConfig(optimizer=OptimizerConfig())
    state = init_train_state(cfg, tcfg, device="cuda")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))
                                 .astype(np.int32)).cuda()
             for k in ("tokens", "labels")}
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(state) + tree_leaves(batch))
    with FlopCounterMode(display=False) as fcm:
        make_train_step(cfg, tcfg)(state, batch)
    mem = dryrun.step_memory(cfg, spec)
    assert mem.argument_size_in_bytes == nbytes
    with dryrun.fake_world(1):
        from repro_torch.dist.sharding import ShardingPolicy
        from repro_torch.launch.mesh import make_mesh_for_devices
        mesh = make_mesh_for_devices(1, device_type="cpu")
        flops = dryrun._run(cfg, spec, mesh, ShardingPolicy.for_mesh(mesh))[0]
    assert flops == fcm.get_total_flops()
