"""The port's plain attention versions against the JAX Pallas kernels (in
interpret mode) on the same inputs, and the CPU dispatch of the wrappers.
Shapes and tolerances are the reference's (tests/test_kernels.py)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_bhd
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_attention_ref
from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      decode_attention_split,
                                                      split_tile)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

FA_SHAPES = [
    # (B, H, Hkv, Sq, Sk, hd, bq, bk, causal, window)
    (1, 4, 4, 64, 64, 32, 16, 16, True, 0),       # MHA causal
    (2, 8, 2, 96, 96, 64, 32, 32, True, 0),       # GQA, non-pow2 grid
    (1, 4, 1, 128, 128, 32, 64, 32, True, 0),     # MQA, asymmetric blocks
    (1, 2, 2, 80, 80, 32, 32, 32, True, 0),       # ragged tail (padding)
    (1, 4, 2, 64, 64, 32, 16, 16, True, 24),      # sliding window
    (1, 2, 2, 48, 48, 16, 16, 16, False, 0),      # bidirectional
    (1, 6, 2, 40, 40, 32, 16, 16, True, 0),       # rep=3, as SmolLM's GQA
] + [
    # the head dims of Phi-3-Vision-4.2B, Zamba2-7B and Gemma-7B, which the
    # wgmma kernel takes in bf16: causal, GQA, ragged tail, window + MQA
    case for hd in (96, 112, 256) for case in (
        (1, 2, 2, 64, 64, hd, 16, 16, True, 0),
        (1, 4, 2, 48, 48, hd, 16, 16, True, 0),
        (1, 2, 2, 40, 40, hd, 16, 16, True, 0),
        (1, 2, 1, 64, 64, hd, 16, 16, True, 24))
]

DA_SHAPES = [
    # (B, H, Hkv, T, hd, bk, length, window)
    (2, 4, 4, 128, 32, 32, 100, 0),
    (1, 8, 2, 256, 64, 64, 256, 0),
    (2, 4, 1, 64, 32, 16, 1, 0),          # first decode step
    (1, 4, 4, 160, 32, 64, 130, 0),        # padded tail
    (1, 4, 2, 256, 32, 64, 200, 96),       # sliding window
    (2, 6, 2, 64, 32, 16, 90, 0),          # length > T (shared serving pos)
    (1, 6, 2, 64, 32, 16, 80, 24),         # length > T with a window
]


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FA_SHAPES)
def test_flash_ref_matches_pallas_kernel(case, dtype):
    B, H, Hkv, Sq, Sk, hd, bq, bk, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)], dtype, 1)
    ref = flash_attention_bhsd(jq, jk, jv, causal=causal, window=window,
                               block_q=bq, block_k=bk, interpret=True)
    port = attention_ref(tq, tk, tv, causal=causal, window=window)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    _close(port, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DA_SHAPES)
def test_decode_ref_matches_pallas_kernel(case, dtype):
    B, H, Hkv, T, hd, bk, length, window = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, H, hd), (B, Hkv, T, hd), (B, Hkv, T, hd)], dtype, 2)
    ref = decode_attention_bhd(jq, jk, jv, jnp.int32(length), window=window,
                               block_k=bk, interpret=True)
    port = decode_attention_ref(tq, tk, tv,
                                torch.tensor(length, dtype=torch.int32),
                                window=window)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    _close(port, ref, dtype)


def test_flash_fully_masked_rows_give_zero():
    """Bidirectional with a window and Sq > Sk + window: rows >= Sk + window
    - 1 see no key.  The oracle gives them 0 (the Pallas kernel does not:
    a fully masked tile there gets p = 1, see its NEG_INF handling)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(1, 2, 48, 16), (1, 2, 16, 16), (1, 2, 16, 16)], "float32", 3)
    ref = jax_attention_ref(jq, jk, jv, causal=False, window=8)
    port = attention_ref(tq, tk, tv, causal=False, window=8)
    _close(port, ref, "float32")
    assert torch.equal(port[:, :, 23:], torch.zeros_like(port[:, :, 23:]))
    assert port[:, :, :23].abs().sum(-1).min() > 0


def test_decode_length_zero_gives_zero():
    _, (tq, tk, tv) = _inputs([(1, 2, 16), (1, 1, 8, 16), (1, 1, 8, 16)],
                              "float32", 4)
    out = decode_attention_ref(tq, tk, tv, 0)
    assert torch.equal(out, torch.zeros_like(out))


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    da_ops.launches = fa_ops.launches = 0
    _, (q, k, v) = _inputs([(2, 6, 32), (2, 2, 64, 32), (2, 2, 64, 32)],
                           "float32", 5)
    length = torch.tensor(40, dtype=torch.int32)
    assert torch.equal(da_ops.decode_attention(q, k, v, length, window=16),
                       decode_attention_ref(q, k, v, length, window=16))
    _, (q, k, v) = _inputs([(2, 40, 6, 32), (2, 40, 2, 32), (2, 40, 2, 32)],
                           "float32", 6)
    bhsd = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    assert torch.equal(fa_ops.flash_attention(q, k, v, window=8),
                       attention_ref(*bhsd, window=8).transpose(1, 2))
    assert da_ops.launches == 0 and fa_ops.launches == 0


def test_wrappers_refuse_a_device_without_a_kernel():
    q = torch.zeros(1, 2, 16, device="meta")
    k = torch.zeros(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        da_ops.decode_attention(q, k, k, 3)
    with pytest.raises(ValueError, match="no kernel"):
        fa_ops.flash_attention_bhsd(q[:, :, None], k, k)
    assert da_ops.launches == 0 and fa_ops.launches == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FA_SHAPES)
def test_flash_ref_with_bf16_p_matches_pallas_kernel(case, dtype):
    """The plain version of the wgmma kernel (P rounded to bf16 before
    P V, row sums in f32) against the Pallas kernel, within the bf16
    tolerance in both dtypes (P's rounding is bf16's)."""
    B, H, Hkv, Sq, Sk, hd, bq, bk, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, H, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)], dtype, 1)
    ref = flash_attention_bhsd(jq, jk, jv, causal=causal, window=window,
                               block_q=bq, block_k=bk, interpret=True)
    port = attention_ref(tq, tk, tv, causal=causal, window=window,
                         round_p=True)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    _close(port, ref, "bfloat16")


def test_flash_ref_with_bf16_p_gives_zero_on_fully_masked_rows():
    _, (tq, tk, tv) = _inputs(
        [(1, 2, 48, 64), (1, 2, 16, 64), (1, 2, 16, 64)], "bfloat16", 3)
    port = attention_ref(tq, tk, tv, causal=False, window=8, round_p=True)
    assert torch.equal(port[:, :, 23:], torch.zeros_like(port[:, :, 23:]))
    ref = attention_ref(tq, tk, tv, causal=False, window=8)
    _close(port[:, :, :23], ref[:, :, :23].float().numpy(), "bfloat16")


def test_flash_variant_dispatch():
    """bf16 at head dim 64, 96, 112, 128 or 256 goes to the wgmma kernel;
    f32 at every head dim the kernels take, and bf16 at 16 and 32, to the
    FMA kernel; anything else raises."""
    for hd in (8, 16, 32, 48, 64, 96, 112, 128, 256, 512):
        if hd not in (16, 32, 64, 96, 112, 128, 256):
            for dtype in (torch.float32, torch.bfloat16):
                with pytest.raises(ValueError, match="unsupported"):
                    fa_ops.variant(dtype, hd)
            continue
        assert fa_ops.variant(torch.float32, hd) == "fma"
        assert fa_ops.variant(torch.bfloat16, hd) == \
            ("wgmma" if hd in (64, 96, 112, 128, 256) else "fma")
        with pytest.raises(TypeError):
            fa_ops.variant(torch.float16, hd)


def test_flash_wrapper_takes_each_variants_plain_version_on_cpu():
    fa_ops.zero_launches()
    _, (q, k, v) = _inputs([(1, 4, 40, 64), (1, 2, 40, 64), (1, 2, 40, 64)],
                           "bfloat16", 7)
    assert torch.equal(fa_ops.flash_attention_bhsd(q, k, v, window=16),
                       attention_ref(q, k, v, window=16, round_p=True))
    assert torch.equal(fa_ops.flash_attention_bhsd(q[..., :32], k[..., :32],
                                                   v[..., :32]),
                       attention_ref(q[..., :32], k[..., :32], v[..., :32]))
    assert fa_ops.launches == 0
    assert fa_ops.launches_by_variant == {"wgmma": 0, "fma": 0}


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DA_SHAPES)
def test_decode_split_matches_pallas_kernel(case, dtype, splits):
    """The split kernel's algorithm (per-split partials over whole tiles,
    log-sum-exp merge in split order) gives the Pallas kernel's output;
    with the kernel's tile (32 or 64 rows here) many of these splits are
    empty."""
    B, H, Hkv, T, hd, bk, length, window = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, H, hd), (B, Hkv, T, hd), (B, Hkv, T, hd)], dtype, 2)
    ref = decode_attention_bhd(jq, jk, jv, jnp.int32(length), window=window,
                               block_k=bk, interpret=True)
    port = decode_attention_split(tq, tk, tv,
                                  torch.tensor(length, dtype=torch.int32),
                                  window=window, splits=splits)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    _close(port, ref, dtype)


# (B, H, Hkv, T, hd, length, window, tile, splits): length 0 and 1, a
# length just past a split boundary, length > T with and without a
# window, a window inside one split, more splits than tiles
SPLIT_EDGES = [
    (1, 4, 2, 64, 32, 0, 0, 8, 3), (2, 6, 2, 64, 32, 1, 0, 8, 4),
    (1, 4, 1, 128, 32, 33, 0, 8, 4), (1, 4, 1, 128, 32, 65, 0, 16, 4),
    (2, 6, 2, 64, 32, 90, 0, 8, 5), (1, 6, 2, 64, 32, 80, 24, 8, 5),
    (1, 4, 2, 256, 32, 200, 5, 8, 7), (1, 4, 2, 256, 32, 200, 96, 16, 2),
    (1, 8, 1, 96, 16, 96, 0, 8, 16),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SPLIT_EDGES)
def test_decode_split_edges_match_pallas_kernel(case, dtype):
    B, H, Hkv, T, hd, length, window, tile, splits = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, H, hd), (B, Hkv, T, hd), (B, Hkv, T, hd)], dtype, 9)
    ref = decode_attention_bhd(jq, jk, jv, jnp.int32(length), window=window,
                               block_k=16, interpret=True)
    port = decode_attention_split(tq, tk, tv, length, window=window,
                                  splits=splits, tile=tile)
    assert torch.isfinite(port.float()).all()
    _close(port, ref, dtype)
    if length == 0:
        assert torch.equal(port, torch.zeros_like(port))


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_past_an_unpadded_cache_end_matches_the_oracle(dtype, window,
                                                             splits):
    """length 700 over a 600-row cache (the engine's shared position past
    max_seq): both plain versions take the live range min(length, T) and
    match the reference's oracle (`repro/kernels/decode_attention/ref.py`).
    The reference's Pallas kernel does not: it zero-pads T to a multiple of
    `block_k` (512) and keeps every padded row below `length`, so those
    rows enter its softmax with score 0.  On this test's f32 inputs
    (interpret mode) it differs from the oracle by 0.0134 at window 0
    (max |oracle| 0.139) and 0.0817 at window 256 (0.276); ROADMAP.md's
    probe, another draw, gave 0.0134 and 0.0939.  The port follows the
    oracle."""
    B, H, Hkv, T, hd, length = 1, 2, 1, 600, 32, 700
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, H, hd), (B, Hkv, T, hd), (B, Hkv, T, hd)], dtype, 0)
    ref = jax_decode_attention_ref(jq, jk, jv, length, window=window)
    len_t = torch.tensor(length, dtype=torch.int32)
    _close(decode_attention_ref(tq, tk, tv, len_t, window=window), ref,
           dtype)
    _close(decode_attention_split(tq, tk, tv, len_t, window=window,
                                  splits=splits), ref, dtype)


def test_decode_split_rules():
    """The wrapper's launch shape: heads per block, the bytes a block's
    ring keeps in flight, splits from the shapes only (about 96 KB of
    loads in flight an SM, no split under 320 rows of T, one split once
    the units fill the card), and the kernel's tile."""
    reps = (1, 2, 3, 4, 5, 7, 8, 12)
    assert [da_ops.heads_per_block(r, torch.float32) for r in reps] == \
        [1, 2, 4, 4, 8, 8, 8, 8]
    assert {da_ops.heads_per_block(r, torch.bfloat16) for r in reps} == {8}
    bf16, f32 = torch.bfloat16, torch.float32
    assert [da_ops.ring_bytes(hd, bf16) for hd in (64, 128, 256)] == \
        [49152, 98304, 131072]
    assert [da_ops.ring_bytes(hd, f32) for hd in (16, 64, 112)] == \
        [32768, 32768, 28672]
    ring64, ring128 = da_ops.ring_bytes(64, bf16), da_ops.ring_bytes(128, bf16)
    assert da_ops.num_splits(40, 512, ring64) == 1      # SmolLM-360M serving
    assert da_ops.num_splits(40, 2048, ring64) == 6     # its full context
    assert da_ops.num_splits(40, 1024, ring64) == 3
    assert da_ops.num_splits(40, 8192, ring64) == 7
    assert da_ops.num_splits(64, 16384, ring128) == 2   # DeepSeek-Coder-33B
    assert da_ops.num_splits(16, 16384, ring128) == 8
    assert da_ops.num_splits(16, 16384, ring128, sm_count=64) == 4
    assert da_ops.num_splits(40, 8192, da_ops.ring_bytes(64, f32)) == 10
    assert da_ops.num_splits(64, 100, ring64) == 1
    assert da_ops.num_splits(1056, 1 << 20, ring64) == 1
    assert da_ops.num_splits(1, 63, ring64) == 1
    assert {split_tile(hd, 2) for hd in (16, 64, 96, 112, 128, 256)} == {64}
    assert [split_tile(hd, 4) for hd in (16, 64, 96, 112, 128, 256)] == \
        [64, 16, 8, 8, 8, 4]


def test_flash_fma_tiling_rule():
    """The fma kernel's launch shape from the shapes only: the largest of
    64, 32, 16 query rows a block whose grid gives each of the card's SMs a
    block (else 16), two warps a row group under two blocks an SM and at
    hd 256; every grid within CUDA's limits (B * H blocks on x, query tiles
    on y), and most of the 132 SMs busy at phase 4's S = 64."""
    tiling = fa_ops.fma_tiling
    assert tiling(2, 15, 64, 64) == (16, 2)      # phase 4: 120 blocks
    assert tiling(2, 32, 64, 128) == (16, 2)     # 11(a): 256 blocks
    assert tiling(2, 15, 2048, 64) == (64, 1)    # SmolLM-360M, full length
    assert tiling(2, 32, 2048, 128) == (64, 1)
    assert tiling(2, 16, 2048, 256) == (64, 2)   # Gemma-7B's heads
    assert tiling(1, 40, 100, 64) == (32, 2)     # 160 blocks of 32 rows
    assert tiling(2, 32, 300, 112) == (64, 1)    # 320 blocks
    assert tiling(2, 15, 64, 64, sm_count=30) == (64, 2)
    assert tiling(1, 1, 1, 16) == (16, 2)
    for B, H, Sq, hd in itertools.product(
            (1, 2, 8), (1, 2, 15, 32, 64),
            (1, 17, 64, 100, 300, 2048, 1 << 20), (16, 64, 112, 256)):
        rows, split = tiling(B, H, Sq, hd)
        assert (rows, split) == tiling(B, H, Sq, hd)
        assert rows in fa_ops.Q_TILES and split in fa_ops.HD_SPLITS
        blocks = B * H * -(-Sq // rows)
        assert -(-Sq // rows) <= 65535 and B * H < 2 ** 31
        if rows != fa_ops.Q_TILES[-1]:
            assert blocks >= 132
        if rows != fa_ops.Q_TILES[0]:     # a taller tile leaves SMs idle
            assert B * H * -(-Sq // (2 * rows)) < 132
        assert split == (2 if blocks < 264 or hd == 256 else 1)
    assert 2 * 15 * -(-64 // tiling(2, 15, 64, 64)[0]) >= 0.9 * 132


# the head dims the wgmma kernel took over from the FMA kernel in bf16
WIDE_HEAD_DIMS = (96, 112, 256)


@pytest.mark.parametrize("hd", WIDE_HEAD_DIMS)
def test_flash_ref_with_bf16_p_at_wide_head_dims_zeroes_rows_with_no_key(hd):
    """Bidirectional, Sk < Sq, window 8: rows 23 on see no key.  The plain
    version gives them 0 and the rows that see a key the Pallas kernel's
    values (the Pallas kernel's masked rows are not 0: see
    test_flash_fully_masked_rows_give_zero)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(1, 2, 48, hd), (1, 2, 16, hd), (1, 2, 16, hd)], "bfloat16", 9)
    ref = flash_attention_bhsd(jq, jk, jv, causal=False, window=8,
                               block_q=16, block_k=16, interpret=True)
    port = attention_ref(tq, tk, tv, causal=False, window=8, round_p=True)
    assert torch.equal(port[:, :, 23:], torch.zeros_like(port[:, :, 23:]))
    _close(port[:, :, :23], np.asarray(ref, np.float32)[:, :, :23],
           "bfloat16")


@pytest.mark.parametrize("hd", WIDE_HEAD_DIMS)
def test_flash_wrapper_on_cpu_takes_wgmmas_plain_version_for_bf16(hd):
    """On CPU tensors the wrapper at these head dims computes what each
    dtype's kernel computes on the card: bf16 P rounded (wgmma), f32 not
    (FMA), and launches nothing."""
    fa_ops.zero_launches()
    _, (q, k, v) = _inputs([(1, 4, 30, hd), (1, 2, 30, hd), (1, 2, 30, hd)],
                           "float32", 10)
    b16 = [t.to(torch.bfloat16) for t in (q, k, v)]
    assert torch.equal(fa_ops.flash_attention_bhsd(*b16, window=12),
                       attention_ref(*b16, window=12, round_p=True))
    assert torch.equal(fa_ops.flash_attention_bhsd(q, k, v, window=12),
                       attention_ref(q, k, v, window=12))
    assert fa_ops.launches_by_variant == {"wgmma": 0, "fma": 0}
