"""The port's SSD scan oracles against the JAX package's on the same
inputs: the plain version of the CUDA kernel against the Pallas kernel (in
interpret mode), the chunked algorithm and the sequential recurrence
against theirs, and the CPU dispatch of the wrapper.  Shapes and
tolerances are the reference's (tests/test_kernels.py)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_sequential as jax_ssd_sequential
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_states,
                                              ssd_scan_chunked, ssd_scan_ref,
                                              ssd_sequential,
                                              ssd_state_passing)
from repro_torch.models.mamba2 import ssd_chunked

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}

SSD_SHAPES = [
    # (b, s, h, p, n, chunk, head_block)
    (1, 64, 4, 16, 16, 16, 4),
    (2, 128, 8, 32, 32, 32, 4),
    (1, 96, 2, 16, 64, 32, 2),
    (1, 64, 8, 64, 16, 64, 8),     # single chunk boundary case
]


def _inputs(b, s, h, p, n, dtype, seed=0, dt_range=(0.001, 0.1),
            a_range=(0.5, 2.0)):
    """The reference's SSD test inputs (x, B, C normal in the model dtype,
    dt and A uniform in f32), as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(*dt_range, (b, s, h)).astype(np.float32)
    A = -rng.uniform(*a_range, (h,)).astype(np.float32)
    B = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    C = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    j = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B, jdt), jnp.asarray(C, jdt))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(B).to(tdt),
         torch.from_numpy(C).to(tdt))
    return j, t


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_SHAPES)
def test_ssd_scan_ref_matches_pallas_kernel(case, dtype):
    b, s, h, p, n, chunk, hb = case
    (jx, jdt, jA, jB, jC), (x, dt, A, B, C) = _inputs(b, s, h, p, n, dtype)
    ref = jax_ssd_scan(jx, jdt, jA, jB[:, :, 0], jC[:, :, 0], chunk=chunk,
                       head_block=hb, interpret=True)
    port = ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk)
    assert port.dtype == x.dtype and port.shape == x.shape
    _close(port, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_SHAPES)
def test_ssd_chunked_matches_jax(case, dtype):
    """y and the final state, with the reference's bf16 casts."""
    b, s, h, p, n, chunk, _ = case
    (jx, jdt, jA, jB, jC), (x, dt, A, B, C) = _inputs(b, s, h, p, n, dtype,
                                                      seed=1)
    jy, jstate = jax_ssd_chunked(jx, jdt, jA, jB, jC, chunk)
    y, state = ssd_chunked(x, dt, A, B, C, chunk)
    assert y.dtype == x.dtype and state.dtype == x.dtype
    assert state.shape == (b, h, p, n)
    _close(y, jy, dtype)
    _close(state, jstate, dtype)


@pytest.mark.parametrize("case", SSD_SHAPES)
def test_ssd_sequential_matches_jax(case):
    b, s, h, p, n, _, _ = case
    (jx, jdt, jA, jB, jC), (x, dt, A, B, C) = _inputs(b, s, h, p, n,
                                                      "float32", seed=2)
    jy, jstate = jax_ssd_sequential(jx, jdt, jA, jB, jC)
    y, state = ssd_sequential(x, dt, A, B, C)
    _close(y, jy, "float32")
    _close(state, jstate, "float32")


@pytest.mark.parametrize("case", SSD_SHAPES)
def test_ssd_scan_ref_matches_sequential(case):
    b, s, h, p, n, chunk, _ = case
    _, (x, dt, A, B, C) = _inputs(b, s, h, p, n, "float32", seed=3)
    y_seq, _ = ssd_sequential(x, dt, A, B, C)
    y = ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk)
    torch.testing.assert_close(y, y_seq, **TOL["float32"])


def test_strong_decay_gives_finite_output():
    """A = -16 and dt = 0.1 over a 128-row chunk: exp(cum_i - cum_j)
    above the diagonal is +inf, which must be selected away, not
    multiplied by 0 (that gives NaN)."""
    b, s, h, p, n, chunk = 1, 256, 2, 16, 16, 128
    _, (x, dt, A, B, C) = _inputs(b, s, h, p, n, "float32", seed=4,
                                  dt_range=(0.1, 0.1), a_range=(16.0, 16.0))
    cum = torch.cumsum(dt[0, :chunk, 0] * A[0], 0)
    assert torch.isinf(torch.exp(cum[0] - cum[-1]))     # the trap is live
    y = ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk)
    assert torch.isfinite(y).all()
    y_seq, _ = ssd_sequential(x, dt, A, B, C)
    torch.testing.assert_close(y, y_seq, **TOL["float32"])


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    """bf16 dispatches to the tensor-core kernel, whose plain version is
    the three steps with its bf16 rounding points; f32 to the FMA kernel,
    whose plain version is the same three steps in f32."""
    ssd_ops.zero_launches()
    _, (x, dt, A, B, C) = _inputs(2, 64, 4, 16, 16, "bfloat16", seed=5)
    y, none = ssd_ops.ssd(x, dt, A, B, C, chunk=16, head_block=2)
    assert none is None
    assert torch.equal(y, ssd_scan_chunked(x, dt, A, B[:, :, 0], C[:, :, 0],
                                           16, bf16_points=True))
    assert torch.equal(y, ssd_ops.ssd(x, dt, A, B, C, chunk=16)[0])
    _, (x, dt, A, B, C) = _inputs(2, 64, 4, 16, 16, "float32", seed=5)
    assert torch.equal(ssd_ops.ssd(x, dt, A, B, C, chunk=16)[0],
                       ssd_scan_chunked(x, dt, A, B[:, :, 0], C[:, :, 0], 16))
    assert ssd_ops.launches == 0
    assert ssd_ops.launches_by_variant == {"tc": 0, "fma": 0}


def test_wrapper_raises_on_what_the_reference_refuses():
    _, (x, dt, A, B, C) = _inputs(1, 48, 2, 16, 16, "float32", seed=6)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ops.ssd(x, dt, A, B, C, chunk=32)
    B2 = torch.cat([B, B], dim=2)
    with pytest.raises(ValueError, match="one B/C group"):
        ssd_ops.ssd(x, dt, A, B2, B2, chunk=16)
    meta = [t.to("meta") for t in (x, dt, A, B[:, :, 0], C[:, :, 0])]
    with pytest.raises(ValueError, match="no kernel"):
        ssd_ops.ssd_scan(*meta, chunk=16)
    assert ssd_ops.launches == 0


# the reference's shapes plus A = -16, dt = 0.1 over 128-row chunks, where
# exp(cum_i - cum_j) above the diagonal overflows to +inf
STEP_SHAPES = [c + (False,) for c in SSD_SHAPES] + [
    (1, 256, 2, 16, 16, 128, 2, True)]


def _step_inputs(case, dtype, seed):
    b, s, h, p, n, chunk, hb, strong = case
    kw = dict(dt_range=(0.1, 0.1), a_range=(16.0, 16.0)) if strong else {}
    return _inputs(b, s, h, p, n, dtype, seed=seed, **kw)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", STEP_SHAPES)
def test_ssd_three_steps_match_pallas_kernel(case, dtype):
    """Chunk states, state passing and chunk scan composed (all f32) give
    the Pallas kernel's y."""
    b, s, h, p, n, chunk, hb, _ = case
    (jx, jdt, jA, jB, jC), (x, dt, A, B, C) = _step_inputs(case, dtype, 7)
    ref = jax_ssd_scan(jx, jdt, jA, jB[:, :, 0], jC[:, :, 0], chunk=chunk,
                       head_block=hb, interpret=True)
    port = ssd_scan_chunked(x, dt, A, B[:, :, 0], C[:, :, 0], chunk)
    assert port.dtype == x.dtype and port.shape == x.shape
    assert torch.isfinite(port.float()).all()
    _close(port, ref, dtype)


@pytest.mark.parametrize("case", STEP_SHAPES)
def test_ssd_three_steps_with_bf16_points_match_sequential(case):
    """With the tensor-core kernel's three bf16 roundings (w x, the
    entering state, L) the composition stays within the reference's bf16
    tolerance of the direct recurrence on the same bf16 inputs."""
    _, (x, dt, A, B, C) = _step_inputs(case, "bfloat16", 8)
    y = ssd_scan_chunked(x, dt, A, B[:, :, 0], C[:, :, 0], case[5],
                         bf16_points=True)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    y_seq, _ = ssd_sequential(x.float(), dt, A, B.float(), C.float())
    torch.testing.assert_close(y.float(), y_seq, **TOL["bfloat16"])


@pytest.mark.parametrize("case", STEP_SHAPES)
def test_ssd_entering_states_match_sequential(case):
    """Steps 1 and 2: the state entering chunk c is the recurrence's state
    after token c * chunk - 1, and the last one carried once more is the
    final state."""
    b, s, h, p, n, chunk, _, _ = case
    _, (x, dt, A, B, C) = _step_inputs(case, "float32", 9)
    cum, contrib = ssd_chunk_states(x, dt, A, B[:, :, 0], chunk)
    assert cum.shape == (b, s, h) and contrib.shape == (b, s // chunk, h, p, n)
    s_in = ssd_state_passing(contrib, cum, chunk)
    assert torch.equal(s_in[:, 0], torch.zeros_like(s_in[:, 0]))
    for c in range(1, s // chunk):
        _, state = ssd_sequential(x[:, :c * chunk], dt[:, :c * chunk], A,
                                  B[:, :c * chunk], C[:, :c * chunk])
        torch.testing.assert_close(s_in[:, c], state, **TOL["float32"])
    _, final = ssd_sequential(x, dt, A, B, C)
    decay = torch.exp(cum[:, -1])[..., None, None]
    torch.testing.assert_close(s_in[:, -1] * decay + contrib[:, -1], final,
                               **TOL["float32"])


def test_ssd_variant_dispatch():
    """bf16 goes to the tensor-core kernel and f32 to the FMA kernel, on
    exactly the shapes both are written for; anything else raises."""
    sizes = (8, 16, 32, 48, 64, 128, 256)
    for p, n, chunk in itertools.product(sizes, sizes, sizes):
        ok = p in (16, 32, 64) and n in (16, 32, 64, 128) \
            and chunk in (16, 32, 64, 128)
        for dtype, expected in ((torch.bfloat16, "tc"),
                                (torch.float32, "fma")):
            if ok:
                assert ssd_ops.variant(dtype, p, n, chunk) == expected
            else:
                with pytest.raises(ValueError, match="unsupported"):
                    ssd_ops.variant(dtype, p, n, chunk)
        if ok:
            with pytest.raises(TypeError):
                ssd_ops.variant(torch.float16, p, n, chunk)


def test_fma_plain_version_is_the_f32_three_steps():
    """PLAIN["fma"] is ssd_scan_chunked without bf16 points: the f32
    algorithm the three-launch f32 kernel follows, held to the Pallas
    kernel above; the wrapper's CPU path gives it bit for bit, and it
    agrees with the model's chunked algorithm within f32 rounding."""
    fma = ssd_ops.PLAIN["fma"]
    assert fma.func is ssd_scan_chunked and fma.keywords == \
        {"bf16_points": False}
    assert ssd_ops.LAUNCHES_PER_CALL == {"tc": 3, "fma": 3}
    for case in STEP_SHAPES:
        b, s, h, p, n, chunk, _, _ = case
        _, (x, dt, A, B, C) = _step_inputs(case, "float32", 10)
        y = ssd_ops.ssd_scan(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk)
        assert torch.equal(y, fma(x, dt, A, B[:, :, 0], C[:, :, 0], chunk))
        torch.testing.assert_close(
            y, ssd_scan_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk),
            **TOL["float32"])


@pytest.mark.parametrize("shape", [
    (2, 16, 80, 64, 128, 128), (2, 2, 80, 64, 128, 128),
    (2, 2, 112, 64, 64, 128), (1, 4, 4, 16, 16, 16), (3, 7, 13, 32, 64, 64)])
def test_fma_heads_per_block_fills_the_card(shape):
    """The f32 kernel's heads per block: in 1..10, and no choice with
    fewer waves of blocks over 132 SMs at equal or lower cost exists."""
    b, nc, h, p, n, q = shape
    hb = ssd_ops.heads_per_block(b, nc, h, p, n, q)
    assert 1 <= hb <= 10

    def cost(k):
        waves = -(-b * nc * -(-h // k) // 132)
        return waves * (k * (2 * q * p * n + q * q * p) + 2 * q * q * n)
    assert all(cost(hb) <= cost(k) for k in range(1, 11))
    if shape == (2, 16, 80, 64, 128, 128):       # Mamba2-2.7B, s = 2048
        assert hb == 10
    if shape == (2, 2, 80, 64, 128, 128):        # the same at s = 256
        assert hb == 3
