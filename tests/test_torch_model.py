"""The port's dense model against the JAX model on the same converted
parameters and inputs (smoke configs, f32, CPU), and the reference's
per-architecture smoke checks on the port for all ten archs."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import list_archs, smoke_config
from repro.launch.shapes import make_batch
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro_torch import models as tm
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.shapes import make_batch as t_make_batch
from repro_torch.launch.shapes import make_decode_tokens
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_leaves

DENSE = ["smollm-360m", "gemma-7b", "deepseek-coder-33b", "mistral-large-123b",
         "phi-3-vision-4.2b", "musicgen-large"]


def _setup(arch, seed=0, **kw):
    cfg = smoke_config(arch).scaled(remat=False, dtype="float32", **kw)
    jp = j_init_params(jax.random.PRNGKey(seed), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _tensor(v):
    """A numpy or JAX array as a tensor; bf16 through f32 (exact)."""
    a = np.array(v)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _tbatch(batch):
    return {k: _tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, impl):
    cfg, jp, tp = _setup(arch)
    cfg = cfg.scaled(attn_impl=impl)
    batch = make_batch(cfg, np.random.default_rng(0), batch=2, seq=40)
    ref, _, jmask = j_forward(jp, batch, cfg)
    out, aux, mask = tm.forward(tp, _tbatch(batch), cfg)
    assert out.dtype == torch.float32 and aux == 0.0
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        tm.prefill(tp, _tbatch(batch), cfg, 40).numpy(),
        np.asarray(ref[:, -1]), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("head_dim", [None, 64])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_prefill_matches_jax(impl, head_dim):
    """SmolLM's smoke config in bf16: the port's prefill logits against
    JAX's on the same converted parameters, within the reference's bf16
    tolerance (tests/test_kernels.py).  At head dim 64 the pallas path's
    attention takes the wgmma kernel's plain version (P rounded to bf16),
    at the smoke config's 32 the FMA kernel's."""
    extra = {} if head_dim is None else {"head_dim": head_dim}
    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="bfloat16",
                                             attn_impl=impl, **extra)
    assert fa_ops.variant(torch.bfloat16, cfg.resolved_head_dim) == \
        ("wgmma" if head_dim == 64 else "fma")
    jp = j_init_params(jax.random.PRNGKey(6), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    batch = make_batch(cfg, np.random.default_rng(3), batch=2, seq=64)
    ref = j_prefill(jp, batch, cfg, 64)
    out = tm.prefill(tp, _tbatch(batch), cfg, 64)
    assert out.shape == (2, cfg.vocab_size) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


# the archs whose bf16 attention runs at head dims 112, 96 and 256 (their
# full configs' own), on smoke widths and depths
WIDE_HEAD_DIMS = {"zamba2-7b": 112, "phi-3-vision-4.2b": 96, "gemma-7b": 256}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", list(WIDE_HEAD_DIMS))
def test_bf16_prefill_at_wide_head_dims_matches_jax(arch, impl):
    """Zamba2-7B's, Phi-3-Vision-4.2B's and Gemma-7B's smoke configs at
    their real head dims in bf16: the port's prefill logits against JAX's
    on the same converted parameters (patch embeddings first for the VLM),
    within the reference's bf16 tolerance.  The pallas path's attention
    takes the wgmma kernel's plain version there."""
    cfg = smoke_config(arch).scaled(remat=False, dtype="bfloat16",
                                    attn_impl=impl,
                                    head_dim=WIDE_HEAD_DIMS[arch])
    assert fa_ops.variant(torch.bfloat16, cfg.resolved_head_dim) == "wgmma"
    jp = j_init_params(jax.random.PRNGKey(8), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    batch = make_batch(cfg, np.random.default_rng(4), batch=2, seq=64)
    ref = j_prefill(jp, batch, cfg, 64)
    out = tm.prefill(tp, _tbatch(batch), cfg, 64)
    assert out.shape == (2, cfg.vocab_size) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_steps_match_jax_and_own_forward(impl):
    cfg, jp, tp = _setup("smollm-360m", seed=3)
    cfg = cfg.scaled(attn_impl=impl)
    B, S = 2, 16
    batch = make_batch(cfg, np.random.default_rng(1), batch=B, seq=S)
    tokens = np.array(batch["tokens"])
    jcache = j_init_cache(cfg, B, S)
    tcache = tm.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        jl, jcache = j_decode_step(jp, jcache, jnp.asarray(tokens[:, t:t + 1]),
                                   cfg)
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(tokens[:, t:t + 1]), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=2e-4, atol=2e-4)
        outs.append(tl)
    assert int(tcache["pos"]) == S and tcache["pos"].dtype == torch.int32
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=2e-4, atol=2e-4)
    fwd, _, _ = tm.forward(tp, _tbatch(batch), cfg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_decode_past_the_cache_end_clamps_like_jax():
    """A shared position beyond max_seq writes at T-1 and attends to the
    whole cache, as dynamic_update_slice and the length mask do."""
    cfg, jp, tp = _setup("smollm-360m", seed=4)
    B, T = 2, 4
    rng = np.random.default_rng(2)
    jcache = j_init_cache(cfg, B, T)
    tcache = tm.init_cache(cfg, B, T, device="cpu")
    for _ in range(7):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = j_decode_step(jp, jcache, jnp.asarray(tok), cfg)
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=2e-4, atol=2e-4)
    assert int(tcache["pos"]) == 7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_exactly(dtype):
    cfg = smoke_config("smollm-360m").scaled(dtype=dtype)
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(5), cfg))
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    if dtype == "bfloat16":
        assert tree["embed"].dtype == ml_dtypes.bfloat16


def test_init_params_matches_the_reference_tree_and_distribution():
    cfg = smoke_config("smollm-360m").scaled(dtype="float32")
    ref = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg))
    port = tm.init_params(cfg, seed=0, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    port_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), port))
    assert [p for p, _ in ref_leaves] == [p for p, _ in port_leaves]
    for (path, a), (_, b) in zip(ref_leaves, port_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.ndim >= 2 and a.size > 1000:           # matrices: same std
            assert abs(b.std() / a.std() - 1) < 0.1, path
            assert np.abs(b).max() <= 1.02 * np.abs(a).max(), path  # +-2σ
    again = tm.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"]["attn"]["wq"],
                       port["layers"]["attn"]["wq"])


def test_unported_attn_impl_raises():
    cfg, _, tp = _setup("smollm-360m")
    with pytest.raises(NotImplementedError, match="splash"):
        tm.forward(tp, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                   cfg.scaled(attn_impl="splash"))


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py's first three checks on the port, all ten archs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_arch_forward_and_loss(arch):
    cfg = smoke_config(arch).scaled(remat=False, dtype="float32")
    params = tm.init_params(cfg, seed=0, device="cpu")
    batch = t_make_batch(cfg, np.random.default_rng(0), 2, 32, device="cpu")
    logits, aux, mask = tm.forward(params, batch, cfg)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    loss, metrics = tm.loss_fn(params, batch, cfg)
    assert loss.shape == () and torch.isfinite(loss)
    assert metrics["ce"] > 0
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", list_archs())
def test_arch_one_grad_step_no_nans(arch):
    cfg = smoke_config(arch).scaled(remat=True, dtype="float32")
    params = tm.init_params(cfg, seed=1, device="cpu")
    batch = t_make_batch(cfg, np.random.default_rng(0), 2, 32, device="cpu")
    loss, _, grads = loss_and_grads(params, batch, cfg)
    assert torch.isfinite(loss)
    leaves = tree_leaves(grads)
    assert leaves
    for g in leaves:
        assert torch.isfinite(g).all(), "NaN/inf gradient"
    assert sum(float(g.abs().sum()) for g in leaves) > 0


@pytest.mark.parametrize("arch", list_archs())
def test_arch_decode_step(arch):
    cfg = smoke_config(arch).scaled(remat=False, dtype="float32")
    params = tm.init_params(cfg, seed=2, device="cpu")
    B, max_seq = 2, 64
    cache = tm.init_cache(cfg, B, max_seq, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        tok = make_decode_tokens(cfg, rng, B, device="cpu")
        logits, cache = tm.decode_step(params, cache, tok, cfg)
        assert logits.shape == (B, cfg.vocab_size)
        assert torch.isfinite(logits).all()
    assert int(cache["pos"]) == 3


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a host without a card")
    cfg = smoke_config("smollm-360m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2)})
