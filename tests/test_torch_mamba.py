"""The port's ssm (Mamba2) and hybrid (Zamba2) families against the JAX
model on the same converted parameters and inputs (smoke configs, f32,
CPU): forward, decode, the hybrid's rolling attention window, the serving
engine, and the reference's SSM-cache and SSD-gradient faults
reproduced."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.launch.shapes import make_batch
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models.mamba2 import ssd_chunked as j_ssd_chunked
from repro.serve import engine as jeng
from repro_torch import models as tm
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.mamba2 import ssd_chunked as t_ssd_chunked
from repro_torch.serve import engine as teng

ARCHS = ["mamba2-2.7b", "zamba2-7b"]


def _setup(arch, seed=0, **kw):
    cfg = smoke_config(arch).scaled(remat=False, dtype="float32", **kw)
    jp = j_init_params(jax.random.PRNGKey(seed), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _decode_both(cfg, jp, tp, tokens, max_seq):
    """Step both packages through `tokens` (B, S); the port's logits per
    step are held to JAX's at 2e-4.  Returns (port logits (B,S,V), port
    cache, JAX cache)."""
    B, S = tokens.shape
    jstep = jax.jit(lambda p, c, t: j_decode_step(p, c, t, cfg))
    jcache = j_init_cache(cfg, B, max_seq)
    tcache = tm.init_cache(cfg, B, max_seq, device="cpu")
    outs = []
    for t in range(S):
        jl, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(tokens[:, t:t + 1]), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=2e-4, atol=2e-4)
        outs.append(tl)
    return torch.stack(outs, 1), tcache, jcache


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, impl):
    cfg, jp, tp = _setup(arch)
    cfg = cfg.scaled(attn_impl=impl)
    batch = make_batch(cfg, np.random.default_rng(0), batch=2, seq=64)
    ref, _, _ = j_forward(jp, batch, cfg)
    ssd_ops.launches = 0
    out, aux, _ = tm.forward(tp, _tbatch(batch), cfg)
    assert out.dtype == torch.float32 and aux == 0.0
    assert ssd_ops.launches == 0                    # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(
        tm.prefill(tp, _tbatch(batch), cfg, 64).numpy(),
        np.asarray(ref[:, -1]), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_and_own_forward(arch, impl):
    cfg, jp, tp = _setup(arch, seed=3)
    cfg = cfg.scaled(attn_impl=impl)
    B, S = 2, 32                                    # two ssm chunks of 16
    batch = make_batch(cfg, np.random.default_rng(1), batch=B, seq=S)
    dec, tcache, jcache = _decode_both(cfg, jp, tp, np.array(batch["tokens"]),
                                       S)
    assert int(tcache["pos"]) == S and tcache["pos"].dtype == torch.int32
    for key in ("state", "conv"):
        np.testing.assert_allclose(tcache["ssm"][key].numpy(),
                                   np.asarray(jcache["ssm"][key]),
                                   rtol=2e-4, atol=2e-4)
    if cfg.family == "hybrid":
        np.testing.assert_allclose(tcache["k"].numpy(),
                                   np.asarray(jcache["k"]),
                                   rtol=2e-4, atol=2e-4)
    fwd, _, _ = tm.forward(tp, _tbatch(batch), cfg)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_hybrid_decode_past_its_window_rolls_like_jax():
    """Smoke Zamba2 has attn_window 64: 80 steps fill the rolling K/V
    window and shift it 16 times; every step's logits and the final K/V
    are held to JAX's."""
    cfg, jp, tp = _setup("zamba2-7b", seed=4)
    assert cfg.attn_window == 64
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int32)
    _, tcache, jcache = _decode_both(cfg, jp, tp, tokens, 96)
    assert tcache["k"].shape[3] == 64 and int(tcache["pos"]) == 80
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_the_reference(arch):
    cfg = smoke_config(arch).scaled(dtype="bfloat16")
    ref = j_init_cache(cfg, 3, 40)
    port = tm.init_cache(cfg, 3, 40, device="cpu")
    ref_l = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, ref))
    port_l = jax.tree_util.tree_leaves_with_path(port)
    assert [p for p, _ in ref_l] == [p for p, _ in port_l]
    for (path, a), (_, b) in zip(ref_l, port_l):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_the_reference_tree_and_distribution(arch):
    cfg = smoke_config(arch).scaled(dtype="float32")
    ref = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg))
    port = tm.init_params(cfg, seed=0, device="cpu")
    ref_l = jax.tree_util.tree_leaves_with_path(ref)
    port_l = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), port))
    assert [p for p, _ in ref_l] == [p for p, _ in port_l]
    for (path, a), (_, b) in zip(ref_l, port_l):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.ndim >= 2 and a.size > 1000 and a.std() > 0:   # same std
            assert abs(b.std() / a.std() - 1) < 0.1, path
            assert np.abs(b).max() <= 1.02 * np.abs(a).max(), path
    m = port["layers"]["mamba"]
    np.testing.assert_allclose(m["A_log"].numpy(),
                               ref["layers"]["mamba"]["A_log"], rtol=1e-6)
    dt = torch.nn.functional.softplus(m["dt_bias"])     # log-uniform dt
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 1e-1 * 1.001
    assert torch.equal(tm.init_params(cfg, seed=0, device="cpu")["layers"]
                       ["mamba"]["in_proj"], m["in_proj"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_exactly_and_load(arch, dtype):
    cfg = smoke_config(arch).scaled(dtype=dtype)
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(5), cfg))
    tp = params_from_numpy(tree, device="cpu")
    back = params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    tokens = torch.zeros((1, cfg.ssm_chunk), dtype=torch.long)
    logits, _, _ = tm.forward(tp, {"tokens": tokens}, cfg)
    assert logits.shape == (1, cfg.ssm_chunk, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def _serve(mod, cfg, params, scfg_kw, requests, **kw):
    eng = mod.ServingEngine(cfg, params, mod.ServeConfig(**scfg_kw), **kw)
    for rid, prompt, n in requests:
        eng.submit(mod.Request(rid=rid, prompt=prompt, max_new_tokens=n))
    eng.run_until_drained()
    return {r: eng.finished[r].output for r in sorted(eng.finished)}, eng


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(arch):
    cfg, jp, tp = _setup(arch, seed=6)
    reqs = [(0, [5, 6, 7], 6), (1, [9, 10, 11, 12], 6), (2, [3, 4], 6)]
    scfg = dict(slots=2, max_seq=48, eos_id=1)
    ref, jeng_ = _serve(jeng, cfg, jp, scfg, reqs)
    out, teng_ = _serve(teng, cfg, tp, scfg, reqs, device="cpu")
    assert out == ref and len(out) == 3
    assert int(teng_.cache["pos"]) == int(jeng_.cache["pos"])


def test_admitted_request_inherits_the_slots_ssm_state():
    """`_admit` resets only the slot's progress, not its SSM state or conv
    window, so a request admitted into a used slot starts from the state
    its predecessor left; idle slots keep advancing on EOS.  A fault of
    the reference that the port reproduces bit for bit."""
    cfg, jp, tp = _setup("mamba2-2.7b", seed=7)
    late = (1, [9, 10, 11, 12], 6)
    first = (0, [5, 6, 7, 8, 9], 6)
    one = dict(slots=1, max_seq=64, eos_id=-1)
    after, _ = _serve(jeng, cfg, jp, one, [first, late])
    fresh, _ = _serve(jeng, cfg, jp, one, [late])
    port_after, _ = _serve(teng, cfg, tp, one, [first, late], device="cpu")
    port_fresh, _ = _serve(teng, cfg, tp, one, [late], device="cpu")
    assert port_after == after and port_fresh == fresh
    # the numbers recorded for the reference's fault; Mamba2 reads no
    # position, so the difference is the carried state alone
    assert after[1] == [84, 144, 205, 182, 183, 245]
    assert fresh[1] == [213, 165, 8, 189, 114, 97]

    eng = teng.ServingEngine(cfg, tp, teng.ServeConfig(slots=2, max_seq=64),
                             device="cpu")
    eng.submit(teng.Request(rid=0, prompt=[5, 6, 7], max_new_tokens=3))
    eng.run_until_drained()
    idle = eng.cache["ssm"]["state"][:, 1]      # slot 1 never had a request
    assert idle.abs().max() > 0
    eng.submit(teng.Request(rid=1, prompt=[9], max_new_tokens=1))
    eng._admit()
    assert eng.slot_req[0].rid == 1
    assert eng.cache["ssm"]["state"][:, 0].abs().max() > 0   # not reset


def test_ssd_gradient_is_nan_at_strong_decay_in_both_packages():
    """The reference's fault, reproduced on purpose: `ssd_chunked` selects
    `exp(seg)` below the diagonal, but above it exp(seg) is +inf at strong
    decay (A = -16, dt = 0.1: seg up to 1.6 x 127), and the backward of
    the select multiplies its zero cotangent by that inf.  The forward
    is finite; the dt-gradient of the strongly decaying head is NaN at
    all 128 positions (the other head's is finite), the x-gradient
    finite.  Mamba2-2.7B's own init reaches this (A down to -16, dt up to
    0.1, chunk 128), so neither package can train it at full width."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 128, 2, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    C = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    dt = np.full((b, s, h), 0.1, np.float32)
    A = np.array([-16.0, -1.0], np.float32)
    ct = rng.standard_normal((b, s, h, p)).astype(np.float32)

    def jf(xx, dd):
        y, _ = j_ssd_chunked(xx, dd, A, B, C, 128)
        return jnp.sum(y * ct), y
    (_, jy), (jgx, jgdt) = jax.value_and_grad(jf, argnums=(0, 1),
                                              has_aux=True)(x, dt)
    tx = torch.from_numpy(x).requires_grad_(True)
    tdt = torch.from_numpy(dt).requires_grad_(True)
    ty, _ = t_ssd_chunked(tx, tdt, torch.from_numpy(A), torch.from_numpy(B),
                          torch.from_numpy(C), 128)
    tgx, tgdt = torch.autograd.grad((ty * torch.from_numpy(ct)).sum(),
                                    [tx, tdt])
    for y, gx, gdt in ((np.asarray(jy), np.asarray(jgx), np.asarray(jgdt)),
                       (ty.detach().numpy(), tgx.numpy(), tgdt.numpy())):
        assert np.isfinite(y).all() and np.isfinite(gx).all()
        assert np.isnan(gdt[..., 0]).sum() == s
        assert np.isfinite(gdt[..., 1]).all()
