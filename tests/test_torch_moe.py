"""The port's moe family against the JAX package on the same converted
parameters and inputs (smoke configs, CPU): the router and the
sort-based dispatch tables exactly (ties, the last expert's overflow,
one hot expert, capacity 1), `moe_ffn` in f32 and bf16, the whole model
(forward, loss with the router aux, prefill, decode) and one train
step."""

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
from repro.models import loss_fn as j_loss_fn
from repro.models import moe as jmoe
from repro.models import prefill as j_prefill
from repro.serve import engine as jeng
from repro.train import step as jstep
from repro.train.optim import OptimizerConfig as JOptimizerConfig
from repro_torch import models as tm
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 train_state_from_numpy)
from repro_torch.models import moe as tmoe
from repro_torch.serve import engine as teng
from repro_torch.train import optim as toptim
from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                    make_train_step)
from repro_torch.tree import tree_leaves

MOE = ["kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b"]


def _setup(arch, seed=0, **kw):
    cfg = smoke_config(arch).scaled(remat=False, dtype="float32", **kw)
    jp = j_init_params(jax.random.PRNGKey(seed), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the router and the dispatch tables
# ---------------------------------------------------------------------------


def _tables_both(expert_idx, gate_vals, T, E, K, C):
    """The reference's and the port's tables for the same (T, K) expert
    ids and gates; the port's `slot` checked against its own `buf`."""
    jb, jg = jmoe._dispatch_tables(jnp.asarray(expert_idx),
                                   jnp.asarray(gate_vals), T, E, K, C)
    tb, tg, slot = tmoe._dispatch_tables(
        torch.from_numpy(np.array(expert_idx)).long(),
        torch.from_numpy(np.array(gate_vals)), T, E, K, C)
    assert tb.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    # slot names each kept (token, choice) where buf holds the token
    flat = tb.reshape(-1)
    for t, k in zip(*np.nonzero(slot.numpy() < E * C)):
        assert int(flat[slot[t, k]]) == t
    assert int((slot < E * C).sum()) == int((tb < T).sum())
    return np.asarray(jb), np.asarray(jg)


@pytest.mark.parametrize("experts, want", [
    # expert 1 (the last) overflows: its kept token 1 at slot C-1 is
    # overwritten by the pad, as XLA's in-order duplicate writes leave it
    ([1, 1, 0, 1], [[2, 4], [0, 4]]),
    # expert 1 exactly full while expert 0 overflows: both kept
    ([0, 0, 0, 1, 1], [[0, 1], [3, 4]]),
])
def test_dispatch_probe_cases_match_the_reference(experts, want):
    T = len(experts)
    gates = np.array([0.5, 0.7, 0.9, 0.6, 0.3][:T], np.float32)[:, None]
    buf, gbuf = _tables_both(np.array(experts, np.int32)[:, None], gates,
                             T, E=2, K=1, C=2)
    assert buf.tolist() == want
    assert all(gbuf[e, c] == 0 for e, c in zip(*np.nonzero(buf == T)))


@pytest.mark.parametrize("case", ["random", "all_on_one", "all_on_last",
                                  "capacity_1", "no_overflow"])
def test_dispatch_tables_match_the_reference(case):
    rng = np.random.default_rng(len(case))
    T, E, K = 37, 6, 2
    C = {"capacity_1": 1, "no_overflow": T}.get(case, 9)
    if case in ("all_on_one", "all_on_last"):
        # every token's first choice on one expert, the second elsewhere
        hot = 2 if case == "all_on_one" else E - 1
        ids = np.stack([np.full(T, hot),
                        (hot + 1 + rng.integers(0, E - 1, T)) % E], 1)
    else:
        ids = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    gates = rng.random((T, K)).astype(np.float32)
    buf, _ = _tables_both(ids.astype(np.int32), gates, T, E, K, C)
    if case == "no_overflow":
        assert (buf < T).sum() == T * K


def _route_both(xf, router, cfg):
    jg, ji, jaux = jmoe._route({"router": jnp.asarray(router)},
                               jnp.asarray(xf), cfg)
    tg, ti, taux = tmoe._route({"router": torch.from_numpy(router)},
                               torch.from_numpy(xf), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-6)
    return np.asarray(ji), np.asarray(jg)


@pytest.mark.parametrize("arch", MOE)
def test_route_matches_the_reference_with_ties(arch):
    """Random rows, and zero rows, where all E probabilities are equal:
    the top K are the K lowest expert ids, in order, as lax.top_k gives
    them; then the tables from the routes."""
    cfg = smoke_config(arch)
    E, K = cfg.num_experts, cfg.experts_per_token
    rng = np.random.default_rng(1)
    xf = rng.standard_normal((24, cfg.d_model)).astype(np.float32)
    xf[[0, 7, 23]] = 0.0
    router = (rng.standard_normal((cfg.d_model, E)) /
              np.sqrt(cfg.d_model)).astype(np.float32)
    ids, gates = _route_both(xf, router, cfg)
    for t in (0, 7, 23):
        assert ids[t].tolist() == list(range(K))
        np.testing.assert_array_equal(gates[t], np.full(K, 1.0 / K,
                                                        np.float32))
    T = xf.shape[0]
    for C in (1, max(1, int(cfg.capacity_factor * T * K / E))):
        _tables_both(ids, gates, T, E, K, C)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_the_reference(arch, dtype, shared):
    """One MoE layer, with and without the shared expert: f32 within
    1e-5, bf16 within the reference's bf16 tolerance 2e-2."""
    cfg = smoke_config(arch).scaled(
        dtype=dtype, shared_expert_d_ff=64 if shared else 0)
    jdt = jnp.dtype(dtype)
    jp = jmoe.init_moe(jax.random.PRNGKey(4), cfg, jdt)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert ("shared" in tp) == shared
    x = np.random.default_rng(5).standard_normal((2, 40, cfg.d_model))
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x, jdt), cfg)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x).to(tm.model.DTYPES[dtype]),
                            cfg)
    assert ty.dtype == tm.model.DTYPES[dtype] and taux.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), rtol=tol, atol=tol)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-6)


def test_moe_impl_shard_map_takes_the_single_device_path():
    cfg = smoke_config("phi3.5-moe-42b-a6.6b").scaled(dtype="float32")
    tp = tm.init_params(cfg, seed=0, device="cpu")
    lp = tm.model._layer_slice(tp["layers"], 0)["moe"]
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    a, aux_a = tmoe.moe_ffn(lp, x, cfg)
    b, aux_b = tmoe.moe_ffn(lp, x, cfg.scaled(moe_impl="shard_map"))
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_loss_and_prefill_match_jax(arch, impl):
    """Logits and prefill within the whole-model tolerance 2e-4; ce, aux
    (the router loss summed over the layers) and the loss too."""
    cfg, jp, tp = _setup(arch, attn_impl=impl)
    batch = make_batch(cfg, np.random.default_rng(0), batch=2, seq=40)
    ref, jaux, _ = j_forward(jp, batch, cfg)
    out, aux, _ = tm.forward(tp, _tbatch(batch), cfg)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6) and \
        float(aux) > 0
    jloss, jmet = j_loss_fn(jp, batch, cfg)
    loss, met = tm.loss_fn(tp, _tbatch(batch), cfg)
    assert float(met["aux"]) == pytest.approx(float(jmet["aux"]), abs=1e-6)
    assert float(met["ce"]) == pytest.approx(float(jmet["ce"]), rel=2e-4)
    assert float(loss) == pytest.approx(float(jloss), rel=2e-4)
    assert float(loss) == pytest.approx(float(met["ce"] + met["aux"]))
    np.testing.assert_allclose(
        tm.prefill(tp, _tbatch(batch), cfg, 40).numpy(),
        np.asarray(j_prefill(jp, batch, cfg, 40)), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_steps_match_jax(arch, impl):
    """Eight steps against JAX's eight.  Decode's capacity counts the
    step's B tokens (C = 1 here), so it is held to JAX's decode, not to
    the forward (the reference's teacher-forcing test leaves MoE out)."""
    cfg, jp, tp = _setup(arch, seed=3, attn_impl=impl)
    B, S = 2, 8
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jcache = j_init_cache(cfg, B, 16)
    tcache = tm.init_cache(cfg, B, 16, device="cpu")
    assert tcache["k"].shape == tuple(jcache["k"].shape)
    for t in range(S):
        jl, jcache = j_decode_step(jp, jcache, jnp.asarray(tokens[:, t:t + 1]),
                                   cfg)
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(tokens[:, t:t + 1]), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               rtol=2e-4, atol=2e-4)


def _serve_both(cfg, jp, tp, reqs):
    outs = []
    for mod, params, kw in ((jeng, jp, {}), (teng, tp, {"device": "cpu"})):
        eng = mod.ServingEngine(cfg, params, mod.ServeConfig(
            slots=2, max_seq=64, eos_id=1), **kw)
        for rid, prompt, n in reqs:
            eng.submit(mod.Request(rid=rid, prompt=prompt, max_new_tokens=n))
        eng.run_until_drained()
        outs.append({r: eng.finished[r].output for r in sorted(eng.finished)})
    assert outs[0] == outs[1]
    return outs[0]


def test_decode_capacity_couples_the_slots_like_jax():
    """At 2 slots a decode step routes T=2 tokens, so C = max(1,
    int(1.25 * 2 * 2 / 4)) = 1: the slots compete for capacity, and a
    request's tokens depend on what the other slot decodes (at the same
    positions), in both engines.  With capacity_factor 2 (C = 2, nothing
    dropped) they do not."""
    R = [5, 6, 7, 8]
    head = [114, 233, 85, 208, 45, 139]     # the reference engine's tokens
    for cf, tails in ((1.25, ([103, 103], [31, 44])),
                      (2.0, ([31, 44], [31, 44]))):
        cfg, jp, tp = _setup("phi3.5-moe-42b-a6.6b", capacity_factor=cf)
        for other, tail in zip(([9, 10, 11, 12], [100, 101, 102, 103]),
                               tails):
            out = _serve_both(cfg, jp, tp, [(0, R, 8), (1, other, 8)])
            assert out[0] == head + tail


def test_moe_train_step_matches_jax():
    """One AdamW step of phi3.5-moe's smoke config (remat on) from the
    same converted state and batch: loss, aux, grad_norm, every grad leaf
    within the whole-model tolerance 2e-4 of its max |g|, and the new
    params within 2e-5.  Adam's first step is lr * g / (|g| + eps), which
    turns f32 noise in a near-zero grad into a visible update, so a new
    param may leave 2e-5 only where |g| <= 100 eps in both packages."""
    cfg = smoke_config("phi3.5-moe-42b-a6.6b").scaled(dtype="float32")
    jt = jstep.TrainConfig(optimizer=JOptimizerConfig(lr=1e-3))
    tt = TrainConfig(optimizer=toptim.OptimizerConfig(lr=1e-3))
    jstate = jstep.init_train_state(jax.random.PRNGKey(0), cfg, jt)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    batch = make_batch(cfg, np.random.default_rng(2), batch=4, seq=32)
    jgrads = jax.grad(lambda p: j_loss_fn(p, batch, cfg)[0])(jstate["params"])
    _, _, grads = loss_and_grads(state["params"], _tbatch(batch), cfg)
    jnew, jm = jax.jit(jstep.make_train_step(cfg, jt))(jstate, batch)
    new, m = make_train_step(cfg, tt)(state, _tbatch(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["aux"]) == pytest.approx(float(jm["aux"]), abs=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    near = 100 * tt.optimizer.eps
    a = jax.tree_util.tree_leaves_with_path(params_to_numpy(new["params"]))
    b = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jnew["params"]))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y), g, jg in zip(a, b, tree_leaves(grads),
                                        jax.tree.leaves(jgrads)):
        g, jg = g.numpy(), np.asarray(jg)
        np.testing.assert_allclose(g, jg, rtol=0,
                                   atol=2e-4 * np.abs(jg).max(),
                                   err_msg=str(path))
        outside = np.abs(x - y) > 2e-5 + 2e-5 * np.abs(y)
        assert not (outside & ~((np.abs(g) <= near) & (np.abs(jg) <= near))
                    ).any(), path
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(new["opt"])),
            jax.tree_util.tree_leaves_with_path(
                jax.tree.map(np.asarray, jnew["opt"]))):
        np.testing.assert_allclose(x, y, rtol=2e-5, atol=2e-5,
                                   err_msg=str(path))
