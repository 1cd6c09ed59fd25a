"""`repro_torch.dist` across eight gloo ranks on the CPU, held to the JAX
package's single-device functions (the reference's own multi-device
tests do not run under this JAX: ROADMAP.md §3): GPipe over send/recv
against the stages in sequence, the expert-parallel all-to-all MoE
against `_moe_gspmd` (forward, aux and grads), its local capacity
against a per-shard oracle, the cases that take the single-device path,
the hd-sharded decode against `attention_decode`, and the activation
hook.  One spawn of a (4, 2) world runs every case (tests/
torch_dist_workers.py::dist_scenarios); each test reads its part."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.quant import quantize_tree as j_quantize_tree
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.moe import moe_ffn
from repro_torch.tree import tree_leaves, tree_map
from torch_dist_workers import dist_scenarios, run_ranks

WORLD = 8
MOE_TOL = 1e-5                  # tests/test_quant_and_dist.py:99
PIPE_TOL = 1e-5                 # tests/test_pipeline.py
DECODE_TOL = 2e-5               # f32, tests/test_kernels.py
# kimi-k2 smoke as the reference's shard_map test has it
MOE_KW = dict(dtype="float32", num_experts=8, moe_d_ff=64,
              capacity_factor=8.0, shared_expert_d_ff=0)
# capacity 1.25: tokens drop by each rank's capacity on the EP path, none
# by the whole batch's; 0.5: the whole batch drops too; the three shapes
# the EP path does not take
MOE_CASES = {
    "ep": {},
    "drop": dict(capacity_factor=1.25),
    "drop_half": dict(capacity_factor=0.5),
    "experts6": dict(capacity_factor=1.25, num_experts=6),
    "dff63": dict(capacity_factor=1.25, moe_d_ff=63),
    "int8": dict(capacity_factor=1.25),
    "pods": dict(capacity_factor=0.5),      # on (2, 2, 2) pod x data x model
}
DECODE_CASES = {            # name: (heads, kv heads, window, hd-sliced)
    "w0": (3, 1, 0, True), "w4": (3, 1, 4, True), "heads": (4, 2, 0, False)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rows(a, rank, n=4):
    """Rank `rank`'s rows of a global batch on the (4, 2) data x model
    mesh: data position rank // 2."""
    b = a.shape[0] // n
    i = rank // 2
    return a[i * b:(i + 1) * b]


def _moe_inputs():
    out, refs = {}, {}
    for name, kw in MOE_CASES.items():
        jcfg = j_smoke_config("kimi-k2-1t-a32b").scaled(**{**MOE_KW, **kw})
        cfg = smoke_config("kimi-k2-1t-a32b").scaled(**{**MOE_KW, **kw})
        jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
        x = np.random.default_rng(0).standard_normal(
            (8, 16, jcfg.d_model)).astype(np.float32)
        jq = j_quantize_tree(jp) if name == "int8" else jp
        y, aux = jmoe._moe_gspmd(jq, jnp.asarray(x), jcfg)
        g = jax.grad(lambda p: jmoe._moe_gspmd(p, jnp.asarray(x), jcfg)[0]
                     .sum())(jp) if name == "ep" else None
        out[name] = (cfg, _np(jp), x)
        refs[name] = (np.asarray(y), float(aux), g and _np(g), cfg, x)
    return out, refs


def _decode_inputs():
    out, refs = {}, {}
    rng = np.random.default_rng(3)
    for name, (H, Hkv, window, sliced) in DECODE_CASES.items():
        kw = dict(dtype="float32", num_heads=H, num_kv_heads=Hkv)
        jcfg = j_smoke_config("smollm-360m").scaled(**kw)
        cfg = smoke_config("smollm-360m").scaled(**kw)
        jp = jlayers.init_attention(jax.random.PRNGKey(1), jcfg, jnp.float32)
        hd, T, pos = jcfg.resolved_head_dim, 16, 9
        x = rng.standard_normal((8, 1, jcfg.d_model)).astype(np.float32)
        kc, vc = (rng.standard_normal((8, Hkv, T, hd)).astype(np.float32)
                  for _ in range(2))
        o, k2, v2 = jlayers.attention_decode(
            jp, jnp.asarray(x), jcfg, jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos, jnp.int32), window=window)
        out[name] = (cfg, _np(jp), (x, kc, vc, pos, window, sliced))
        refs[name] = tuple(np.asarray(a) for a in (o, k2, v2))
    return out, refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs and the JAX references made here; the eight ranks' results."""
    rng = np.random.default_rng(0)
    D, n_stages, layers_per_stage = 32, 4, 2
    Ws = (rng.standard_normal((n_stages, layers_per_stage, D, D)) * 0.2
          ).astype(np.float32)
    x = rng.standard_normal((6, 3, D)).astype(np.float32)

    def stage_fn(W, v):
        for i in range(layers_per_stage):
            v = jnp.tanh(v @ W[i])
        return v
    ys = [jnp.asarray(x)]
    for s in range(n_stages):
        ys.append(jax.vmap(lambda xm: stage_fn(Ws[s], xm))(ys[-1]))
    moe_in, moe_ref = _moe_inputs()
    dec_in, dec_ref = _decode_inputs()
    inp = {"Ws": Ws, "x_pipe": x, "moe": moe_in, "decode": dec_in}
    res = run_ranks(dist_scenarios, WORLD,
                    tmp_path_factory.mktemp("dist"), inp, timeout=240)
    return {"res": res, "pipe_ref": [np.asarray(y) for y in ys],
            "moe": moe_ref, "moe_params": {k: v[1] for k, v in moe_in.items()},
            "decode": dec_ref}


def test_gpipe_matches_sequential_stages(world):
    """(4, 2) pipe x model: every rank returns the 6 microbatches of 3
    through the four stages, as the stages applied in turn."""
    for r in world["res"]:
        np.testing.assert_allclose(r["gpipe4"].numpy(), world["pipe_ref"][4],
                                   rtol=0, atol=PIPE_TOL)
        assert "3 stages but mesh axis 'pipe' has 4 devices" in \
            r["gpipe_err"]


def test_gpipe_ring_of_one_stage(world):
    """A pipe axis of size 1: the ring passes each activation to itself."""
    for r in world["res"]:
        np.testing.assert_allclose(r["gpipe1"].numpy(), world["pipe_ref"][1],
                                   rtol=0, atol=PIPE_TOL)


def test_ep_moe_matches_reference_gspmd(world):
    """kimi-k2 smoke, 8 experts, cf 8 (no drops), (4, 2) mesh: shard_map
    and gspmd on each rank's rows equal the reference's `_moe_gspmd` on
    the whole batch, and so does the single-device path on the rows;
    the aux is the EP group's mean of the per-shard aux (shard_map) or
    the whole batch's (gspmd)."""
    y, aux, _g, _cfg, _x = world["moe"]["ep"]
    shard_aux = []
    for rank, r in enumerate(world["res"]):
        m = r["moe_ep"]
        for key in ("y_sm", "y_gs", "y_shard"):
            np.testing.assert_allclose(m[key].numpy(), _rows(y, rank),
                                       rtol=0, atol=MOE_TOL, err_msg=key)
        assert float(m["aux_gs"]) == pytest.approx(aux, rel=1e-5)
        shard_aux.append(float(m["aux_shard"]))
    for r in world["res"]:
        assert float(r["moe_ep"]["aux_sm"]) == pytest.approx(
            np.mean(shard_aux[::2]), rel=1e-5)


def test_ep_moe_grads_through_the_all_to_alls(world):
    """d sum(y) / d params through both all-to-alls and the TP sum, summed
    over the DP ranks (each TP rank's are whole: the F slice's grad is
    gathered over TP, the gates' and the input's summed over it):
    finite, and the single-device grads (the reference's and the
    port's)."""
    _y, _aux, jg, cfg, x = world["moe"]["ep"]
    params = tree_map(lambda p: p.requires_grad_(True),
                      params_from_numpy(world["moe_params"]["ep"],
                                        device="cpu"))
    with torch.enable_grad():
        tg = torch.autograd.grad(moe_ffn(params, torch.from_numpy(x),
                                         cfg)[0].sum(), tree_leaves(params))
    jleaves = jax.tree.leaves(jg)
    for r in world["res"]:
        grads = r["moe_ep"]["g_sm"]
        assert len(grads) == len(jleaves) == len(tg)
        for g, ref, port in zip(grads, jleaves, tg):
            assert bool(torch.isfinite(g).all())
            np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5,
                                       atol=MOE_TOL)
            np.testing.assert_allclose(g.numpy(), port.numpy(), rtol=1e-5,
                                       atol=MOE_TOL)


@pytest.mark.parametrize("case", ["drop", "drop_half"])
def test_ep_moe_drops_by_local_capacity(world, case):
    """cf 1.25 and 0.5: the EP path's capacity is each rank's (the
    reference's shard_map body), so each rank's rows equal the
    single-device dispatch on those rows alone, which drops other tokens
    than the whole batch; gspmd under the context keeps the whole batch's
    capacity and positions (at 0.5 it drops tokens too)."""
    y, aux, _g, _cfg, _x = world["moe"][case]
    differs = False
    for rank, r in enumerate(world["res"]):
        m = r[f"moe_{case}"]
        np.testing.assert_allclose(m["y_sm"].numpy(), m["y_shard"].numpy(),
                                   rtol=0, atol=MOE_TOL)
        np.testing.assert_allclose(m["y_gs"].numpy(), _rows(y, rank),
                                   rtol=0, atol=MOE_TOL)
        assert float(m["aux_gs"]) == pytest.approx(aux, rel=1e-5)
        differs |= not np.allclose(m["y_shard"].numpy(), _rows(y, rank),
                                   rtol=0, atol=MOE_TOL)
    assert differs, "local and global capacity drop the same tokens here"


def test_moe_over_two_dp_dims(world):
    """A (2, 2, 2) pod x data x model mesh, cf 0.5: gspmd keeps the whole
    batch's capacity over a DP group of both dims (pod major, as the
    reference's P(("pod", "data"))), and the EP path, over "data" within
    each pod, each rank's own."""
    y, aux, _g, _cfg, _x = world["moe"]["pods"]
    for rank, r in enumerate(world["res"]):
        m = r["moe_pods"]
        np.testing.assert_allclose(m["y_gs"].numpy(), _rows(y, rank),
                                   rtol=0, atol=MOE_TOL)
        assert float(m["aux_gs"]) == pytest.approx(aux, rel=1e-5)
        np.testing.assert_allclose(m["y_sm"].numpy(), m["y_shard"].numpy(),
                                   rtol=0, atol=MOE_TOL)


@pytest.mark.parametrize("case", ["experts6", "dff63", "int8"])
def test_moe_takes_the_single_device_path_where_the_reference_does(world,
                                                                   case):
    """E % n_ep, moe_d_ff % tp with tp > 1, int8 weights: shard_map takes
    `_moe_gspmd`, so the rows are the whole batch's dispatch (capacity
    1.25), which the per-shard dispatch is not."""
    y, aux, _g, _cfg, _x = world["moe"][case]
    differs = False
    for rank, r in enumerate(world["res"]):
        m = r[f"moe_{case}"]
        np.testing.assert_allclose(m["y_sm"].numpy(), _rows(y, rank),
                                   rtol=0, atol=MOE_TOL)
        assert float(m["aux_sm"]) == pytest.approx(aux, rel=1e-5)
        differs |= not np.allclose(m["y_shard"].numpy(), _rows(y, rank),
                                   rtol=0, atol=MOE_TOL)
    assert differs, "the per-shard dispatch equals the whole batch's here"


@pytest.mark.parametrize("case", ["w0", "w4"])
def test_hd_sharded_decode_matches_reference(world, case):
    """smollm-360m smoke (Hkv 1, hd 32) at tp 2: each rank's rows of the
    output and its hd slice of both caches equal the reference's
    `attention_decode` on the whole batch and cache (window 0 and 4)."""
    o, k, v = world["decode"][case]
    for rank, r in enumerate(world["res"]):
        d = r[f"decode_{case}"]
        hl = k.shape[-1] // 2
        lo = (rank % 2) * hl
        np.testing.assert_allclose(d["out"].numpy(), _rows(o, rank),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        # the new row is the roped K, rounded by another f32 rope
        np.testing.assert_allclose(d["k"].numpy(),
                                   _rows(k, rank)[..., lo:lo + hl],
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        np.testing.assert_allclose(d["v"].numpy(),
                                   _rows(v, rank)[..., lo:lo + hl],
                                   rtol=DECODE_TOL, atol=DECODE_TOL)


def test_hd_sharded_decode_gate_not_taken_when_heads_divide(world):
    """Hkv 2 at tp 2: the heads shard, so the decode takes the plain path
    on the rank's rows at full hd (the hd path would refuse them)."""
    o, k, v = world["decode"]["heads"]
    for rank, r in enumerate(world["res"]):
        d = r["decode_heads"]
        np.testing.assert_allclose(d["out"].numpy(), _rows(o, rank),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        np.testing.assert_allclose(d["k"].numpy(), _rows(k, rank),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        np.testing.assert_allclose(d["v"].numpy(), _rows(v, rank),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)


def test_activation_hook(world):
    """pshard: the identity outside a context and, inside, on a plain
    tensor; a replicated DTensor moves to Shard(0) over "data" (2 of 8
    rows a rank), one whose rows do not split stays replicated."""
    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    for r in world["res"]:
        h = r["hook"]
        assert h["outside"] and h["local"] and h["after"]
        assert h["dtensor"] == ["Shard(0)", "Replicate()"]
        assert h["dtensor_local_shape"] == [2, 6]
        np.testing.assert_array_equal(h["dtensor_full"].numpy(), x)
        assert h["odd"] == ["Replicate()", "Replicate()"]
