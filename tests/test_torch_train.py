"""The port's training slice against the JAX package on the same converted
parameters and numpy batches (smoke configs, f32, CPU): `loss_fn` and its
grads, remat, the chunked and head-major attention paths, one
`train_step` per optimizer and option, a JAX state continued in the
port, gradient compression; the reference's own optimizer, compression
and train-step tests run on the port; the kernels refuse a gradient."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import smoke_config
from repro.data.pipeline import DataConfig, TokenStream
from repro.dist import compression as jcomp
from repro.launch.shapes import make_batch
from repro.models import init_params as j_init_params
from repro.models import layers as jlayers
from repro.models import loss_fn as j_loss_fn
from repro.train import step as jstep
from repro.train.optim import OptimizerConfig as JOptimizerConfig
from repro_torch import models as tm
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.dist import compression as tcomp
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.shapes import make_batch as t_make_batch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.train import optim as toptim
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    loss_and_grads, make_prefill_step,
                                    make_serve_step, make_train_step)
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
# whole-model tolerances, tests/test_pallas_model_integration.py
GRAD_TOL = {"smollm-360m": 2e-4, "phi-3-vision-4.2b": 2e-4,
            "musicgen-large": 2e-4, "mamba2-2.7b": 5e-4, "zamba2-7b": 5e-4,
            "kimi-k2-1t-a32b": 2e-4, "phi3.5-moe-42b-a6.6b": 2e-4}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, seed=0, **kw):
    cfg = smoke_config(arch).scaled(remat=False, dtype="float32", **kw)
    jp = j_init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, jp, params_from_numpy(_np_tree(jp), device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaves_with_path(tree):
    """(path, numpy leaf) of a port's tree of tensors or a JAX tree."""
    if isinstance(tree_leaves(tree)[0], torch.Tensor):
        tree = params_to_numpy(tree)
    return jax.tree_util.tree_leaves_with_path(_np_tree(tree))


def _assert_trees_close(port, ref, rtol=2e-5, atol=2e-5):
    """Same paths, shapes and dtypes; values within rtol/atol."""
    a, b = _leaves_with_path(port), _leaves_with_path(ref)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, path
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                   err_msg=str(path))


def _stream_batch(cfg, seed=5, batch=8, seq=32, step=0, mixture=False):
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed, mixture_docs=mixture)
    return TokenStream(dcfg, 0).batch_at(step)


# ---------------------------------------------------------------------------
# loss_fn, remat, attention paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(GRAD_TOL))
def test_loss_and_grads_match_jax(arch):
    """Text, VLM (patch positions masked out), audio frames, Mamba2, the
    hybrid and both MoE archs: loss within 1e-5 relative, every grad leaf
    within the whole-model tolerance of its max |g|."""
    cfg, jp, tp = _setup(arch)
    batch = make_batch(cfg, np.random.default_rng(0), batch=2, seq=32)
    (jloss, jmet), jgrads = jax.jit(
        jax.value_and_grad(j_loss_fn, has_aux=True), static_argnums=2)(
        jp, batch, cfg)
    loss, met, grads = loss_and_grads(tp, _tbatch(batch), cfg)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(met["ce"]) == pytest.approx(float(jmet["ce"]), rel=1e-5)
    # the MoE router aux (0 for the other families), in the loss and
    # its grads
    assert float(met["aux"]) == pytest.approx(float(jmet["aux"]), abs=1e-6)
    assert (float(met["aux"]) > 0) == (cfg.family == "moe")
    assert int(met["tokens"]) == int(jmet["tokens"])
    if cfg.modality == "vlm":
        assert int(met["tokens"]) == 2 * (32 - cfg.num_patches)
    tol = GRAD_TOL[arch]
    for (path, g), (_, jg) in zip(_leaves_with_path(grads),
                                  _leaves_with_path(jgrads)):
        assert np.isfinite(jg).all(), path
        assert g.shape == jg.shape and g.dtype == jg.dtype, path
        scale = max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(g, jg, rtol=0, atol=tol * scale,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b"])
def test_remat_policies_give_equal_grads(arch, monkeypatch):
    """Remat off, full and dots give the same loss and grads bit for bit;
    dots saves exactly the projections (aten.mm: 7 a dense or shared
    attention block, 2 a Mamba2 block) and recomputes the batched
    einsums (aten.bmm)."""
    base = smoke_config(arch).scaled(dtype="float32")
    params = tm.init_params(base, seed=1, device="cpu")
    batch = t_make_batch(base, np.random.default_rng(0), 2, 32, device="cpu")
    decisions = []
    policy = tmodel.dots_policy

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, out))
        return out
    monkeypatch.setattr(tmodel, "dots_policy", spy)
    ref_loss, _, ref = loss_and_grads(params, batch, base.scaled(remat=False))
    for policy_name in ("full", "dots"):
        loss, _, grads = loss_and_grads(
            params, batch, base.scaled(remat=True, remat_policy=policy_name))
        assert torch.equal(loss, ref_loss)
        for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
            assert torch.equal(a, b)
    saved = [op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE]
    recomputed = {op for op, d in decisions
                  if d != CheckpointPolicy.MUST_SAVE}
    n_attn = base.num_layers if base.family == "dense" \
        else sum(tmodel.hybrid_attn_mask(base))
    n_ssm = 0 if base.family == "dense" else base.num_layers
    assert set(saved) == {torch.ops.aten.mm.default}
    assert len(saved) == 7 * n_attn + 2 * n_ssm
    assert torch.ops.aten.bmm.default in recomputed


def test_remat_applies_only_when_gradients_are_on(monkeypatch):
    cfg = smoke_config("smollm-360m").scaled(dtype="float32", remat=True)
    params = tm.init_params(cfg, seed=0, device="cpu")
    batch = t_make_batch(cfg, np.random.default_rng(0), 1, 8, device="cpu")
    calls = []
    monkeypatch.setattr(tmodel, "checkpoint",
                        lambda *a, **k: calls.append(1) or a[0](*a[1:]))
    with torch.no_grad():
        tm.forward(params, batch, cfg)
    assert calls == []
    with torch.enable_grad():
        tm.forward(params, batch, cfg)
    assert len(calls) == cfg.num_layers


# (S, window): S not a multiple of the 512-row chunk (two chunks, the
# second padded), with and without a window
ATTN_CASES = [(600, 0), (600, 100)]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("impl", ["xla_chunked", "xla_bhsd"])
def test_attention_impls_match_jax(impl, case):
    """The chunked online softmax and the head-major layout: forward and
    the grads of <out, cotangent> w.r.t. the input and every weight,
    against JAX's at the attention tolerance 2e-4."""
    S, window = case
    cfg = smoke_config("smollm-360m").scaled(dtype="float32",
                                             attn_impl=impl)
    rng = np.random.default_rng(S + window)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jp = jlayers.init_attention(jax.random.PRNGKey(3), cfg, jnp.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))

    def jf(p, xx):
        out = jlayers.attention(p, xx, cfg, jnp.asarray(pos), window=window)
        return jnp.sum(out * ct), out
    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jp, x)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(True), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tlayers.attention(tp, tx, cfg, torch.from_numpy(pos.copy()),
                            window=window)
    gx, *gp = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                  [tx, *tree_leaves(tp)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-4, atol=2e-4)
    for g, jg in zip([gx, *gp], [jgx, *jax.tree.leaves(jgp)]):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=2e-4 * np.abs(jg).max())


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------

TRAIN_VARIANTS = {
    "adamw": dict(),
    "adafactor": dict(name="adafactor"),
    "microbatches4": dict(microbatches=4),
    "grad_compression": dict(grad_compression=True),
}


def _train_configs(variant):
    kw = dict(TRAIN_VARIANTS[variant])
    name = kw.pop("name", "adamw")
    jt = jstep.TrainConfig(optimizer=JOptimizerConfig(name=name, lr=1e-3),
                           **kw)
    tt = TrainConfig(optimizer=toptim.OptimizerConfig(name=name, lr=1e-3),
                     **kw)
    return jt, tt


@pytest.mark.parametrize("variant", list(TRAIN_VARIANTS))
def test_train_step_matches_jax(variant):
    """One step from the same converted state and batch (remat on, as the
    configs have it): loss, grad_norm, new params and optimizer state."""
    cfg = smoke_config("smollm-360m").scaled(dtype="float32")
    jt, tt = _train_configs(variant)
    jstate = jstep.init_train_state(jax.random.PRNGKey(0), cfg, jt)
    state = train_state_from_numpy(_np_tree(jstate), device="cpu")
    batch = _stream_batch(cfg)
    jnew, jm = jax.jit(jstep.make_train_step(cfg, jt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = make_train_step(cfg, tt)(state, batch)
    assert set(m) == set(jm)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    assert m["step"].dtype == torch.int32 and int(m["step"]) == 1
    _assert_trees_close(new, jnew)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_jax_state_continues_in_the_port(optimizer):
    """Two JAX steps, the state carried across: the port's step 3 gives
    JAX's step 3, and its state carried back has the reference's tree."""
    cfg = smoke_config("smollm-360m").scaled(dtype="float32")
    jt = jstep.TrainConfig(optimizer=JOptimizerConfig(name=optimizer,
                                                      lr=1e-3))
    tt = TrainConfig(optimizer=toptim.OptimizerConfig(name=optimizer,
                                                      lr=1e-3))
    jfn = jax.jit(jstep.make_train_step(cfg, jt))
    jstate = jstep.init_train_state(jax.random.PRNGKey(2), cfg, jt)
    batches = [_stream_batch(cfg, seed=7, step=s, mixture=True)
               for s in range(3)]
    for b in batches[:2]:
        jstate, _ = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state = train_state_from_numpy(_np_tree(jstate), device="cpu")
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2
    jstate, jm = jfn(jstate, {k: jnp.asarray(v)
                              for k, v in batches[2].items()})
    state, m = make_train_step(cfg, tt)(state, batches[2])
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    back = train_state_to_numpy(state)
    _assert_trees_close(back, _np_tree(jstate))
    with pytest.raises(ValueError, match="not a train state"):
        train_state_from_numpy({"params": {}}, device="cpu")


def test_compression_matches_jax():
    """int8 round trip and error feedback: the same dequantized values
    and residuals as JAX's, bit for bit, in f32 and bf16, and scale 1 for
    an all-zero leaf."""
    rng = np.random.default_rng(4)
    grads = {"w": rng.standard_normal((64, 130)).astype(np.float32),
             "z": np.zeros((7,), np.float32),
             "h": (rng.standard_normal((33,)) * 1e-3).astype(np.float32)}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    jg["b"] = jnp.asarray(rng.standard_normal((40, 3)), jnp.bfloat16)
    tg = params_from_numpy(_np_tree(jg), device="cpu")
    _assert_trees_close(tcomp.compress_decompress(tg),
                        _np_tree(jcomp.compress_decompress(jg)), 0, 0)
    jres, tres = None, None
    for _ in range(3):
        jout, jres = jcomp.compress_with_feedback(jg, jres)
        tout, tres = tcomp.compress_with_feedback(tg, tres)
        _assert_trees_close(tout, _np_tree(jout), 0, 0)
        _assert_trees_close(tres, _np_tree(jres), 0, 0)
    deq, codes, _ = tcomp.quantize_codes(tg["w"])
    assert codes.dtype == torch.int8 and int(codes.abs().max()) == 127
    scale = tg["w"].abs().max() / 127.0
    assert torch.equal(codes.float() * scale, deq)


# ---------------------------------------------------------------------------
# the reference's own tests, on the port
# (tests/test_substrate.py, tests/test_elastic_and_microbatch.py)
# ---------------------------------------------------------------------------


def _quad_params():
    return {"w": torch.tensor([[1.0, -2.0], [3.0, 0.5]]),
            "b": torch.tensor([0.3, -0.1])}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_reduces_quadratic(name):
    cfg = toptim.OptimizerConfig(name=name, lr=0.05, weight_decay=0.0)
    params = _quad_params()
    state = toptim.init_opt_state(params, cfg)

    def loss(p):
        return torch.sum(torch.square(p["w"])) + torch.sum(
            torch.square(p["b"]))

    l0 = loss(params)
    for _ in range(60):
        grads = {k: 2 * v for k, v in params.items()}
        params, state, _ = toptim.apply_optimizer(grads, state, params, cfg)
    assert loss(params) < 0.2 * l0


def test_adafactor_factored_stats_memory_shape():
    params = {"big": torch.zeros((256, 512)), "small": torch.zeros((8,)),
              "stacked": torch.zeros((3, 128, 200)),
              "layer_vec": torch.zeros((3, 960))}
    st = toptim.adafactor_init(params)
    assert st["stats"]["big"]["vr"].shape == (256,)
    assert st["stats"]["big"]["vc"].shape == (512,)
    assert st["stats"]["small"]["v"].shape == (8,)
    assert st["stats"]["stacked"]["vr"].shape == (3, 128)
    assert st["stats"]["stacked"]["vc"].shape == (3, 200)
    assert st["stats"]["layer_vec"]["v"].shape == (3, 960)
    assert st["count"].dtype == torch.int32


def test_choose_optimizer_by_parameter_count():
    assert toptim.choose_optimizer(int(200e9)).name == "adamw"
    assert toptim.choose_optimizer(int(200e9) + 1).name == "adafactor"


def test_compression_bounded_error():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((128, 130))
                               .astype(np.float32))}
    out = tcomp.compress_decompress(g)
    err = torch.max(torch.abs(out["w"] - g["w"]))
    scale = torch.max(torch.abs(g["w"])) / 127.0
    assert err <= scale + 1e-6


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy((rng.standard_normal((64, 64)) * 1e-3)
                               .astype(np.float32))}
    res = None
    acc = torch.zeros_like(g["w"])
    for _ in range(50):
        out, res = tcomp.compress_with_feedback(g, res)
        acc = acc + out["w"]
    true = g["w"] * 50
    rel = float(torch.linalg.norm(acc - true) / torch.linalg.norm(true))
    assert rel < 0.05


def test_microbatch_accumulation_matches_full_batch():
    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="float32")
    batch = _stream_batch(cfg)
    t1 = TrainConfig(optimizer=toptim.OptimizerConfig(lr=1e-3),
                     microbatches=1)
    t4 = TrainConfig(optimizer=toptim.OptimizerConfig(lr=1e-3),
                     microbatches=4)
    s1b, m1 = make_train_step(cfg, t1)(
        init_train_state(cfg, t1, seed=0, device="cpu"), batch)
    s4b, m4 = make_train_step(cfg, t4)(
        init_train_state(cfg, t4, seed=0, device="cpu"), batch)
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert set(m4) == {"loss", "grad_norm", "step"}
    # atol covers f32 reduction-order noise in the per-microbatch grads,
    # amplified by Adam's rsqrt on near-zero second moments at step 1
    for a, b in zip(tree_leaves(s1b["params"]), tree_leaves(s4b["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_grad_compression_step_trains():
    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="float32")
    tcfg = TrainConfig(optimizer=toptim.OptimizerConfig(lr=1e-3),
                       grad_compression=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                      seed=6)
    stream = TokenStream(dcfg, 0)
    state = init_train_state(cfg, tcfg, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg)
    losses = []
    for s in range(8):
        state, m = step(state, stream.batch_at(s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# kernels refuse a gradient; entry points; the example
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_a_gradient_on_the_cpu():
    """Every wrapper raises when gradients are on and an input requires
    one, on the CPU's plain path too; with gradients off, or no input
    requiring one, it computes as before.  A train step with
    attn_impl="pallas" is refused the same way."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    qd = torch.randn(1, 2, 16, generator=g)
    kc, vc = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(2))
    x = torch.randn(1, 16, 2, 16, generator=g)
    dt = torch.full((1, 16, 2), 0.05)
    A = torch.tensor([-1.0, -2.0])
    Bm, Cm = (torch.randn(1, 16, 16, generator=g) for _ in range(2))
    calls = {
        "flash_attention": lambda t: fa_ops.flash_attention(t, k, v),
        "decode_attention": lambda t: da_ops.decode_attention(t, kc, vc, 8),
        "ssd_scan": lambda t: ssd_ops.ssd_scan(t, dt, A, Bm, Cm, chunk=16),
    }
    inputs = {"flash_attention": q, "decode_attention": qd, "ssd_scan": x}
    for name, call in calls.items():
        t = inputs[name].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):
            call(t)
        with torch.no_grad():
            call(t)
        call(inputs[name])
    with pytest.raises(RuntimeError, match="forward-only"):
        ssd_ops.ssd(x.requires_grad_(True), dt, A, Bm[:, :, None],
                    Cm[:, :, None], chunk=16)
    for arch in ("smollm-360m", "mamba2-2.7b"):
        cfg = smoke_config(arch).scaled(dtype="float32", attn_impl="pallas")
        params = tm.init_params(cfg, seed=0, device="cpu")
        batch = t_make_batch(cfg, np.random.default_rng(0), 1, 16,
                             device="cpu")
        with pytest.raises(RuntimeError, match="attn_impl='xla'"):
            loss_and_grads(params, batch, cfg)


def test_prefill_and_serve_steps_wrap_the_model():
    cfg = smoke_config("smollm-360m").scaled(dtype="float32")
    params = tm.init_params(cfg, seed=0, device="cpu")
    batch = t_make_batch(cfg, np.random.default_rng(1), 2, 8, device="cpu")
    with torch.no_grad():
        logits = make_prefill_step(cfg)(params, batch)
        assert torch.equal(logits, tm.prefill(params, batch, cfg, 8))
        cache = tm.init_cache(cfg, 2, 8, device="cpu")
        out, cache = make_serve_step(cfg)(params, cache,
                                          batch["tokens"][:, :1])
    assert out.shape == (2, cfg.vocab_size) and int(cache["pos"]) == 1


def test_train_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a host without a card")
    cfg = smoke_config("smollm-360m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_make_batch(cfg, np.random.default_rng(0), 1, 8)


def test_torch_train_example_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train.py"),
         "--preset", "5m", "--steps", "3", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: loss" in out.stdout
    assert (tmp_path / "results" / "train_5m.json").exists()
