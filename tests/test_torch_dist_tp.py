"""A batch the DP ranks do not divide, and compute with TP/FSDP-sharded
parameters, across gloo ranks on the CPU, held to the JAX package's
single-device functions on the whole batch (its multi-device tests do
not run under this JAX: ROADMAP.md §3).

Two spawns run every case (tests/torch_dist_workers.py::tp_cases):
- 2 ranks as a (2, 1) data x model mesh: smollm-360m's step on a batch
  of 3, replicated on both ranks;
- 4 ranks as a (2, 2) mesh: phi3.5-moe's step on a batch of 3, then in
  the same context a forward, prefill and decode of split rows; and with
  each rank storing only its block of every parameter, the dense
  (mistral-large), moe (gspmd and the EP all-to-all) and hybrid (zamba2)
  smoke configs: forward, prefill, 4 decode steps against a sharded
  cache, and train steps, the EP path at TP 2 included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke_config
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models.quant import quantize_tree as j_quantize_tree
from repro.train import step as jstep
from repro.train.optim import OptimizerConfig as JOptimizerConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import params_to_numpy
from torch_dist_workers import run_ranks, tp_cases

CFG_KW = dict(dtype="float32")
B, S, T, STEPS = 4, 16, 32, 4
# the DP tolerances of tests/test_torch_dist_train.py and
# tests/test_torch_dist.py: losses 1e-5, grad norms 1e-4, f32 values 2e-5
LOSS_RTOL, NORM_RTOL, TOL = 1e-5, 1e-4, 2e-5
# name: (arch, config options, remat)
SHARDED = {
    "dense": ("mistral-large-123b", {}, True),
    "moe_gspmd": ("phi3.5-moe-42b-a6.6b", {}, False),
    # capacity factor 8, as the reference's test of the EP path
    # (tests/test_quant_and_dist.py): no token drops, so each rank's local
    # capacity routes as the whole batch's.  The EP aux loss is the mean
    # of each rank's (the reference's shard_map body), not the whole
    # batch's, and tests/test_torch_dist.py holds it to that per-shard
    # oracle; here its coefficient is 0, so the loss is the whole batch's
    "moe_ep": ("phi3.5-moe-42b-a6.6b",
               dict(moe_impl="shard_map", capacity_factor=8.0,
                    router_aux_coef=0.0), False),
    "hybrid": ("zamba2-7b", {}, False),
}
# name: (arch, mesh, rows)
ODD = {"odd_dense": ("smollm-360m", (2, 1), 3),
       "odd_moe": ("phi3.5-moe-42b-a6.6b", (2, 2), 3)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, kw, remat):
    opts = dict(CFG_KW, remat=remat, **kw)
    return j_smoke_config(arch).scaled(**opts), smoke_config(arch).scaled(
        **opts)


def _batches(vocab, rows, n, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (rows, S)).astype(np.int32),
             "labels": rng.integers(0, vocab, (rows, S)).astype(np.int32)}
            for _ in range(n)]


def _jax_train(jcfg, batches, optimizer="adamw"):
    """JAX's state at seed 0 (numpy) and its jitted steps on the whole
    batches: per-step loss and grad_norm, the final parameters."""
    jt = jstep.TrainConfig(optimizer=JOptimizerConfig(name=optimizer,
                                                      lr=1e-3))
    state = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    start = _np(state)
    fn = jax.jit(jstep.make_train_step(jcfg, jt))
    losses, norms = [], []
    for b in batches:
        state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return start, losses, norms, _np(state["params"])


def _jax_serve(jcfg, params, batch, toks):
    logits, aux, _ = j_forward(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, jcfg)
    cache = j_init_cache(jcfg, toks.shape[0], T)
    steps = []
    for t in range(toks.shape[1]):
        lg, cache = j_decode_step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                                  jcfg)
        steps.append(np.asarray(lg))
    return {"logits": np.asarray(logits), "aux": float(aux),
            "decode": np.stack(steps)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_tp")
    ref, cases2, cases4 = {}, {}, {}
    for name, (arch, mesh, rows) in ODD.items():
        jcfg, cfg = _cfgs(arch, {}, False)
        batches = _batches(cfg.vocab_size, rows, 2, seed=1)
        start, losses, norms, params = _jax_train(jcfg, batches)
        ref[name] = {"loss": losses, "grad_norm": norms, "params": params}
        (cases2 if mesh == (2, 1) else cases4)[name] = {
            "mesh": mesh, "cfg": cfg, "train": {
                "state": start, "batches": batches, "sharded": False}}
    # after the odd step, rows of a batch of B that the ranks pass
    # themselves: split again, so the router's capacity and statistics
    # are the whole batch's
    jcfg, _ = _cfgs(ODD["odd_moe"][0], {}, False)
    start = cases4["odd_moe"]["train"]["state"]
    batch = _batches(jcfg.vocab_size, B, 1, seed=7)[0]
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    ref["odd_moe"].update(_jax_serve(jcfg, jax.tree.map(
        jnp.asarray, start["params"]), batch, toks))
    cases4["odd_moe"]["serve"] = {"params": start["params"], "batch": batch,
                                  "tokens": toks, "T": T}
    for name, (arch, kw, remat) in SHARDED.items():
        jcfg, cfg = _cfgs(arch, kw, remat)
        batches = _batches(cfg.vocab_size, B, 2, seed=2)
        start, losses, norms, params = _jax_train(jcfg, batches)
        toks = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
        jparams = jax.tree.map(jnp.asarray, start["params"])
        ref[name] = {"loss": losses, "grad_norm": norms, "params": params,
                     **_jax_serve(jcfg, jparams, batches[0], toks)}
        cases4[name] = {"mesh": (2, 2), "cfg": cfg,
                        "serve": {"params": start["params"],
                                  "batch": batches[0], "tokens": toks,
                                  "T": T},
                        "train": {"state": start, "batches": batches,
                                  "sharded": True}}
    # Adafactor on blocks: its factored means and RMS clip are summed
    # over the ranks holding the other blocks
    jcfg, cfg = _cfgs("mistral-large-123b", {}, False)
    batches = _batches(cfg.vocab_size, B, 2, seed=4)
    start, losses, norms, params = _jax_train(jcfg, batches, "adafactor")
    ref["adafactor"] = {"loss": losses, "grad_norm": norms,
                        "params": params}
    cases4["adafactor"] = {"mesh": (2, 2), "cfg": cfg, "train": {
        "state": start, "batches": batches, "sharded": True,
        "optimizer": "adafactor"}}
    # int8 weights, served: gathered whole and cut to the TP block
    jcfg, cfg = _cfgs("mistral-large-123b", {}, False)
    batch = _batches(cfg.vocab_size, B, 1, seed=5)[0]
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    start = _np(j_init_params(jax.random.PRNGKey(1), jcfg))
    ref["int8"] = _jax_serve(jcfg, j_quantize_tree(
        jax.tree.map(jnp.asarray, start)), batch, toks)
    cases4["int8"] = {"mesh": (2, 2), "cfg": cfg, "serve": {
        "params": start, "batch": batch, "tokens": toks, "T": T,
        "int8": True}}
    res2 = run_ranks(tp_cases, 2, tmp, cases2, timeout=240)
    res4 = run_ranks(tp_cases, 4, tmp, cases4, timeout=240)
    return {"ref": ref, 2: res2, 4: res4}


def _rows(a, rank, mesh):
    """Rank `rank`'s rows of a whole-batch array on a (data, model)
    mesh: data position rank // model."""
    n = mesh[0]
    b = a.shape[0] // n
    i = rank // mesh[1]
    return a[i * b:(i + 1) * b]


def _assert_params_close(port, ref):
    """Every leaf within 2e-5 but for one element in 1000: the sums over
    ranks add in another order, and where Adam's second moment is near
    zero that f32 noise moves an element by up to lr
    (tests/test_torch_dist_train.py)."""
    a = jax.tree_util.tree_leaves_with_path(params_to_numpy(port))
    b = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        off = ~np.isclose(x, y, rtol=TOL, atol=TOL)
        assert off.sum() <= off.size / 1000, (jax.tree_util.keystr(path),
                                              int(off.sum()), off.size)


def _check_train(got, ref, rank):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=NORM_RTOL)
    if rank == 0:
        _assert_params_close(got["params"], ref["params"])


@pytest.mark.parametrize("name", list(ODD))
def test_indivisible_batch_is_replicated_and_gives_the_whole_batch_step(
        runs, name):
    """A batch of 3 rows on 2 DP ranks: every rank takes all 3, and the
    loss, grad norm and parameters after 2 steps are JAX's whole-batch
    step's (the token count, the ce, the router's statistics and
    capacity, and the grads counted once, not once per rank)."""
    mesh = ODD[name][1]
    world = int(np.prod(mesh))
    for rank, r in enumerate(runs[world]):
        _check_train(r[name], runs["ref"][name], rank)


def _check_serve(runs, name):
    ref = runs["ref"][name]
    for rank, r in enumerate(runs[4]):
        got = r[name]
        want = _rows(ref["logits"], rank, (2, 2))
        np.testing.assert_allclose(got["logits"].numpy(), want, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["prefill"].numpy(), want[:, -1],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(got["aux"]), ref["aux"],
                                   rtol=LOSS_RTOL, atol=1e-7)
        dec = np.stack([_rows(s, rank, (2, 2)) for s in ref["decode"]])
        np.testing.assert_allclose(got["decode"].numpy(), dec, rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("name", [*SHARDED, "int8"])
def test_sharded_forward_prefill_and_decode_match_jax(runs, name):
    """Each rank stores its block of every parameter; its rows' logits,
    last-token logits (prefill), the MoE aux loss and 4 decode steps
    against a cache of its rows and KV heads equal JAX's single-device
    functions on the whole batch.  int8 is the dense case with int8
    weights (`quantize_tree` in both packages)."""
    _check_serve(runs, name)


def test_split_rows_after_an_indivisible_step_route_as_the_whole_batch(
        runs):
    """A train step on a batch of 3 at DP 2 (replicated rows), then, in
    the same context, the MoE forward, prefill and decode of rows each
    rank passes itself: the rows count as split again, so the router's
    capacity, counts and aux loss are the whole batch's, equal to JAX's.
    The replicated fact lasts only for the step (`MeshContext.rows`)."""
    _check_serve(runs, "odd_moe")


@pytest.mark.parametrize("name", [*SHARDED, "adafactor"])
def test_sharded_train_steps_match_jax(runs, name):
    """Two steps from JAX's state with every rank holding its blocks of
    the parameters and the AdamW moments: losses, grad norms and the
    parameters gathered whole equal JAX's single-device steps on the
    whole batch.  moe_ep is the EP all-to-all at TP 2, which the step
    used to refuse; adafactor is the dense case's step with Adafactor's
    factored statistics on the blocks."""
    for rank, r in enumerate(runs[4]):
        _check_train(r[name], runs["ref"][name], rank)


# the modules of layer 0 (and the hybrid's shared block) that compute
# TP-split at TP 2: every attention has whole KV heads a rank
TP_MODULES = {"dense": ["attn", "mlp"], "moe_gspmd": ["attn", "moe"],
              "moe_ep": ["attn", "moe"], "hybrid": ["attn", "mlp"],
              "int8": ["attn", "mlp"]}


@pytest.mark.parametrize("name", [*SHARDED, "int8"])
def test_each_rank_stores_its_share_of_the_parameters(runs, name):
    """A rank's stored parameter bytes are the whole tree's, each leaf
    over its shard factor, and less than the whole tree's; attention, the
    MLP and the experts compute TP-split."""
    for r in runs[4]:
        got = r[name]
        assert got["stored"] == got["whole_over_factor"]
        assert got["stored"] < got["whole"]
        assert got["tp_modules"] == TP_MODULES[name]
