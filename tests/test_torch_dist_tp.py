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
  (mistral-large), moe (gspmd and the EP all-to-all), ssm (mamba2) and
  hybrid (zamba2) smoke configs: forward, prefill, 4 decode steps
  against a sharded cache, and train steps, the EP path at TP 2
  included;
- the same 4 ranks as a (1, 4) mesh, TP 4: the dense, moe, ssm and
  hybrid cases again.  There mistral-large's and phi3.5-moe's 4 q heads
  on 2 KV heads give 1 q head a rank and 2 ranks a KV head (shared KV
  heads), mamba2's and zamba2's 8 SSM heads give 2 a rank (head-parallel
  Mamba2), and the untied unembeddings split the vocab 4 ways, with the
  loss's log-softmax taken across TP.
A plain-CPU test, with no process group, holds the sum of the per-rank
Mamba2 work over the ranks to the whole block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import smoke_config as j_smoke_config
from repro.dist import sharding as jsh
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models import mamba2 as j_mamba2
from repro.models.quant import quantize_tree as j_quantize_tree
from repro.train import step as jstep
from repro.train.optim import OptimizerConfig as JOptimizerConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.dist.sharding import tp_share
from repro_torch.models import mamba2 as t_mamba2
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
    "ssm": ("mamba2-2.7b", {}, False),
}
# at TP 4 on a (1, 4) mesh, held to the same JAX runs as the (2, 2) case
# named
TP4 = {"dense_tp4": "dense", "moe_tp4": "moe_gspmd", "ssm_tp4": "ssm",
       "hybrid_tp4": "hybrid"}
MESH = {**{name: (2, 2) for name in [*SHARDED, "int8", "odd_moe"]},
        **{name: (1, 4) for name in TP4}}
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


def _jax_serve(jcfg, params, batch, toks, grads=False):
    logits, aux, _ = j_forward(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, jcfg)
    cache = j_init_cache(jcfg, toks.shape[0], T)
    steps = []
    for t in range(toks.shape[1]):
        lg, cache = j_decode_step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                                  jcfg)
        steps.append(np.asarray(lg))
    out = {"logits": np.asarray(logits), "aux": float(aux),
           "decode": np.stack(steps), "cache": _np(cache)}
    if grads:
        (loss, _), g = jax.value_and_grad(j_loss_fn, has_aux=True)(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        out.update(loss=float(loss), grads=_np(g))
    return out


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
        serve = _jax_serve(jcfg, jparams, batches[0], toks, grads=True)
        ref[name] = {"loss": losses, "grad_norm": norms, "params": params,
                     "serve_loss": serve.pop("loss", None), **serve}
        cases4[name] = {"mesh": (2, 2), "cfg": cfg,
                        "serve": {"params": start["params"],
                                  "batch": batches[0], "tokens": toks,
                                  "T": T, "grads": True},
                        "train": {"state": start, "batches": batches,
                                  "sharded": True}}
    for name, base in TP4.items():
        ref[name] = ref[base]
        cases4[name] = dict(cases4[base], mesh=(1, 4))
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
    return {"ref": ref, 2: res2, 4: res4,
            "params": {name: c["serve"]["params"]
                       for name, c in cases4.items() if "serve" in c}}


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
    ref, mesh = runs["ref"][name], MESH[name]
    for rank, r in enumerate(runs[4]):
        got = r[name]
        want = _rows(ref["logits"], rank, mesh)
        np.testing.assert_allclose(got["logits"].numpy(), want, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["prefill"].numpy(), want[:, -1],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(got["aux"]), ref["aux"],
                                   rtol=LOSS_RTOL, atol=1e-7)
        dec = np.stack([_rows(s, rank, mesh) for s in ref["decode"]])
        np.testing.assert_allclose(got["decode"].numpy(), dec, rtol=TOL,
                                   atol=TOL)
        # the engine's next tokens (torch.argmax: the first among ties)
        np.testing.assert_array_equal(got["decode"].argmax(-1).numpy(),
                                      dec.argmax(-1))


@pytest.mark.parametrize("name", [*SHARDED, "int8", *TP4])
def test_sharded_forward_prefill_and_decode_match_jax(runs, name):
    """Each rank stores its block of every parameter; its rows' logits,
    last-token logits (prefill), the MoE aux loss and 4 decode steps
    against a cache of its rows and heads, and their next tokens, equal
    JAX's single-device functions on the whole batch.  int8 is the dense
    case with int8 weights (`quantize_tree` in both packages); the _tp4
    cases split the vocab, share KV heads and split Mamba2's heads."""
    _check_serve(runs, name)


@pytest.mark.parametrize("name", [*SHARDED, *TP4])
def test_sharded_loss_and_grads_match_jax(runs, name):
    """`loss_fn` of each rank's rows with its blocks of the parameters:
    the loss and every parameter's grad, summed over DP and gathered
    whole, equal JAX's `loss_fn` and `jax.grad` on the whole batch.  An
    untied vocab splits over TP (the log-softmax across TP, no whole
    logits), and at TP 4 the KV exchange's and Mamba2's packed columns'
    backward sums over the ranks that share them."""
    ref = runs["ref"][name]
    for rank, r in enumerate(runs[4]):
        got = r[name]
        np.testing.assert_allclose(got["serve_loss"], ref["serve_loss"],
                                   rtol=LOSS_RTOL)
        a = jax.tree_util.tree_leaves_with_path(params_to_numpy(
            got["grads"]))
        b = jax.tree_util.tree_leaves_with_path(ref["grads"])
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL,
                                       err_msg=jax.tree_util.keystr(path))


def test_split_rows_after_an_indivisible_step_route_as_the_whole_batch(
        runs):
    """A train step on a batch of 3 at DP 2 (replicated rows), then, in
    the same context, the MoE forward, prefill and decode of rows each
    rank passes itself: the rows count as split again, so the router's
    capacity, counts and aux loss are the whole batch's, equal to JAX's.
    The replicated fact lasts only for the step (`MeshContext.rows`)."""
    _check_serve(runs, "odd_moe")


@pytest.mark.parametrize("name", [*SHARDED, "adafactor", *TP4])
def test_sharded_train_steps_match_jax(runs, name):
    """Two steps from JAX's state with every rank holding its blocks of
    the parameters and the AdamW moments: losses, grad norms and the
    parameters gathered whole equal JAX's single-device steps on the
    whole batch.  moe_ep is the EP all-to-all at TP 2, which the step
    used to refuse; adafactor is the dense case's step with Adafactor's
    factored statistics on the blocks."""
    for rank, r in enumerate(runs[4]):
        _check_train(r[name], runs["ref"][name], rank)


# the modules of layer 0 (and the hybrid's shared block) and the
# unembedding that compute TP-split, at TP 2 and 4 (shared KV heads at 4);
# mamba2's embedding is tied
TP_MODULES = {"dense": ["attn", "mlp", "unembed"],
              "moe_gspmd": ["attn", "moe", "unembed"],
              "moe_ep": ["attn", "moe", "unembed"],
              "hybrid": ["attn", "mamba", "mlp", "unembed"],
              "ssm": ["mamba"], "int8": ["attn", "mlp", "unembed"]}
TP_MODULES.update({name: TP_MODULES[base] for name, base in TP4.items()})


@pytest.mark.parametrize("name", [*SHARDED, "int8", *TP4])
def test_each_rank_stores_its_share_of_the_parameters(runs, name):
    """A rank's stored parameter bytes are the whole tree's, each leaf
    over its shard factor, and less than the whole tree's; attention, the
    MLP, the experts, Mamba2 and the untied unembedding compute
    TP-split."""
    for r in runs[4]:
        got = r[name]
        assert got["stored"] == got["whole_over_factor"]
        assert got["stored"] < got["whole"]
        assert got["tp_modules"] == TP_MODULES[name]


def _block(a, spec, coord):
    """The block of `a` at mesh coordinate `coord` ({dim name: (index,
    size)}) under a reference spec."""
    for d, entry in enumerate(spec):
        names = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        i, n = 0, 1
        for name in names:
            i, n = i * coord[name][1] + coord[name][0], n * coord[name][1]
        rows = a.shape[d] // n
        a = a[(slice(None),) * d + (slice(i * rows, (i + 1) * rows),)]
    return a


def _rank_cols(cfg, n, r):
    """Rank r's conv-window channels of a one-group Mamba2 at TP n: its
    heads' x channels, then B and C."""
    din, hl = cfg.d_inner, cfg.d_inner // n
    return np.r_[r * hl:(r + 1) * hl, din:din + 2 * cfg.ssm_state]


@pytest.mark.parametrize("name", [*SHARDED, *TP4])
def test_stored_and_cache_blocks_are_the_reference_blocks(runs, name):
    """Each rank stores exactly the reference's `param_spec` block of
    every parameter (`_drop_indivisible`, on an `AbstractMesh` of the same
    shape), and after 4 decode steps its cache holds the reference's
    `cache_sharding` block of JAX's cache: its rows, its KV heads and
    SSM heads where TP divides them.  Where the reference's spec
    replicates a leaf over TP, the rank keeps the part it reads and
    writes: the KV head its q heads read (TP 4 on 2 KV heads) and the
    conv window's channels of its heads with B and C."""
    base, mesh = TP4.get(name, name), MESH[name]
    arch = SHARDED[base][0]
    jcfg = j_smoke_config(arch).scaled(**CFG_KW)
    amesh = AbstractMesh(mesh, ("data", "model"))
    jctx = jsh.MeshContext(amesh, jcfg, jsh.ShardingPolicy.for_mesh(amesh))
    ref = runs["ref"][name]
    params = jax.tree.map(np.asarray, runs["params"][base])
    pspecs = jax.tree.leaves(jctx.param_shardings(params))
    cspecs = jax.tree.leaves(jctx.cache_sharding(ref["cache"]))
    n = mesh[1]
    for rank, r in enumerate(runs[4]):
        got = r[name]
        coord = {"data": (rank // n, mesh[0]), "model": (rank % n, n)}
        blocks = jax.tree_util.tree_leaves_with_path(params_to_numpy(
            got["blocks"]))
        for (path, x), y, ns in zip(blocks, jax.tree.leaves(params),
                                    pspecs):
            np.testing.assert_array_equal(
                x, _block(y, ns.spec, coord),
                err_msg=jax.tree_util.keystr(path))
        cache = jax.tree_util.tree_leaves_with_path(params_to_numpy(
            got["cache"]))
        for (path, x), y, ns in zip(cache, jax.tree.leaves(ref["cache"]),
                                    cspecs):
            key = jax.tree_util.keystr(path)
            want = _block(y, ns.spec, coord)
            if n > 1 and x.ndim >= 4 and ns.spec[2] is None:
                # replicated over TP by the reference's spec
                assert key in ("['k']", "['v']", "['ssm']['conv']"), key
                if "conv" in key:
                    want = want[..., _rank_cols(jcfg, n, rank % n)]
                else:
                    kv = (rank % n) * jcfg.num_heads // n \
                        // (jcfg.num_heads // jcfg.num_kv_heads)
                    want = want[:, :, kv:kv + 1]
            np.testing.assert_allclose(x, want, rtol=TOL, atol=TOL,
                                       err_msg=key)


@pytest.mark.parametrize("arch,n", [("mamba2-2.7b", 2), ("mamba2-2.7b", 8),
                                    ("zamba2-7b", 4)])
def test_mamba2_rank_shares_sum_to_the_whole_block(arch, n):
    """With no process group: each of n TP ranks' work on its share of
    one Mamba2 block's parameters (`tp_share`; `mamba2_gated`, then
    `mamba2_out` with the norm's mean square summed from every rank's
    partial sum), summed over the ranks, equals the port's whole block
    and JAX's `mamba2_block` on the same parameters and input."""
    jcfg = j_smoke_config(arch).scaled(**CFG_KW)
    cfg = smoke_config(arch).scaled(**CFG_KW)
    jp = _np(j_mamba2.init_mamba2(jax.random.PRNGKey(3), jcfg, jnp.float32))
    x = np.random.default_rng(9).standard_normal(
        (2, 4 * cfg.ssm_chunk, cfg.d_model)).astype(np.float32)
    want = np.asarray(j_mamba2.mamba2_block(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg))
    params, xt = params_from_numpy(jp, device="cpu"), torch.from_numpy(x)
    whole = t_mamba2.mamba2_block(params, xt, cfg)
    shares = [tp_share(params, "ssm", cfg, n, r) for r in range(n)]
    assert all(p["dt_bias"].shape == (cfg.ssm_heads // n,) for p in shares)
    gated = [t_mamba2.mamba2_gated(p, xt, cfg) for p in shares]
    mean_sq = sum(torch.sum(torch.square(g), dim=-1, keepdim=True)
                  for g in gated) / cfg.d_inner
    got = sum(t_mamba2.mamba2_out(p, g, mean_sq, cfg)
              for p, g in zip(shares, gated))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
