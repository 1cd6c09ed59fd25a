"""The port's checkpoint store: the reference's checkpoint cases on CPU
tensors, the same chunks, versions and manifest as the reference's store
for the same tree and seed, restores across the two frameworks both ways
(bf16 included), the serving engine refreshing from the real store, and
the fault-tolerant training example on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import smoke_config
from repro.data.pipeline import DataConfig, TokenStream
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.serve import engine as jeng
from repro.train import step as jstep
from repro.train.optim import OptimizerConfig as JOptimizerConfig
from repro_torch.checkpoint import (SpinnakerCheckpointStore,
                                    StaleTrainerError, StoreConfig)
from repro_torch.checkpoint import store as tstore
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.models import forward, init_params
from repro_torch.serve import engine as teng
from repro_torch.train.optim import OptimizerConfig
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_train_step)
from repro_torch.tree import tree_leaves, tree_leaves_with_path

ROOT = Path(__file__).resolve().parents[1]


def small_tree(seed=0):
    """tests/test_checkpoint.py::small_tree as CPU tensors."""
    rng = np.random.default_rng(seed)
    return {
        "layer": {"w": torch.from_numpy(
                      rng.standard_normal((33, 17)).astype(np.float32)),
                  "b": torch.from_numpy(
                      rng.standard_normal((17,)).astype(np.float32))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def trees_equal(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


# ---------------------------------------------------------------------------
# the reference's checkpoint cases (tests/test_checkpoint.py) on the port
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip():
    store = SpinnakerCheckpointStore(StoreConfig(chunk_bytes=512))
    tree = small_tree()
    store.save(10, tree)
    step, restored = store.restore_tree(small_tree(1))
    assert step == 10
    assert trees_equal(tree, restored)
    # numpy leaves, a numpy scalar and an empty array among them, save as
    # the reference's do
    nptree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "step": np.int32(7), "empty": np.zeros((0, 3), np.int64)}
    store.save(11, nptree)
    _, flat = store.restore()
    assert flat["step"].dtype == torch.int32 and int(flat["step"]) == 7
    assert torch.equal(flat["w"], torch.arange(6.0).reshape(2, 3))
    assert flat["empty"].shape == (0, 3) and flat["empty"].dtype == torch.int64


def test_manifest_fences_zombie_trainer():
    store = SpinnakerCheckpointStore(StoreConfig())
    t1 = small_tree(1)
    store.save(1, t1)

    # trainer B takes over the run (restores, then commits newer state)
    store_b = object.__new__(SpinnakerCheckpointStore)
    store_b.__dict__.update(store.__dict__)      # same cluster, own version
    store_b._manifest_version = None
    store_b.restore_tree(t1)
    store_b.save(2, small_tree(2))

    # trainer A (zombie, stale manifest version) must NOT clobber step 2
    with pytest.raises(StaleTrainerError):
        store.save(3, small_tree(3))
    assert store_b.latest_step() == 2


def test_checkpoint_survives_storage_node_crash():
    store = SpinnakerCheckpointStore(StoreConfig(chunk_bytes=256))
    tree = small_tree(4)
    store.save(5, tree)
    store.crash_storage_node(1)
    store.sim.run_for(5.0)
    step, restored = store.restore_tree(tree)
    assert step == 5 and trees_equal(tree, restored)
    store.save(6, small_tree(5))
    assert store.latest_step() == 6
    store.restart_storage_node(1)
    step, _ = store.restore_tree(tree)
    assert step == 6


def test_timeline_read_for_serving_refresh():
    store = SpinnakerCheckpointStore(StoreConfig())
    store.save(1, small_tree(1))
    assert store.latest_step(consistent=False) == 1
    store.sim.run_for(2.0)
    step, flat = store.restore(consistent=False)
    assert step == 1
    assert torch.equal(flat["layer/w"], small_tree(1)["layer"]["w"])


def test_train_crash_resume_bit_exact(deterministic):
    """Train 3 steps and checkpoint, 'crash', restore into a trainer
    initialised from another seed, continue 3 steps: the losses and the
    final state equal an uninterrupted run's bit for bit."""
    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="float32")
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3))
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4, seed=11,
                                    mixture_docs=False), 0)
    step_fn = make_train_step(cfg, tcfg)

    def run(state, start, n):
        losses = []
        for s in range(start, start + n):
            state, metrics = step_fn(state, stream.batch_at(s))
            losses.append(float(metrics["loss"]))
        return state, losses

    ref_state, ref_losses = run(
        init_train_state(cfg, tcfg, seed=0, device="cpu"), 0, 6)
    state, l1 = run(init_train_state(cfg, tcfg, seed=0, device="cpu"), 0, 3)
    store = SpinnakerCheckpointStore(StoreConfig(chunk_bytes=1 << 16))
    store.save(3, state)
    del state
    fresh = init_train_state(cfg, tcfg, seed=42, device="cpu")
    step, restored = store.restore_tree(fresh)
    assert step == 3
    restored_state, l2 = run(restored, 3, 3)
    assert l1 + l2 == ref_losses
    assert trees_equal(restored_state, ref_state)


# ---------------------------------------------------------------------------
# across the frameworks
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same_bits(t, arr) -> bool:
    """A port tensor and a JAX/numpy leaf hold the same bytes."""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes() == \
        np.asarray(arr).tobytes()


@pytest.fixture(scope="module")
def jax_run():
    """The smoke SmolLM-360M (f32) and a JAX AdamW state one step in, with
    the jitted step and three batches."""
    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="float32")
    jt = jstep.TrainConfig(optimizer=JOptimizerConfig(lr=1e-3))
    jfn = jax.jit(jstep.make_train_step(cfg, jt))
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4, seed=5), 0)
    batches = [stream.batch_at(s) for s in range(3)]
    jstate, _ = jfn(jstep.init_train_state(jax.random.PRNGKey(0), cfg, jt),
                    {k: jnp.asarray(v) for k, v in batches[0].items()})
    return cfg, jt, jfn, _np(jstate), batches


def _trees(kind, jax_run):
    """(JAX tree of numpy leaves, the same tree as the port's tensors)."""
    cfg, _, _, jstate, _ = jax_run
    if kind == "adamw_state":
        return jstate, train_state_from_numpy(jstate, device="cpu")
    dtype = {"params_f32": "float32", "params_bf16": "bfloat16"}[kind]
    jp = _np(j_init_params(jax.random.PRNGKey(3), cfg.scaled(dtype=dtype)))
    return jp, params_from_numpy(jp, device="cpu")


def _recorded_save(mod, tree):
    """Save `tree` at step 1 into a fresh store of package `mod`; returns
    the manifest JSON, every chunk put (key, code, version), the manifest
    version, the simulated time and the protocol journal."""
    store = mod.SpinnakerCheckpointStore(mod.StoreConfig(chunk_bytes=1 << 16))
    puts, put = [], store._put

    def recorded(key, value):
        res = put(key, value)
        puts.append((key, res.code.name, res.version))
        return res
    store._put = recorded
    manifest = store.save(1, tree)
    return (json.dumps(manifest), puts, store._manifest_version,
            store.sim.now, store.cluster.obs.journal.to_jsonl())


@pytest.mark.parametrize("kind", ["params_f32", "params_bf16",
                                  "adamw_state"])
def test_same_tree_same_chunks_and_manifest(kind, jax_run):
    jtree, ttree = _trees(kind, jax_run)
    ref = _recorded_save(jstore, jtree)
    port = _recorded_save(tstore, ttree)
    assert port[0] == ref[0]                    # manifest JSON
    assert port[1] == ref[1]                    # chunk keys and versions
    assert port[2:4] == ref[2:4]
    assert port[4] == ref[4]                    # journal, value digests
    names = [e["name"] for e in json.loads(port[0])["index"]]
    assert names == [n for n, _ in tree_leaves_with_path(ttree)]
    if kind == "adamw_state":
        assert names[0] == "opt/count" and "opt/m/layers/attn/wq" in names


@pytest.mark.parametrize("kind", ["adamw_state", "params_bf16"])
def test_reference_save_restores_into_the_port(kind, jax_run):
    cfg, _, _, _, batches = jax_run
    jtree, _ = _trees(kind, jax_run)
    store = jstore.SpinnakerCheckpointStore(jstore.StoreConfig(
        chunk_bytes=1 << 16))
    store.save(4, jtree)
    # the same cluster, read through the port's facade
    store.__class__ = tstore.SpinnakerCheckpointStore
    like = (init_train_state(cfg, TrainConfig(), seed=9, device="cpu")
            if kind == "adamw_state" else
            init_params(cfg.scaled(dtype="bfloat16"), seed=9, device="cpu"))
    step, restored = store.restore_tree(like)
    assert step == 4
    like_leaves = tree_leaves(like)
    for (name, t), j, lk in zip(tree_leaves_with_path(restored),
                                jax.tree.leaves(jtree), like_leaves):
        assert t.dtype == lk.dtype and _same_bits(t, j), name
    if kind == "adamw_state":
        tokens = batches[1]["tokens"]
        ref, _, _ = j_forward(jtree["params"], {"tokens": tokens}, cfg)
        out, _, _ = forward(restored["params"],
                            {"tokens": torch.from_numpy(tokens)}, cfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-4)


def test_port_save_restores_into_the_reference_and_trains_on(jax_run):
    """A port state one step further than the JAX state restores into a
    fresh JAX state bit for bit, and JAX's next step from it gives the
    port's next step; a bf16 port state restores bit for bit and trains
    on in JAX."""
    cfg, jt, jfn, jstate, batches = jax_run
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3))
    step_fn = make_train_step(cfg, tcfg)
    state, _ = step_fn(train_state_from_numpy(jstate, device="cpu"),
                       batches[1])
    store = SpinnakerCheckpointStore(StoreConfig(chunk_bytes=1 << 16))
    store.save(2, state)
    store.__class__ = jstore.SpinnakerCheckpointStore   # the reference reads
    step, jrestored = store.restore_tree(
        jstep.init_train_state(jax.random.PRNGKey(9), cfg, jt))
    assert step == 2
    assert int(jrestored["step"]) == 2
    for t, j in zip(tree_leaves(state), jax.tree.leaves(jrestored)):
        assert _same_bits(t, j)
    jnext, jm = jfn(jax.tree.map(jnp.asarray, jrestored),
                    {k: jnp.asarray(v) for k, v in batches[2].items()})
    _, m = step_fn(state, batches[2])
    assert float(jm["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    assert int(jnext["step"]) == 3

    cfg16 = cfg.scaled(dtype="bfloat16")
    state16 = init_train_state(cfg16, tcfg, seed=3, device="cpu")
    store16 = SpinnakerCheckpointStore(StoreConfig(chunk_bytes=1 << 16))
    store16.save(1, state16)
    store16.__class__ = jstore.SpinnakerCheckpointStore
    _, j16 = store16.restore_tree(
        jstep.init_train_state(jax.random.PRNGKey(9), cfg16, jt))
    for t, j in zip(tree_leaves(state16), jax.tree.leaves(j16)):
        assert str(np.asarray(j).dtype) == tstore._DTYPE_NAMES[t.dtype]
        assert _same_bits(t, j)
    j16next, jm16 = jax.jit(jstep.make_train_step(cfg16, jt))(
        jax.tree.map(jnp.asarray, j16),
        {k: jnp.asarray(v) for k, v in batches[0].items()})
    assert np.isfinite(float(jm16["loss"])) and int(j16next["step"]) == 1


# ---------------------------------------------------------------------------
# serving refreshes from the real store
# ---------------------------------------------------------------------------


def _engine_run(mod, store_mod, cfg, params, new_params, reqs):
    store = store_mod.SpinnakerCheckpointStore(store_mod.StoreConfig())
    store.save(3, new_params)
    store.sim.run_for(2.0)              # followers apply the commit
    eng = mod.ServingEngine(cfg, params, mod.ServeConfig(
        slots=2, max_seq=64, refresh_every_batches=2), store=store,
        **({"device": "cpu"} if mod is teng else {}))
    for rid, prompt, n in reqs:
        eng.submit(mod.Request(rid=rid, prompt=prompt, max_new_tokens=n))
    eng.run_until_drained()
    return {r: eng.finished[r].output for r in sorted(eng.finished)}, eng


def test_engine_refresh_from_the_real_store_matches_jax():
    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="float32")
    jp0 = _np(j_init_params(jax.random.PRNGKey(0), cfg))
    jp7 = _np(j_init_params(jax.random.PRNGKey(7), cfg))
    reqs = [(0, [5, 6, 7], 4), (1, [9, 10], 4), (2, [3, 4, 5, 6], 6)]
    ref, jeng_ = _engine_run(jeng, jstore, cfg, jp0, jp7, reqs)
    tp7 = params_from_numpy(jp7, device="cpu")
    out, eng = _engine_run(teng, tstore, cfg,
                           params_from_numpy(jp0, device="cpu"), tp7, reqs)
    assert out == ref
    assert eng.weights_step == jeng_.weights_step == 3
    assert trees_equal(eng.params, tp7)


def test_engine_refreshes_bf16_weights_from_the_real_store():
    """The store restores bf16 leaves as bf16 tensors, which numpy cannot
    hold: the engine takes them as they come."""
    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="bfloat16")
    new = init_params(cfg, seed=7, device="cpu")
    _, eng = _engine_run(teng, tstore, cfg,
                         init_params(cfg, seed=0, device="cpu"), new,
                         [(0, [5, 6, 7], 4)])
    assert eng.weights_step == 3
    assert trees_equal(eng.params, new)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------


def test_fault_tolerant_training_example_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable,
         str(ROOT / "examples" / "torch_fault_tolerant_training.py"),
         "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout
    for n in range(1, 6):
        assert f"[{n}]" in lines
    assert "5 resumed steps bit-match reference: True" in lines
    assert "fenced out by conditionalPut" in lines
    assert "old generation fenced: True" in lines
