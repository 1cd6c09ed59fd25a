"""The data-parallel train step across gloo ranks on the CPU, held to the
JAX package's jitted `make_train_step` on the whole batch (what GSPMD
gives it under a mesh), and the reference's elastic scenario
(tests/test_elastic_and_microbatch.py): 3 steps on a (4, 2) mesh of 8
ranks, a commit to the checkpoint store, a restore on a (2, 2) mesh of 4
ranks and 3 more steps, against the uninterrupted run.  Two spawns (8
ranks, then 4) run every case (tests/torch_dist_workers.py::dp_steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.train import step as jstep
from repro.train.optim import OptimizerConfig as JOptimizerConfig
from repro_torch.checkpoint import SpinnakerCheckpointStore, StoreConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import train_state_to_numpy
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.optim import OptimizerConfig
from repro_torch.train.step import TrainConfig, init_train_state
from torch_dist_workers import dp_steps, run_ranks

# the elastic test's model and stream
CFG_KW = dict(remat=False, dtype="float32")
DATA_KW = dict(seq_len=32, global_batch=8, seed=9, mixture_docs=False)
# (arch, train options, mesh, steps): each against JAX's whole-batch step
DP_CASES = {
    "smollm": ("smollm-360m", {}, (4, 1), 3),
    "phi_gspmd": ("phi3.5-moe-42b-a6.6b", {}, (2, 2), 3),
    "smollm_mb2_int8": ("smollm-360m",
                        dict(microbatches=2, grad_compression=True),
                        (2, 2), 2),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_run(arch, tkw, n):
    """JAX's state at seed 0 (numpy) and n jitted steps on the whole
    batch: per-step loss, grad_norm and state (numpy)."""
    jcfg = j_smoke_config(arch).scaled(**CFG_KW)
    jt = jstep.TrainConfig(optimizer=JOptimizerConfig(lr=1e-3), **tkw)
    state = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    start = _np(state)
    stream = JTokenStream(JDataConfig(vocab_size=jcfg.vocab_size,
                                      **DATA_KW), 0)
    fn = jax.jit(jstep.make_train_step(jcfg, jt))
    losses, norms, states = [], [], []
    for s in range(n):
        state, m = fn(state, {k: jnp.asarray(v)
                              for k, v in stream.batch_at(s).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        states.append(_np(state))
    return start, losses, norms, states


def _assert_states_close(port, ref):
    """The same tree, every leaf within 2e-5 but for at most one element
    in 1000.  The DP sum adds the grads in another order; where an
    element's second moment is near zero Adam's rsqrt turns that f32
    noise into a step of up to lr (tests/test_elastic_and_microbatch.py
    notes it for microbatches), and an int8 code can round the other
    way.  A reduction that is missing or wrong moves every element."""
    a = jax.tree_util.tree_leaves_with_path(train_state_to_numpy(port))
    b = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        off = ~np.isclose(x, y, rtol=2e-5, atol=2e-5)
        assert off.sum() <= off.size / 1000, (jax.tree_util.keystr(path),
                                              int(off.sum()), off.size)


def _case(arch, tkw, mesh, state, start, n):
    cfg = smoke_config(arch).scaled(**CFG_KW)
    return (mesh, cfg, tkw, DataConfig(vocab_size=cfg.vocab_size, **DATA_KW),
            state, start, n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    ref = {name: _jax_run(arch, tkw, 6 if name == "smollm" else n)
           for name, (arch, tkw, _mesh, n) in DP_CASES.items()}
    start = ref["smollm"][0]
    # phase 1 on 8 ranks as (4, 2), and the uninterrupted 6 steps there
    a = run_ranks(dp_steps, 8, tmp, {
        "elastic_a": _case("smollm-360m", {}, (4, 2), start, 0, 3),
        "uninterrupted": _case("smollm-360m", {}, (4, 2), start, 0, 6),
    }, timeout=240)
    store = SpinnakerCheckpointStore(StoreConfig(chunk_bytes=1 << 16))
    store.save(3, a[0]["elastic_a"]["state"])
    # "node loss": a fresh state from another seed, restored from the store
    cfg = smoke_config("smollm-360m").scaled(**CFG_KW)
    fresh = init_train_state(cfg, TrainConfig(
        optimizer=OptimizerConfig(lr=1e-3)), seed=1, device="cpu")
    step0, restored = store.restore_tree(fresh)
    cases = {"elastic_b": _case("smollm-360m", {}, (2, 2),
                                train_state_to_numpy(restored), step0, 3)}
    for name, (arch, tkw, mesh, n) in DP_CASES.items():
        cases[name] = _case(arch, tkw, mesh, ref[name][0], 0, n)
    b = run_ranks(dp_steps, 4, tmp, cases, timeout=240)
    return {"ref": ref, "a": a, "b": b, "step0": step0}


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_step_matches_jax_whole_batch(runs, name):
    """Every rank's loss and grad_norm per step, and rank 0's final
    state, equal JAX's whole-batch steps (the port's train tolerances,
    tests/test_torch_train.py); phi3.5-moe's gspmd routing shows the
    whole batch's capacity and aux."""
    _start, losses, norms, states = runs["ref"][name]
    n = DP_CASES[name][3]
    for r in runs["b"]:
        got = r[name]
        np.testing.assert_allclose(got["loss"], losses[:n], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norms[:n], rtol=1e-4)
    _assert_states_close(runs["b"][0][name]["state"], states[n - 1])


def test_elastic_restart_on_smaller_mesh(runs):
    """Checkpoint on a (4, 2) mesh, restore and resume on a (2, 2) mesh of
    4 ranks: the losses are the uninterrupted run's (restore is by
    logical key), at the reference's tolerances; the uninterrupted run
    is JAX's six whole-batch steps."""
    l1 = runs["a"][0]["elastic_a"]["loss"]
    lr = runs["a"][0]["uninterrupted"]["loss"]
    l2 = runs["b"][0]["elastic_b"]["loss"]
    assert runs["step0"] == 3
    for r in runs["a"]:
        assert r["elastic_a"]["loss"] == l1
        assert r["uninterrupted"]["loss"] == lr
    for r in runs["b"]:
        assert r["elastic_b"]["loss"] == l2
    assert np.allclose(l1, lr[:3], rtol=1e-5), (l1, lr)
    assert np.allclose(l2, lr[3:], rtol=1e-4, atol=1e-5), (l2, lr)
    np.testing.assert_allclose(lr, runs["ref"]["smollm"][1], rtol=1e-5)
    _assert_states_close(runs["a"][0]["uninterrupted"]["state"],
                         runs["ref"]["smollm"][3][5])
