"""The port's serving engine gives the JAX engine's tokens on the same
converted parameters (smoke config, f32, CPU), including the reference's
shared cache position."""

import jax
import numpy as np
import pytest

from repro.checkpoint.store import SpinnakerCheckpointStore
from repro.configs import smoke_config
from repro.models import init_params as j_init_params
from repro.serve import engine as jeng
from repro_torch.checkpoint import CheckpointError
from repro_torch.convert import params_from_numpy
from repro_torch.serve import engine as teng


def _params(seed, **kw):
    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="float32",
                                             **kw)
    jp = j_init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _serve(mod, cfg, params, scfg_kw, requests, **kw):
    eng = mod.ServingEngine(cfg, params, mod.ServeConfig(**scfg_kw), **kw)
    for rid, prompt, n in requests:
        eng.submit(mod.Request(rid=rid, prompt=prompt, max_new_tokens=n))
    eng.run_until_drained()
    return {r: eng.finished[r].output for r in sorted(eng.finished)}, eng


def _both(cfg, jp, tp, scfg_kw, requests):
    ref, jeng_ = _serve(jeng, cfg, jp, scfg_kw, requests)
    out, teng_ = _serve(teng, cfg, tp, scfg_kw, requests, device="cpu")
    assert out == ref
    assert int(teng_.cache["pos"]) == int(jeng_.cache["pos"])
    return out, teng_


def test_greedy_two_slots_matches_jax():
    """The scenario of tests/test_substrate.py::
    test_serving_greedy_matches_sequential_decode."""
    cfg, jp, tp = _params(0)
    reqs = [(0, [5, 6, 7], 5), (1, [9, 10, 11, 12], 5)]
    out, _ = _both(cfg, jp, tp, dict(slots=2, max_seq=64, eos_id=1), reqs)
    assert set(out) == {0, 1}
    for rid, prompt, n in reqs:       # the reference's own single-slot oracle
        solo, _ = _both(cfg, jp, tp, dict(slots=1, max_seq=64, eos_id=1),
                        [(0, prompt, n)])
        assert solo[0] == out[rid]


def test_continuous_batching_admits_from_queue_like_jax():
    """The scenario of tests/test_substrate.py::
    test_serving_continuous_batching_admits_from_queue."""
    cfg, jp, tp = _params(1)
    reqs = [(i, [3 + i, 4], 3) for i in range(5)]
    out, _ = _both(cfg, jp, tp, dict(slots=2, max_seq=32), reqs)
    assert len(out) == 5


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_shared_position_fault_is_reproduced(impl):
    """One cache position serves every slot, so a request's tokens depend
    on what ran before it, and the position runs past max_seq (writes clamp
    to T-1, attention sees length > T)."""
    cfg, jp, tp = _params(0, attn_impl=impl)
    late = [9, 10, 11, 12]
    reqs = [(0, [5, 6, 7], 20), (1, [1, 2], 20), (2, late, 6),
            (3, [7, 8, 9], 20), (4, [4, 4], 20)]
    out, eng = _both(cfg, jp, tp, dict(slots=2, max_seq=24, eos_id=1), reqs)
    assert int(eng.cache["pos"]) > 24
    fresh, _ = _both(cfg, jp, tp, dict(slots=2, max_seq=24, eos_id=1),
                     [(2, late, 6)])
    if impl == "xla":    # the numbers recorded for the reference's fault
        assert out[2] == [26, 241, 147, 247, 140, 140]
        assert fresh[2] == [229, 47, 53, 144, 229, 124]
    assert out[2] != fresh[2]


class _StubStore:
    """latest_step/restore as the checkpoint store offers them to serving;
    a timeline read that races a commit raises."""

    def __init__(self, flat, step, fail=False):
        self.flat, self.step, self.fail = flat, step, fail
        self.calls = []

    def latest_step(self, run_id, consistent=True):
        self.calls.append(("latest_step", run_id, consistent))
        return self.step

    def restore(self, step=None, run_id="run0", consistent=True):
        self.calls.append(("restore", run_id, consistent))
        if self.fail:
            raise CheckpointError("manifest mid-commit")
        return self.step, self.flat


def test_weight_refresh_swaps_params_like_jax():
    cfg, jp0, tp0 = _params(0)
    _, jp1, _ = _params(7)
    flat = dict(SpinnakerCheckpointStore._flatten(jp1))   # the store's names
    reqs = [(0, [5, 6, 7], 4), (1, [9, 10], 4)]
    scfg = dict(slots=2, max_seq=64, refresh_every_batches=2)
    stores = (_StubStore(flat, 3), _StubStore(flat, 3))
    ref, _ = _serve(jeng, cfg, jp0, scfg, reqs, store=stores[0])
    out, eng = _serve(teng, cfg, tp0, scfg, reqs, store=stores[1],
                      device="cpu")
    assert out == ref and eng.weights_step == 3
    assert ("restore", "run0", False) in stores[1].calls
    assert np.array_equal(eng.params["layers"]["attn"]["wq"].numpy(),
                          np.asarray(jp1["layers"]["attn"]["wq"]))
    assert eng.params["embed"].dtype == tp0["embed"].dtype
    assert not eng.maybe_refresh_weights()             # step not newer


def test_weight_refresh_skips_a_failed_timeline_read():
    cfg, _, tp = _params(0)
    eng = teng.ServingEngine(cfg, tp, teng.ServeConfig(), device="cpu",
                             store=_StubStore({}, 5, fail=True))
    assert not eng.maybe_refresh_weights()
    assert eng.weights_step == -1 and eng.params is tp
