"""The port's int8 weights against the JAX package (CPU): `quantize_weight`
and `quantize_tree` equal to the reference's, the reference's own quant
checks on the port, quantized decode held to JAX's quantized decode, the
layer-by-layer build, and a quantized MoE tree across the converter,
both checkpoint stores and both serving engines."""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import smoke_config
from repro.launch.shapes import make_batch
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import quant as jquant
from repro.serve import engine as jeng
from repro_torch import models as tm
from repro_torch.checkpoint import store as tstore
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import model as tmodel
from repro_torch.models import quant as tquant
from repro_torch.serve import engine as teng
from repro_torch.tree import tree_leaves, tree_leaves_with_path

MOE = "phi3.5-moe-42b-a6.6b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _quantized(arch, seed=0, dtype="float32"):
    """The JAX package's quantized smoke tree (numpy leaves), the same
    tree in the port, and the config."""
    cfg = smoke_config(arch).scaled(remat=False, dtype=dtype)
    jq = _np(jquant.quantize_tree(j_init_params(jax.random.PRNGKey(seed),
                                                cfg)))
    return cfg, jq, params_from_numpy(jq, device="cpu")


def _same_bits(t, arr) -> bool:
    return t.dtype != torch.bool and \
        t.reshape(-1).view(torch.uint8).numpy().tobytes() == \
        np.asarray(arr).tobytes()


def _assert_s_within_an_ulp(s, js):
    np.testing.assert_array_less(np.abs(s - js),
                                 np.spacing(np.abs(js)) * 1.0001)


# ---------------------------------------------------------------------------
# quantize_weight, quantize_tree, wcast
# ---------------------------------------------------------------------------


def test_quantize_roundtrip_error_bounded():
    """tests/test_quant_and_dist.py::test_quantize_roundtrip_error_bounded
    on the port."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((256, 128)) * 0.05)
                         .astype(np.float32))
    q = tquant.quantize_weight(w)
    assert q["q"].dtype == torch.int8 and q["s"].dtype == torch.float32
    assert q["s"].shape == (128,)
    back = tquant.wcast(q, torch.float32)
    assert float((back - w).abs().max()) <= float(w.abs().max()) / 127.0 \
        + 1e-7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_matches_jax(dtype):
    """A stacked (L, E, in, out) weight, a column of zeros (scale floored
    at 1e-8) and values on the .5 rounding boundary: q equal, s within
    one f32 ulp; wcast of the same codes equal to JAX's in f32 and
    bf16."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 3, 40, 24)).astype(np.float32) * 0.1
    w[..., 5] = 0.0
    w[0, 0, :, 7] = np.arange(40) - 19.5        # absmax 20.5, halves
    jw = jnp.asarray(w, jnp.dtype(dtype))
    jq = jquant.quantize_weight(jw)
    tq = tquant.quantize_weight(params_from_numpy({"w": np.asarray(jw)},
                                                  device="cpu")["w"])
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    _assert_s_within_an_ulp(tq["s"].numpy(), np.asarray(jq["s"]))
    assert float(tq["s"][0, 0, 5]) == pytest.approx(1e-8)
    jq_t = params_from_numpy(_np(jq), device="cpu")
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            tquant.wcast(jq_t, dt).float().numpy(),
            np.asarray(jquant.wcast(jq, jdt), np.float32))


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-2.7b", "zamba2-7b",
                                  "kimi-k2-1t-a32b", MOE])
def test_quantize_tree_quantizes_the_reference_leaf_set(arch):
    """The same leaves quantized (paths, shapes, dtypes) and the same
    codes; the router, norms, embeddings and SSM scalars stay dense."""
    cfg = smoke_config(arch).scaled(dtype="bfloat16")
    jp = _np(j_init_params(jax.random.PRNGKey(2), cfg))
    ref = jax.tree_util.tree_leaves_with_path(_np(jquant.quantize_tree(jp)))
    port = tree_leaves_with_path(tquant.quantize_tree(
        params_from_numpy(jp, device="cpu")))
    assert ["/".join(k.key for k in p) for p, _ in ref] == \
        [n for n, _ in port]
    for (path, a), (name, t) in zip(ref, port):
        assert str(a.dtype) == tstore._DTYPE_NAMES[t.dtype], name
        assert a.shape == tuple(t.shape), name
        if name.endswith("/q"):
            np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
    names = [n for n, _ in port]
    quantized = {n[:-2].rsplit("/", 1)[-1] for n in names if n.endswith("/q")}
    assert quantized and quantized <= set(tquant._QUANT_SUFFIXES)
    assert "embed" in names and "final_norm/scale" in names
    if cfg.family == "moe":
        assert "layers/moe/router" in names
    back = tquant.dequantize_tree(tquant.quantize_tree(
        params_from_numpy(jp, device="cpu")))
    assert [n for n, _ in tree_leaves_with_path(back)] == \
        [n for n, _ in tree_leaves_with_path(params_from_numpy(jp, "cpu"))]


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b", MOE])
def test_layer_by_layer_build_equals_quantizing_the_stack(arch):
    """Quantizing each layer alone gives the slices of quantizing the
    (L, ...) stack (the scale reduces axis -2 only), and
    `init_quantized_params`, which quantizes one layer at a time, is
    `quantize_tree(init_params(...))` bit for bit."""
    cfg = smoke_config(arch).scaled(dtype="bfloat16")
    dense = tm.init_params(cfg, seed=3, device="cpu")
    whole = tquant.quantize_tree(dense)
    for i in range(cfg.num_layers):
        per = tquant.quantize_tree(tmodel._layer_slice(dense["layers"], i))
        for a, b in zip(tree_leaves(per), tree_leaves(
                tmodel._layer_slice(whole["layers"], i))):
            assert torch.equal(a, b)
    built = tmodel.init_quantized_params(cfg, seed=3, device="cpu")
    assert [n for n, _ in tree_leaves_with_path(built)] == \
        [n for n, _ in tree_leaves_with_path(whole)]
    for a, b in zip(tree_leaves(built), tree_leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_quantized_forward_close_to_dense():
    """tests/test_quant_and_dist.py::test_quantized_forward_close_to_dense
    on the port's own parameters."""
    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="float32")
    params = tm.init_params(cfg, seed=0, device="cpu")
    qparams = tquant.quantize_tree(params)
    assert tquant.is_quantized(qparams["layers"]["attn"]["wq"])
    assert not tquant.is_quantized(qparams["embed"])
    batch = {k: torch.from_numpy(np.array(v)) for k, v in make_batch(
        cfg, np.random.default_rng(1), batch=2, seq=16).items()}
    ref, _, _ = tm.forward(params, batch, cfg)
    out, _, _ = tm.forward(qparams, batch, cfg)
    rel = float((out - ref).abs().max()) / (float(ref.std()) + 1e-9)
    assert rel < 0.25, f"quantized logits too far off ({rel})"


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-2.7b", MOE])
def test_quantized_decode_matches_jax(arch, impl):
    """tests/test_quant_and_dist.py::test_quantized_decode_runs, held to
    JAX's quantized decode at the whole-model tolerance 2e-4 over four
    steps, not only finite."""
    cfg, jq, tq = _quantized(arch)
    cfg = cfg.scaled(attn_impl=impl)
    rng = np.random.default_rng(2)
    jcache = j_init_cache(cfg, 2, 32)
    tcache = tm.init_cache(cfg, 2, 32, device="cpu")
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = j_decode_step(jax.tree.map(jnp.asarray, jq), jcache,
                                   jnp.asarray(tok), cfg)
        tl, tcache = tm.decode_step(tq, tcache, torch.from_numpy(tok), cfg)
        assert torch.isfinite(tl).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# a quantized MoE tree across the converter, the stores and the engines
# ---------------------------------------------------------------------------


def test_quantized_moe_tree_round_trips_bit_for_bit():
    """JAX -> numpy -> port -> numpy: int8 codes, f32 scales and bf16
    leaves, the same bits and dtypes."""
    _, jq, tq = _quantized(MOE, dtype="bfloat16")
    back = params_to_numpy(tq)
    a = jax.tree_util.tree_leaves_with_path(jq)
    b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in a] == [p for p, _ in b]
    dtypes = set()
    for (_, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))
        dtypes.add(x.dtype)
    assert {np.dtype(np.int8), np.dtype(np.float32),
            np.dtype(ml_dtypes.bfloat16)} <= dtypes


def _recorded_save(mod, tree):
    """Save `tree` at step 1 into a fresh store of package `mod`: the
    manifest JSON, every chunk put (key, code, version), the manifest
    version, sim.now and the journal."""
    store = mod.SpinnakerCheckpointStore(mod.StoreConfig(chunk_bytes=1 << 14))
    puts, put = [], store._put

    def recorded(key, value):
        res = put(key, value)
        puts.append((key, res.code.name, res.version))
        return res
    store._put = recorded
    manifest = store.save(1, tree)
    return (json.dumps(manifest), puts, store._manifest_version,
            store.sim.now, store.cluster.obs.journal.to_jsonl())


def test_quantized_moe_tree_same_chunks_and_manifest_in_both_stores():
    _, jq, tq = _quantized(MOE, dtype="bfloat16")
    ref, port = _recorded_save(jstore, jq), _recorded_save(tstore, tq)
    assert port == ref
    dtypes = {e["dtype"] for e in json.loads(port[0])["index"]}
    assert {"int8", "float32", "bfloat16"} <= dtypes


def test_quantized_moe_tree_restores_across_the_frameworks():
    """Saved by the reference, restored by the port, and the other way,
    every leaf with its dtype and bits."""
    _, jq, tq = _quantized(MOE, seed=1, dtype="bfloat16")
    _, jlike, tlike = _quantized(MOE, seed=2, dtype="bfloat16")
    store = jstore.SpinnakerCheckpointStore(jstore.StoreConfig())
    store.save(4, jq)
    store.__class__ = tstore.SpinnakerCheckpointStore
    step, restored = store.restore_tree(tlike)
    assert step == 4
    for (name, t), j in zip(tree_leaves_with_path(restored),
                            jax.tree.leaves(jq)):
        assert tstore._DTYPE_NAMES[t.dtype] == str(j.dtype)
        assert _same_bits(t, j), name
    store = tstore.SpinnakerCheckpointStore(tstore.StoreConfig())
    store.save(5, tq)
    store.__class__ = jstore.SpinnakerCheckpointStore
    step, jrestored = store.restore_tree(jlike)
    assert step == 5
    for t, j in zip(tree_leaves(tq), jax.tree.leaves(jrestored)):
        assert tstore._DTYPE_NAMES[t.dtype] == str(np.asarray(j).dtype)
        assert _same_bits(t, j)


def _engine(mod, cfg, params, reqs, store=None, **kw):
    eng = mod.ServingEngine(cfg, params, mod.ServeConfig(
        slots=2, max_seq=64, refresh_every_batches=2 if store else 0),
        store=store, **kw)
    for rid, prompt, n in reqs:
        eng.submit(mod.Request(rid=rid, prompt=prompt, max_new_tokens=n))
    eng.run_until_drained()
    return {r: eng.finished[r].output for r in sorted(eng.finished)}, eng


def test_quantized_moe_engine_matches_jax_and_refreshes_from_the_store():
    """Greedy, 2 slots, f32: the port's engine on the quantized smoke
    tree gives the JAX engine's tokens; then both refresh to a second
    quantized tree committed to their own real store (timeline read),
    give equal tokens again, and the port's engine holds the committed
    leaves bit for bit."""
    cfg, jq0, tq0 = _quantized(MOE, seed=0)
    _, jq7, tq7 = _quantized(MOE, seed=7)
    reqs = [(0, [5, 6, 7], 5), (1, [9, 10, 11, 12], 5), (2, [3, 4], 6)]
    ref, _ = _engine(jeng, cfg, jax.tree.map(jnp.asarray, jq0), reqs)
    out, _ = _engine(teng, cfg, tq0, reqs, device="cpu")
    assert out == ref
    stores = []
    for mod, tree in ((jstore, jq7), (tstore, tq7)):
        store = mod.SpinnakerCheckpointStore(mod.StoreConfig())
        store.save(3, tree)
        store.sim.run_for(2.0)          # followers apply the commit
        stores.append(store)
    ref, jeng_ = _engine(jeng, cfg, jax.tree.map(jnp.asarray, jq0), reqs,
                         store=stores[0])
    out, eng = _engine(teng, cfg, tq0, reqs, store=stores[1], device="cpu")
    assert out == ref
    assert eng.weights_step == jeng_.weights_step == 3
    for a, b in zip(tree_leaves(eng.params), tree_leaves(tq7)):
        assert a.dtype == b.dtype and torch.equal(a, b)
