"""The port's sharding policy against the reference's, shape only, in one
process: for all ten archs' full configs, every parameter's spec
(`param_spec`, `_drop_indivisible`), every cache leaf's (`cache_sharding`
on `init_cache`) and every batch leaf's (`batch_sharding`) equal
`tuple(PartitionSpec)` of the reference on an `AbstractMesh` of the same
sizes, and the DTensor placements follow.  The port's meshes are
`DeviceMesh`es of a fake process group (world 8 to 512); the pipeline's
napkin math equals the reference's.  The datastore test keeps
`dist/context.py` byte for byte."""

import contextlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.dist import pipeline as jpipe
from repro.dist import sharding as jsh
from repro.launch.shapes import make_batch as j_make_batch
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro_torch.configs import get_config
from repro_torch.dist import pipeline as tpipe
from repro_torch.dist import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.shapes import make_batch
from repro_torch.models import init_cache

# (shape, dim names, shard_params_on_pod)
MESHES = {
    "data8": ((8,), ("data",), False),
    "data4_model2": ((4, 2), ("data", "model"), False),
    "data2_model4": ((2, 4), ("data", "model"), False),
    "pod16x16": ((16, 16), ("data", "model"), False),
    "pods2": ((2, 16, 16), ("pod", "data", "model"), False),
    "pods2_fsdp_pod": ((2, 16, 16), ("pod", "data", "model"), True),
}
CACHE_BATCH, CACHE_SEQ = 16, 32768     # >= every attn_window
BATCH, SEQ = 16, 8                    # SEQ beyond a VLM's patches


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _name(path) -> str:
    return "/".join(str(k.key) for k in path)


def _meta(shapes):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)


def _contexts(mesh_name, arch):
    shape, names, on_pod = MESHES[mesh_name]
    amesh = AbstractMesh(shape, names)
    jpol = jsh.ShardingPolicy.for_mesh(amesh, shard_params_on_pod=on_pod)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    pol = tsh.ShardingPolicy.for_mesh(mesh, shard_params_on_pod=on_pod)
    assert pol == tsh.ShardingPolicy(**vars(jpol))
    return (jsh.MeshContext(amesh, j_get_config(arch), jpol),
            tsh.MeshContext(mesh, get_config(arch), pol))


def _at(tree, name: str):
    for key in name.split("/"):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_equal_the_reference_on_every_full_config(mesh_name):
    """Every leaf of the parameters, the cache and a batch of all ten
    archs: the port's spec is the reference's `tuple(PartitionSpec)`, and
    its placements are that spec's."""
    shape = MESHES[mesh_name][0]
    with fake_world(int(np.prod(shape))):
        for arch in list_archs():
            jctx, ctx = _contexts(mesh_name, arch)
            jcfg, cfg = j_get_config(arch), get_config(arch)
            params = jax.eval_shape(
                lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
            placed = ctx.param_shardings(_meta(params))
            for (path, leaf), ns in zip(
                    jax.tree_util.tree_leaves_with_path(params),
                    jax.tree.leaves(jctx.param_shardings(params))):
                name = _name(path)
                spec = tsh._drop_indivisible(
                    tsh.param_spec(name, leaf, ctx.pol, cfg), leaf, ctx.mesh)
                assert spec == tuple(ns.spec), (arch, name)
                assert _at(placed, name) == tsh.to_placements(
                    spec, ctx.mesh), (arch, name)

            jcache = jax.eval_shape(
                lambda: j_init_cache(jcfg, CACHE_BATCH, CACHE_SEQ))
            cache = init_cache(cfg, CACHE_BATCH, CACHE_SEQ, device="meta")
            placed = ctx.cache_sharding(cache)
            for (path, leaf), ns in zip(
                    jax.tree_util.tree_leaves_with_path(jcache),
                    jax.tree.leaves(jctx.cache_sharding(jcache))):
                name = _name(path)
                assert tuple(_at(cache, name).shape) == leaf.shape, name
                spec = tsh._drop_indivisible(ctx._cache_spec(leaf), leaf,
                                             ctx.mesh)
                assert spec == tuple(ns.spec), (arch, name)
                assert _at(placed, name) == tsh.to_placements(
                    spec, ctx.mesh), (arch, name)

            seq = SEQ + (cfg.num_patches if cfg.modality == "vlm" else 0)
            jbatch = j_make_batch(jcfg, np.random.default_rng(0), BATCH, seq)
            batch = make_batch(cfg, np.random.default_rng(0), BATCH, seq,
                               device="cpu")
            placed = ctx.batch_sharding(batch)
            jb = jctx.batch_sharding(jbatch)
            assert sorted(batch) == sorted(jbatch)
            for k, leaf in jbatch.items():
                spec = tsh._drop_indivisible(ctx._batch_spec(leaf), leaf,
                                             ctx.mesh)
                assert spec == tuple(jb[k].spec), (arch, k)
                assert placed[k] == tsh.to_placements(spec, ctx.mesh)


@pytest.mark.parametrize("world", [8, 256])
def test_to_placements_on_a_fake_device_mesh(world):
    """One placement per mesh dim; a tensor dim over two mesh dims, split
    major to minor, gives the reference's local block; a mesh dim named
    twice, out of order or unknown raises."""
    shape = (4, 2) if world == 8 else (16, 16)
    with fake_world(world, rank=world - 3):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        assert tsh.to_placements((None, "model"), mesh) == (Replicate(),
                                                            Shard(1))
        assert tsh.to_placements(("data", "model"), mesh) == (Shard(0),
                                                              Shard(1))
        both = tsh.to_placements((("data", "model"), None), mesh)
        assert both == (Shard(0), Shard(0))
        rows = 2 * world
        t = distribute_tensor(torch.zeros(rows, 6), mesh, list(both))
        assert tuple(t.to_local().shape) == (rows // world, 6)
        t = distribute_tensor(torch.zeros(shape[0] * 3, shape[1] * 5), mesh,
                              list(tsh.to_placements(("data", "model"),
                                                     mesh)))
        assert tuple(t.to_local().shape) == (3, 5)
        for bad in [("data", "data"), (("model", "data"), None),
                    ("pod", None)]:
            with pytest.raises(ValueError):
                tsh.to_placements(bad, mesh)
        ctx = tsh.MeshContext(mesh, get_config("smollm-360m"),
                              tsh.ShardingPolicy.for_mesh(mesh))
        assert ctx.replicated() == (Replicate(), Replicate())
        assert ctx.size(("data", "model")) == world
        assert ctx.index("data") == (world - 3) // shape[1]
        assert ctx.index(("data", "model")) == world - 3


def test_mesh_builders_keep_the_reference_shapes():
    """`make_production_mesh`'s 16x16 and 2x16x16 and the largest grid of
    `make_mesh_for_devices`, as the reference's."""
    with fake_world(256):
        m = tmesh.make_production_mesh(device_type="cpu")
        assert (m.shape, m.mesh_dim_names) == ((16, 16), ("data", "model"))
    with fake_world(512):
        m = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert (m.shape, m.mesh_dim_names) == ((2, 16, 16),
                                              ("pod", "data", "model"))
    for n, mp, want in [(8, 2, (4, 2)), (6, 4, (2, 3)), (4, 1, (4, 1)),
                        (3, 8, (1, 3))]:
        with fake_world(n):
            m = tmesh.make_mesh_for_devices(n, mp, device_type="cpu")
            assert m.shape == want and m.mesh_dim_names == ("data", "model")


def test_pipeline_napkin_math_equals_the_reference():
    for m, s in [(1, 4), (15, 2), (100, 2), (6, 4), (8, 1)]:
        assert tpipe.bubble_fraction(m, s) == jpipe.bubble_fraction(m, s)
    for kw in [dict(grad_bytes=246e9, dcn_bw=25e9 * 256, step_compute_s=1.0,
                    n_micro=16, n_stages=2),
               dict(grad_bytes=1e9, dcn_bw=1e9, step_compute_s=5.0,
                    n_micro=2, n_stages=8)]:
        assert tpipe.pp_vs_dp_napkin(**kw) == jpipe.pp_vs_dp_napkin(**kw)


def test_path_str_joins_names_and_keys():
    keys = jax.tree_util.tree_leaves_with_path({"layers": {"attn": {
        "wq": 0}}})[0][0]
    assert tsh.path_str(keys) == jsh.path_str(keys) == "layers/attn/wq"
    assert tsh.path_str("layers/attn/wq") == "layers/attn/wq"


# at the pod's TP of 16: (unembed, attention, ssm), "-" where the arch has
# no such module
TP16_PLAN = {
    "smollm-360m": ("whole", "whole", "-"),          # tied; 15 q heads
    "gemma-7b": ("whole", "split", "-"),             # tied
    "mistral-large-123b": ("split", "split", "-"),   # 96/8: shared KV
    "deepseek-coder-33b": ("split", "whole", "-"),   # 56 q heads
    "phi3.5-moe-42b-a6.6b": ("split", "split", "-"),
    "kimi-k2-1t-a32b": ("split", "split", "-"),
    "mamba2-2.7b": ("whole", "-", "split"),          # tied; 80 heads
    "zamba2-7b": ("split", "split", "split"),         # 112 SSM heads
    "musicgen-large": ("split", "split", "-"),
    "phi-3-vision-4.2b": ("split", "split", "-"),
}


@pytest.mark.parametrize("arch", list(TP16_PLAN))
def test_tp_plan_of_the_full_configs_at_tp16(arch):
    """What computes split over a TP of 16 (`tp_plan`): the untied
    unembedding, attention whose q heads 16 divides (a KV head shared by
    16 / Hkv ranks where 16 does not divide Hkv), Mamba2's heads; and
    each rank's columns (`tp_columns`) tile the whole leaf, a shared KV
    head's or B/C group's columns repeated on every rank that reads
    them."""
    cfg = get_config(arch)
    plan = tsh.tp_plan(cfg, 16)
    assert tuple(plan.get(k, "-") for k in ("unembed", "attention",
                                            "ssm")) == TP16_PLAN[arch]

    def cols(kind, key, size):
        runs = [tsh.tp_columns(kind, key, size, cfg, 16, r)
                for r in range(16)]
        for rr in runs:
            assert all(a < b for a, b in rr) and rr == sorted(rr)
        return np.bincount(np.concatenate(
            [np.arange(a, b) for rr in runs for a, b in rr]), minlength=size)
    if plan["unembed"] == "split":
        assert (cols("unembed", "unembed", cfg.vocab_size) == 1).all()
    if plan.get("attention") == "split":
        H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        assert (cols("attention", "wq", H * hd) == 1).all()
        assert (cols("attention", "wk", Hkv * hd)
                == max(1, 16 // Hkv)).all()
    if plan.get("ssm") == "split":
        Din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        seen = cols("ssm", "in_proj", 2 * Din + 2 * N + H)
        assert (seen[:2 * Din] == 1).all() and (seen[2 * Din + 2 * N:] == 1
                                                ).all()
        assert (seen[2 * Din:2 * Din + 2 * N] == 16).all()      # B, C
        assert (cols("ssm", "out_proj", Din) == 1).all()


def test_tp_plan_raises_where_a_rank_would_read_part_of_a_kv_head():
    """20 q heads on 4 KV heads over 10 ranks: a rank's 2 q heads would
    read two KV heads, a part of each's 5; no split takes that, and none
    is quietly computed whole."""
    cfg = get_config("mistral-large-123b").scaled(num_heads=20,
                                                  num_kv_heads=4)
    with pytest.raises(ValueError, match="no split"):
        tsh.tp_plan(cfg, 10)
    with pytest.raises(ValueError, match="no split"):
        tsh.tp_plan(cfg, 5)                    # 4 q heads on groups of 5
    assert tsh.tp_plan(cfg, 4)["attention"] == "split"   # a KV head a rank
