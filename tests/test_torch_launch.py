"""`repro_torch.launch` against `repro.launch`, on the CPU in one process:
the input specs (meta tensors) leaf for leaf against the reference's
`ShapeDtypeStruct`s and `applicable` on all 40 cells; the shape-only
constructors (`device="meta"`) against `jax.eval_shape` of the reference's
for all ten full configs; the roofline's `model_flops` and `derive`; the
collective inventory's ring formulas against the reference's HLO
parser; and the dry-run (a fake process group of 256 ranks)
writing the reference's record, read by `benchmarks/run.py` and
`benchmarks/roofline_report.py` unchanged."""

import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.launch import hlo as jhlo
from repro.launch import roofline as jroof
from repro.launch import shapes as jshapes
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models.quant import quantize_tree as j_quantize_tree
from repro.train import step as jstep
from repro.train.optim import choose_optimizer as j_choose_optimizer
from repro_torch.configs import get_config
from repro_torch.launch import hlo as thlo
from repro_torch.launch import roofline as troof
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.dryrun import fake_world
from repro_torch.models import init_cache, init_params
from repro_torch.models.model import init_quantized_params
from repro_torch.train.optim import choose_optimizer
from repro_torch.train.step import TrainConfig, init_train_state
from repro_torch.tree import tree_leaves_with_path

CELLS = [(a, s) for a in list_archs() for s in jshapes.SHAPES]


def _jleaves(tree) -> list:
    """(name, shape, dtype) of a JAX tree, names '/'-joined."""
    return [("/".join(str(k.key) for k in path), tuple(leaf.shape),
             str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


def _tleaves(tree) -> list:
    return [(name, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in tree_leaves_with_path(tree)]


def uncounted(cfg) -> int:
    """The leaves `param_count()`'s analytic formula leaves out: the final
    norm's D, and per SSM block conv_b (d_inner + 2 G N) and the third
    (H,) vector, less the D of a norm it counts twice."""
    n = cfg.d_model
    if cfg.has_ssm:
        n += cfg.num_layers * (cfg.d_inner + 2 * cfg.ssm_groups
                               * cfg.ssm_state + cfg.ssm_heads
                               - cfg.d_model)
    return n


def _assert_meta(tree):
    for name, t in tree_leaves_with_path(tree):
        assert t.device.type == "meta", name


def test_shape_table_and_applicable_equal_the_reference():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in jshapes.SHAPES.items():
        assert vars(tshapes.SHAPES[name]) == vars(spec)
    for arch, shape in CELLS:
        assert tshapes.applicable(get_config(arch), shape) == \
            jshapes.applicable(j_get_config(arch), shape), (arch, shape)


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_the_reference_leaf_for_leaf(arch):
    """Every leaf of `input_specs` on the four shapes: the reference's
    names, shapes and dtypes, on the meta device (no storage)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape in jshapes.SHAPES:
        got = tshapes.input_specs(cfg, shape)
        _assert_meta(got)
        assert _tleaves(got) == _jleaves(jshapes.input_specs(jcfg, shape)), \
            (arch, shape)


@pytest.mark.parametrize("arch", list_archs())
def test_shape_only_constructors_equal_jax_eval_shape(arch):
    """`init_params`, `init_quantized_params`, `init_cache` and
    `init_train_state` on the meta device against `jax.eval_shape` of the
    reference's: every leaf's name, shape and dtype; nothing is drawn and
    nothing allocated; the count is `cfg.param_count()` plus the leaves
    its formula leaves out (`uncounted`)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    params = init_params(cfg, device="meta")
    _assert_meta(params)
    jparams = jax.eval_shape(
        lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    assert _tleaves(params) == _jleaves(jparams)
    assert sum(t.numel() for _, t in tree_leaves_with_path(params)) == \
        cfg.param_count() + uncounted(cfg)
    q = init_quantized_params(cfg, device="meta")
    _assert_meta(q)
    assert _tleaves(q) == _jleaves(jax.eval_shape(
        lambda: j_quantize_tree(j_init_params(jax.random.PRNGKey(0), jcfg))))
    cache = init_cache(cfg, 4, 1024, device="meta")
    _assert_meta(cache)
    assert _tleaves(cache) == _jleaves(jax.eval_shape(
        lambda: j_init_cache(jcfg, 4, 1024)))
    tcfg = TrainConfig(optimizer=choose_optimizer(cfg.param_count()))
    jt = jstep.TrainConfig(optimizer=j_choose_optimizer(jcfg.param_count()))
    state = init_train_state(cfg, tcfg, device="meta")
    _assert_meta(state)
    assert _tleaves(state) == _jleaves(jax.eval_shape(
        lambda: jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jt)))


def test_meta_build_leaves_the_drawing_path_unchanged():
    """The card's draws are not moved by the meta path: the same seed
    gives the same tensors before and after a meta build."""
    cfg = get_config("zamba2-7b").scaled(num_layers=2, d_model=64,
                                         d_ff=128, vocab_size=64,
                                         ssm_state=16, ssm_head_dim=16,
                                         num_heads=4, num_kv_heads=4,
                                         head_dim=16, attn_every=2)
    a = init_params(cfg, seed=3, device="cpu")
    init_params(cfg, seed=3, device="meta")
    b = init_params(cfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(tree_leaves_with_path(a),
                              tree_leaves_with_path(b)):
        assert torch.equal(x, y), n


# ---------------------------------------------------------------------------
# roofline and the collective inventory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference_on_every_cell(arch):
    for shape, spec in jshapes.SHAPES.items():
        assert troof.model_flops(get_config(arch), tshapes.SHAPES[shape]) \
            == jroof.model_flops(j_get_config(arch), spec), (arch, shape)


class _Mem:
    argument_size_in_bytes = 123_456_789
    temp_size_in_bytes = 987_654


def test_derive_equals_the_reference_with_the_h100_constants(monkeypatch):
    """`derive` on the same inputs gives the reference's record once the
    reference's TPU constants are swapped for the port's (in the test;
    `repro/launch/roofline.py` is not edited); each term moves."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    assert troof.NVLINK_BW == 450e9 and troof.LINK_BW == troof.IB_NDR_BW
    cases = [("smollm-360m", "train_4k", "pod", 256,
              {"flops": 3.2e14, "bytes accessed": 7.1e11}, 2.3e9),
             ("kimi-k2-1t-a32b", "decode_32k", "multipod", 512,
              {"flops": 1.1e12, "bytes accessed": 4.4e11}, 9.9e10),
             ("mamba2-2.7b", "long_500k", "pod", 256,
              {"flops": 5e9}, 0.0)]
    before = [jroof.derive(a, s, m, c, cost, _Mem(), lb, j_get_config(a))
              for a, s, m, c, cost, lb in cases]
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroof, name, getattr(troof, name))
    for (a, s, m, c, cost, lb), old in zip(cases, before):
        want = jroof.derive(a, s, m, c, cost, _Mem(), lb,
                            j_get_config(a)).to_dict()
        got = troof.derive(a, s, m, c, cost, _Mem(), lb,
                           get_config(a)).to_dict()
        assert got == want, a
        assert got["compute_s"] != old.compute_s


# (torch call, the op's HLO kind, its HLO result type) over the data
# (N=16) or model (N=16) dim of a 16x16 mesh, or both (N=256)
def _collectives(mesh):
    data, model = mesh.get_group("data"), mesh.get_group("model")
    x = torch.ones(4, 8)
    cases = []

    def ar():
        dist.all_reduce(x.clone(), group=data)
    cases.append((ar, "all-reduce", "f32[4,8]", 16))

    def ag():
        out = torch.empty(64, 8, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(out, x.bfloat16(), group=model)
    cases.append((ag, "all-gather", "bf16[64,8]", 16))

    def rs():
        out = torch.empty(4, 8)
        dist.reduce_scatter_tensor(out, torch.ones(64, 8), group=data)
    cases.append((rs, "reduce-scatter", "f32[4,8]", 16))

    def a2a():
        out = torch.empty(16, 8)
        dist.all_to_all_single(out, torch.ones(16, 8), group=data)
    cases.append((a2a, "all-to-all", "f32[16,8]", 16))

    def fa2a():
        fc.wait_tensor(fc.all_to_all_single_autograd(
            torch.ones(32, 8, dtype=torch.bfloat16), None, None, model))
    cases.append((fa2a, "all-to-all", "bf16[32,8]", 16))

    def far():
        fc.wait_tensor(fc.all_reduce(torch.ones(2, 3), "sum",
                                     dist.group.WORLD))
    cases.append((far, "all-reduce", "f32[2,3]", 256))

    def fag():
        fc.wait_tensor(fc.all_gather_tensor(torch.ones(2, 8), 0, data))
    cases.append((fag, "all-gather", "f32[32,8]", 16))

    def frs():
        fc.wait_tensor(fc.reduce_scatter_tensor(torch.ones(32, 8), "sum", 0,
                                                data))
    cases.append((frs, "reduce-scatter", "f32[2,8]", 16))

    def p2p():
        buf = torch.empty(4, 8)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 16, group=data),
                dist.P2POp(dist.irecv, buf, 16, group=data)]):
            w.wait()
    cases.append((p2p, "collective-permute", "f32[4,8]", 16))
    return cases


def _hlo_line(i, kind, type_str, n):
    op = kind + ("-start" if kind in ("all-gather", "collective-permute")
                 else "")
    return (f"  %c{i} = {type_str}{{1,0}} {op}(f32[1] %p{i}), "
            f"replica_groups=[{256 // n},{n}]<=[256], dimensions={{0}}")


def test_inventory_ring_bytes_equal_the_reference_hlo_parser():
    """The same collectives, issued by torch on a fake world of 256 under
    `CollectiveInventory` and written as HLO text for the reference's
    `parse_collectives`: equal counts, result bytes and link bytes per
    kind (the ring formulas with N the op's group size)."""
    with fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        cases = _collectives(mesh)
        with thlo.CollectiveInventory() as inv:
            for fn, *_ in cases:
                fn()
    text = "\n".join(_hlo_line(i, k, t, n)
                     for i, (_, k, t, n) in enumerate(cases))
    ref = jhlo.parse_collectives(text, 256)
    assert inv.stats.table() == ref.table()
    assert inv.stats.total_link_bytes == ref.total_link_bytes
    assert sorted(ref.counts) == sorted(thlo.COLLECTIVES)
    for t in ("f32[4,8]", "(bf16[2,3], s32[5])", "pred[7]"):
        assert thlo.shape_bytes(t) == jhlo.shape_bytes(t)
    assert thlo.DTYPE_BYTES == jhlo.DTYPE_BYTES


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent
# the keys of the reference's record (repro/launch/dryrun.py::run_cell)
RECORD_KEYS = ["cell", "status", "arch", "shape", "mesh", "chips",
               "param_count", "active_param_count", "seq_parallel",
               "shard_params_on_pod", "attn_impl", "moe_impl",
               "weight_quant", "serve_stationary", "lower_s", "compile_s",
               "analysis_depths", "cost_extrapolated", "memory",
               "collectives_per_period", "collectives_full_hlo_bodyonce",
               "roofline"]
SKIP_SCRIPT = """
import json, sys
from pathlib import Path
sys.path.insert(0, "src")
from repro.launch.dryrun import run_cell
print(json.dumps(run_cell("gemma-7b", "long_500k", "pod", Path(sys.argv[1]))))
"""


def analytic_flops_per_device(cfg, shape: str, tp: int, dp: int) -> float:
    """One device's matmul FLOPs of a decode step from the config: 2 x its
    rows x the weights it multiplies (attention's over TP when TP divides
    its q heads, with one KV head a rank where TP does not divide the KV
    heads, whole otherwise; the MLP's over TP when TP divides its d_ff;
    Mamba2's over TP when TP divides its heads, B and C of its one group
    on every rank; the untied unembedding over TP, the tied one whole),
    plus the attention's scores and values over the whole cache (4 B H T
    hd a layer, over TP when split), plus an SSM block's state read-out
    (2 H P N, over TP when split)."""
    spec = tshapes.SHAPES[shape]
    rows = spec.global_batch // dp if spec.global_batch % dp == 0 \
        else spec.global_batch
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    per_layer, H = 0.0, cfg.num_heads
    attn_tp = tp if cfg.family in ("dense", "moe") and H % tp == 0 else 1
    if cfg.family in ("dense", "moe"):
        Hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        per_layer += 2 * D * H * hd / attn_tp \
            + 2 * D * hd * max(Hkv // attn_tp, 1)
        per_layer += 3 * D * cfg.d_ff / (tp if cfg.d_ff % tp == 0 else 1)
    ssm_tp = tp if cfg.has_ssm and cfg.ssm_heads % tp == 0 else 1
    if cfg.has_ssm:
        assert cfg.ssm_groups == 1
        N, Din = cfg.ssm_state, cfg.d_inner
        per_layer += D * ((2 * Din + cfg.ssm_heads) / ssm_tp + 2 * N)
        per_layer += Din / ssm_tp * D
    vocab_tp = tp if not cfg.tie_embeddings and V % tp == 0 else 1
    flops = 2 * rows * (L * per_layer + V * D / vocab_tp)
    if cfg.family in ("dense", "moe"):
        flops += L * 4 * rows * H / attn_tp * spec.seq_len \
            * cfg.resolved_head_dim
    if cfg.has_ssm:
        flops += L * 2 * rows * cfg.ssm_heads / ssm_tp * cfg.ssm_head_dim \
            * cfg.ssm_state
    return flops


@pytest.fixture(scope="module")
def dryrun_dir(tmp_path_factory):
    from repro_torch.launch import dryrun
    out = tmp_path_factory.mktemp("dryrun_torch")
    recs = {cell: dryrun.run_cell(*cell, "pod", out)
            for cell in [("smollm-360m", "decode_32k"),
                         ("mamba2-2.7b", "long_500k"),
                         ("gemma-7b", "long_500k")]}
    return out, recs


@pytest.mark.parametrize("cell", [("smollm-360m", "decode_32k"),
                                  ("mamba2-2.7b", "long_500k")])
def test_dryrun_writes_the_reference_record(dryrun_dir, cell):
    """The record's keys are the reference's, key for key, and the
    roofline's its `Roofline` fields; one rank of 256 holds its blocks
    of the parameters and cache; the FLOPs counted on that rank lie within
    10 % of the analytic count; the terms are positive."""
    out, recs = dryrun_dir
    rec = recs[cell]
    assert list(rec) == RECORD_KEYS
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert list(rec["roofline"]) == [f.name for f in
                                     dataclasses.fields(jroof.Roofline)]
    assert list(rec["memory"]) == ["argument_bytes", "output_bytes",
                                   "temp_bytes", "alias_bytes"]
    assert rec["memory"]["argument_bytes"] > 0
    r = rec["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    cfg = get_config(cell[0])
    assert r["model_flops"] == troof.model_flops(cfg,
                                                 tshapes.SHAPES[cell[1]])
    want = analytic_flops_per_device(cfg, cell[1], tp=16, dp=16)
    got = rec["cost_extrapolated"]["flops"]
    assert abs(got - want) <= 0.1 * want, (got, want)
    assert json.loads((out / f"{rec['cell']}.json").read_text()) == rec


def test_dryrun_replicates_the_batch_of_one(dryrun_dir):
    """long_500k's global batch of 1 on a 16-way data axis: every rank
    holds the whole (replicated) batch, and its SSM cache is the batch
    of 1's at its 5 of the 80 heads (the state) and their conv channels
    with B and C; the step's work is the whole batch's on those heads."""
    _out, recs = dryrun_dir
    rec = recs[("mamba2-2.7b", "long_500k")]
    cfg = get_config("mamba2-2.7b")
    cache = init_cache(cfg, 1, tshapes.SHAPES["long_500k"].seq_len,
                       device="meta")["ssm"]
    din, two_n = cfg.d_inner, 2 * cfg.ssm_state
    conv = cache["conv"].numel() // (din + two_n) * (din // 16 + two_n)
    assert rec["memory"]["alias_bytes"] == 2 * (
        cache["state"].numel() // 16 + conv) + 4          # bf16; pos int32
    want = analytic_flops_per_device(cfg, "long_500k", tp=16, dp=16)
    assert abs(rec["cost_extrapolated"]["flops"] - want) <= 0.1 * want


def test_skip_record_equals_the_reference(dryrun_dir):
    """gemma-7b x long_500k: the reference's skip record, key for key and
    value for value (the reference's dry-run in a subprocess: it sets
    XLA_FLAGS on import)."""
    _out, recs = dryrun_dir
    with tempfile.TemporaryDirectory() as td:
        r = subprocess.run([sys.executable, "-c", SKIP_SCRIPT, td],
                           capture_output=True, text=True, timeout=300,
                           cwd=REPO)
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    assert recs[("gemma-7b", "long_500k")] == ref


def test_benchmark_readers_read_the_dryrun_dir(dryrun_dir):
    """`benchmarks/run.py::roofline_summary` and
    `benchmarks/roofline_report.py::load` read the directory unchanged."""
    out, _recs = dryrun_dir
    sys.path.insert(0, str(REPO))
    from benchmarks.roofline_report import load
    from benchmarks.run import roofline_summary
    rows, summary = roofline_summary(str(out))
    assert summary == {"cells_ok": 2, "cells_skipped": 1}
    assert sorted(row.split(",")[1] for row in rows) == ["mamba2-2.7b",
                                                         "smollm-360m"]
    cells = load(out, "pod")
    assert sorted(cells) == [("gemma-7b", "long_500k"),
                             ("mamba2-2.7b", "long_500k"),
                             ("smollm-360m", "decode_32k")]
