"""The multi-pod dry-run; a port of `repro/launch/dryrun.py`.

A host-only tool by design, as the reference's is: it allocates nothing
on any device.  Each (architecture x shape x mesh) cell runs one rank
(rank 0) of a "fake" process group of 256 ranks (512 for `multipod`) on
`make_production_mesh(device_type="cpu")`, under `FakeTensorMode`:
every tensor has a shape and a dtype and no storage, and every
collective returns at once.  The step is the port's own, with each
rank's block of the parameters (`MeshContext.shard_params`) built from
the shape-only constructors (`init_params(device="meta")`):

  1. the FULL config's step: the runnability proof, its collective
     inventory, and its memory -- `argument_bytes` counted exactly (this
     rank's blocks of the parameters, optimizer state, batch rows and
     cache), and as `temp_bytes` the peak of the tensors the step makes,
     outputs included: `torch.distributed._tools.mem_tracker.MemTracker`'s
     peak, the inputs tracked as external, less the inputs (a device holds
     `argument_bytes + temp_bytes` at most);
  2. two reduced-DEPTH configs (L1 = one layer period, L2 = two periods):
     flops from `FlopCounterMode`, bytes from a count of every operator's
     input and output bytes (the eager operators', before any fusion),
     and link bytes from `hlo.CollectiveInventory`; per-layer values are
     the (L2 - L1) delta, extrapolated to L exactly (the layers are
     identical by construction);
  3. the roofline terms on H100 constants (`roofline.derive`), one JSON
     per cell, in the reference's schema (resumable).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape decode_32k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

`benchmarks/run.py --only roofline` (`roofline_summary`) and
`benchmarks/roofline_report.py --dir results/dryrun_torch` read the
output directory as they read the reference's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

DEFAULT_OUT = "results/dryrun_torch"


def _analysis_depths(cfg) -> tuple[int, int, int]:
    """(L1, L2, period): delta of one full period captures the repeating
    unit (hybrid: attn_every mamba blocks + one shared-attention slot)."""
    period = cfg.attn_every if cfg.family == "hybrid" and cfg.attn_every \
        else 1
    return period, 2 * period, period


@contextlib.contextmanager
def fake_world(world: int):
    """Rank 0 of a "fake" process group of `world` ranks: collectives
    return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(x) -> int:
    """Bytes of the tensors in `x`: a tensor, or dicts, lists and tuples
    of them."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class BytesCounter(TorchDispatchMode):
    """Bytes every operator reads and writes: its tensor inputs' and
    outputs' sizes (views, allocations and collectives excluded; an
    in-place operator counts its other inputs twice, read and written,
    not the whole tensor it updates).  The counterpart of XLA's "bytes
    accessed", counted on eager operators, so an upper bound of what
    fused kernels move."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if func.is_view or "c10d" in name or name.startswith(
                ("aten.empty", "aten.new_empty", "aten.detach",
                 "aten.lift_fresh")):
            return out
        schema = func._schema
        if schema.is_mutable:
            written = {a.name for a in schema.arguments
                       if a.alias_info is not None and a.alias_info.is_write}
            rest = [v for a, v in zip(schema.arguments, args)
                    if a.name not in written]
            rest += [v for k, v in (kwargs or {}).items()
                     if k not in written]
            self.total += 2 * _nbytes(rest)
        else:
            self.total += _nbytes(list(args)) + _nbytes(
                list((kwargs or {}).values())) + _nbytes(out)
        return out


class _Memory:
    """The reference's `memory_analysis()` fields, from one rank's run."""

    def __init__(self, argument, output, temp, alias):
        self.argument_size_in_bytes = argument
        self.output_size_in_bytes = output
        self.temp_size_in_bytes = temp
        self.alias_size_in_bytes = alias


def _fake(tree):
    """Meta tensors as empty tensors of the active FakeTensorMode."""
    from ..tree import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def _step(cfg, spec, ctx, weight_quant: bool):
    """(run, inputs, argument_bytes, alias_bytes): one step of the kind of
    `spec` (a `ShapeSpec`) on this rank's blocks (made inside the active
    FakeTensorMode) as a closure, and the tensors it is given.  A train
    step is given the global batch and takes its rows; its arguments
    count the rows."""
    from ..models import init_params
    from ..models.model import init_quantized_params
    from ..train.optim import choose_optimizer, init_opt_state
    from ..train.step import (TrainConfig, make_prefill_step,
                              make_serve_step, make_train_step)
    from ..tree import tree_map
    from .shapes import decode_input_specs, train_input_specs

    build = init_quantized_params if weight_quant and spec.kind == "decode" \
        else init_params
    full = build(cfg, device="meta")
    params = _fake(ctx.shard_params(full))
    specs = decode_input_specs(cfg, spec) if spec.kind == "decode" \
        else train_input_specs(cfg, spec)
    if spec.kind == "train":
        tcfg = TrainConfig(optimizer=choose_optimizer(cfg.param_count()))
        opt = init_opt_state(full, tcfg.optimizer)
        opt = _fake(tree_map(ctx.block, opt, _opt_shardings(ctx, opt)))
        state = {"params": params, "opt": opt,
                 "step": torch.zeros((), dtype=torch.int32)}
        batch = _fake(specs)
        step = make_train_step(cfg, tcfg)
        rows = _nbytes(ctx.local_batch(batch))
        return (lambda: step(state, batch)), [state, batch], \
            _nbytes(state) + rows, _nbytes(state)
    if spec.kind == "prefill":
        batch = _fake(ctx.local_batch(specs))
        step = make_prefill_step(cfg)

        def run():
            with ctx.rows(specs):
                return step(params, batch)
        return run, [params, batch], _nbytes(params) + _nbytes(batch), 0
    tok = _fake(ctx.local_batch(specs["tokens"]))
    cache = _fake(ctx.shard_cache(specs["cache"]))
    step = make_serve_step(cfg)

    def run():
        with ctx.rows(specs["tokens"]):
            return step(params, cache, tok)
    return run, [params, cache, tok], \
        _nbytes(params) + _nbytes(cache) + _nbytes(tok), _nbytes(cache)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    return [t for v in x for t in _tensors(v)] \
        if isinstance(x, (list, tuple)) else []


def _run(cfg, spec, mesh, pol, weight_quant: bool = False,
         memory: bool = False):
    """One step of `cfg` at `spec` (a `ShapeSpec`) on rank 0 under
    FakeTensorMode: (flops, bytes, collective stats, _Memory or None,
    seconds).  With `memory`, the memory alone (no FLOP or byte count)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..dist.sharding import MeshContext
    from .hlo import CollectiveInventory

    t0 = time.time()
    with FakeTensorMode(), MeshContext(mesh, cfg, pol) as ctx:
        run, inputs, args_b, alias_b = _step(cfg, spec, ctx, weight_quant)
        flop_mode = FlopCounterMode(display=False)
        byte_mode = BytesCounter()
        if memory:
            from torch.distributed._tools.mem_tracker import MemTracker
            mt = MemTracker()
            # the inputs' storages are known to the tracker, so that a
            # view of one (a layer of a stack) is not counted as new
            inputs = _tensors(inputs)
            mt.track_external(*inputs)
            with mt, CollectiveInventory() as inv:
                out = run()
            peak = sum(v["Total"] for v in
                       mt.get_tracker_snapshot("peak").values())
            mem = _Memory(args_b, _nbytes(out),
                          max(0, peak - _nbytes(inputs)), alias_b)
            flops = byts = 0
        else:
            with flop_mode, byte_mode, CollectiveInventory() as inv:
                run()
            mem = None
            flops, byts = flop_mode.get_total_flops(), byte_mode.total
    return float(flops), float(byts), inv.stats, mem, time.time() - t0


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: Path,
             seq_parallel: bool = False, shard_params_on_pod=None,
             overwrite: bool = False, tag: str = "",
             attn_impl: str = None, moe_impl: str = None,
             weight_quant: bool = False, serve_stationary: bool = False,
             remat_off: bool = False, remat_policy: str = None,
             decode_attn_impl: str = None, skip_full: bool = False) -> dict:
    """One cell's record (written to `out_dir`, and read back from there
    unless `overwrite`).  Starts and ends its own fake process group.
    `lower_s` is the full-depth step's seconds, `compile_s` the two
    analysis steps'."""
    from ..configs import get_config
    from ..dist.sharding import ShardingPolicy
    from . import roofline as roof_mod
    from .mesh import make_production_mesh
    from .shapes import SHAPES, applicable

    cfg = get_config(arch)
    if attn_impl:
        cfg = cfg.scaled(attn_impl=attn_impl)
    if moe_impl:
        cfg = cfg.scaled(moe_impl=moe_impl)
    if remat_off:
        cfg = cfg.scaled(remat=False)
    if decode_attn_impl:
        cfg = cfg.scaled(decode_attn_impl=decode_attn_impl)
    if remat_policy:
        cfg = cfg.scaled(remat_policy=remat_policy)
    ok, reason = applicable(cfg, shape)
    cell_id = f"{arch}__{shape}__{mesh_name}" + (f"__{tag}" if tag else "")
    out_path = out_dir / f"{cell_id}.json"
    if out_path.exists() and not overwrite:
        return json.loads(out_path.read_text())
    if not ok:
        rec = {"cell": cell_id, "status": "skipped", "reason": reason}
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    multi_pod = mesh_name == "multipod"
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        if shard_params_on_pod is None:
            shard_params_on_pod = multi_pod and cfg.param_count() > 4e11
        pol = ShardingPolicy.for_mesh(mesh, seq_parallel=seq_parallel,
                                      shard_params_on_pod=shard_params_on_pod)
        if serve_stationary:
            # weight-stationary serving: params replicated over the data
            # axes (TP-only sharding); decode loses its per-step FSDP
            # all-gathers
            pol.fsdp_axes = ()

        # --- 1. full-config step: runnability proof + memory ------------
        mem = None
        full_collectives = None
        t_lower = t_compile = 0.0
        if not skip_full:
            _f, _b, full_collectives, mem, t_lower = _run(
                cfg, SHAPES[shape], mesh, pol, weight_quant, memory=True)

        # --- 2. depth-extrapolated cost analysis -------------------------
        L1, L2, period = _analysis_depths(cfg)
        L = cfg.num_layers
        costs, colls = [], []
        for depth in (L1, L2):
            cfg_a = cfg.scaled(num_layers=depth, scan_layers=False)
            flops, byts, stats, _m, secs = _run(cfg_a, SHAPES[shape], mesh,
                                                pol, weight_quant)
            costs.append({"flops": flops, "bytes accessed": byts})
            colls.append(stats)
            t_compile += secs

    def extrap(v1: float, v2: float) -> float:
        return v1 + (v2 - v1) * (L - L1) / float(L2 - L1)

    flops = extrap(costs[0]["flops"], costs[1]["flops"])
    byts = extrap(costs[0]["bytes accessed"], costs[1]["bytes accessed"])
    link_bytes = extrap(colls[0].total_link_bytes, colls[1].total_link_bytes)

    roof = roof_mod.derive(arch, shape, mesh_name, chips,
                           {"flops": flops, "bytes accessed": byts}, mem,
                           link_bytes, cfg)

    per_layer_coll = {}
    for op in set(list(colls[0].counts) + list(colls[1].counts)):
        per_layer_coll[op] = {
            "count_per_period": colls[1].counts.get(op, 0)
            - colls[0].counts.get(op, 0),
            "link_bytes_per_period": colls[1].link_bytes.get(op, 0.0)
            - colls[0].link_bytes.get(op, 0.0),
        }

    rec = {
        "cell": cell_id,
        "status": "ok",
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "seq_parallel": seq_parallel,
        "shard_params_on_pod": shard_params_on_pod,
        "attn_impl": attn_impl or cfg.attn_impl,
        "moe_impl": moe_impl or cfg.moe_impl,
        "weight_quant": weight_quant,
        "serve_stationary": serve_stationary,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "analysis_depths": [L1, L2],
        "cost_extrapolated": {"flops": flops, "bytes_accessed": byts,
                              "link_bytes": link_bytes},
        "memory": {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "alias_bytes": mem.alias_size_in_bytes,
        } if mem else None,
        "collectives_per_period": per_layer_coll,
        # every layer's collectives (the reference counts a scanned
        # body once; the port's layers are a Python loop)
        "collectives_full_hlo_bodyonce": full_collectives.table()
        if full_collectives else None,
        "roofline": roof.to_dict(),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def _opt_shardings(ctx, opt_shape):
    """Optimizer state follows its parameter's sharding; scalars replicate
    (one spec per leaf; `to_placements` gives its placements).  AdamW m/v
    mirror the param tree exactly; Adafactor factored stats drop the last
    (vr) or second-to-last (vc) entry of the parameter's spec, so that
    each rank updates its blocks (`MeshContext.opt_spec`; the reference
    takes the spec of the statistic's own rank and leaves the rest to
    GSPMD).  `ctx.shard_params` has seen the parameters."""
    from ..tree import tree_map_with_path
    return tree_map_with_path(lambda path, leaf: ctx.opt_spec(path),
                              opt_shape)


def step_memory(cfg, spec) -> _Memory:
    """The memory of one step of `cfg` at `spec` on a world of one (the
    card's own step, phase 14 of chip_smoke.py): its arguments' bytes and
    its peak's temporaries."""
    from ..dist.sharding import ShardingPolicy
    from .mesh import make_mesh_for_devices
    with fake_world(1):
        mesh = make_mesh_for_devices(1, device_type="cpu")
        return _run(cfg, spec, mesh, ShardingPolicy.for_mesh(mesh),
                    memory=True)[3]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", help="architecture id (see repro_torch.configs)")
    ap.add_argument("--shape",
                    help="train_4k|prefill_32k|decode_32k|long_500k")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--attn-impl", default=None,
                    choices=[None, "xla", "xla_chunked", "xla_bhsd"])
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "gspmd", "shard_map"])
    ap.add_argument("--weight-quant", action="store_true",
                    help="int8 weight-only serving quantization")
    ap.add_argument("--remat-off", action="store_true",
                    help="disable activation checkpointing")
    ap.add_argument("--remat-policy", default=None,
                    choices=[None, "full", "dots"])
    ap.add_argument("--decode-attn-impl", default=None,
                    choices=[None, "xla", "shard_map"])
    ap.add_argument("--serve-stationary", action="store_true",
                    help="replicate weights over data axes for decode")
    ap.add_argument("--skip-full", action="store_true",
                    help="skip the full-depth step (analysis only)")
    args = ap.parse_args()

    from ..configs import list_archs
    from .shapes import SHAPES

    out_dir = Path(args.out)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in list_archs():
            for shape in SHAPES:
                for mesh in meshes:
                    cells.append((arch, shape, mesh))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        for mesh in meshes:
            cells.append((args.arch, args.shape, mesh))

    failures = 0
    for arch, shape, mesh in cells:
        cid = f"{arch}__{shape}__{mesh}"
        try:
            t0 = time.time()
            rec = run_cell(arch, shape, mesh, out_dir,
                           seq_parallel=args.seq_parallel,
                           overwrite=args.overwrite, tag=args.tag,
                           attn_impl=args.attn_impl,
                           moe_impl=args.moe_impl,
                           weight_quant=args.weight_quant,
                           serve_stationary=args.serve_stationary,
                           remat_off=args.remat_off,
                           remat_policy=args.remat_policy,
                           decode_attn_impl=args.decode_attn_impl,
                           skip_full=args.skip_full)
            status = rec.get("status")
            if status == "ok":
                r = rec["roofline"]
                msg = (f"[OK ] {cid}: dominant={r['dominant']} "
                       f"mfu={r['mfu']:.3f} trace={rec['lower_s']}s "
                       f"({time.time()-t0:.0f}s)")
                if rec.get("memory") and rec["memory"]["argument_bytes"]:
                    per_dev = (rec["memory"]["argument_bytes"]
                               + (rec["memory"]["temp_bytes"] or 0))
                    msg += f" mem/dev={per_dev/1e9:.1f}GB"
                    if per_dev > 80e9:
                        msg += " (>80GB HBM!)"
                print(msg, flush=True)
            else:
                print(f"[SKIP] {cid}: {rec.get('reason')}", flush=True)
        except Exception as e:
            failures += 1
            print(f"[FAIL] {cid}: {e}", flush=True)
            (out_dir / f"{cid}.error.txt").parent.mkdir(parents=True,
                                                        exist_ok=True)
            (out_dir / f"{cid}.error.txt").write_text(traceback.format_exc())
    print(f"done: {len(cells) - failures}/{len(cells)} cells ok", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
