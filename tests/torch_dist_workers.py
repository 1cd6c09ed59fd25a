"""Rank bodies of the multi-process tests of `repro_torch.dist`
(tests/test_torch_dist.py, tests/test_torch_dist_train.py,
tests/test_torch_dist_tp.py) and the
spawner that runs them: gloo ranks, one thread each, a `file://`
rendezvous in the test's own directory, a deadline.  Each body runs in
a spawned process, takes numpy inputs made by the test, and returns
tensors, numbers and strings, which the test holds to the JAX package.
Imports no JAX."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor

from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data.pipeline import TokenStream
from repro_torch.dist.pipeline import gpipe
from repro_torch.dist.sharding import MeshContext, ShardingPolicy, TPLocal
from repro_torch.models import (decode_step, forward, init_cache, loss_fn,
                                prefill)
from repro_torch.models.layers import attention_decode, pshard
from repro_torch.models.moe import moe_ffn
from repro_torch.models.quant import quantize_tree
from repro_torch.train.optim import OptimizerConfig
from repro_torch.train.step import TrainConfig, make_train_step
from repro_torch.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                               tree_map_with_path)


def _entry(rank, fn, world, init_file, out_dir, backend, args):
    torch.set_num_threads(1)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", rank)
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world, **kw)
    try:
        torch.save(fn(rank, world, *args), Path(out_dir) / f"{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path: Path, *args, timeout: float = 120,
              backend: str = "gloo"):
    """`fn(rank, world, *args)` on `world` spawned ranks (gloo on the CPU;
    nccl, rank r on card r); returns their results in rank order.  A
    rank's exception fails the call (`ProcessRaisedException`), and so
    does the deadline."""
    out = Path(tmp_path) / f"ranks_{fn.__name__}_{world}"
    out.mkdir()
    pc = mp.start_processes(_entry, args=(fn, world, str(out / "rdzv"),
                                          str(out), backend, args),
                            nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not pc.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in pc.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: {world} ranks ran past "
                               f"{timeout} s")
    return [torch.load(out / f"{r}.pt") for r in range(world)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _grads(fn, params, group):
    """d fn(params) / d params, summed over the ranks of `group` (the DP
    ranks: those of one TP group hold the same grads)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        out = fn(leaves)
        grads = torch.autograd.grad(out, tree_leaves(leaves),
                                    materialize_grads=True)
    for g in grads:
        dist.all_reduce(g, group=group)
    return list(grads)


# ---------------------------------------------------------------------------
# tests/test_torch_dist.py: eight ranks
# ---------------------------------------------------------------------------


def _gpipe_cases(Ws, x, stage_fn):
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("pipe", "model"))
    y4 = gpipe(stage_fn, mesh, axis="pipe")(Ws, x)
    try:
        gpipe(stage_fn, mesh, axis="pipe")(Ws[:3], x)
        err = ""
    except ValueError as e:
        err = str(e)
    ring1 = init_device_mesh("cpu", (1, 8), mesh_dim_names=("pipe", "model"))
    y1 = gpipe(stage_fn, ring1, axis="pipe")(Ws[:1], x)
    return {"gpipe4": y4, "gpipe1": y1, "gpipe_err": err}


def tanh_stages(W, x):
    """tests/test_pipeline.py's stage: tanh(x @ W[i]) for each layer."""
    for i in range(W.shape[0]):
        x = torch.tanh(x @ W[i])
    return x


def _moe_case(mesh, cfg, params, x, grads: bool):
    """Under the (4,2) context: shard_map and gspmd on this rank's rows,
    and (`grads`) the grads of sum(y) through the all-to-alls and the TP
    sum, summed over the DP ranks; the single-device path on this rank's
    rows alone."""
    ctx = MeshContext(mesh, cfg, ShardingPolicy.for_mesh(mesh))
    xl = ctx.local_batch(x)
    sm, gs = cfg.scaled(moe_impl="shard_map"), cfg.scaled(moe_impl="gspmd")
    with ctx:
        y_sm, aux_sm = moe_ffn(params, xl, sm)
        y_gs, aux_gs = moe_ffn(params, xl, gs)
        g_sm = _grads(lambda p: moe_ffn(p, xl, sm)[0].sum(), params,
                      ctx.dp_group()) if grads else None
    y_shard, aux_shard = moe_ffn(params, xl, sm)       # no context
    return {"y_sm": y_sm, "aux_sm": aux_sm, "y_gs": y_gs, "aux_gs": aux_gs,
            "g_sm": g_sm, "y_shard": y_shard, "aux_shard": aux_shard}


def _decode_case(mesh, cfg, params, x, kc, vc, pos, window, sliced):
    """attention_decode under the context on this rank's rows; `sliced`:
    the caches are this rank's hd slice, else its rows at full hd."""
    ctx = MeshContext(mesh, cfg, ShardingPolicy.for_mesh(mesh))
    xl, kc, vc = (ctx.local_batch(_t(a)) for a in (x, kc, vc))
    if sliced:
        hl = kc.shape[-1] // ctx.size("model")
        lo = ctx.index("model") * hl
        kc, vc = kc[..., lo:lo + hl], vc[..., lo:lo + hl]
    kc, vc = kc.contiguous(), vc.contiguous()
    with ctx:
        out, kc, vc = attention_decode(
            params, xl, cfg.scaled(decode_attn_impl="shard_map"), kc, vc,
            torch.tensor(pos, dtype=torch.int32), window=window)
    return {"out": out, "k": kc, "v": vc}


def _placements(x) -> list[str]:
    return [f"Shard({p.dim})" if p.is_shard() else "Replicate()"
            for p in x.placements]


def _hook_case(mesh, cfg):
    ctx = MeshContext(mesh, cfg, ShardingPolicy.for_mesh(mesh))
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    out = {"outside": pshard(x, "act_btd") is x}
    full = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    odd = distribute_tensor(x[:3], mesh, [Replicate(), Replicate()])
    with ctx:
        out["local"] = pshard(x, "act_btd") is x
        y = pshard(full, "act_btd")
        out["dtensor"] = _placements(y)
        out["dtensor_local_shape"] = list(y.to_local().shape)
        out["dtensor_full"] = y.full_tensor()
        out["odd"] = _placements(pshard(odd, "act_btd"))
    out["after"] = pshard(x, "act_btd") is x
    return out


def dist_scenarios(rank, world, inp):
    """Every case of tests/test_torch_dist.py on one (4,2) world."""
    res = _gpipe_cases(_t(inp["Ws"]), _t(inp["x_pipe"]), tanh_stages)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    pods = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    for name, (cfg, p, x) in inp["moe"].items():
        params = params_from_numpy(p, device="cpu")
        if name == "int8":
            params = quantize_tree(params)
        res[f"moe_{name}"] = _moe_case(pods if name == "pods" else mesh,
                                       cfg, params, _t(x),
                                       grads=name == "ep")
    for name, (cfg, p, args) in inp["decode"].items():
        res[f"decode_{name}"] = _decode_case(
            mesh, cfg, params_from_numpy(p, device="cpu"), *args)
    res["hook"] = _hook_case(mesh, inp["decode"]["w0"][0])
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_dist_train.py: the data-parallel step and the elastic
# restart
# ---------------------------------------------------------------------------


def _steps(cfg, tcfg, mesh, state, dcfg, start, n):
    """`n` train steps from stream step `start` under a context on
    `mesh`; (state, per-step loss and grad_norm)."""
    step = make_train_step(cfg, tcfg)
    stream = TokenStream(dcfg, 0)
    losses, norms = [], []
    ctx = MeshContext(mesh, cfg, ShardingPolicy.for_mesh(mesh))
    with ctx:
        for s in range(start, start + n):
            state, m = step(state, stream.batch_at(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return state, losses, norms


def dp_steps(rank, world, cases):
    """Each case: `n` steps from its numpy state under a context on its
    mesh shape; rank 0 returns the final state."""
    out = {}
    for name, (shape, cfg, tkw, dcfg, np_state, start, n) in cases.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3), **tkw)
        state = train_state_from_numpy(np_state, device="cpu")
        state, losses, norms = _steps(cfg, tcfg, mesh, state, dcfg, start, n)
        out[name] = {"loss": losses, "grad_norm": norms,
                     "state": state if rank == 0 else None}
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_gpu.py: one NCCL rank per card
# ---------------------------------------------------------------------------


def gpu_gpipe(rank, world):
    """tests/test_pipeline.py's stages with `world` stages on the cards,
    against the stages in sequence on this card."""
    dev = torch.device("cuda", rank)
    rng = np.random.default_rng(0)
    Ws = _t((rng.standard_normal((world, 2, 32, 32)) * 0.2
             ).astype(np.float32)).to(dev)
    x = _t(rng.standard_normal((6, 3, 32)).astype(np.float32)).to(dev)
    mesh = init_device_mesh("cuda", (world, 1),
                            mesh_dim_names=("pipe", "model"))
    y = gpipe(tanh_stages, mesh, axis="pipe")(Ws, x)
    ref = x
    for s in range(world):
        ref = tanh_stages(Ws[s], ref)
    return {"err": float((y - ref).abs().max()), "device": str(y.device)}


def gpu_ep_moe(rank, world, cfg, params):
    """The EP MoE on a (world, 1) mesh of cards: shard_map and gspmd on
    this rank's rows against the single-device path, and the grads of
    sum(y) through the all-to-alls, summed over the ranks, against the
    single-device grads of the whole batch."""
    dev = torch.device("cuda", rank)
    params = params_from_numpy(params, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2 * world, 16, cfg.d_model)).astype(np.float32)).to(dev)
    mesh = init_device_mesh("cuda", (world, 1),
                            mesh_dim_names=("data", "model"))
    res = _moe_case(mesh, cfg, params, x, grads=True)
    ctx = MeshContext(mesh, cfg, ShardingPolicy.for_mesh(mesh))
    y_full, _ = moe_ffn(params, x, cfg)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        g_full = torch.autograd.grad(moe_ffn(leaves, x, cfg)[0].sum(),
                                     tree_leaves(leaves))
    rows = ctx.local_batch(y_full)
    return {"err_sm": float((res["y_sm"] - rows).abs().max()),
            "err_gs": float((res["y_gs"] - rows).abs().max()),
            "grads_finite": all(bool(torch.isfinite(g).all())
                                for g in res["g_sm"]),
            "err_grads": [(float((g - f).abs().max()), float(f.abs().max()))
                          for g, f in zip(res["g_sm"], g_full)],
            "device": str(res["y_sm"].device)}


# ---------------------------------------------------------------------------
# tests/test_torch_dist_tp.py: a replicated (indivisible) batch, and
# compute with TP/FSDP-sharded parameters
# ---------------------------------------------------------------------------


def _whole(ctx, tree):
    """Every leaf of a tree of this rank's blocks gathered whole."""
    with torch.no_grad():
        return tree_map_with_path(
            lambda path, leaf: ctx._gather(leaf, path, None, None), tree)


def _stored(ctx, local, full) -> dict:
    """This rank's stored parameter bytes, and the whole tree's bytes
    over each leaf's shard factor (the sizes of the mesh dims its spec
    names)."""
    got = want = 0
    for (path, t), (_, f) in zip(tree_leaves_with_path(local),
                                 tree_leaves_with_path(full)):
        spec = ctx._layout[path][0]
        factor = int(np.prod([ctx.size(e) for e in spec if e is not None]))
        got += t.numel() * t.element_size()
        want += f.numel() * f.element_size() // factor
    return {"stored": got, "whole_over_factor": want,
            "whole": sum(f.numel() * f.element_size()
                         for f in tree_leaves(full))}


def _own_rows(ctx, x):
    """This rank's block of the leading dim of `x` over the DP dims, cut
    here rather than by the context: what a caller that passes its own
    rows of a split batch gives the model."""
    n, i = ctx.size(ctx.pol.dp_axes), ctx.index(ctx.pol.dp_axes)
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _serve_case(ctx, cfg, full, batch, toks, T, grads=False):
    """forward, prefill and len(toks[0]) decode steps with this rank's
    blocks of the parameters and of the cache, on this rank's rows (cut
    by `_own_rows`, outside `MeshContext.rows`); the stored blocks and
    the cache after the steps; with `grads`, `loss_fn` of the rows and
    its grads, summed over DP and gathered whole."""
    local = ctx.shard_params(full)
    res = _stored(ctx, local, full)
    res["blocks"] = local
    # the modules that compute TP-split: layer 0's, the shared block's,
    # the unembedding
    with torch.no_grad():
        lp = ctx.materialize(local["layers"], "layers", cfg, 0)
        if "shared_attn" in local:
            lp.update(ctx.materialize(local["shared_attn"], "shared_attn",
                                      cfg))
        if "unembed" in local:
            lp["unembed"] = ctx.materialize({"unembed": local["unembed"]},
                                            "", cfg)
    res["tp_modules"] = sorted(k for k, v in lp.items()
                               if isinstance(v, TPLocal))
    if grads:
        rows = {k: _own_rows(ctx, _t(v)) for k, v in batch.items()}
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), local)
        with ctx, torch.enable_grad():
            loss, _ = loss_fn(leaves, rows, cfg)
            g = torch.autograd.grad(loss, tree_leaves(leaves),
                                    materialize_grads=True)
        it = iter(g)
        g = ctx.reduce_grads(tree_map(lambda _: next(it), local))
        res["serve_loss"] = float(loss)
        res["grads"] = _whole(ctx, g)
    with ctx, torch.no_grad():
        rows = {k: _own_rows(ctx, _t(v)) for k, v in batch.items()}
        logits, aux, _ = forward(local, rows, cfg)
        res.update(logits=logits, aux=torch.as_tensor(aux),
                   prefill=prefill(local, rows, cfg, T))
        tl = _own_rows(ctx, _t(toks))
        cache = ctx.shard_cache(init_cache(cfg, toks.shape[0], T,
                                           device="cpu"))
        steps = []
        for t in range(tl.shape[1]):
            lg, cache = decode_step(local, cache, tl[:, t:t + 1], cfg)
            steps.append(lg)
        res["decode"] = torch.stack(steps)
        res["cache"] = cache
    return res


def tp_cases(rank, world, cases):
    """Each case on a (data, model) mesh of its shape, in one context:
    `train` runs steps from a numpy state, sharded (`shard_state`) or
    replicated, and rank 0 returns the final parameters gathered whole;
    then `serve` runs `_serve_case` with sharded parameters."""
    out = {}
    for name, c in cases.items():
        mesh = init_device_mesh("cpu", c["mesh"],
                                mesh_dim_names=("data", "model"))
        cfg = c["cfg"]
        ctx = MeshContext(mesh, cfg, ShardingPolicy.for_mesh(mesh))
        res = {}
        if "train" in c:
            tr = c["train"]
            state = train_state_from_numpy(tr["state"], device="cpu")
            if tr["sharded"]:
                state = ctx.shard_state(state)
            step = make_train_step(cfg, TrainConfig(
                optimizer=OptimizerConfig(name=tr.get("optimizer", "adamw"),
                                          lr=1e-3)))
            losses, norms = [], []
            with ctx:
                for b in tr["batches"]:
                    state, m = step(state, b)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
            params = _whole(ctx, state["params"]) if tr["sharded"] \
                else state["params"]
            res.update(loss=losses, grad_norm=norms,
                       params=params if rank == 0 else None)
        if "serve" in c:
            full = params_from_numpy(c["serve"]["params"], device="cpu")
            if c["serve"].get("int8"):
                full = quantize_tree(full)
            res.update(_serve_case(ctx, cfg, full, c["serve"]["batch"],
                                   c["serve"]["tokens"], c["serve"]["T"],
                                   c["serve"].get("grads", False)))
        out[name] = res
    return out


def gpu_sharded(rank, world):
    """chip_smoke.py phase 14(d) at smoke widths on a (1, world) data x
    model mesh of cards (TP over every card): 2 f32 train steps with each
    rank's blocks of the state against the replicated steps, and a bf16
    prefill and 4 decode steps through the flash wgmma and decode split
    kernels on the local heads against the replicated path, with the
    sharded run's launches."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_params
    from repro_torch.train.step import init_train_state
    dev = torch.device("cuda", rank)
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    cfg = smoke_config("mistral-large-123b").scaled(dtype="float32")
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3))
    start = init_train_state(cfg, tcfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    step = make_train_step(cfg, tcfg)
    state, plain = tree_map(torch.clone, start), []
    for b in batches:
        state, m = step(state, b)
        plain.append(float(m["loss"]))
    ctx = MeshContext(mesh, cfg, ShardingPolicy.for_mesh(mesh))
    state, sharded = ctx.shard_state(start), []
    with ctx:
        for b in batches:
            state, m = step(state, b)
            sharded.append(float(m["loss"]))

    scfg = cfg.scaled(dtype="bfloat16", head_dim=64, attn_impl="pallas")
    params = init_params(scfg, seed=1, device=dev)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, scfg.vocab_size, (2, 256)).astype(np.int32)).to(dev)}
    toks = torch.from_numpy(rng.integers(0, scfg.vocab_size, (2, 4)).astype(
        np.int32)).to(dev)

    def run(p, cache):
        out = [prefill(p, batch, scfg, 264)]
        for t in range(toks.shape[1]):
            lg, cache = decode_step(p, cache, toks[:, t:t + 1], scfg)
            out.append(lg)
        return torch.stack(out).float()
    with torch.no_grad():
        ref = run(params, init_cache(scfg, 2, 264, device=dev))
        local = ctx.shard_params(params)
        cache = ctx.shard_cache(init_cache(scfg, 2, 264, device=dev))
        da_ops.zero_launches()
        fa_ops.zero_launches()
        with ctx:
            got = run(local, cache)
    return {"plain": plain, "sharded": sharded,
            "serve_err": float((got - ref).abs().max()),
            "launches": {**{f"flash.{k}": v for k, v in
                            fa_ops.launches_by_variant.items()},
                         **{f"decode.{k}": v for k, v in
                            da_ops.launches_by_variant.items()}}}
