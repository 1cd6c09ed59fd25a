"""The step functions train_step / prefill_step / serve_step and their
makers; a port of `repro/train/step.py`.

`train_step(state, batch) -> (state, metrics)` over the reference's
train-state tree {"params", "opt", "step"}, so a state crosses between
the packages through `repro_torch.convert`.  Gradients come from
`torch.autograd.grad` over detached leaves that require grad (the layer
checkpointing of `cfg.remat` is `torch.utils.checkpoint`).  Training runs
no kernel: the kernels are forward-only and refuse a gradient, so train
with `attn_impl="xla"` (or `"xla_chunked"`, `"xla_bhsd"`), as the
reference does.

Inside a `repro_torch.dist.sharding.MeshContext` the step is what GSPMD
gives the reference's step under a mesh: each rank takes its rows of the
global batch (`local_batch`; all of them when the DP ranks do not divide
it), `loss_fn` makes loss and metrics the global batch's, and the grads
are summed over the DP ranks that hold other rows (`reduce_grads`)
before compression and the optimizer.  The state is either replicated
or this rank's blocks (`MeshContext.shard_state`): then the model
gathers each layer's FSDP blocks just before it runs and computes its
matmuls split over TP, the grads come back to the blocks, and the
optimizer updates the blocks with the whole tree's grad norm
(`MeshContext.global_norm`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve
from ..dist.context import current_ctx
from ..models import decode_step, forward, init_params, loss_fn
from ..models.config import ModelConfig
from ..tree import tree_leaves, tree_map, tree_unflatten
from .optim import OptimizerConfig, apply_optimizer, init_opt_state


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1          # grad accumulation steps per global step
    grad_compression: bool = False  # int8 round trip of the grads


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
                     device="cuda") -> dict:
    """Fresh parameters (`init_params(cfg, seed, device)`), optimizer state
    and an int32 step counter, on `device`; raises without a card unless
    `device` names the CPU.  On "meta" the state holds shapes and dtypes
    only (the reference's `jax.eval_shape(init_train_state)`)."""
    dev = resolve(device)
    params = init_params(cfg, seed=seed, device=dev)
    return {"params": params, "opt": init_opt_state(params, tcfg.optimizer),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def loss_and_grads(params: dict, batch: dict, cfg: ModelConfig):
    """(loss, metrics, grads) of `loss_fn` at `params`; the grads have the
    params' tree and dtypes (zeros for a leaf the loss does not use)."""
    tparams = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(tparams, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(tparams),
                                    allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _grads_of(params, blocks: list, cfg: ModelConfig, n: int):
    """(loss, metrics, grads) of one batch (`n` = 1), or of `n`
    microbatches: their grads summed into f32 zeros and divided by n, the
    metrics empty."""
    if n == 1:
        return loss_and_grads(params, blocks[0], cfg)
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    loss_sum = 0.0
    for b in blocks:
        loss, _metrics, grads = loss_and_grads(params, b, cfg)
        gsum = tree_map(torch.add, gsum, grads)
        loss_sum = loss_sum + loss
    return loss_sum / n, {}, tree_map(lambda g: g / n, gsum)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    `batch` holds numpy arrays or tensors; they are moved to the
    parameters' device.  With `microbatches` n > 1 the batch is cut into
    n contiguous row blocks, their grads are summed into f32 zeros and
    divided by n (so the grads are f32 even for bf16 parameters), and the
    metrics hold only loss, grad_norm and step, as in the reference.
    Inside a `MeshContext` each rank takes its rows of every microbatch
    (of the whole batch), and the summed grads are then summed over the
    DP group.  Then the int8 round trip (`grad_compression`) and the
    optimizer; `grad_norm` is the norm of the grads it receives.  Like the
    reference's jitted step, which donates its input state, the step may
    reuse the input state's storage: do not read `state` after the call.
    """
    def train_step(state, batch):
        params = state["params"]
        dev = state["step"].device
        batch = _to_device(batch, dev)
        ctx = current_ctx()
        n = tcfg.microbatches
        blocks = [batch] if n == 1 else [
            {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]
        if ctx is None:
            loss, metrics, grads = _grads_of(params, blocks, cfg, n)
        else:
            with ctx.rows(blocks[0]):
                loss, metrics, grads = _grads_of(
                    params, [ctx.local_batch(b) for b in blocks], cfg, n)
                grads = ctx.reduce_grads(grads)

        if tcfg.grad_compression:
            from ..dist.compression import compress_decompress
            grads = compress_decompress(grads)

        new_params, new_opt, gnorm = apply_optimizer(
            grads, state["opt"], params, tcfg.optimizer, shards=ctx)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        out_metrics = {"loss": loss.float(), "grad_norm": gnorm.float(),
                       "step": new_state["step"]}
        out_metrics.update({k: v for k, v in metrics.items()
                            if k in ("ce", "aux")})
        return new_state, out_metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> last-token logits (B, V)."""

    def prefill_step(params, batch):
        logits, _aux, _mask = forward(params, batch, cfg)
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens) -> (logits, cache): one new token
    against the cache (which `decode_step` updates in place)."""

    def serve_step(params, cache, tokens):
        logits, new_cache = decode_step(params, cache, tokens, cfg)
        return logits, new_cache

    return serve_step
