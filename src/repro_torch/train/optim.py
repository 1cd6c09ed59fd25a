"""Hand-rolled optimizers over the nested param dict; a port of
`repro/train/optim.py`.

AdamW for configs up to ~200B parameters; Adafactor (factored second
moments, no momentum) above.  Pure functions over nested dicts of
tensors, not `torch.optim`, so that the reference's rules hold exactly:
- the global norm sums per-leaf f32 sums in the order of
  `jax.tree.leaves` (dict keys sorted), and clipped grads keep their
  dtype;
- weight decay applies to every leaf of rank >= 2 *as stored*: layers are
  stacked on a leading L axis, so per-layer vectors ((L, D) norms, the
  SSM's (L, H) `A_log`, `D`, `dt_bias`, ...) are decayed and only
  unstacked vectors (`final_norm`) are not;
- Adafactor factors a leaf when both trailing dims are >= 128 and clips
  its update by the RMS over the whole stacked leaf;
- the new parameter is `p + u.to(p.dtype)`: bf16 parameters are updated
  in bf16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..tree import tree_leaves, tree_map, tree_map_with_path, tree_unzip


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128


def choose_optimizer(param_count: int) -> OptimizerConfig:
    if param_count > 200e9:
        return OptimizerConfig(name="adafactor")
    return OptimizerConfig(name="adamw")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, shards=None):
    """`grads` scaled to a global norm of at most `max_norm`, and the norm
    before: with `shards` (a `MeshContext` that cut the tree) the whole
    tree's (`MeshContext.global_norm`)."""
    norm = global_norm(grads) if shards is None else shards.global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    count = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": count}


def adamw_update(grads, opt_state, params, cfg: OptimizerConfig):
    count = opt_state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    t = count.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(g, m, v, p):
        g32 = g.float()
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m2 / c1
        vhat = v2 / c2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (as stored: L-stacked too)
            step = step + cfg.weight_decay * p.float()
        return (-cfg.lr * step).to(p.dtype), m2, v2

    updates, m, v = tree_unzip(tree_map(upd, grads, opt_state["m"],
                                        opt_state["v"], params), 3)
    return updates, {"m": m, "v": v, "count": count}


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------


def _factored(p, min_dim: int) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= min_dim and p.shape[-2] >= min_dim


def adafactor_init(params, cfg: OptimizerConfig = OptimizerConfig()):
    def one(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p, cfg.factored_min_dim):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    count = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
    return {"stats": tree_map(one, params), "count": count}


def adafactor_update(grads, opt_state, params, cfg: OptimizerConfig,
                     shards=None):
    """With `shards` (a `MeshContext` that cut the tree) each leaf is this
    rank's block, and its means over the factored dims and the whole leaf
    are summed over the ranks holding the other blocks."""
    count = opt_state["count"] + 1
    t = count.float()
    beta2 = 1.0 - t ** (-cfg.decay_rate)

    def upd(path, g, p, stat):
        def mean(x, dim, pdim, keepdim=False):
            # the mean over param dim `pdim` of x (dim `dim` of x)
            if shards is None:
                return torch.mean(x, dim=dim, keepdim=keepdim)
            n = shards.full_shape(path, p)[pdim]
            return shards.sum_blocks(torch.sum(x, dim=dim, keepdim=keepdim),
                                     path, p, (pdim,)) / n

        g32 = g.float()
        g2 = torch.square(g32) + 1e-30
        if "vr" in stat:
            vr = beta2 * stat["vr"] + (1 - beta2) * mean(g2, -1, -1)
            vc = beta2 * stat["vc"] + (1 - beta2) * mean(g2, -2, -2)
            rfac = vr / mean(vr, -1, -2, keepdim=True)
            step = g32 / (torch.sqrt(rfac)[..., None]
                          * torch.sqrt(vc)[..., None, :] + cfg.eps)
            new = {"vr": vr, "vc": vc}
        else:
            v = beta2 * stat["v"] + (1 - beta2) * g2
            step = g32 / (torch.sqrt(v) + cfg.eps)
            new = {"v": v}
        # update clipping (Adafactor's RMS clip, over the whole leaf)
        if shards is None:
            ms = torch.mean(torch.square(step))
        else:
            full = shards.full_shape(path, p)
            ms = shards.sum_blocks(torch.sum(torch.square(step)), path,
                                   p) / math.prod(full)
        rms = torch.sqrt(ms + 1e-30)
        step = step / torch.clamp(rms, min=1.0)
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p.float()
        return (-cfg.lr * step).to(p.dtype), new

    # the stats tree holds a dict at each param's place: tree_map walks
    # the grads' tree and hands `upd` that dict whole
    updates, stats = tree_unzip(tree_map_with_path(
        upd, grads, params, opt_state["stats"]), 2)
    return updates, {"stats": stats, "count": count}


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


def init_opt_state(params, cfg: OptimizerConfig):
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg)
    return adamw_init(params)


@torch.no_grad()
def apply_optimizer(grads, opt_state, params, cfg: OptimizerConfig,
                    shards=None):
    """(new params, new optimizer state, the grads' global norm before
    clipping).  With `shards`, the `MeshContext` that cut the trees into
    this rank's blocks, the norm and Adafactor's means are the whole
    tree's (`MeshContext.global_norm`, `sum_blocks`); AdamW is
    elementwise."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shards)
    if cfg.name == "adafactor":
        updates, new_state = adafactor_update(grads, opt_state, params, cfg,
                                              shards)
    else:
        updates, new_state = adamw_update(grads, opt_state, params, cfg)
    new_params = tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
    return new_params, new_state, gnorm
