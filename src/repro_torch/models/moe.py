"""Token-choice top-k MoE with capacity-bounded, sort-based dispatch; a
port of the single-device path of `repro/models/moe.py`.

Tokens are sorted by expert id (stably), positioned within their
expert's capacity C, gathered into an (E, C, D) buffer, run through
batched per-expert GEMMs and added back to their tokens weighted by the
router's gate.  Overflow tokens are dropped.  The router's softmax and
the Switch load-balancing aux loss are f32.

`moe_impl="shard_map"` (the reference's expert-parallel all-to-all)
takes this path too, as the reference does when no mesh is installed:
the port runs on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init, init_mlp, mlp
from .quant import wcast


def init_moe(gen, cfg: ModelConfig, dtype, device="cpu"):
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    params = {
        "router": dense_init(gen, (D, E), 0, torch.float32, device),
        "w_gate": dense_init(gen, (E, D, Fd), 1, dtype, device),
        "w_up": dense_init(gen, (E, D, Fd), 1, dtype, device),
        "w_down": dense_init(gen, (E, Fd, D), 1, dtype, device),
    }
    if cfg.shared_expert_d_ff:
        params["shared"] = init_mlp(gen, D, cfg.shared_expert_d_ff, dtype,
                                    device)
    return params


def _route(params, xf: torch.Tensor, cfg: ModelConfig):
    """Router top-k + Switch-style load-balancing aux.  xf: (T, D).
    Returns (gate values (T, K) f32, renormalised; expert ids (T, K)
    int64; aux 0-d f32)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    T = xf.shape[0]
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower index first among equal values; a
    # stable descending sort does too (torch.topk promises no order)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :K], expert_idx[:, :K]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.full((T * K,), 1.0 / (T * K), device=xf.device))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return gate_vals, expert_idx, aux


def _dispatch_tables(expert_idx, gate_vals, T: int, E: int, K: int, C: int):
    """Sort-based capacity dispatch.  Returns (buf (E, C) int32 token ids,
    pad id T; gbuf (E, C) f32 gates; slot (T, K) int64: the flat index
    e * C + c of each (token, choice) in `buf`, E * C where dropped).

    The reference writes every dropped slot to (E-1, C-1) with pad id T
    and gate 0, and XLA applies those duplicate writes in order, the last
    one winning: when expert E-1 overflows, its kept token at slot C-1 is
    overwritten and dropped too.  The port writes only the kept slots,
    each once, and applies that rule explicitly, so the tables are the
    same on every device and deterministic on the card."""
    flat_e = expert_idx.reshape(-1)                           # (T*K,)
    order = torch.sort(flat_e, stable=True).indices           # by expert
    sorted_e = flat_e[order]
    sorted_tok = order // K
    sorted_gate = gate_vals.reshape(-1)[order]
    arange_e = torch.arange(E, device=flat_e.device)
    group_start = torch.searchsorted(sorted_e, arange_e, side="left")
    pos_in_e = torch.arange(T * K, device=flat_e.device) - \
        group_start[sorted_e]
    keep = pos_in_e < C
    # the last expert's group runs to the end; if it overflowed, its
    # slot C-1 is the reference's last write of the pad
    last_overflowed = T * K - group_start[E - 1] > C
    dst = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    dst = torch.where(last_overflowed & (dst == E * C - 1), E * C, dst)
    # dropped entries all land in the scratch element E*C, cut off below
    buf = torch.full((E * C + 1,), T, dtype=torch.int32,
                     device=flat_e.device)
    buf.scatter_(0, dst, sorted_tok.to(torch.int32))
    gbuf = torch.zeros(E * C + 1, dtype=torch.float32, device=flat_e.device)
    gbuf.scatter_(0, dst, sorted_gate)
    slot = torch.empty_like(dst).scatter_(0, order, dst).reshape(T, K)
    return buf[:E * C].reshape(E, C), gbuf[:E * C].reshape(E, C), slot


def _experts(xe, wg, wu, wd, activation: str) -> torch.Tensor:
    """The batched per-expert gated MLP: (E, C, D) -> (E, C, D)."""
    g = torch.bmm(xe, wg)
    u = torch.bmm(xe, wu)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if activation == "geglu" \
        else F.silu(g)
    return torch.bmm(act * u, wd)


def _combine(ye: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each token's sum of its experts' outputs, ye: (E, C, D) gated,
    slot: (T, K) -> (T, D).  The reference scatter-adds the (E, C) rows
    onto zeros in expert order; here each token gathers its rows and adds
    them in that order (a token's rows sorted by slot are sorted by
    expert; a dropped choice adds an exact zero), with no atomics, so
    the sum's rounding is the reference's and the same on every run."""
    E, C, D = ye.shape
    rows = torch.cat([ye.reshape(E * C, D), ye.new_zeros((1, D))])
    slot = torch.sort(slot, dim=-1).values
    y = torch.zeros((slot.shape[0], D), dtype=ye.dtype, device=ye.device)
    for k in range(slot.shape[1]):
        y = y + rows[slot[:, k]]
    return y


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (y (B, S, D), aux 0-d f32)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xf = x.reshape(T, D)
    gate_vals, expert_idx, aux = _route(params, xf, cfg)
    # Python float arithmetic, truncated, as the reference
    C = max(1, int(cfg.capacity_factor * T * K / E))
    buf, gbuf, slot = _dispatch_tables(expert_idx, gate_vals, T, E, K, C)

    # gather -> (E, C, D); the pad id T reads a zero row
    xe = torch.cat([xf, xf.new_zeros((1, D))])[buf]
    ye = _experts(xe, wcast(params["w_gate"], xe.dtype),
                  wcast(params["w_up"], xe.dtype),
                  wcast(params["w_down"], xe.dtype), cfg.activation)
    ye = ye * gbuf[..., None].to(ye.dtype)
    y = _combine(ye, slot).reshape(B, S, D)
    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg.activation)
    return y, aux
