"""Token-choice top-k MoE with capacity-bounded, sort-based dispatch; a
port of the single-device path of `repro/models/moe.py`.

Tokens are sorted by expert id (stably), positioned within their
expert's capacity C, gathered into an (E, C, D) buffer, run through
batched per-expert GEMMs and added back to their tokens weighted by the
router's gate.  Overflow tokens are dropped.  The router's softmax and
the Switch load-balancing aux loss are f32.

Inside a `repro_torch.dist.sharding.MeshContext` x is this rank's rows.
`_moe_gspmd` then keeps the reference's whole-batch semantics with
collectives over the DP group: capacity, positions within an expert and
the aux loss are the global batch's, the experts run on this rank's
tokens.  `moe_impl="shard_map"` is the reference's expert-parallel path
(`_moe_shard_map`): local routing and capacity, an all-to-all of the
expert blocks there and back, the local experts on (E_l, D, F_l) slices.
It takes `_moe_gspmd` where the reference does: outside a context, when
the experts or F do not tile the mesh, and for int8 weights; and for a
batch replicated over DP (`MeshContext.local_batch`).

Over TP each rank computes its F slice of every expert (TP-split
parameters, `dist.sharding.TPLocal`, or on the EP path a slice of
replicated ones): the expert GEMMs' input and the gates enter the TP
group (their grads are summed over it) and the combined output is
summed over it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
import torch.nn.functional as F

from ..dist.context import current_ctx
from ..dist.sharding import pmean, psum, tp_enter, tp_group, tp_slice
from ..obs import spans
from .config import ModelConfig
from .layers import dense_init, init_mlp, mlp, pshard
from .quant import is_quantized, kernel_matmul, takes_kernel, wcast


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


def _route(params, xf: torch.Tensor, cfg: ModelConfig, group=None):
    """Router top-k + Switch-style load-balancing aux.  xf: (T, D).
    Returns (gate values (T, K) f32, renormalised; expert ids (T, K)
    int64; aux 0-d f32).  With a DP `group`, xf is this rank's share of
    equal shares: the mean router probability P and the routed fraction f
    are summed over the group before their product, so the aux is the
    whole batch's."""
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
    if group is None:
        me = torch.mean(probs, dim=0)
        ce = torch.zeros(E, dtype=torch.float32, device=xf.device
                         ).index_add_(0, expert_idx.reshape(-1),
                                      torch.full((T * K,), 1.0 / (T * K),
                                                 device=xf.device))
    else:
        Tg = T * dist.get_world_size(group)
        me = psum(torch.sum(probs, dim=0), group) / Tg
        ce = torch.zeros(E, dtype=torch.float32, device=xf.device
                         ).index_add_(0, expert_idx.reshape(-1),
                                      torch.ones(T * K, device=xf.device))
        dist.all_reduce(ce, group=group)
        ce = ce / (Tg * K)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return gate_vals, expert_idx, aux


def _dispatch_tables(expert_idx, gate_vals, T: int, E: int, K: int, C: int,
                     before=None, total=None):
    """Sort-based capacity dispatch.  Returns (buf (E, C) int32 token ids,
    pad id T; gbuf (E, C) f32 gates; slot (T, K) int64: the flat index
    e * C + c of each (token, choice) in `buf`, E * C where dropped).

    `before` and `total` ((E,) int64) make the capacity a larger batch's,
    of which these T tokens are one rank's share: `before[e]` of expert
    e's entries come from earlier ranks, `total[e]` from all.  An entry is
    kept by its position in the whole batch; the buffer holds this rank's
    kept entries in min(C, T) slots (an expert takes a token at most
    once).

    The reference writes every dropped slot to (E-1, C-1) with pad id T
    and gate 0, and XLA applies those duplicate writes in order, the last
    one winning: when expert E-1 overflows, its kept token at slot C-1 is
    overwritten and dropped too.  The port writes only the kept slots,
    each once, and applies that rule explicitly, so the tables are the
    same on every device and deterministic on the card.

    Counted (`obs.spans`): `moe.routed` the T * K entries and `moe.rows`
    the E * Cb rows the expert GEMMs run.  The entries kept follow from
    the routes and C alone, so they are left to whoever records the
    routes: counting them here would add device work to the step."""
    flat_e = expert_idx.reshape(-1)                           # (T*K,)
    order = torch.sort(flat_e, stable=True).indices           # by expert
    sorted_e = flat_e[order]
    sorted_tok = order // K
    sorted_gate = gate_vals.reshape(-1)[order]
    arange_e = torch.arange(E, device=flat_e.device)
    group_start = torch.searchsorted(sorted_e, arange_e, side="left")
    pos_in_e = torch.arange(T * K, device=flat_e.device) - \
        group_start[sorted_e]
    if before is None:
        gpos, Cb = pos_in_e, C
        # the last expert's group runs to the end
        last_overflowed = T * K - group_start[E - 1] > C
    else:
        gpos, Cb = pos_in_e + before[sorted_e], min(C, T)
        last_overflowed = total[E - 1] > C
    keep = gpos < C
    dst = torch.where(keep, sorted_e * Cb + pos_in_e, E * Cb)
    # if the last expert overflowed, its slot C-1 is the reference's last
    # write of the pad
    dst = torch.where(last_overflowed & (sorted_e == E - 1) & (gpos == C - 1),
                      E * Cb, dst)
    if spans.ON:
        spans.add("moe.routed", T * K)
        spans.add("moe.rows", E * Cb)
    # dropped entries all land in the scratch element E*Cb, cut off below
    buf = torch.full((E * Cb + 1,), T, dtype=torch.int32,
                     device=flat_e.device)
    buf.scatter_(0, dst, sorted_tok.to(torch.int32))
    gbuf = torch.zeros(E * Cb + 1, dtype=torch.float32, device=flat_e.device)
    gbuf.scatter_(0, dst, sorted_gate)
    slot = torch.empty_like(dst).scatter_(0, order, dst).reshape(T, K)
    return (buf[:E * Cb].reshape(E, Cb), gbuf[:E * Cb].reshape(E, Cb),
            slot)


def _expert_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """(E, C, D_in) @ an expert stack (E, D_in, D_out), dense or int8: at
    decode shapes on the card an int8 stack goes through the W8A16 kernel
    (`quant.takes_kernel`), else it is dequantized at the call."""
    if takes_kernel(w, x):
        return kernel_matmul(x, w)
    return torch.bmm(x, wcast(w, x.dtype))


def _experts(xe, wg, wu, wd, activation: str) -> torch.Tensor:
    """The batched per-expert gated MLP: (E, C, D) -> (E, C, D); the
    weights are the expert stacks as stored, dense or int8."""
    g = _expert_matmul(xe, wg)
    u = _expert_matmul(xe, wu)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if activation == "geglu" \
        else F.silu(g)
    return _expert_matmul(pshard(act * u, "moe_ecf"), wd)


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


@spans.traced("moe_ffn")
def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (y (B, S, D), aux 0-d f32).  Dispatch impl per
    cfg.moe_impl."""
    if cfg.moe_impl == "shard_map":
        ctx = current_ctx()
        if ctx is not None:
            return _moe_shard_map(params, x, cfg, ctx)
    return _moe_gspmd(params, x, cfg)


def _capacity(cfg: ModelConfig, T: int) -> int:
    # Python float arithmetic, truncated, as the reference
    return max(1, int(cfg.capacity_factor * T * cfg.experts_per_token
                      / cfg.num_experts))


def _expert_counts(expert_idx, E: int, group):
    """(before, total): per expert, the entries routed on the group's
    lower ranks and on all of them."""
    flat = expert_idx.reshape(-1)
    # a scatter, not bincount: its output's shape is E's alone
    counts = torch.zeros(E, dtype=flat.dtype, device=flat.device
                         ).scatter_add_(0, flat, torch.ones_like(flat))
    every = [torch.empty_like(counts)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, counts, group=group)
    every = torch.stack(every)
    return every[:dist.get_rank(group)].sum(0), every.sum(0)


def _moe_gspmd(params, x: torch.Tensor, cfg: ModelConfig):
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    ctx = current_ctx()
    group = ctx.row_group() if ctx is not None else None
    xf = x.reshape(T, D)
    gate_vals, expert_idx, aux = _route(params, xf, cfg, group)
    if group is None:
        C = _capacity(cfg, T)
        buf, gbuf, slot = _dispatch_tables(expert_idx, gate_vals, T, E, K, C)
    else:
        C = _capacity(cfg, T * dist.get_world_size(group))
        buf, gbuf, slot = _dispatch_tables(
            expert_idx, gate_vals, T, E, K, C,
            *_expert_counts(expert_idx, E, group))

    tp = tp_group(params)               # the experts' F split over TP
    xin = xf if tp is None else tp_enter(xf, tp)
    if tp is not None:
        gbuf = tp_enter(gbuf, tp)
    # gather -> (E, C, D); the pad id T reads a zero row
    xe = torch.cat([xin, xin.new_zeros((1, D))])[buf]
    xe = pshard(xe, "moe_ecd")
    ye = _experts(xe, params["w_gate"], params["w_up"], params["w_down"],
                  cfg.activation)
    ye = ye * gbuf[..., None].to(ye.dtype)
    y = _combine(ye, slot)
    if tp is not None:
        y = psum(y, tp)
    y = y.reshape(B, S, D)
    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg.activation)
    return y, aux


# ---------------------------------------------------------------------------
# expert parallelism: explicit all-to-all dispatch
# ---------------------------------------------------------------------------
#
# Each rank routes its own tokens with a local capacity, an all-to-all
# sends every expert's block to the rank holding that expert, the local
# experts compute, a second all-to-all returns the outputs and the source
# rank combines.  Per-rank link bytes are O(T_local·K·cf·D).


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of dim 0 goes to rank j of `group`; the result holds, at
    block j, what rank j sent here.  Differentiable (the backward is the
    reverse exchange)."""
    return fc.wait_tensor(fc.all_to_all_single_autograd(
        x.contiguous(), None, None, group))


def _moe_shard_map(params, x: torch.Tensor, cfg: ModelConfig, ctx):
    pol = ctx.pol
    E, K, D = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    n_ep, n_tp = ctx.size(pol.ep_axes), ctx.size(pol.tp_axis)
    if E % n_ep or (n_tp > 1 and cfg.moe_d_ff % n_tp) \
            or is_quantized(params["w_gate"]) or not ctx.rows_split:
        # shapes don't tile; or the rows are replicated, which the
        # reference's shard_map cannot take and its GSPMD path computes
        return _moe_gspmd(params, x, cfg)

    # x: this rank's rows (B_l, S, D); the local experts are E_l of E
    # over EP and F_l of F over TP: sliced from TP-split parameters'
    # stacks (F_l columns already), or from replicated ones, whose F
    # slice's grad is made whole over TP again (`tp_slice`)
    Bl, S, _ = x.shape
    Tl = Bl * S
    El, Fl = E // n_ep, cfg.moe_d_ff // n_tp
    e0, f_i = ctx.index(pol.ep_axes) * El, ctx.index(pol.tp_axis)
    tp = ctx.group(pol.tp_axis) if n_tp > 1 else None

    def local(w, fdim):
        w = w[e0:e0 + El]
        if tp is not None and w.shape[fdim] != Fl:
            w = tp_slice(w, fdim, tp, n_tp, f_i)
        return w
    wg = local(params["w_gate"], -1)
    wu = local(params["w_up"], -1)
    wd = local(params["w_down"], -2)
    ep_group = ctx.group(pol.ep_axes)

    xf = x.reshape(Tl, D)
    gate_vals, expert_idx, aux = _route(params, xf, cfg)
    C = _capacity(cfg, Tl)
    buf, gbuf, slot = _dispatch_tables(expert_idx, gate_vals, Tl, E, K, C)
    xin = xf if tp is None else tp_enter(xf, tp)
    if tp is not None:
        gbuf = tp_enter(gbuf, tp)
    xe = torch.cat([xin, xin.new_zeros((1, D))])[buf]        # (E, C, D)
    # exchange: every rank sends each expert block home, and holds its
    # experts' blocks from every rank in rank order: (E_l, C·n_ep, D)
    xe = _all_to_all(xe, ep_group)
    xe = xe.reshape(n_ep, El, C, D).transpose(0, 1).reshape(El, n_ep * C, D)
    ye = _experts(xe, wg, wu, wd, cfg.activation)
    # return trip; outputs are partial over TP (F was sliced)
    ye = ye.reshape(El, n_ep, C, D).transpose(0, 1)
    ye = _all_to_all(ye, ep_group).reshape(E, C, D)
    ye = ye * gbuf[..., None].to(ye.dtype)
    yf = _combine(ye, slot)
    if tp is not None:
        yf = psum(yf, tp)
    aux = pmean(aux, ep_group)
    y = yf.reshape(Bl, S, D)
    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg.activation)
    return y, aux
