"""Model assembly in PyTorch, for all four families (dense, moe, ssm,
hybrid); a port of `repro/models/model.py`.

embedding -> stacked layers (a Python loop over the leading L axis, in
place of `lax.scan`; each layer's body checkpointed under `cfg.remat`
when gradients are on) -> norm -> tied or separate unembedding, and the
next-token loss `loss_fn`.  Inside a `MeshContext` whose TP group splits
the untied unembedding over the vocab (`dist.sharding.tp_plan`), each TP
rank computes its (…, V/n) block of the logits: `loss_fn` takes the
log-softmax across TP without whole logits, and `forward`, `prefill` and
`decode_step` gather the blocks before they return.  Hybrid models run
Mamba2 blocks and apply
one *shared* attention + MLP block after every `attn_every`-th layer
(Zamba2-style); moe layers replace the MLP with `moe.moe_ffn`, whose
router aux loss the forward sums over the layers.  Parameters keep the
reference's tree, dense or with `quant`'s int8 weights, so
`repro_torch.convert` carries weights across both ways.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve
from ..dist.context import current_ctx
from ..dist.sharding import psum, tp_enter, tp_gather, tp_group
from ..obs import spans
from ..tree import tree_map
from .config import ModelConfig
from .layers import (attention, attention_decode, embed_init, init_attention,
                     init_mlp, init_rmsnorm, mlp, pshard, rms_norm)
from .mamba2 import init_mamba2, init_ssm_cache, mamba2_block, mamba2_decode
from .moe import init_moe, moe_ffn
from .quant import quantize_tree

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: ModelConfig, dt, dev) -> dict:
    """One layer's parameters (no leading L axis)."""
    D = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": init_rmsnorm(D, dev),
                "mamba": init_mamba2(gen, cfg, dt, dev)}
    layer = {"attn_norm": init_rmsnorm(D, dev),
             "attn": init_attention(gen, cfg, dt, dev),
             "mlp_norm": init_rmsnorm(D, dev)}
    if cfg.family == "moe":
        layer["moe"] = init_moe(gen, cfg, dt, dev)
    else:
        layer["mlp"] = init_mlp(gen, D, cfg.d_ff, dt, dev)
    return layer


def _init(cfg: ModelConfig, seed: int, device, transform) -> dict:
    """Parameters drawn one layer at a time into the stacks, each layer
    (and the rest of the tree) passed through `transform` first.  On the
    meta device nothing is drawn (no generator): every leaf is empty, with
    the shape and dtype the drawing path gives it."""
    _check_family(cfg)
    dev = resolve(device)
    dt = _dtype(cfg)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    D, L = cfg.d_model, cfg.num_layers
    params: dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, D), dt, dev),
        "final_norm": init_rmsnorm(D, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, (D, cfg.vocab_size), dt, dev)
    for i in range(L):
        layer = transform(_layer_init(gen, cfg, dt, dev))
        if i == 0:
            params["layers"] = tree_map(
                lambda t: t.new_empty((L,) + t.shape), layer)
        if gen is None:
            break               # shapes only: one layer gives the stacks
        tree_map(lambda s, t: s[i].copy_(t), params["layers"], layer)
        del layer
    if cfg.family == "hybrid":
        # one shared attention + MLP block (weights reused at each slot)
        params["shared_attn"] = transform({
            "attn_norm": init_rmsnorm(D, dev),
            "attn": init_attention(gen, cfg, dt, dev),
            "mlp_norm": init_rmsnorm(D, dev),
            "mlp": init_mlp(gen, D, cfg.d_ff, dt, dev),
        })
    return params


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters with the reference's distributions (truncated
    normal, std 1/sqrt(fan_in); embeddings std 0.02), drawn from a
    `torch.Generator` seeded with `seed` on `device`, one layer at a time
    into the (L, ...) stacks.  The values differ from
    `repro.models.init_params`; convert those to compare.  On
    `device="meta"` the tree holds shapes and dtypes only, drawn from
    nothing (the counterpart of `jax.eval_shape(init_params)`)."""
    return _init(cfg, seed, device, lambda tree: tree)


def init_quantized_params(cfg: ModelConfig, seed: int = 0,
                          device="cuda") -> dict:
    """`quantize_tree(init_params(cfg, seed, device))`, bit for bit (the
    same draws; the scale reduces axis -2 only, so each layer quantizes
    alone as it would in the stack), built one layer at a time: the dense
    weights of one layer exist at once, never the dense stack."""
    return _init(cfg, seed, device, quantize_tree)


def hybrid_attn_mask(cfg: ModelConfig) -> list[bool]:
    """True at layers after which the shared attention block runs."""
    if not cfg.attn_every:
        return [False] * cfg.num_layers
    return [i % cfg.attn_every == cfg.attn_every - 1
            for i in range(cfg.num_layers)]


def _layer_slice(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def _use(params, name: str, cfg: ModelConfig, index=None):
    """`params[name]` (layer `index` of the stacks, if given) as the layers
    compute with it: inside a `MeshContext`, gathered from this rank's
    blocks just before use (`MeshContext.materialize`; the identity for
    replicated parameters), else the tree itself."""
    ctx = current_ctx()
    if ctx is None:
        tree = params[name]
        return tree if index is None else _layer_slice(tree, index)
    return ctx.materialize(params[name], name, cfg, index)


@spans.traced("unembed")
def _unembed(params, cfg: ModelConfig, h: torch.Tensor):
    """(logits in the model dtype (the reference's einsum), not yet f32;
    the TP group when they are this rank's (…, V/n) block of the vocab,
    else None).  A tied embedding computes whole: the reference's spec
    puts no TP on `embed`."""
    if cfg.tie_embeddings:
        return h @ _use(params, "embed", cfg).T.to(h.dtype), None
    ctx = current_ctx()
    if ctx is None:
        return h @ params["unembed"].to(h.dtype), None
    w = ctx.materialize({"unembed": params["unembed"]}, "", cfg)
    tp = tp_group(w)
    if tp is not None:
        h = tp_enter(h, tp)
    return h @ w["unembed"].to(h.dtype), tp


def _whole(logits: torch.Tensor, tp) -> torch.Tensor:
    """Logits over the whole vocab: the TP ranks' blocks gathered."""
    return logits if tp is None else tp_gather(logits, -1, tp)


def _vocab_parallel_ll(logits: torch.Tensor, labels: torch.Tensor, tp):
    """log p(label) at each position from this rank's (…, V/n) block of
    f32 logits, with no whole logits: the max over TP (no gradient), the
    sum of exponentials summed over TP, and the label's logit from the
    rank whose block holds its column, summed over TP.  The loss is the
    same on every TP rank, so the sums' grads reach each block as they
    are (`psum`)."""
    Vl = logits.shape[-1]
    local = labels.long() - dist.get_rank(tp) * Vl
    m = torch.amax(logits.detach(), dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp)
    se = psum(torch.sum(torch.exp(logits - m), dim=-1), tp)
    own = (local >= 0) & (local < Vl)
    tl = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    tl = psum(torch.where(own, tl, 0.0), tp)
    return tl - m[..., 0] - torch.log(se)


# ---------------------------------------------------------------------------
# forward (train / prefill trunk)
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch: dict, cfg: ModelConfig):
    """Returns (h (B,S,D), positions (B,S), loss_mask (B,S))."""
    dt = _dtype(cfg)
    if cfg.modality == "vlm":
        tokens = batch["tokens"]                      # (B, S - P)
        patches = batch["patches"].to(dt)             # (B, P, D)
        te = _use(params, "embed", cfg)[tokens].to(dt)
        h = torch.cat([patches, te], dim=1)
        mask = torch.cat([torch.zeros(patches.shape[:2], dtype=torch.bool,
                                      device=h.device),
                          torch.ones(tokens.shape, dtype=torch.bool,
                                     device=h.device)], dim=1)
    elif cfg.modality == "audio" and cfg.frame_embed:
        h = batch["frames"].to(dt)                    # (B, S, D)
        mask = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
    else:
        h = _use(params, "embed", cfg)[batch["tokens"]].to(dt)
        mask = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    return h, positions, mask


def _shared_attn_block(cfg: ModelConfig, h, params, positions):
    sp = _use(params, "shared_attn", cfg)
    a = attention(sp["attn"], rms_norm(sp["attn_norm"], h, cfg.norm_eps),
                  cfg, positions, window=cfg.attn_window)
    h = h + a
    return h + mlp(sp["mlp"], rms_norm(sp["mlp_norm"], h, cfg.norm_eps),
                   cfg.activation)


# `dots_with_no_batch_dims_saveable`: the projections x @ W reach the
# dispatcher as aten.mm once matmul folds the leading dims, the attention
# and SSD einsums (which carry batch dims) as aten.bmm
DOTS_SAVED = (torch.ops.aten.mm.default,)


def dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of `remat_policy="dots"`: save the
    outputs of `DOTS_SAVED`, recompute everything else."""
    if op in DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, body):
    """`body` checkpointed as the reference's `_remat` does (`full`: keep
    only the layer's inputs; `dots`: also the non-batch matmuls), when
    `cfg.remat` and gradients are on; remat changes no value, so serving
    and prefill run `body` as it is."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, dots_policy)
    return functools.partial(checkpoint, body, use_reentrant=False, **kw)


def forward(params: dict, batch: dict, cfg: ModelConfig):
    """Full-sequence forward.  Returns (logits (B,S,V) f32, aux_loss,
    loss_mask)."""
    logits, tp, aux, mask = _forward(params, batch, cfg)
    logits = _whole(logits, tp).to(DTYPES[cfg.logit_dtype])
    return pshard(logits, "act_btv"), aux, mask


def _forward(params: dict, batch: dict, cfg: ModelConfig):
    """(logits in the model dtype, whole or this rank's vocab block; its
    TP group or None; aux_loss; loss_mask)."""
    _check_family(cfg)
    h, positions, mask = _embed_inputs(params, batch, cfg)
    attn_mask = hybrid_attn_mask(cfg)

    def body(h, i, use_attn):
        # gathered here, so that remat gathers again in the backward
        lp = _use(params, "layers", cfg, i)
        if cfg.family in ("dense", "moe"):
            a = attention(lp["attn"],
                          rms_norm(lp["attn_norm"], h, cfg.norm_eps),
                          cfg, positions)
            h = pshard(h + a, "act_btd")
            hin = rms_norm(lp["mlp_norm"], h, cfg.norm_eps)
            if cfg.family == "moe":
                m, aux = moe_ffn(lp["moe"], hin, cfg)
            else:
                m, aux = mlp(lp["mlp"], hin, cfg.activation), 0.0
            return pshard(h + m, "act_btd"), aux
        h = h + mamba2_block(lp["mamba"], rms_norm(lp["norm"], h,
                                                   cfg.norm_eps), cfg)
        if use_attn:
            h = _shared_attn_block(cfg, h, params, positions)
        return pshard(h, "act_btd"), 0.0

    body = _remat(cfg, body)
    aux = 0.0
    for i in range(cfg.num_layers):
        # the MoE aux summed in layer order, in f32
        h, a = body(h, i, attn_mask[i])
        aux = aux + a
    h = rms_norm(_use(params, "final_norm", cfg), h, cfg.norm_eps)
    logits, tp = _unembed(params, cfg, h)
    return logits, tp, aux, mask


def loss_fn(params: dict, batch: dict, cfg: ModelConfig):
    """Next-token cross entropy over f32 log-probabilities, weighted by
    `mask & (labels >= 0)` (VLM patch positions are masked out), plus the
    MoE router aux loss (0 for the other families).  Returns (loss,
    {"ce", "aux", "tokens"}).

    Inside a `MeshContext` with DP dims, `batch` is this rank's rows: the
    weighted sum is divided by the token count summed over the DP group,
    and the ce is summed over it (`psum`; the aux is global already), so
    loss and metrics are the whole batch's on every rank, while the
    gradient of this rank's loss is its share of the whole batch's (the
    train step sums the shares).  Rows replicated over DP
    (`MeshContext.row_group` is None) are the whole batch: nothing is
    summed.  Logits split over the vocab (`_unembed`) take the
    log-softmax across TP (`_vocab_parallel_ll`)."""
    ctx = current_ctx()
    group = ctx.row_group() if ctx is not None else None
    logits, tp, aux, mask = _forward(params, batch, cfg)
    logits = pshard(logits.to(DTYPES[cfg.logit_dtype]), "act_btv")
    labels = batch["labels"]
    lw = mask & (labels >= 0)
    if tp is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1,
                          labels.clamp(min=0).long()[..., None])[..., 0]
    else:
        ll = _vocab_parallel_ll(logits.float(), labels.clamp(min=0), tp)
    count = lw.sum()
    if group is not None:
        dist.all_reduce(count, group=group)
    denom = torch.clamp(count, min=1).to(torch.int32)
    ce = -torch.sum(ll * lw) / denom
    if group is not None:
        ce = psum(ce, group)
    loss = ce + aux
    return loss, {"ce": ce,
                  "aux": torch.as_tensor(aux, dtype=torch.float32,
                                         device=ce.device),
                  "tokens": denom}


@spans.traced("model.prefill")
def prefill(params: dict, batch: dict, cfg: ModelConfig, max_seq: int):
    """Last-token logits of the full-prompt forward (the reference's
    `prefill`, which leaves the KV cache to the serving engine); vocab
    blocks are gathered at the last position only."""
    logits, tp, _aux, _mask = _forward(params, batch, cfg)
    return _whole(logits[:, -1], tp).to(DTYPES[cfg.logit_dtype])


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    """On `device` (on "meta": shapes and dtypes only): {"pos": 0-d
    int32} and, by family,
    dense and moe: "k"/"v" (L, batch, Hkv, max_seq, hd);
    ssm: "ssm": {"state": (L, batch, H, P, N), "conv": (L, batch, K-1, C)};
    hybrid: "ssm", and "k"/"v" (L // attn_every, batch, Hkv, w, hd) with
    w = min(attn_window or max_seq, max_seq), a rolling window."""
    _check_family(cfg)
    dev = resolve(device)
    dt = dtype or _dtype(cfg)
    L = cfg.num_layers
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.family in ("dense", "moe"):
        slots, w = L, max_seq
    else:
        cache["ssm"] = init_ssm_cache(cfg, batch, dt, dev, (L,))
        if cfg.family == "ssm":
            return cache
        slots = L // max(cfg.attn_every, 1)
        w = min(cfg.attn_window or max_seq, max_seq)
    shape = (slots, batch, cfg.num_kv_heads, w, cfg.resolved_head_dim)
    cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
    cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


@spans.traced("model.decode_step")
def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1) integer (or (B,1,D) frames for
    audio).  Returns (logits (B, V) f32, new_cache).

    The cache tensors (K/V, SSM state and conv window) are updated in
    place (no copy of the whole cache per step): the returned cache shares
    them with `cache` and carries pos + 1.
    """
    _check_family(cfg)
    dt = _dtype(cfg)
    pos = cache["pos"]
    if cfg.modality == "audio" and cfg.frame_embed:
        h = tokens.to(dt)
    else:
        h = _use(params, "embed", cfg)[tokens].to(dt)  # (B,1,D)
    if cfg.family in ("dense", "moe"):
        for i in range(cfg.num_layers):
            lp = _use(params, "layers", cfg, i)
            x = rms_norm(lp["attn_norm"], h, cfg.norm_eps)
            a, _, _ = attention_decode(lp["attn"], x, cfg, cache["k"][i],
                                       cache["v"][i], pos)
            h = h + a
            hin = rms_norm(lp["mlp_norm"], h, cfg.norm_eps)
            if cfg.family == "moe":
                # capacity counts this step's B tokens only (the aux is
                # dropped, as the reference's decode drops it)
                m, _ = moe_ffn(lp["moe"], hin, cfg)
            else:
                m = mlp(lp["mlp"], hin, cfg.activation)
            h = h + m
    else:
        h = _ssm_decode_layers(params, cache, h, cfg)
    h = rms_norm(_use(params, "final_norm", cfg), h, cfg.norm_eps)
    logits = _whole(*_unembed(params, cfg, h))
    return logits[:, 0].float(), dict(cache, pos=pos + 1)


def _ssm_decode_layers(params, cache, h, cfg: ModelConfig):
    """The ssm and hybrid trunks of `decode_step`, writing the SSM state
    and conv window (and the hybrid's K/V slots) back in place."""
    pos = cache["pos"]
    ssm = cache["ssm"]
    attn_mask = hybrid_attn_mask(cfg)
    if cfg.family == "hybrid":
        w = cache["k"].shape[3]
        wpos = torch.clamp(pos, max=w - 1)    # position in the rolling window
        full = pos >= w
    slot = -1
    for i in range(cfg.num_layers):
        lp = _use(params, "layers", cfg, i)
        out, c2 = mamba2_decode(lp["mamba"],
                                rms_norm(lp["norm"], h, cfg.norm_eps),
                                _layer_slice(ssm, i), cfg)
        ssm["state"][i].copy_(c2["state"])
        ssm["conv"][i].copy_(c2["conv"])
        h = h + out
        if not attn_mask[i]:
            continue
        slot += 1
        # rolling window: shift left by one once the window is full (a
        # select on the device, as the reference's jnp.where, so the step
        # does not wait on the host); the rolled copy is written back
        kc = torch.where(full, cache["k"][slot].roll(-1, dims=2),
                         cache["k"][slot])
        vc = torch.where(full, cache["v"][slot].roll(-1, dims=2),
                         cache["v"][slot])
        sp = _use(params, "shared_attn", cfg)
        x = rms_norm(sp["attn_norm"], h, cfg.norm_eps)
        a, kc, vc = attention_decode(sp["attn"], x, cfg, kc, vc, wpos)
        cache["k"][slot].copy_(kc)
        cache["v"][slot].copy_(vc)
        h = h + a
        h = h + mlp(sp["mlp"], rms_norm(sp["mlp_norm"], h, cfg.norm_eps),
                    cfg.activation)
    return h
