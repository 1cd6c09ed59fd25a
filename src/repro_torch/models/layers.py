"""Building-block layers in PyTorch; a port of `repro/models/layers.py`.

Parameters are plain dicts of tensors with the reference's names and
layout (matmul weights stored (in, out), dense or as `quant`'s int8
{"q", "s"}).  Every layer is an `init_*` function drawing one layer's
parameters from a `torch.Generator` (with `gen=None`, on the meta
device: shapes and dtypes only) and an apply function.
`cfg.attn_impl == "pallas"` routes attention through the hand-written
kernels (`repro_torch.kernels`, forward-only); "xla" is the eager path,
the counterpart of the reference's XLA branch, "xla_chunked" its online
softmax over KV chunks and "xla_bhsd" its head-major layout.  Decode takes
the eager path for every value but "pallas", as the reference's does.

Sharding is applied from outside, by `repro_torch.dist`: `pshard` is the
pluggable activation hook that `MeshContext` installs (the identity when
none is installed, and on a plain tensor, which inside a context already
holds this rank's rows), and `decode_attn_impl="shard_map"` decodes with
hd-sharded K/V and an all-reduce of the partial scores inside a context
whose TP size divides hd but not the KV heads and whose parameters are
not TP-split.  A module whose parameters come TP-split
(`dist.sharding.TPLocal`, from `MeshContext.materialize`) computes on
this rank's heads or d_ff columns: its input enters the TP group
(`tp_enter`) and its output is summed over it (`psum`).  An attention's
share is its q heads and the KV heads they read, which ranks share when
TP does not divide the KV heads; the attention kernels run unchanged on
the local heads.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..dist.sharding import psum, tp_enter, tp_group
from ..obs import spans
from .config import ModelConfig
from .quant import is_quantized, kernel_matmul, takes_kernel, wcast

# ---------------------------------------------------------------------------
# activation sharding hook (installed by repro_torch.dist.sharding)
# ---------------------------------------------------------------------------

_SHARD_HOOK = None


def install_shard_hook(fn) -> None:
    global _SHARD_HOOK
    _SHARD_HOOK = fn


def pshard(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Constrain activation sharding; `kind` names a logical layout
    ('act_btd', 'act_btf', 'moe_ecd', ...) resolved by the dist context."""
    if _SHARD_HOOK is None:
        return x
    return _SHARD_HOOK(x, kind)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _trunc_normal(gen, shape, std, dtype, device):
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # in place: at Kimi-K2's widths one expert stack is 22.5 GB in f32
    return x.mul_(std).to(dtype)


def dense_init(gen, shape, in_axis: int = 0, dtype=torch.float32,
               device="cpu"):
    """Truncated normal, std 1/sqrt(fan_in); with no generator (the
    shape-only build on the meta device) an empty tensor of that shape and
    dtype, drawn from nothing."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return _trunc_normal(gen, shape, 1.0 / math.sqrt(shape[in_axis]), dtype,
                         device)


def embed_init(gen, shape, dtype=torch.float32, device="cpu",
               std: float = 0.02):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return _trunc_normal(gen, shape, std, dtype, device)


# ---------------------------------------------------------------------------
# norms / projections
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float,
             var: torch.Tensor = None) -> torch.Tensor:
    """RMS norm over the last dim; `var`, when given, is the mean of
    squares over the whole normalised dim, of which x and the scale hold
    a part (a TP rank's channels)."""
    x32 = x.float()
    if var is None:
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def linear(w, x: torch.Tensor) -> torch.Tensor:
    """x @ w for a dense or an int8 weight: at decode shapes on the card
    an int8 weight goes through the W8A16 kernel (`quant.takes_kernel`),
    else it is dequantized at every call, as the reference's `linear`."""
    if takes_kernel(w, x):
        return kernel_matmul(x, w)
    return x @ wcast(w, x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S).  Rotates split halves."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, causal, optional sliding window)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, dtype, device="cpu"):
    D = cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (D, H * hd), 0, dtype, device),
        "wk": dense_init(gen, (D, Hkv * hd), 0, dtype, device),
        "wv": dense_init(gen, (D, Hkv * hd), 0, dtype, device),
        "wo": dense_init(gen, (H * hd, D), 0, dtype, device),
    }


ATTN_IMPLS = ("xla", "pallas", "xla_chunked", "xla_bhsd")


def _check_attn_impl(cfg: ModelConfig) -> None:
    if cfg.attn_impl not in ATTN_IMPLS:
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported; the port has "
            f"{ATTN_IMPLS}")


@spans.traced("attention")
def attention(params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Causal self-attention over the full sequence (train / prefill); on
    this rank's heads when `params` are TP-split."""
    _check_attn_impl(cfg)
    B, S, D = x.shape
    H, Hkv, hd = _heads(params, cfg)
    tp = tp_group(params)
    if tp is not None:
        x = tp_enter(x, tp)
    rep = H // Hkv
    q = linear(params["wq"], x).reshape(B, S, H, hd)
    k = linear(params["wk"], x).reshape(B, S, Hkv, hd)
    v = linear(params["wv"], x).reshape(B, S, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = pshard(q, "act_bshrd")
    k = pshard(k, "act_bthd")

    if cfg.attn_impl == "pallas":
        from ..kernels.flash_attention import ops as fa_ops
        o = fa_ops.flash_attention(q, k, v, causal=True, window=window)
        o = o.reshape(B, S, H * hd)
    elif cfg.attn_impl == "xla_chunked":
        o = _attention_chunked(q.reshape(B, S, Hkv, rep, hd), k, v,
                               positions, window=window)
        o = o.reshape(B, S, H * hd)
    elif cfg.attn_impl == "xla_bhsd":
        # head-major: K/V repeated to H heads, so the scores carry a q-head
        # axis (the reference's sharding layout)
        q = pshard(q, "act_q_bshd")
        kr = pshard(k.repeat_interleave(rep, dim=2), "act_q_bshd")
        vr = pshard(v.repeat_interleave(rep, dim=2), "act_q_bshd")
        scale = 1.0 / math.sqrt(hd)
        s = torch.einsum("bshd,bthd->bhst", q, kr) * scale
        mask = _causal_mask(positions, window)
        s = s.masked_fill(~mask[:, None, :, :], float("-inf"))
        p = torch.softmax(s.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhst,bthd->bshd", p, vr).reshape(B, S, H * hd)
    else:
        q = q.reshape(B, S, Hkv, rep, hd)
        scale = 1.0 / math.sqrt(hd)
        scores = torch.einsum("bshrd,bthd->bhrst", q, k) * scale
        mask = _causal_mask(positions, window)
        scores = scores.masked_fill(~mask[:, None, None, :, :],
                                    float("-inf"))
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhrst,bthd->bshrd", probs, v).reshape(B, S, H * hd)
    o = pshard(o, "act_bshd_flat")
    return _tp_out(linear(params["wo"], o), tp)


def _heads(params, cfg: ModelConfig) -> tuple[int, int, int]:
    """(H, Hkv, hd) of the heads these parameters hold: all of them, or
    this rank's share when they are TP-split (its q heads and the KV heads
    they read, from its columns of wq and wk)."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if tp_group(params) is not None:
        H, Hkv = _columns(params["wq"]) // hd, _columns(params["wk"]) // hd
    return H, Hkv, hd


def _columns(w) -> int:
    """The output features of a dense or an int8 weight."""
    return (w["q"] if is_quantized(w) else w).shape[-1]


def _tp_out(y: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel product's partial sums added over the TP group."""
    return y if tp is None else psum(y, tp)


def _causal_mask(positions: torch.Tensor, window: int) -> torch.Tensor:
    """(B,S,T) bool: key j visible from query i (j <= i, and j > i - window
    with a window)."""
    ii = positions[:, :, None]                              # (B,S,1)
    jj = positions[:, None, :]                              # (B,1,T)
    mask = jj <= ii
    if window:
        mask &= jj > ii - window
    return mask


def _attention_chunked(q, k, v, positions, *, window: int = 0,
                       chunk: int = 512):
    """Online-softmax attention over KV chunks of `chunk` rows, the
    reference's pure-XLA flash formulation (its unrolled form): the live
    score buffer is (B,Hkv,rep,S,chunk), not (B,Hkv,rep,S,T).

    q: (B,S,Hkv,rep,hd); k/v: (B,T,Hkv,hd) -> (B,S,Hkv,rep,hd)
    """
    B, S, Hkv, rep, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nc = k.shape[1] // chunk
    qpos = positions[:, :, None]                            # (B,S,1)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((B, Hkv, rep, S), float("-inf"), **f32)
    l = torch.zeros((B, Hkv, rep, S), **f32)
    acc = torch.zeros((B, S, Hkv, rep, hd), **f32)
    for ic in range(nc):
        kb = k[:, ic * chunk:(ic + 1) * chunk]
        vb = v[:, ic * chunk:(ic + 1) * chunk]
        s = torch.einsum("bshrd,bthd->bhrst", q, kb) * scale
        kpos = ic * chunk + torch.arange(chunk, device=q.device)[None, None]
        mask = (kpos <= qpos) & (kpos < T)                  # (B,S,chunk)
        if window:
            mask &= kpos > qpos - window
        mask = mask[:, None, None, :, :]
        s = torch.where(mask, s.float(), float("-inf"))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # guard fully masked rows (exp(-inf - -inf))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bhrst,bthd->bshrd", p.to(q.dtype), vb)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv.float()
        m = m_new
    denom = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / denom).to(q.dtype)


@spans.traced("attention_decode")
def attention_decode(params, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, window: int = 0):
    """One-token decode against a KV cache.

    x: (B,1,D); caches: (B,Hkv,T,hd); pos: 0-d int32 tensor, the current
    index, shared by every batch row.  The new K/V row is written into the
    caches in place at min(pos, T-1) (the clamp of the reference's
    dynamic_update_slice).  Returns (out (B,1,D), k_cache, v_cache).

    With `decode_attn_impl="shard_map"`, inside a `MeshContext` whose TP
    size tp divides hd but not Hkv (the reference's gate), with
    parameters that are not TP-split (q heads TP does not divide), x is
    this rank's rows and the caches are this rank's hd slices
    (B,Hkv,T,hd/tp): see `_decode_attention_shard_map`.  With TP-split
    parameters the caches hold the KV heads this rank's q heads read
    (`MeshContext.shard_cache`).
    """
    _check_attn_impl(cfg)
    B, _, D = x.shape
    H, Hkv, hd = _heads(params, cfg)
    tp = tp_group(params)
    if tp is not None:
        x = tp_enter(x, tp)
    rep = H // Hkv
    T = k_cache.shape[2]
    q = linear(params["wq"], x).reshape(B, 1, H, hd)
    k = linear(params["wk"], x).reshape(B, 1, Hkv, hd)
    v = linear(params["wv"], x).reshape(B, 1, Hkv, hd)
    posb = pos.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)

    if cfg.decode_attn_impl == "shard_map":
        from ..dist.context import current_ctx
        ctx = current_ctx()
        ntp = ctx.size(ctx.pol.tp_axis) if ctx is not None else 0
        # only when KV heads cannot shard the model axis; head-shardable
        # archs decode collective-free, and TP-split parameters (q heads
        # that TP divides) on their shared KV heads.  (The reference also
        # asks that the global batch split over DP: B rows a rank are such
        # a split.)
        if ctx is not None and tp is None and Hkv % ntp != 0 \
                and hd % ntp == 0:
            o, k_cache, v_cache = _decode_attention_shard_map(
                q.reshape(B, 1, Hkv, rep, hd), k, v, k_cache, v_cache, pos,
                ctx, window=window)
            return linear(params["wo"], o), k_cache, v_cache

    idx = torch.clamp(pos, max=T - 1).reshape(1).long()
    k_cache.index_copy_(2, idx, k.transpose(1, 2).to(k_cache.dtype))
    v_cache.index_copy_(2, idx, v.transpose(1, 2).to(v_cache.dtype))
    if cfg.attn_impl == "pallas":
        from ..kernels.decode_attention import ops as da_ops
        o = da_ops.decode_attention(q.reshape(B, H, hd), k_cache, v_cache,
                                    pos + 1, window=window)
        o = o.reshape(B, 1, H * hd)
    else:
        q = q.reshape(B, 1, Hkv, rep, hd)
        scale = 1.0 / math.sqrt(hd)
        scores = torch.einsum("bshrd,bhtd->bhrst", q,
                              k_cache.to(q.dtype)) * scale
        jj = torch.arange(T, device=x.device)
        mask = jj <= pos
        if window:
            mask &= jj > pos - window
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhrst,bhtd->bshrd", probs,
                         v_cache.to(x.dtype)).reshape(B, 1, H * hd)
    return _tp_out(linear(params["wo"], o), tp), k_cache, v_cache


def _decode_attention_shard_map(q, k_new, v_new, k_cache, v_cache, pos, ctx,
                                *, window: int = 0):
    """Decode attention over head_dim-sharded K/V, the collectives written
    by hand (eager, as the reference's shard_map body): each TP rank keeps
    an hd slice of the cache, and the hd contraction becomes an all-reduce
    of the (B,Hkv,rep,1,T) partial scores while the cache stays put.

    q: (B,1,Hkv,rep,hd); k_new/v_new: (B,1,Hkv,hd), this rank's rows at
    full hd; caches: (B,Hkv,T,hd/tp), this rank's slice (TP position i
    holds dims [i*hd/tp, (i+1)*hd/tp)), its new K/V slice written in place
    at min(pos, T-1).  Returns (o (B,1,H*hd), gathered over TP before
    `wo`; k_cache, v_cache).
    """
    group = ctx.group(ctx.pol.tp_axis)
    tp = ctx.size(ctx.pol.tp_axis)
    B, _, Hkv, rep, hd = q.shape
    T = k_cache.shape[2]
    hl = hd // tp
    if k_cache.shape[-1] != hl or v_cache.shape[-1] != hl:
        raise ValueError(f"hd-sharded decode: caches hold {k_cache.shape[-1]}"
                         f" of hd {hd}, need this rank's {hl} (tp {tp})")
    lo = ctx.index(ctx.pol.tp_axis) * hl
    scale = 1.0 / math.sqrt(hd)
    idx = torch.clamp(pos, max=T - 1).reshape(1).long()
    k_cache.index_copy_(2, idx, k_new[..., lo:lo + hl].transpose(1, 2)
                        .to(k_cache.dtype))
    v_cache.index_copy_(2, idx, v_new[..., lo:lo + hl].transpose(1, 2)
                        .to(v_cache.dtype))
    s = torch.einsum("bshrd,bhtd->bhrst", q[..., lo:lo + hl],
                     k_cache.to(q.dtype)) * scale
    dist.all_reduce(s, group=group)                   # (B,Hkv,rep,1,T)
    jj = torch.arange(T, device=q.device)
    mask = jj <= pos
    if window:
        mask &= jj > pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhrst,bhtd->bshrd", p, v_cache.to(q.dtype)).contiguous()
    parts = [torch.empty_like(o) for _ in range(tp)]
    dist.all_gather(parts, o, group=group)
    return (torch.cat(parts, dim=-1).reshape(B, 1, Hkv * rep * hd), k_cache,
            v_cache)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, dtype, device="cpu"):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), 0, dtype, device),
        "w_up": dense_init(gen, (d_model, d_ff), 0, dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), 0, dtype, device),
    }


def mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """The gated MLP; on this rank's d_ff columns when `params` are
    TP-split."""
    tp = tp_group(params)
    if tp is not None:
        x = tp_enter(x, tp)
    g = linear(params["w_gate"], x)
    u = linear(params["w_up"], x)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if activation == "geglu" \
        else F.silu(g)
    h = pshard(act * u, "act_btf")
    return _tp_out(linear(params["w_down"], h), tp)
