"""Mamba2 / SSD blocks in PyTorch; a port of `repro/models/mamba2.py`.

Full-sequence forward (train / prefill) runs the chunked SSD algorithm:
`ssd_chunked` here on the eager path (`attn_impl == "xla"`), or the
hand-written CUDA scan (`kernels/ssd_scan`) when `attn_impl == "pallas"`.
Decode is the O(1) recurrent update, with no kernel, as in the reference.

With TP-split parameters (`dist.sharding.TPLocal`) the block is
head-parallel: each rank computes its heads' z, x and dt columns of the
packed in_proj and the B/C groups they read, the conv on those channels,
the scan on its heads (`mamba2_gated`), and its heads' rows of out_proj
(`mamba2_out`).  The gated norm normalises over the whole d_inner, so
its mean of squares is each rank's partial sum summed over TP
(`psum_shared`), and out_proj's partial products are summed over TP.
The dims come from the parameters' shapes, so one code path serves the
whole block and a rank's share.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist.sharding import psum_shared, tp_enter, tp_group
from ..obs import spans
from .config import ModelConfig
from .layers import (_tp_out, dense_init, init_rmsnorm, linear, pshard,
                     rms_norm)


def init_mamba2(gen, cfg: ModelConfig, dtype, device):
    """The reference's distributions: log-uniform dt in [1e-3, 1e-1] held
    as softplus^-1 in `dt_bias`, A = -linspace(1, 16, H), D = 1.  With
    `gen=None` (meta) nothing is drawn."""
    D, Din = cfg.d_model, cfg.d_inner
    N, H, G = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    conv_dim = Din + 2 * G * N
    u = torch.empty((H,), device=device) if gen is None else \
        torch.rand((H,), generator=gen, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * u)
    return {
        "in_proj": dense_init(gen, (D, 2 * Din + 2 * G * N + H), 0, dtype,
                              device),
        "conv_w": dense_init(gen, (cfg.ssm_conv_width, conv_dim), 0, dtype,
                             device) * 0.5,
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32,
                              device=device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "norm": init_rmsnorm(Din, device),
        "out_proj": dense_init(gen, (Din, D), 0, dtype, device),
    }


def _dims(params, cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, groups, heads) of the heads `params` hold: all of them,
    or a TP rank's share (its heads and the B/C groups they read)."""
    H = params["dt_bias"].shape[-1]
    Din = H * cfg.ssm_head_dim
    return Din, (params["conv_b"].shape[-1] - Din) // (2 * cfg.ssm_state), H


def _split_proj(Din: int, G: int, N: int, zxbcdt: torch.Tensor):
    """(z, xBC, dt) at the reference's split indices (jnp.split takes
    indices, torch.tensor_split too)."""
    return torch.tensor_split(zxbcdt, [Din, 2 * Din + 2 * G * N], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d of width K, then SiLU.  xBC: (B,S,C);
    w: (K,C).  Summed tap by tap in the reference's order."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b.to(out.dtype))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward (oracle).  Shapes:
      x: (b, s, h, p)   dt: (b, s, h) f32   A: (h,) (negative)
      B, C: (b, s, g, n) with heads grouped g | h.
    Returns y: (b, s, h, p) in x's dtype and the final state (b, h, p, n).
    The casts to x's dtype are the reference's: in bf16 the intra-chunk
    weights, the chunk states and the inter-chunk term are rounded."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError("sequence must be chunk-aligned")
    nc = s // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)

    dA = dtc * A                                       # (b,nc,q,h), negative
    cum = torch.cumsum(dA, dim=2)

    # intra-chunk quadratic term: M[i,j] = (C_i.B_j) exp(cum_i - cum_j) dt_j
    Bh = Bc.repeat_interleave(rep, dim=3)             # (b,nc,q,h,n)
    Ch = Cc.repeat_interleave(rep, dim=3)
    cb = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)   # (b,nc,h,q,q)
    cumt = cum.permute(0, 1, 3, 2)                    # (b,nc,h,q)
    seg = cumt[..., :, None] - cumt[..., None, :]
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    # select, never multiply: exp(seg) is +inf above the diagonal at
    # strong decay, and inf * 0 would be NaN
    decay = torch.where(causal, torch.exp(seg), 0.0)
    M = cb * decay * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M.to(x.dtype), xc)

    # chunk-level states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    last = cum[:, :, -1:, :]                          # (b,nc,1,h)
    w = torch.exp(last - cum) * dtc                   # (b,nc,q,h)
    states = torch.einsum("bcjh,bcjhn,bcjhp->bchpn", w.to(x.dtype),
                          Bh.to(x.dtype), xc)

    # inter-chunk recurrence over nc (the reference's lax.scan)
    chunk_decay = torch.exp(last[:, :, 0, :])         # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None].to(carry.dtype) \
            + states[:, c]
    prev_states = torch.stack(prev, dim=1)            # (b,nc,h,p,n)

    # inter-chunk output: y_i += C_i . (exp(cum_i) * S_prev)
    inter_w = torch.exp(cum)                          # (b,nc,q,h)
    y_inter = torch.einsum("bcihn,bchpn->bcihp", Ch.to(x.dtype),
                           prev_states) * inter_w[..., None].to(x.dtype)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, carry


@spans.traced("mamba2_block")
def mamba2_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full Mamba2 block (train / prefill).  x: (B,S,D) -> (B,S,D); on
    this rank's heads when `params` are TP-split."""
    tp = tp_group(params)
    if tp is not None:
        x = tp_enter(x, tp)
    g = mamba2_gated(params, x, cfg)
    return _tp_out(mamba2_out(params, g, _mean_sq(g, tp, cfg), cfg), tp)


def mamba2_gated(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block up to its gated norm: in_proj, the causal conv, the SSD
    scan with the D skip, times silu(z).  x: (B,S,D) -> (B,S,d_inner) on
    the heads `params` hold (all of them, or a TP rank's share: then it
    is the rank's work alone, with no collective)."""
    Bsz, S, _ = x.shape
    Din, G, H = _dims(params, cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(Din, G, N, linear(params["in_proj"], x))
    xBC = _causal_conv(xBC, params["conv_w"].to(x.dtype), params["conv_b"])
    xs, Bs, Cs = torch.tensor_split(xBC, [Din, Din + G * N], dim=-1)
    xs = xs.reshape(Bsz, S, H, P)
    Bs = Bs.reshape(Bsz, S, G, N)
    Cs = Cs.reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + params["dt_bias"])   # (B,S,H)
    A = -torch.exp(params["A_log"])                   # (H,) negative

    if cfg.attn_impl == "pallas":
        from ..kernels.ssd_scan import ops as ssd_ops
        y, _ = ssd_ops.ssd(xs.contiguous(), dt.contiguous(), A,
                           Bs.contiguous(), Cs.contiguous(),
                           chunk=cfg.ssm_chunk)
    else:
        y, _ = ssd_chunked(xs, dt, A, Bs, Cs, chunk=cfg.ssm_chunk)
    y = y + xs * params["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(Bsz, S, Din)
    return y * F.silu(z)


def mamba2_out(params, g: torch.Tensor, mean_sq, cfg: ModelConfig):
    """The block after its gated product `g` (B,S,d_inner of the heads
    `params` hold): the gated RMS norm with `mean_sq`, the mean of squares
    over the whole d_inner (None: over g's own), then out_proj.  On a TP
    rank's share its out_proj rows give a partial sum of the output."""
    y = rms_norm(params["norm"], g, cfg.norm_eps, var=mean_sq)
    y = pshard(y, "act_btf")
    return linear(params["out_proj"], y)


def _mean_sq(g: torch.Tensor, tp, cfg: ModelConfig):
    """The gated norm's mean of squares over the whole d_inner when `g`
    holds a TP rank's channels (its partial sum summed over TP), else
    None: `rms_norm` takes the mean itself."""
    if tp is None:
        return None
    ss = torch.sum(torch.square(g.float()), dim=-1, keepdim=True)
    return psum_shared(ss, tp) / cfg.d_inner


# ---------------------------------------------------------------------------
# O(1) recurrent decode
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device,
                   layers: tuple = ()):
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "state": torch.zeros(layers + (batch, H, P, N), dtype=dtype,
                             device=device),
        "conv": torch.zeros(layers + (batch, cfg.ssm_conv_width - 1,
                                      conv_dim), dtype=dtype, device=device),
    }


@spans.traced("mamba2_decode")
def mamba2_decode(params, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token step.  x: (B,1,D); cache: {'state','conv'} of one layer.
    Returns (out (B,1,D), new cache): the state is updated in f32 and
    stored in the cache's dtype.  With TP-split parameters the cache holds
    this rank's heads and conv channels (`MeshContext.shard_cache`)."""
    tp = tp_group(params)
    if tp is not None:
        x = tp_enter(x, tp)
    Bsz = x.shape[0]
    Din, G, H = _dims(params, cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(Din, G, N, linear(params["in_proj"], x)[:, 0])
    # rolling conv window
    hist = torch.cat([cache["conv"],
                      xBC[:, None, :].to(cache["conv"].dtype)], dim=1)
    w = params["conv_w"].to(x.dtype)
    conv_out = torch.einsum("bkc,kc->bc", hist.to(x.dtype), w)
    xBC = F.silu(conv_out + params["conv_b"].to(x.dtype))
    new_conv = hist[:, 1:, :]

    xs, Bs, Cs = torch.tensor_split(xBC, [Din, Din + G * N], dim=-1)
    xs = xs.reshape(Bsz, H, P)
    Bs = Bs.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1)
    Cs = Cs.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt.float() + params["dt_bias"])   # (B,H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                         # (B,H)
    state = cache["state"].float()
    state = state * decay[..., None, None] \
        + (dt[..., None] * xs.float())[..., :, None] \
        * Bs[:, :, None, :].float()
    y = torch.einsum("bhpn,bhn->bhp", state, Cs.float())
    y = y.to(x.dtype) + xs * params["D"][None, :, None].to(x.dtype)
    g = y.reshape(Bsz, 1, Din) * F.silu(z)[:, None, :]
    out = _tp_out(mamba2_out(params, g, _mean_sq(g, tp, cfg), cfg), tp)
    return out, {"state": state.to(cache["state"].dtype), "conv": new_conv}
