"""Plain float32 forward of the two families the benchmark runs: decoder
layers of GQA attention with rotary positions and a top-k mixture of
experts with a capacity (Phi-3.5-MoE as the program states it), and
Mamba2 blocks in the SSD's quadratic (dual) form.

The mixture of experts is the program's stated semantics: an f32 softmax
router, the top k by a stable descending sort (ties to the lower expert),
gates renormalised over the k; each expert keeps at most
C = max(1, int(capacity_factor * n * k / E)) entries of a dispatch group
of n tokens, in token order, and when the last expert overflows the
entry at its position C - 1 is dropped as well.  A group is one decode
step's tokens (`groups="position"`: the rows at one position) or the
whole call (`groups="all"`, row-major).

`routes`, when given, are the program's expert ids for every token and
layer.  The reference judges them (`route_margin`: the most by which the
router probabilities of its own top k exceed those of the program's
choice, 0 where they agree) and then follows them, with gates from its
own probabilities, so that a near-tie which rounding decides one way in
the program and the other here does not send the two computations apart.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import weights as W
from .quant import prepare


def full_precision() -> None:
    """float32 matmuls in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta):
    """x: (B, S, H, hd) at positions 0..S-1; rotates split halves."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, x, m):
    """Causal GQA self-attention over each row, x: (B, S, D)."""
    B, S, _ = x.shape
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = rope((x @ p["wq"]).view(B, S, H, hd), m["rope_theta"])
    k = rope((x @ p["wk"]).view(B, S, Hkv, hd), m["rope_theta"])
    v = (x @ p["wv"]).view(B, S, Hkv, hd)
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    o = torch.empty(B, S, H, hd, device=x.device)
    for b in range(B):                                  # bounds the scores
        s = torch.einsum("shd,thd->hst", q[b], k[b]) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        o[b] = torch.einsum("hst,thd->shd", torch.softmax(s, dim=-1), v[b])
    return o.reshape(B, S, H * hd) @ p["wo"]


def _order(B: int, S: int, groups: str, device):
    """Token indices (into the row-major (B, S) flattening) in dispatch
    order, and each one's group."""
    idx = torch.arange(B * S, device=device).view(B, S)
    if groups == "position":
        return idx.t().reshape(-1), \
            torch.arange(S, device=device).repeat_interleave(B)
    if groups == "all":
        return idx.reshape(-1), torch.zeros(B * S, dtype=torch.long,
                                            device=device)
    raise ValueError(groups)


def moe(p, x, m, groups: str, follow=None):
    """x: (B, S, D).  Returns (y, expert ids (B, S, k), route margin,
    tokens whose route differs from this router's own top k)."""
    B, S, D = x.shape
    E, K = m["num_experts"], m["experts_per_token"]
    n = B if groups == "position" else B * S
    C = max(1, int(m["capacity_factor"] * n * K / E))
    order, group = _order(B, S, groups, x.device)
    xf = x.reshape(B * S, D)[order]
    probs = torch.softmax(xf @ p["router"], dim=-1)
    own = torch.sort(probs, dim=-1, descending=True, stable=True).indices[
        :, :K]
    margin, differ = 0.0, 0
    ids = own
    if follow is not None:
        ids = follow.reshape(B * S, K)[order].to(x.device)
        mine = probs.gather(1, own).sum(-1)
        theirs = probs.gather(1, ids).sum(-1)
        same = (torch.sort(ids, -1).values == torch.sort(own, -1).values
                ).all(-1)
        differ = int((~same).sum())
        if differ:
            margin = float((mine - theirs)[~same].max())
    gate = probs.gather(1, ids)
    gate = gate / gate.sum(-1, keepdim=True)
    # each entry's rank among its (group, expert)'s entries, in order
    key = (group[:, None] * E + ids).reshape(-1)
    srt = torch.sort(key, stable=True)
    start = torch.searchsorted(srt.values, srt.values, side="left")
    rank = torch.empty_like(key)
    rank[srt.indices] = torch.arange(key.numel(), device=x.device) - start
    count = torch.bincount(key, minlength=(int(group.max()) + 1) * E)
    keep = rank < C
    last_over = (key % E == E - 1) & (count[key] > C) & (rank == C - 1)
    keep &= ~last_over
    keep = keep.view(-1, K)
    y = torch.zeros_like(xf)
    for e in range(E):
        t, kk = torch.nonzero((ids == e) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        xe = xf[t]
        h = F.silu(xe @ p["w_gate"][e]) * (xe @ p["w_up"][e])
        y.index_add_(0, t, (h @ p["w_down"][e]) * gate[t, kk, None])
    out = torch.empty_like(y)
    out[order] = y
    ids_bs = torch.empty_like(ids)
    ids_bs[order] = ids
    return out.view(B, S, D), ids_bs.view(B, S, K), margin, differ


def mamba2(p, x, m):
    """The Mamba2 block over each row, x: (B, S, D) -> (B, S, D)."""
    B, S, _ = x.shape
    Din, N, H, K, P = W.ssm_dims(m)
    z, xbc, dt = torch.split(x @ p["in_proj"], [Din, Din + 2 * N, H], -1)
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(K))
    xbc = F.silu(conv + p["conv_b"])
    xs, Bm, Cm = torch.split(xbc, [Din, N, N], -1)
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt + p["dt_bias"])                  # (B, S, H)
    A = -torch.exp(p["A_log"])
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(xs)
    cum = torch.cumsum((dt * A).double(), dim=1)        # (B, S, H)
    cb = Cm @ Bm.transpose(1, 2)                        # (B, S_i, S_j)
    # blocks of rows and heads, so that the (S, S) weights fit
    rb = max(1, min(B, (1 << 27) // (S * S * 16)))
    for b0 in range(0, B, rb):
        bs = slice(b0, b0 + rb)
        for h0 in range(0, H, 16):
            hs = slice(h0, h0 + 16)
            seg = (cum[bs, :, None, hs] - cum[bs, None, :, hs]).float()
            decay = torch.where(causal[..., None], torch.exp(seg), 0.0)
            mix = cb[bs, ..., None] * decay * dt[bs, None, :, hs]
            y[bs, :, hs] = torch.einsum("bijh,bjhp->bihp", mix,
                                        xs[bs, :, hs])
    y = y + xs * p["D"][:, None]
    g = y.reshape(B, S, Din) * F.silu(z)
    return rms_norm(g, p["norm"]["scale"], m["norm_eps"]) @ p["out_proj"]


@torch.no_grad()
def proj_err(m: dict, seed: int, layer: int, pairs: list,
             weights: str | None = None) -> float:
    """The widest relative error (Frobenius norm of the difference over
    the reference's) of a Mamba2 block's recorded projections: each
    program output against the float32 product of the program's own
    input to it with the layer's in_proj or out_proj, told by shape.
    Raises where a pair matches neither."""
    full_precision()
    p = prepare(W.layer(m, seed, layer, pairs[0][0].device),
                weights)["mamba"]
    worst = 0.0
    for x, y in pairs:
        shape = (x.shape[-1], y.shape[-1])
        w = [p[k] for k in ("in_proj", "out_proj") if p[k].shape == shape]
        if not w:
            raise ValueError(f"no projection of shape {shape}")
        ref = x.float() @ w[0]
        worst = max(worst, float(torch.linalg.vector_norm(y.float() - ref)
                                 / torch.linalg.vector_norm(ref)))
    return worst


@torch.no_grad()
def forward(m: dict, seed: int, tokens: torch.Tensor, at: torch.Tensor, *,
            weights: str | None = None, groups: str = "all", routes=None):
    """Logits (f32) at the (row, position) pairs where `at` (B, S) is
    true, in row-major order.  `weights`: None serves the dense draws,
    "int8"/"int4" their per-channel codes.  `routes`: per layer, the
    program's expert ids (B, S, k) to judge and follow (moe only).
    Returns {"logits", "routes" (the ids used, per layer),
    "route_margin", "route_differ"}."""
    full_precision()
    dev = tokens.device
    top = prepare(W.top(m, seed, dev), None)
    h = top["embed"][tokens]
    used, margin, differ = [], 0.0, 0
    eps = m["norm_eps"]
    for i in range(m["num_layers"]):
        lp = prepare(W.layer(m, seed, i, dev), weights)
        if m["family"] == "ssm":
            h = h + mamba2(lp["mamba"], rms_norm(h, lp["norm"]["scale"], eps),
                           m)
            continue
        h = h + attention(lp["attn"], rms_norm(h, lp["attn_norm"]["scale"],
                                               eps), m)
        if "mlp" in lp:
            x = rms_norm(h, lp["mlp_norm"]["scale"], eps)
            h = h + (F.silu(x @ lp["mlp"]["w_gate"]) * (x @ lp["mlp"]["w_up"])
                     ) @ lp["mlp"]["w_down"]
            continue
        y, ids, mg, df = moe(lp["moe"], rms_norm(h, lp["mlp_norm"]["scale"],
                                                 eps), m, groups,
                             None if routes is None else routes[i])
        h = h + y
        used.append(ids)
        margin, differ = max(margin, mg), differ + df
        del lp
    h = rms_norm(h[at], top["final_norm"]["scale"], eps)
    unembed = top["embed"].t() if m["tie_embeddings"] else top["unembed"]
    return {"logits": h @ unembed, "routes": used, "route_margin": margin,
            "route_differ": differ}
