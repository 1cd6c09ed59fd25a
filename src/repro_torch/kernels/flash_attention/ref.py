"""Plain PyTorch oracle for flash attention (GQA, causal, sliding window);
a port of `repro/kernels/flash_attention/ref.py`."""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float | None = None,
                  round_p: bool = False) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, Hkv, Sk, hd) -> (B, H, Sq, hd).

    All arithmetic in f32.  With `round_p`, the unnormalised
    probabilities exp(s - rowmax) are rounded to bf16 before P V and the
    row sums stay f32: the function of `csrc/flash_attention_wgmma.cu`,
    which feeds P to the tensor cores in bf16."""
    B, H, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    group = H // Hkv
    if scale is None:
        scale = hd ** -0.5
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    s = s.masked_fill(~mask, float("-inf"))
    if round_p:
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), 0.0, m)   # rows with no visible key
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd",
                         p.to(torch.bfloat16).float(), vv)
        return torch.where(l > 0, o / l, 0.0).to(q.dtype)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)       # fully masked rows give 0
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
