"""Plain PyTorch oracle for single-query decode attention; a port of
`repro/kernels/decode_attention/ref.py`."""

from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length, *, window: int = 0,
                         scale: float | None = None) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, Hkv, T, hd); length: int or 0-d int
    tensor, the number of valid cache positions (may exceed T).
    Returns (B, H, hd)."""
    B, H, hd = q.shape
    _, Hkv, T, _ = k_cache.shape
    group = H // Hkv
    if scale is None:
        scale = hd ** -0.5
    kk = k_cache.repeat_interleave(group, dim=1).float()
    vv = v_cache.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhd,bhtd->bht", q.float(), kk) * scale
    pos = torch.arange(T, device=q.device)
    mask = pos < length
    if window:
        mask &= pos >= length - window
    s = s.masked_fill(~mask[None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bht,bhtd->bhd", p, vv).to(q.dtype)
