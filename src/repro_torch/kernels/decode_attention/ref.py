"""Plain PyTorch oracles for single-query decode attention.

`decode_attention_ref` is a port of `repro/kernels/decode_attention/
ref.py`.  `decode_attention_split` computes the same function the way
`csrc/decode_attention.cu` does: the live cache range cut into tiles of
`split_tile` rows, each split's share of the tiles reduced to a partial
(max, sum, unnormalised output), the partials merged by log-sum-exp in
split order.
"""

from __future__ import annotations

import torch

TILE_BYTES = 4096   # of K per tile of the kernel's f32 ring (csrc)
MMA_TILE = 64       # rows per tile of the bf16 (tensor-core) path


def split_tile(hd: int, itemsize: int) -> int:
    """Cache rows per tile of the kernel: 64 in bf16 (16 per warp); in f32
    the largest power of two whose rows of K fit in TILE_BYTES."""
    if itemsize == 2:
        return MMA_TILE
    return 1 << ((TILE_BYTES // (hd * itemsize)).bit_length() - 1)


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


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length, *, window: int = 0,
                           splits: int, tile: int | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """The split kernel's algorithm.  Shapes as `decode_attention_ref`.
    The live range is cut into tiles of `tile` rows (default: the
    kernel's `split_tile`); split i takes tiles [i * per, (i + 1) * per)
    with per = ceil(tiles / splits), and may be empty.  Each split gives
    (m, l, acc) in f32; o = sum_i exp(m_i - M) acc_i / sum_i exp(m_i - M)
    l_i over the non-empty splits, in split order, and 0 where none is."""
    B, H, hd = q.shape
    _, Hkv, T, _ = k_cache.shape
    if scale is None:
        scale = hd ** -0.5
    if tile is None:
        tile = split_tile(hd, q.element_size())
    length = int(length)
    start = max(0, length - window) if window > 0 else 0
    end = max(start, min(length, T))           # the live range [start, end)
    ntiles = -(-(end - start) // tile)
    per = -(-ntiles // splits)
    kk = k_cache.repeat_interleave(H // Hkv, dim=1).float()
    vv = v_cache.repeat_interleave(H // Hkv, dim=1).float()
    qf = q.float()
    M = torch.full((B, H), float("-inf"), device=q.device)
    parts = []
    for i in range(splits):
        lo = start + min(ntiles, i * per) * tile
        hi = min(end, start + min(ntiles, (i + 1) * per) * tile)
        if lo >= hi:
            continue                                   # an empty split
        s = torch.einsum("bhd,bhtd->bht", qf, kk[:, :, lo:hi]) * scale
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bht,bhtd->bhd", p, vv[:, :, lo:hi])))
        M = torch.maximum(M, m)
    L = torch.zeros((B, H), device=q.device)
    A = torch.zeros((B, H, hd), device=q.device)
    for m, l, acc in parts:                            # split order
        w = torch.exp(m - M)
        L = L + w * l
        A = A + w[..., None] * acc
    out = torch.where(L[..., None] > 0, A / L.clamp_min(1e-30)[..., None],
                      0.0)
    return out.to(q.dtype)
