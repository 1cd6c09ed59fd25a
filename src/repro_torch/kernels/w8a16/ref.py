"""Plain PyTorch versions of the W8A16 product y = x @ (q * s).

`w8a16_ref` is what every matmul site computed before the kernel, and
what it still computes off the kernel: `x @ wcast(w, x.dtype)`, the int8
weight dequantized to the activation's dtype, then multiplied.

`stream_k` computes the product the way `csrc/w8a16_gemm.cu` cuts it, in
f32: the flat space of (matrix, BN-column tile, BK-row k tile)
iterations split into `blocks` equal contiguous runs (`run_start`,
`owner`), each block's share of a column tile summed alone, and a tile
cut across blocks merged from their partials in block order, each
partial held in its block's first slot if the tile is the one the
block's run starts in, else in its second (`merge_plan`).
"""

from __future__ import annotations

import torch

BN = 128      # weight columns a tile (csrc/w8a16_gemm.cu)
BK = 64       # k rows a tile


def w8a16_ref(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x @ wcast(w, x.dtype): x (M, K) against q (K, N), or (E, M, K)
    against (E, K, N)."""
    # models/quant.py imports this package's wrapper
    from ...models.quant import wcast
    return x @ wcast(w, x.dtype)


def iterations(E: int, K: int, N: int) -> tuple[int, int, int]:
    """(column tiles a matrix, k tiles a column tile, iterations)."""
    nt, it = -(-N // BN), -(-K // BK)
    return nt, it, E * nt * it


def run_start(b: int, total: int, blocks: int) -> int:
    """The first iteration of block b's run."""
    return b * total // blocks


def owner(i: int, total: int, blocks: int) -> int:
    """The block whose run holds iteration i."""
    return -(-(i + 1) * blocks // total) - 1


def merge_plan(E: int, K: int, N: int, blocks: int) -> list:
    """For each column tile, in order, the (block, slot, k tiles) shares
    that make it: one share with slot None when a block holds all of it
    (written directly), else one a block in block order, each in the
    workspace slot the kernel writes it to."""
    _, it, total = iterations(E, K, N)
    plan = []
    for t in range(total // it):
        b0, b1 = owner(t * it, total, blocks), owner((t + 1) * it - 1,
                                                     total, blocks)
        shares = []
        for b in range(b0, b1 + 1):
            lo = max(run_start(b, total, blocks), t * it) - t * it
            hi = min(run_start(b + 1, total, blocks), (t + 1) * it) - t * it
            slot = None if b0 == b1 else \
                (0 if run_start(b, total, blocks) // it == t else 1)
            shares.append((b, slot, range(lo, hi)))
        plan.append(shares)
    return plan


def stream_k(x: torch.Tensor, w: dict, blocks: int) -> torch.Tensor:
    """x (E, M, K) against q (E, K, N), s (E, N), in f32 and cut as the
    kernel cuts it over `blocks` blocks; (E, M, N) f32, before the
    kernel's rounding to bf16."""
    q, s = w["q"], w["s"]
    E, M, K = x.shape
    N = q.shape[-1]
    nt, _, _ = iterations(E, K, N)
    x32, q32 = x.float(), q.float()
    y = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    for t, shares in enumerate(merge_plan(E, K, N, blocks)):
        e, n0 = divmod(t, nt)
        n0 *= BN
        cols = slice(n0, min(n0 + BN, N))
        acc = torch.zeros((M, cols.stop - cols.start), dtype=torch.float32,
                          device=x.device)
        for _, _, ks in shares:
            rows = slice(ks.start * BK, min(ks.stop * BK, K))
            acc = acc + x32[e, :, rows] @ q32[e, rows, cols]
        y[e, :, cols] = acc * s[e, cols]
    return y
