"""Plain PyTorch oracles for the SSD scan; a port of
`repro/kernels/ssd_scan/ref.py`.

`ssd_sequential` is the ground truth (the direct recurrence, one step per
token).  `ssd_scan_ref` is the kernel's function the model's way: inputs
upcast to f32, the chunked algorithm (`models/mamba2.py::ssd_chunked`) in
f32, y cast back to x's dtype.  `ssd_chunk_states`, `ssd_state_passing`
and `ssd_chunk_scan` are the three steps of `csrc/ssd_scan.cu` (f32) and
`csrc/ssd_scan_tc.cu` (bf16), and `ssd_scan_chunked` composes them; with
`bf16_points` it rounds operands to bf16 where the tc kernel does.
"""

from __future__ import annotations

import torch

from ...models.mamba2 import ssd_chunked


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor):
    """Direct SSD recurrence.  x: (b,s,h,p); dt: (b,s,h); A: (h,);
    B/C: (b,s,g,n).  Returns (y in x's dtype, final state f32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2).float()      # (b,s,h,n)
    Ch = C.repeat_interleave(rep, dim=2).float()
    dt = dt.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)               # (b,h)
        state = state * decay[..., None, None] \
            + (dt[:, t, :, None] * x[:, t].float())[..., :, None] \
            * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """The kernel's function.  x: (b,s,h,p); dt: (b,s,h); A: (h,);
    B/C: (b,s,n) (one group).  Returns y (b,s,h,p) in x's dtype."""
    y, _ = ssd_chunked(x.float(), dt.float(), A.float(),
                       B.float()[:, :, None], C.float()[:, :, None], chunk)
    return y.to(x.dtype)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def ssd_chunk_states(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, chunk: int, bf16_points: bool = False):
    """Step 1.  x: (b,s,h,p); dt: (b,s,h); A: (h,); B: (b,s,n).  Returns
    cum (b,s,h) f32, the running sum of dt * A inside each chunk, and each
    chunk's contribution to the state, (b,nc,h,p,n) f32:
    sum_j exp(cum_last - cum_j) dt_j x_j B_j^T.  With `bf16_points` the
    weighted x is rounded to bf16 before the product."""
    b, s, h, p = x.shape
    n, nc = B.shape[-1], s // chunk
    dtc = dt.float().reshape(b, nc, chunk, h)
    cum = torch.cumsum(dtc * A.float(), dim=2)
    w = torch.exp(cum[:, :, -1:] - cum) * dtc             # (b,nc,q,h)
    wx = w[..., None] * x.float().reshape(b, nc, chunk, h, p)
    if bf16_points:
        wx = _bf16(wx)
    contrib = torch.einsum("bcjhp,bcjn->bchpn", wx,
                           B.float().reshape(b, nc, chunk, n))
    return cum.reshape(b, s, h), contrib


def ssd_state_passing(contrib: torch.Tensor, cum: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """Step 2.  The state entering each chunk, (b,nc,h,p,n) f32: zero for
    the first, then S <- exp(cum_last) S + contribution, chunk by chunk."""
    b, nc, h = contrib.shape[:3]
    decay = torch.exp(cum.reshape(b, nc, chunk, h)[:, :, -1])   # (b,nc,h)
    state = torch.zeros_like(contrib[:, 0])
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * decay[:, c, :, None, None] + contrib[:, c]
    return torch.stack(entering, dim=1)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, s_in: torch.Tensor,
                   chunk: int, bf16_points: bool = False) -> torch.Tensor:
    """Step 3.  y (b,s,h,p) f32: exp(cum_i) C_i . S_c + sum_{j <= i} L_ij
    x_j with L = (C B^T) exp(cum_i - cum_j) dt_j, 0 above the diagonal
    (masked before exp, which would give +inf there at strong decay).
    C B^T is one (q x q) matrix per (b, chunk), shared by the heads.  With
    `bf16_points` the entering state and L are rounded to bf16 before
    their products."""
    b, s, h, p = x.shape
    n, nc = B.shape[-1], s // chunk
    Cc = C.float().reshape(b, nc, chunk, n)
    cb = torch.einsum("bcin,bcjn->bcij", Cc,
                      B.float().reshape(b, nc, chunk, n))      # (b,nc,q,q)
    cumt = cum.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)     # (b,nc,h,q)
    dtt = dt.float().reshape(b, nc, chunk, h).permute(0, 1, 3, 2)
    ii = torch.arange(chunk, device=x.device)
    above = ii[:, None] < ii[None, :]
    seg = (cumt[..., :, None] - cumt[..., None, :]).masked_fill(
        above, float("-inf"))
    L = cb[:, :, None] * torch.exp(seg) * dtt[..., None, :]    # (b,nc,h,q,q)
    if bf16_points:
        L, s_in = _bf16(L), _bf16(s_in)
    y = torch.einsum("bchij,bcjhp->bcihp", L,
                     x.float().reshape(b, nc, chunk, h, p))
    inter = torch.einsum("bcin,bchpn->bcihp", Cc, s_in)
    y = y + inter * torch.exp(cumt).permute(0, 1, 3, 2)[..., None]
    return y.reshape(b, s, h, p)


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, chunk: int,
                     bf16_points: bool = False) -> torch.Tensor:
    """The three steps composed.  x: (b,s,h,p); dt: (b,s,h); A: (h,);
    B/C: (b,s,n).  Returns y (b,s,h,p) in x's dtype.  With `bf16_points`,
    the function of `csrc/ssd_scan_tc.cu`: w x, the entering state and L
    rounded to bf16, everything else f32."""
    cum, contrib = ssd_chunk_states(x, dt, A, B, chunk, bf16_points)
    s_in = ssd_state_passing(contrib, cum, chunk)
    return ssd_chunk_scan(x, dt, cum, B, C, s_in, chunk,
                          bf16_points).to(x.dtype)
