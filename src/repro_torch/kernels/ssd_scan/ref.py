"""Plain PyTorch oracles for the SSD scan; a port of
`repro/kernels/ssd_scan/ref.py`.

`ssd_sequential` is the ground truth (the direct recurrence, one step per
token).  `ssd_scan_ref` computes what the kernel computes: inputs upcast
to f32, the chunked algorithm (`models/mamba2.py::ssd_chunked`) in f32,
y cast back to x's dtype.
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
