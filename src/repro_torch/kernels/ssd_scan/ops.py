"""SSD scan wrapper: the device of the tensors picks the path.

CPU tensors take the plain version (`ref.py`).  CUDA tensors launch the
hand-written kernel `csrc/ssd_scan.cu`, or raise; nothing falls back.
`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_scan_ref

launches = 0

# what csrc/ssd_scan.cu is written for
HEAD_DIMS = (16, 32, 64)
STATES = (16, 32, 64, 128)
CHUNKS = (16, 32, 64, 128)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def ssd(x, dt, A, B, C, *, chunk: int = 128, head_block: int = 8):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B/C: (b,s,g,n) with g == 1.
    Returns (y, None): decode keeps its own state path.  `head_block` is
    the TPU kernel's tiling of heads; it does not change the result and is
    accepted and ignored (the CUDA kernel runs one block per head)."""
    if B.dim() != 4 or B.shape[2] != 1 or C.shape != B.shape:
        raise ValueError(f"ssd: the kernel takes one B/C group, got "
                         f"B{tuple(B.shape)} C{tuple(C.shape)}")
    return ssd_scan(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk), None


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """x: (b,s,h,p); dt: (b,s,h) f32; A: (h,) f32; B/C: (b,s,n).
    Returns y: (b,s,h,p) in x's dtype."""
    if x.dim() != 4 or x.shape[1] % chunk:
        raise ValueError(f"ssd_scan: sequence of x{tuple(x.shape)} must be "
                         f"a multiple of chunk {chunk}")
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk)
    return _launch(x, dt, A, B, C, chunk)


def _launch(x, dt, A, B, C, chunk):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n) \
            or C.shape != B.shape:
        raise ValueError(f"ssd_scan: bad shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} A{tuple(A.shape)} "
                         f"B{tuple(B.shape)} C{tuple(C.shape)}")
    if p not in HEAD_DIMS or n not in STATES or chunk not in CHUNKS \
            or b * h > 2 ** 31 - 1:
        raise ValueError(f"ssd_scan: unsupported head dim {p}, state {n} "
                         f"or chunk {chunk}")
    if x.dtype not in _build.DTYPE_CODE or B.dtype != x.dtype \
            or C.dtype != x.dtype or dt.dtype != torch.float32 \
            or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dtypes x {x.dtype}, dt {dt.dtype}, "
                        f"A {A.dtype}, B {B.dtype}, C {C.dtype}")
    for t in (x, dt, A, B, C):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ssd_scan: tensors must be contiguous and on "
                             "one device")
    y = torch.empty_like(x)
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(), _build.DTYPE_CODE[x.dtype],
                    b, s, h, p, n, chunk,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "ssd_scan")
    launches += 1
    return y
