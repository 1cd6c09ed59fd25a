"""Flash attention wrappers: the device of the tensors picks the path.

CPU tensors take the plain version (`ref.py`).  CUDA tensors launch the
hand-written kernel `csrc/flash_attention.cu`, or raise; nothing falls
back.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, Hkv, hd) -> (B, S, H, hd), the layout
    the model uses."""
    o = flash_attention_bhsd(q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(),
                             causal=causal, window=window)
    return o.transpose(1, 2)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, Hkv, Sk, hd) -> (B, H, Sq, hd)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


def _launch(q, k, v, causal, window):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Bk, Hkv, Sk, hdk = k.shape
    if Bk != B or hdk != hd or H % Hkv or hd not in _build.HEAD_DIMS \
            or Sq < 1 or Sk < 1 or B * H > 65535:
        raise ValueError(f"flash_attention: unsupported shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)}")
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention: tensors must be contiguous "
                             "and on one device")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    _build.DTYPE_CODE[q.dtype], B, H, Hkv, Sq, Sk, hd,
                    int(bool(causal)), int(window), hd ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "flash_attention")
    launches += 1
    return out
