"""Decode attention wrapper: the device of the tensors picks the path.

CPU tensors take the plain version (`ref.py`).  CUDA tensors launch the
hand-written kernel `csrc/decode_attention.cu`, or raise; nothing falls
back.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import decode_attention_ref

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, Hkv, T, hd); length: int32 0-d tensor (or
    int), the number of valid cache positions; positions >= min(length, T)
    and, with a window, < length - window are masked.  Returns (B, H, hd)
    in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length,
                                    window=window)
    return _launch(q, k_cache, v_cache, length, window)


def _launch(q, k_cache, v_cache, length, window):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    Bk, Hkv, T, hdk = k_cache.shape
    if Bk != B or hdk != hd or H % Hkv or hd not in _build.HEAD_DIMS:
        raise ValueError(f"decode_attention: unsupported shapes "
                         f"q{tuple(q.shape)} k{tuple(k_cache.shape)}")
    if q.dtype not in _build.DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    for t in (q, k_cache, v_cache):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention: tensors must be contiguous "
                             "and on one device")
    if not isinstance(length, torch.Tensor):
        length = torch.tensor(int(length), dtype=torch.int32,
                              device=q.device)
    if length.dtype != torch.int32 or length.numel() != 1 \
            or length.device != q.device:
        raise ValueError("decode_attention: length must be one int32 on "
                         "q's device")
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    out.data_ptr(), length.data_ptr(),
                    _build.DTYPE_CODE[q.dtype], B, H, Hkv, T, hd,
                    int(window), hd ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "decode_attention")
    launches += 1
    return out
