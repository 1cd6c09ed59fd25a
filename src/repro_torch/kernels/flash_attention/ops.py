"""Flash attention wrappers: the device of the tensors picks the path.

`variant` picks a kernel from the dtype and head dim, deterministically:
- "wgmma": bf16 at head dim 64, 96, 112, 128 or 256 (every head dim a
  config uses), `csrc/flash_attention_wgmma.cu` (tensor cores);
- "fma": f32 at every head dim in `_build.HEAD_DIMS`, and bf16 at 16 and
  32 (the reference's test shapes), `csrc/flash_attention.cu` (f32 FMAs);
and raises on anything else.  CPU tensors take the variant's plain
version (`PLAIN`, from `ref.py`).  CUDA tensors launch the variant's
hand-written kernel, or raise; nothing falls back.  `launches_by_variant`
counts each kernel's launches, `launches` their sum.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, refuse_grad
from .ref import attention_ref

WGMMA_HEAD_DIMS = (64, 96, 112, 128, 256)
SOURCES = {"wgmma": "flash_attention_wgmma", "fma": "flash_attention"}
PLAIN = {"wgmma": functools.partial(attention_ref, round_p=True),
         "fma": attention_ref}

launches = 0
launches_by_variant = {name: 0 for name in SOURCES}

_ARGTYPES = {
    "fma": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p]),
    "wgmma": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
              + [ctypes.c_float, ctypes.c_void_p]),
}


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that computes attention at this dtype and head dim."""
    if dtype not in _build.DTYPE_CODE:
        raise TypeError(f"flash_attention: no kernel for dtype {dtype}")
    if head_dim not in _build.HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported head dim {head_dim}")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def zero_launches() -> None:
    global launches
    launches = 0
    for name in launches_by_variant:
        launches_by_variant[name] = 0


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
    refuse_grad("flash_attention", q, k, v)
    var = variant(q.dtype, q.shape[-1])
    if q.device.type == "cpu":
        return PLAIN[var](q, k, v, causal=causal, window=window)
    return _launch(var, q, k, v, causal, window)


def _launch(var, q, k, v, causal, window):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Bk, Hkv, Sk, hdk = k.shape
    # grid: fma (q tiles of 64, B * H), wgmma (B * H, q tiles of 128)
    grid_ok = (B * H <= 65535 if var == "fma"
               else B * H < 2 ** 31 and (Sq + 127) // 128 <= 65535)
    if Bk != B or hdk != hd or H % Hkv or Sq < 1 or Sk < 1 or not grid_ok:
        raise ValueError(f"flash_attention: unsupported shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention: tensors must be contiguous "
                             "and on one device")
    out = torch.empty_like(q)
    lib = _build.load(SOURCES[var])
    fn = getattr(lib, f"{SOURCES[var]}_launch")
    fn.argtypes, fn.restype = _ARGTYPES[var], ctypes.c_int
    dtype_arg = [] if var == "wgmma" else [_build.DTYPE_CODE[q.dtype]]
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    *dtype_arg, B, H, Hkv, Sq, Sk, hd, int(bool(causal)),
                    int(window), hd ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, f"flash_attention ({var})")
    launches_by_variant[var] += 1
    launches += 1
    return out
