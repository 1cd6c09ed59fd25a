"""Flash attention wrappers: the device of the tensors picks the path.

`variant` picks a kernel from the dtype and head dim, deterministically:
- "wgmma": bf16 at head dim 64, 96, 112, 128 or 256 (every head dim a
  config uses), `csrc/flash_attention_wgmma.cu` (tensor cores);
- "fma": f32 at every head dim in `_build.HEAD_DIMS`, and bf16 at 16 and
  32 (the reference's test shapes), `csrc/flash_attention.cu` (f32 FMAs);
and raises on anything else.  `fma_tiling` picks the fma kernel's launch
shape from the shapes alone: query rows a block (64, 32 or 16), so that
its grid fills the card at short sequences, and whether two warps split
each row group's head dim.  CPU tensors take the variant's plain
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
Q_TILES = (64, 32, 16)        # the fma kernel's query rows a block
HD_SPLITS = (1, 2)            # its warps a 16-row group
SOURCES = {"wgmma": "flash_attention_wgmma", "fma": "flash_attention"}
PLAIN = {"wgmma": functools.partial(attention_ref, round_p=True),
         "fma": attention_ref}

launches = 0
launches_by_variant = {name: 0 for name in SOURCES}

_ARGTYPES = {
    "fma": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
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


def fma_tiling(B: int, H: int, Sq: int, hd: int,
               sm_count: int = 132) -> tuple[int, int]:
    """The fma kernel's launch shape, from the shapes only: (query rows a
    block, warps a 16-row group).  Rows: the largest of Q_TILES whose grid
    (B * H * ceil(Sq / rows) blocks) gives every SM a block, else the
    smallest; long sequences keep 64-row tiles (four row groups share each
    K/V tile), and S = 64 at SmolLM-360M's 30 (b, h) pairs takes 16 (120
    blocks, not 30).  Two warps split a group's head dim where a block's
    own latency is the time (under two blocks an SM) and at hd 256, where
    one warp a group leaves 4 warps an SM (shared memory holds one
    block)."""
    rows = next((r for r in Q_TILES if B * H * -(-Sq // r) >= sm_count),
                Q_TILES[-1])
    few = B * H * -(-Sq // rows) < 2 * sm_count
    return rows, 2 if few or hd >= 256 else 1


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


def _launch(var, q, k, v, causal, window, tiling=None):
    """Launch variant `var`; the fma kernel takes `tiling` (query rows a
    block, warps a row group; default: `fma_tiling`'s choice)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Bk, Hkv, Sk, hdk = k.shape
    if var == "fma" and tiling is None:
        tiling = fma_tiling(B, H, Sq, hd, _build.sm_count(q.device))
    rows = tiling[0] if var == "fma" else 128
    # grid: (B * H, q tiles of `rows`)
    grid_ok = B * H < 2 ** 31 and -(-Sq // rows) <= 65535
    if var == "fma" and (rows not in Q_TILES or tiling[1] not in HD_SPLITS):
        raise ValueError(f"flash_attention: no fma tiling {tiling}")
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
        if var == "fma" and t.data_ptr() % 16:
            raise ValueError("flash_attention: fma copies 16-byte chunks; "
                             "tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _build.load(SOURCES[var])
    fn = getattr(lib, f"{SOURCES[var]}_launch")
    fn.argtypes, fn.restype = _ARGTYPES[var], ctypes.c_int
    dtype_arg = [] if var == "wgmma" else [_build.DTYPE_CODE[q.dtype]]
    tiling_arg = [] if var == "wgmma" else list(tiling)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    *dtype_arg, B, H, Hkv, Sq, Sk, hd, int(bool(causal)),
                    int(window), *tiling_arg, hd ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, f"flash_attention ({var})")
    launches_by_variant[var] += 1
    launches += 1
    return out
