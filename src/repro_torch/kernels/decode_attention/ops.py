"""Decode attention wrapper: the device of the tensors picks the path.

CPU tensors take the plain version (`ref.py::decode_attention_ref`).
CUDA tensors launch the hand-written kernel `csrc/decode_attention.cu`
(one launch: the cache axis split over `num_splits` blocks per unit,
merged in the same launch), or raise; nothing falls back.  `launches`
counts kernel launches; `launches_by_variant["split"]` is the same count
under the kernel's name.

The kernel's workspace (partials and one ticket counter per unit) is
allocated once per (device, shape) and cached.  The counters are zeroed
when allocated and every call leaves them at zero, so two calls that run
concurrently on two CUDA streams must not share a workspace: issue calls
of one shape from one stream.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, refuse_grad
from .ref import decode_attention_ref, split_tile

MIN_SPLIT_ROWS = 320          # five 64-row tiles: no split of T is shorter
INFLIGHT_PER_SM = 96 * 1024   # bytes of K/V loads to keep in flight an SM

launches = 0
launches_by_variant = {"split": 0}

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])
_WORKSPACES: dict[tuple, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def heads_per_block(rep: int, dtype: torch.dtype) -> int:
    """q heads a block takes together: 8 in bf16 (the m16 tensor-core
    operand's rows 0..7); in f32 the smallest of 1, 2, 4 that holds a kv
    head's `rep` q heads, else 8.  More than 8 take several blocks."""
    if dtype == torch.bfloat16:
        return 8
    return next((r for r in (1, 2, 4) if rep <= r), 8)


def ring_bytes(hd: int, dtype: torch.dtype) -> int:
    """Bytes of K and V a block keeps in flight: its cp.async ring, 3
    stages of 64-row tiles in bf16 (2 at hd 256), 4 stages of
    `split_tile` rows in f32 (csrc/decode_attention.cu)."""
    elt = 2 if dtype == torch.bfloat16 else 4
    stages = (2 if hd > 128 else 3) if elt == 2 else 4
    return stages * 2 * split_tile(hd, elt) * hd * elt


def num_splits(units: int, T: int, ring: int, sm_count: int = 132) -> int:
    """Blocks along the cache axis per unit, from the shapes only (never
    from `length`): enough blocks that their rings (`ring` bytes each)
    hold about INFLIGHT_PER_SM bytes of loads an SM, and no split under
    MIN_SPLIT_ROWS rows of the cache.  A decode step is bound by memory
    latency until that much is in flight; past it, more blocks only add
    partials to merge (chip_smoke.py times the choice against one split
    fewer and more; PERF.md)."""
    want = round(sm_count * INFLIGHT_PER_SM / (units * ring))
    return max(1, min(want, T // MIN_SPLIT_ROWS))


def zero_launches() -> None:
    global launches
    launches = 0
    launches_by_variant["split"] = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, Hkv, T, hd); length: int32 0-d tensor (or
    int), the number of valid cache positions; positions >= min(length, T)
    and, with a window, < length - window are masked.  Returns (B, H, hd)
    in q's dtype."""
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length,
                                    window=window)
    return _launch(q, k_cache, v_cache, length, window)


@functools.cache
def _kernel():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


def _workspace(device, units, splits, rg, hd):
    """(ws_ml, ws_acc, counters) for splits > 1; one split needs none."""
    if splits == 1:
        return None
    key = (device, units, splits, rg, hd)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = (torch.empty((units, splits, 2, rg), dtype=torch.float32,
                          device=device),
              torch.empty((units, splits, rg, hd), dtype=torch.float32,
                          device=device),
              torch.zeros((units,), dtype=torch.int32, device=device))
        _WORKSPACES[key] = ws
    return ws


def _launch(q, k_cache, v_cache, length, window, splits=None):
    """Launch the kernel; `splits` defaults to num_splits' choice (a
    caller may set it to time the kernel at other split counts)."""
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
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("decode_attention: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    if not isinstance(length, torch.Tensor):
        length = torch.tensor(int(length), dtype=torch.int32,
                              device=q.device)
    if length.dtype != torch.int32 or length.numel() != 1 \
            or length.device != q.device:
        raise ValueError("decode_attention: length must be one int32 on "
                         "q's device")
    rep = H // Hkv
    rg = heads_per_block(rep, q.dtype)
    units = B * Hkv * -(-rep // rg)
    if splits is None:
        splits = num_splits(units, T, ring_bytes(hd, q.dtype),
                            _build.sm_count(q.device))
    ws = _workspace(q.device, units, splits, rg, hd)
    ws_ptrs = [t.data_ptr() for t in ws] if ws else [None] * 3
    out = torch.empty_like(q)
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    out.data_ptr(), length.data_ptr(), *ws_ptrs,
                    _build.DTYPE_CODE[q.dtype], B, H, Hkv, T, hd,
                    int(window), rg, splits, hd ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "decode_attention")
    launches += 1
    launches_by_variant["split"] += 1
    return out
