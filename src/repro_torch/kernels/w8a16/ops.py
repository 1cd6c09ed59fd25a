"""W8A16 matmul wrapper: the device of the tensors picks the path.

y = x @ (q * s) for an int8 weight {"q", "s"} (`models/quant.py`), read
as stored: x (..., K) bf16 (M rows in all) against q (K, N) int8 and s
(N,) f32, giving (..., N); or E matrices at once, x (E, M, K) against q
(E, K, N) and s (E, N), giving (E, M, N).  CPU tensors take the plain version
(`ref.py::w8a16_ref`, exactly `x @ wcast(w, x.dtype)`).  CUDA tensors
launch the hand-written kernel `csrc/w8a16_gemm.cu` (one launch, its
blocks cut by `grid`), or raise; nothing falls back.  It takes the shapes
`takes` admits: at most MAX_ROWS rows a matrix, K a multiple of 8 and N
of 16 (every int8 matmul of the configured archs).  `launches` counts
kernel launches; `launches_by_variant["mma"]` is the same count under the
kernel's name.

A launch's grid is worked out once per (device, shapes).  The kernel's
workspace (f32 partials, two slots a block) and its counters (one a
column tile; zeroed when allocated, and every call leaves them at zero)
are kept per device, grown when a call needs more, and shared by every
call: make the calls from one CUDA stream.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import _build, refuse_grad
from .ref import BN, iterations, w8a16_ref

MAX_ROWS = 64       # rows a matrix: 8 mma tiles of 8
THREADS = 128       # csrc/w8a16_gemm.cu
MIN_ITERS = 8       # k tiles a block at least: 32 KB of weight

launches = 0
launches_by_variant = {"mma": 0}

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_GRIDS: dict = {}       # (device, E, M, K, N) -> blocks
_SCRATCH: dict = {}     # device -> (workspace f32, counters int32)


def takes(M: int, K: int, N: int) -> bool:
    """Whether the kernel takes M rows a matrix against a (K, N) weight:
    16-byte rows of the weight and of x, at most MAX_ROWS rows."""
    return (1 <= M <= MAX_ROWS and K >= 8 and K % 8 == 0 and N >= 16
            and N % 16 == 0)


def grid(E: int, K: int, N: int, blocks_per_sm: int,
         sm_count: int = 132) -> int:
    """Blocks of a launch, from the shapes and the card: every block the
    SMs hold at once, but no fewer than MIN_ITERS k tiles a block, so
    that a small matrix is not cut into partials that cost more to merge
    than to read."""
    _, _, total = iterations(E, K, N)
    return max(1, min(blocks_per_sm * sm_count, total // MIN_ITERS))


def row_tiles(M: int) -> int:
    """The 8-row tiles the kernel pads M rows to: 1, 2, 4 or 8 (its four
    instantiations)."""
    return 1 << (-(-M // 8) - 1).bit_length()


def workspace_floats(blocks: int, M: int) -> int:
    """f32 workspace of a launch: two slots a block, each 8 * row_tiles(M)
    accumulators a thread."""
    return blocks * 2 * 8 * row_tiles(M) * THREADS


def zero_launches() -> None:
    global launches
    launches = 0
    launches_by_variant["mma"] = 0


def w8a16_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x @ (w["q"] * w["s"]) in x's dtype; see the module's note."""
    refuse_grad("w8a16_matmul", x, w["s"])
    if x.device.type == "cpu":
        return w8a16_ref(x, w)
    return _launch(x, w["q"], w["s"])


@functools.cache
def _kernel():
    lib = _build.load("w8a16_gemm")
    fn = lib.w8a16_gemm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    occ = lib.w8a16_gemm_blocks_per_sm
    occ.argtypes, occ.restype = [ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    return lib, fn, occ


@functools.cache
def blocks_per_sm(device: torch.device, M: int) -> int:
    """Blocks of the instantiation M rows take an SM holds at once on
    `device`."""
    lib, _, occ = _kernel()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib, occ(M, ctypes.byref(n)), "w8a16_gemm occupancy")
    if n.value < 1:
        raise RuntimeError(f"w8a16_gemm: no block of {M} rows fits an SM")
    return n.value


def _grid(device, E: int, M: int, K: int, N: int) -> int:
    """`grid`'s blocks for these shapes on `device`, worked out once."""
    key = (device, E, M, K, N)
    blocks = _GRIDS.get(key)
    if blocks is None:
        blocks = grid(E, K, N, blocks_per_sm(device, 8 * row_tiles(M)),
                      _build.sm_count(device))
        _GRIDS[key] = blocks
    return blocks


def _scratch(device, floats: int, tiles: int):
    """The device's workspace and counters, grown to hold a call."""
    ws, counters = _SCRATCH.get(device, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(tiles, dtype=torch.int32, device=device)
    _SCRATCH[device] = (ws, counters)
    return ws, counters


def _launch(x, q, s, blocks=None):
    """Launch the kernel; `blocks` defaults to `grid`'s choice (a caller
    may set it to run the kernel on other cuts of the same product)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul: no kernel for {x.device}")
    batched = q.dim() == 3
    if q.dim() not in (2, 3) or s.dim() != q.dim() - 1 \
            or (x.dim() != 3 if batched else x.dim() < 1) \
            or x.shape[-1] != q.shape[-2] or s.shape[-1] != q.shape[-1] \
            or (batched and not x.shape[0] == q.shape[0] == s.shape[0]):
        raise ValueError(f"w8a16_matmul: bad shapes x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} s{tuple(s.shape)}")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise TypeError(f"w8a16_matmul: dtypes {x.dtype}, {q.dtype}, "
                        f"{s.dtype} (the kernel takes bf16, int8, float32)")
    E = q.shape[0] if batched else 1
    K, N = q.shape[-2], q.shape[-1]
    M = x.numel() // (E * K)
    if not takes(M, K, N):
        raise ValueError(f"w8a16_matmul: unsupported shapes: {M} rows "
                         f"against ({K}, {N}); the kernel takes 1 to "
                         f"{MAX_ROWS} rows, K % 8 == 0 and N % 16 == 0")
    idx = x.get_device()
    if q.get_device() != idx or s.get_device() != idx \
            or not (x.is_contiguous() and q.is_contiguous()
                    and s.is_contiguous()) \
            or (x.data_ptr() | q.data_ptr() | s.data_ptr()) % 16:
        raise ValueError("w8a16_matmul: tensors must be contiguous, "
                         "16-byte aligned and on one device")
    if blocks is None:
        blocks = _grid(x.device, E, M, K, N)
    ws, counters = _scratch(x.device, workspace_floats(blocks, M),
                            E * -(-N // BN))
    y = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    lib, fn, _ = _kernel()
    # the raw stream handle: torch.cuda.current_stream builds a Stream
    # object, 6.7 us a call against 0.12 on an H100's host; the device
    # guard only when x is not on the current device
    guard = contextlib.nullcontext() if idx == torch.cuda.current_device() \
        else torch.cuda.device(idx)
    with guard:
        status = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                    ws.data_ptr(), counters.data_ptr(), E, M, K, N, blocks,
                    torch._C._cuda_getCurrentRawStream(idx))
    _build.check(lib, status, "w8a16_gemm")
    launches += 1
    launches_by_variant["mma"] += 1
    return y
