"""SSD scan wrapper: the device of the tensors picks the path.

`variant` picks a kernel from the dtype and shape, deterministically:
- "tc": bf16, `csrc/ssd_scan_tc.cu` (three launches: chunk states, state
  passing, chunk scan; chunk-parallel, products on the tensor cores);
- "fma": f32, `csrc/ssd_scan.cu` (the same three launches, all f32 on
  register-tiled FMAs, no TF32);
for head dims in `HEAD_DIMS`, states in `STATES` and chunks in `CHUNKS`,
and raises on anything else.  CPU tensors take the variant's plain
version (`PLAIN`, from `ref.py`).  CUDA tensors launch the variant's
hand-written kernels, or raise; nothing falls back.
`launches_by_variant` counts each variant's kernel launches, `launches`
their sum.  The fma kernel takes `heads_per_block(...)` heads per block
of its chunk-parallel steps; the tc kernel fixes its own (10).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, refuse_grad
from .ref import ssd_scan_chunked

# what both kernels are written for
HEAD_DIMS = (16, 32, 64)
STATES = (16, 32, 64, 128)
CHUNKS = (16, 32, 64, 128)
SOURCES = {"tc": "ssd_scan_tc", "fma": "ssd_scan"}
LAUNCHES_PER_CALL = {"tc": 3, "fma": 3}
PLAIN = {"tc": functools.partial(ssd_scan_chunked, bf16_points=True),
         "fma": functools.partial(ssd_scan_chunked, bf16_points=False)}

launches = 0
launches_by_variant = {name: 0 for name in SOURCES}

_ARGTYPES = {
    "fma": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "tc": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}


def variant(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The kernel that scans x of this dtype, head dim p, state n and
    chunk length."""
    if p not in HEAD_DIMS or n not in STATES or chunk not in CHUNKS:
        raise ValueError(f"ssd_scan: unsupported head dim {p}, state {n} "
                         f"or chunk {chunk}")
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"ssd_scan: no kernel for dtype {dtype}")


def heads_per_block(b: int, nc: int, h: int, p: int, n: int, q: int,
                    sm_count: int = 132) -> int:
    """Heads per block of the f32 kernel's chunk-parallel steps (grid
    b * nc x ceil(h / hb), one block per SM): the hb <= 10 that minimises
    waves x (hb heads' products + the block's one C B^T), so that short
    sequences still fill the SMs."""
    def cost(hb):
        waves = -(-b * nc * -(-h // hb) // sm_count)
        return waves * (hb * (2 * q * p * n + q * q * p) + 2 * q * q * n)
    return min(range(1, 11), key=lambda hb: (cost(hb), -hb))


def zero_launches() -> None:
    global launches
    launches = 0
    for name in launches_by_variant:
        launches_by_variant[name] = 0


def ssd(x, dt, A, B, C, *, chunk: int = 128, head_block: int = 8):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B/C: (b,s,g,n) with g == 1.
    Returns (y, None): decode keeps its own state path.  `head_block` is
    the TPU kernel's tiling of heads; it does not change the result and is
    accepted and ignored (the CUDA kernels choose their own)."""
    if B.dim() != 4 or B.shape[2] != 1 or C.shape != B.shape:
        raise ValueError(f"ssd: the kernel takes one B/C group, got "
                         f"B{tuple(B.shape)} C{tuple(C.shape)}")
    return ssd_scan(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk), None


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """x: (b,s,h,p); dt: (b,s,h) f32; A: (h,) f32; B/C: (b,s,n).
    Returns y: (b,s,h,p) in x's dtype."""
    refuse_grad("ssd_scan", x, dt, A, B, C)
    if x.dim() != 4 or x.shape[1] % chunk:
        raise ValueError(f"ssd_scan: sequence of x{tuple(x.shape)} must be "
                         f"a multiple of chunk {chunk}")
    var = variant(x.dtype, x.shape[-1], B.shape[-1], chunk)
    if x.device.type == "cpu":
        return PLAIN[var](x, dt, A, B, C, chunk)
    return _launch(var, x, dt, A, B, C, chunk)


@functools.cache
def _kernel(var):
    lib = _build.load(SOURCES[var])
    fn = getattr(lib, f"{SOURCES[var]}_launch")
    fn.argtypes, fn.restype = _ARGTYPES[var], ctypes.c_int
    return lib, fn


def _launch(var, x, dt, A, B, C, chunk):
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
    if b * h > 2 ** 31 - 1 or h > 65535 \
            or (var == "tc" and (h + 9) // 10 > 65535):
        raise ValueError(f"ssd_scan: unsupported batch {b} x heads {h}")
    if B.dtype != x.dtype or C.dtype != x.dtype \
            or dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dtypes x {x.dtype}, dt {dt.dtype}, "
                        f"A {A.dtype}, B {B.dtype}, C {C.dtype}")
    for t in (x, dt, A, B, C):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ssd_scan: tensors must be contiguous and on "
                             "one device")
    y = torch.empty_like(x)
    lib, fn = _kernel(var)
    # workspace: cum, each chunk's state contribution (then, for fma, the
    # state entering it, in place; tc keeps those in bf16)
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    if var == "tc":
        work = [torch.empty((b, s, h), **f32),
                torch.empty((b, nc, h, p, n), **f32),
                torch.empty((b, nc, h, p, n), dtype=torch.bfloat16,
                            device=x.device)]
        tail = []
    else:
        work = [torch.empty((b, s, h), **f32),
                torch.empty((b, nc, h, n, p), **f32)]
        tail = [heads_per_block(b, nc, h, p, n, chunk,
                                _build.sm_count(x.device))]
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(),
                    *(t.data_ptr() for t in work), b, s, h, p, n, chunk,
                    *tail, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, f"ssd_scan ({var})")
    launches_by_variant[var] += LAUNCHES_PER_CALL[var]
    launches += LAUNCHES_PER_CALL[var]
    return y
