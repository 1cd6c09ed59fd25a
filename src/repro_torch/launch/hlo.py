"""Collective inventory and per-device link bytes; the port of
`repro/launch/hlo.py`, which parses the compiled HLO text.

The port has no HLO: `CollectiveInventory` is a
`torch.distributed.tensor.debug.CommDebugMode` that also records, for
every collective the step issues, its kind, the size N of its process
group and its result bytes.  It sees the c10d ops the port calls
directly (`dist.all_reduce`, `all_gather_into_tensor`,
`reduce_scatter_tensor`, `all_to_all_single`, the send of
`batch_isend_irecv`), the functional collectives and those DTensor
issues; CommDebugMode's own counts leave out send/recv, which are
counted here as collective-permute.  For each collective the bytes a
single device moves over its links under ring algorithms are the
reference's:

    all-gather      : (N-1)/N × result_bytes
    reduce-scatter  : (N-1)   × result_bytes          (input = N × result)
    all-reduce      : 2(N-1)/N × result_bytes
    all-to-all      : (N-1)/N × result_bytes
    collective-permute : result_bytes

A collective over a group of one moves nothing (XLA removes such ops
from the module; here they run, and are counted with 0 link bytes).
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string ("f32[8,128]", "(bf16[4], s32[2])")."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dtype]
    return total


def ring_link_bytes(op: str, result_bytes: float, n: int) -> float:
    """Bytes one device moves for collective `op` over a group of `n`."""
    if op == "collective-permute":
        return float(result_bytes)
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return (n - 1) / n * result_bytes
    if op == "reduce-scatter":
        return float((n - 1) * result_bytes)
    if op == "all-reduce":
        return 2 * (n - 1) / n * result_bytes
    if op == "all-to-all":
        return (n - 1) / n * result_bytes
    raise ValueError(op)


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=lambda: defaultdict(int))
    result_bytes: dict = field(default_factory=lambda: defaultdict(int))
    link_bytes: dict = field(default_factory=lambda: defaultdict(float))

    @property
    def total_link_bytes(self) -> float:
        return sum(self.link_bytes.values())

    def add(self, op: str, result_bytes: int, n: int) -> None:
        self.counts[op] += 1
        self.result_bytes[op] += result_bytes
        self.link_bytes[op] += ring_link_bytes(op, result_bytes, n)

    def table(self) -> list[dict]:
        return [{"op": op, "count": self.counts[op],
                 "result_bytes": self.result_bytes[op],
                 "link_bytes_per_chip": self.link_bytes[op]}
                for op in sorted(self.counts)]


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(args) -> int:
    """N from the op's process group: a boxed ProcessGroup, or for the
    functional ops the group's name, their last string argument."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue            # a ReduceOp
    name = [a for a in args if isinstance(a, str)][-1]
    return dist.distributed_c10d._resolve_process_group(name).size()


# op name -> (kind, how its result bytes are read from (args, out, N))
_OPS = {
    "c10d.allreduce_": ("all-reduce", lambda a, o, n: _nbytes(a[0])),
    "_c10d_functional.all_reduce": ("all-reduce",
                                    lambda a, o, n: _nbytes(a[0])),
    "_c10d_functional.all_reduce_": ("all-reduce",
                                     lambda a, o, n: _nbytes(a[0])),
    "c10d._allgather_base_": ("all-gather", lambda a, o, n: _nbytes(a[0])),
    "c10d.allgather_": ("all-gather", lambda a, o, n: _nbytes(a[0])),
    "c10d.allgather_into_tensor_coalesced_": (
        "all-gather", lambda a, o, n: _nbytes(a[0])),
    "_c10d_functional.all_gather_into_tensor": (
        "all-gather", lambda a, o, n: _nbytes(a[0]) * n),
    "c10d._reduce_scatter_base_": ("reduce-scatter",
                                   lambda a, o, n: _nbytes(a[0])),
    "c10d.reduce_scatter_": ("reduce-scatter", lambda a, o, n: _nbytes(a[0])),
    "_c10d_functional.reduce_scatter_tensor": (
        "reduce-scatter", lambda a, o, n: _nbytes(a[0]) // n),
    "c10d.alltoall_base_": ("all-to-all", lambda a, o, n: _nbytes(a[0])),
    "c10d.alltoall_": ("all-to-all", lambda a, o, n: _nbytes(a[0])),
    "_c10d_functional.all_to_all_single": ("all-to-all",
                                           lambda a, o, n: _nbytes(o)),
    # a ring step sends and receives: one permute a send
    "c10d.send": ("collective-permute", lambda a, o, n: _nbytes(a[0])),
}


class CollectiveInventory(CommDebugMode):
    """CommDebugMode that also keeps `stats`: per kind, the count, result
    bytes and ring link bytes of every collective in the block."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = str(func.overloadpacket)
        kind = _OPS.get(name)
        if kind is not None:
            n = _group_size(args)
            self.stats.add(kind[0], kind[1](args, out, n), n)
        return out
