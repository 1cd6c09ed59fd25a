"""Roofline terms from dry-run artifacts, on NVIDIA H100 SXM constants; a
port of `repro/launch/roofline.py` (the same fields and formulas, other
constants).

Terms (per device; the dry-run counts one rank's share of the step):
    compute    = flops / peak_flops
    memory     = bytes / hbm_bw
    collective = link_bytes_per_device / link_bw

plus MODEL_FLOPS (6·N·D train / 2·N·D forward, N_active for MoE) and the
useful-compute ratio MODEL_FLOPS / (flops × devices), which exposes remat
recompute and dispatch waste.

Constants: NVIDIA H100 Tensor Core GPU datasheet, SXM5 column.
- PEAK_FLOPS: 989 TFLOP/s BF16 dense (the datasheet's 1,979 is with
  2:4 sparsity).
- HBM_BW: 3.35 TB/s (HBM3).
- The link: an HGX H100 node holds 8 GPUs on NVLink 4 (900 GB/s
  bidirectional, 450 GB/s each way: NVLINK_BW); between nodes each GPU
  has one ConnectX-7 NDR InfiniBand port, 400 Gb/s = 50 GB/s each way
  (IB_NDR_BW).  Both axes of the 16×16 production mesh span 16 or more
  GPUs, i.e. at least two nodes, so a ring over either axis crosses
  InfiniBand and runs at its rate: LINK_BW = IB_NDR_BW.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from ..models.config import ModelConfig
from .shapes import SHAPES, ShapeSpec

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per H100 SXM
HBM_BW = 3.35e12             # bytes/s per H100 SXM (HBM3)
NVLINK_BW = 450e9            # bytes/s each way per GPU, NVLink 4, in a node
IB_NDR_BW = 50e9             # bytes/s each way per GPU, NDR 400 Gb/s
LINK_BW = IB_NDR_BW          # the production mesh's axes cross nodes


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    link_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    step_time_s: float          # max of the three terms (overlap-ideal)
    mfu: float                  # model_flops / (chips·peak·step_time)
    args_bytes_per_chip: float = 0.0
    temp_bytes_per_chip: float = 0.0

    def to_dict(self):
        return asdict(self)


def model_flops(cfg: ModelConfig, spec: ShapeSpec) -> float:
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    if spec.kind == "train":
        tokens = spec.seq_len * spec.global_batch
        return 6.0 * n * tokens
    if spec.kind == "prefill":
        tokens = spec.seq_len * spec.global_batch
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * spec.global_batch


def derive(arch: str, shape: str, mesh_name: str, chips: int,
           cost: dict, mem: object, link_bytes_per_chip: float,
           cfg: ModelConfig) -> Roofline:
    """The reference's fields ("chip" is one device; `hlo_*` keep their
    names for the readers of the record) from the per-device `cost`
    ({"flops", "bytes accessed"}) and `mem` (`argument_size_in_bytes`,
    `temp_size_in_bytes`, as the reference reads them)."""
    spec = SHAPES[shape]
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    coll_s = link_bytes_per_chip / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, spec)
    useful = mf / max(1.0, flops * chips)
    step = max(compute_s, memory_s, coll_s)
    mfu = mf / max(1e-12, chips * PEAK_FLOPS * step)
    args_b = getattr(mem, "argument_size_in_bytes", 0) if mem else 0
    temp_b = getattr(mem, "temp_size_in_bytes", 0) if mem else 0
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=flops, hlo_bytes_per_chip=byts,
        link_bytes_per_chip=link_bytes_per_chip,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=mf, useful_ratio=useful,
        step_time_s=step, mfu=mfu,
        args_bytes_per_chip=float(args_b), temp_bytes_per_chip=float(temp_b))
