"""The traced slice's model FLOPs (every completed call: matmul weights,
causal attention or the SSD scan, the last position's unembedding) over
the slice's length times the bf16 peak, in %."""

from perfbench.harness import Missing
from perfbench.records import busy_s, need
from perfbench.roofline.counts import prefill_flops
from perfbench.roofline.peaks import BF16_FLOPS


def read(records: dict) -> float:
    need(records, "calls", "m", "batch", "seq", "window_s")
    busy_s(records)
    if not records["calls"]:
        raise Missing("no call in the traced slice")
    flops = records["calls"] * prefill_flops(records["m"], records["batch"],
                                             records["seq"])
    return 100.0 * flops / (records["window_s"] * BF16_FLOPS)
