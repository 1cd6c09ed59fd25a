"""The traced slice's model FLOPs (every occupied slot's token: its
matmul weights, attention over the shared position's rows, the
unembedding) over the slice's length times the bf16 peak, in %."""

from perfbench.harness import Missing
from perfbench.records import busy_s, need
from perfbench.roofline.counts import decode_token_flops
from perfbench.roofline.peaks import BF16_FLOPS


def read(records: dict) -> float:
    need(records, "steps", "m", "window_s")
    busy_s(records)
    if not records["steps"]:
        raise Missing("no step in the traced slice")
    flops = sum(active * decode_token_flops(records["m"], pos + 1)
                for pos, active in records["steps"])
    return 100.0 * flops / (records["window_s"] * BF16_FLOPS)
