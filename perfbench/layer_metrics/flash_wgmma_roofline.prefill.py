"""The wgmma flash-attention kernel's share of its roofline over the
traced slice, in %: causal operations of each call (the bf16 peak bounds
them) over the kernels' device time.  One call a layer a prefill,
checked against the program's launch counter."""

from perfbench.records import device_s, need
from perfbench.roofline.counts import flash_causal
from perfbench.roofline.peaks import bound_s


def read(records: dict) -> float:
    need(records, "calls", "m", "batch", "seq")
    m, n = records["m"], records["m"]["num_layers"] * records["calls"]
    secs = device_s(records, r"flash_wgmma_kernel", n,
                    "flash_attention.wgmma")
    one = bound_s(*flash_causal(records["batch"], m["num_heads"],
                                m["num_kv_heads"], records["seq"],
                                m["head_dim"]))
    return 100.0 * n * one / secs
