"""The decode-attention kernel's share of its roofline over the traced
slice, in %: the sum over its calls of the least time the chip could
take (bytes of q, o and every slot's K and V rows up to the shared
position; the bytes bound it) over the kernels' device time.  One call
a layer a step, checked against the program's launch counter."""

from perfbench.records import device_s, need
from perfbench.roofline.counts import decode_attention
from perfbench.roofline.peaks import bound_s


def read(records: dict) -> float:
    need(records, "steps", "m", "slots")
    m, steps = records["m"], records["steps"]
    L = m["num_layers"]
    secs = device_s(records, r"decode_split_kernel", L * len(steps),
                    "decode_attention.split")
    bound = sum(L * bound_s(*decode_attention(
        records["slots"], m["num_heads"], m["num_kv_heads"], pos + 1,
        m["head_dim"])) for pos, _ in steps)
    return 100.0 * bound / secs
