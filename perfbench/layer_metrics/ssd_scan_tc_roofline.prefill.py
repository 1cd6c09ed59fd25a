"""The tensor-core SSD scan's share of its roofline over the traced
slice, in %: each call's lower-triangle operations or bytes, whichever
bounds, over the device time of all three of its launches (chunk states,
state passing, chunk scan).  Checked against the launch counter, which
counts the three."""

from perfbench.records import device_s, need
from perfbench.roofline.counts import ssd_scan
from perfbench.roofline.peaks import bound_s


def read(records: dict) -> float:
    need(records, "calls", "m", "batch", "seq")
    m = records["m"]
    calls = m["num_layers"] * records["calls"]
    secs = device_s(records, r"ssd_chunk_state_kernel|ssd_state_pass_kernel"
                    r"|ssd_chunk_scan_kernel", 3 * calls, "ssd_scan.tc")
    Din = m["ssm_expand"] * m["d_model"]
    one = bound_s(*ssd_scan(records["batch"], records["seq"],
                            Din // m["ssm_head_dim"], m["ssm_head_dim"],
                            m["ssm_state"], m["ssm_chunk"]))
    return 100.0 * calls * one / secs
