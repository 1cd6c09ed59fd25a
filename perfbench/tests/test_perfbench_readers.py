"""The per-layer readers and the trace's reduction on records made by
hand."""

import pytest

from perfbench_testing import ROOT, H

from perfbench import trace
from perfbench.roofline.counts import decode_token_flops
from perfbench.roofline.peaks import BF16_FLOPS

BENCH = H.load_benchmark(ROOT)
PHI = H.config_file(BENCH, "phi35moe-int8", ROOT)["model"]

RECORDS = {
    "kernels": [
        ("void at::native::unrolled_elementwise_kernel<copy>", 0.002,
         ("wcast", "moe_ffn")),
        ("void at::native::vectorized_elementwise_kernel<mul>", 0.001,
         ("moe_ffn",)),
        ("void at::native::reduce_kernel<sum>", 0.0005, ()),
        ("nvjet_tst_512x8_64x3", 0.003, ()),
    ],
    "busy_s": 0.008, "window_s": 0.010,
    "m": PHI, "slots": 32, "steps": [(40, 32), (41, 32)],
    "occupied": 300, "prompt_steps": 120, "window_steps": 10,
}


@pytest.mark.parametrize("name, want", [
    ("dequant_share.serve", 0.25), ("dequant_share.prefill", 0.25),
    ("elementwise_share.serve", 0.1875), ("idle_share.serve", 0.2),
    ("prompt_step_share.serve", 0.4), ("slot_occupancy.serve", 300 / 320),
])
def test_share_readers(name, want):
    assert H.reader(name)(RECORDS) == pytest.approx(want)


def test_mfu_serve_counts_every_occupied_slot():
    want = 32 * (decode_token_flops(PHI, 41) + decode_token_flops(PHI, 42))
    got = H.reader("mfu.serve")(RECORDS)
    assert got == pytest.approx(100 * want / (0.010 * BF16_FLOPS))


def test_readers_find_nothing_rather_than_zero():
    empty = dict(RECORDS, kernels=[], busy_s=0.0)
    for name in ("dequant_share.serve", "elementwise_share.prefill",
                 "idle_share.prefill", "mfu.serve"):
        with pytest.raises(H.Missing):
            H.reader(name)(empty)


def test_union_and_idle_gaps_by_host_activity():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("k3", 20.0, 25.0),
              ("k4", 40.0, 41.0)]
    busy, gaps = trace.union(device)
    assert busy == 12 + 5 + 1 and gaps == [(12.0, 20.0), (25.0, 40.0)]
    host = [(0.0, 50.0, "decode_step"), (13.0, 19.0, "aten::item"),
            (26.0, 30.0, "wcast")]
    assert trace.host_at(host, [16.0, 32.5]) == ["aten::item",
                                                "decode_step"]
    got = trace.breakdown(device, gaps, host)
    assert got["device_ops"][0] == ["k1", 10e-6]
    assert dict(got["idle_gaps"]) == {"aten::item": 8e-6,
                                      "decode_step": 15e-6}
