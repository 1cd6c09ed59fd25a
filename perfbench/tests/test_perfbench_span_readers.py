"""The readers of the program's step tracer (`step_spans` and the six
`layer_metrics` that use it) on records made by hand: each gives the
value the records hold, and raises `Missing`, never 0, where the run
recorded nothing for it, as with a program that has no tracer."""

from types import SimpleNamespace

import pytest
import torch

from perfbench_testing import H

from perfbench import step_spans

SPAN_READERS = ["enqueue_ms.serve", "step_gap_ms.serve",
                "launch_idle_share.serve", "launch_idle_share.prefill",
                "expert_row_use.serve", "expert_row_use.prefill"]

MS = 1_000_000          # ns


def _serve_spans():
    """Six engine steps, two generations (steps 0-3 and 4-5): step k
    starts at k ms; its `model.decode_step` runs from 0.01 ms in for
    0.1 + 0.01k ms, its `engine.sync` ends at 0.8 - 0.02k ms in."""
    out = []
    for k in range(6):
        t = k * MS
        i = len(out)
        out.append(("engine.step", t, t + 900_000, -1, k))
        out.append(("model.decode_step", t + 10_000,
                    t + 10_000 + 100_000 + 10_000 * k, i, k))
        out.append(("engine.sync", t + 300_000, t + 800_000 - 20_000 * k,
                    i, k))
    return out


# step 2 is the profiled slice; on the profiler's clock (us) its
# decode_step runs 1000-1120, its device operations leave gaps 1020-1050
# and 1090-1130 in a slice of 200 us
RECORDS = {
    "spans": _serve_spans(), "slice_ids": [2], "gen_steps": [4, 2],
    "clock_offset_ns": 3 * MS, "trace_start_ns": 3 * MS + 1_010_000,
    "device": [("k1", 1000.0, 1020.0), ("k2", 1050.0, 1090.0),
               ("k3", 1130.0, 1150.0)],
    "busy_s": 80e-6, "window_s": 200e-6,
    "counters": {"moe.routed": 64, "moe.rows": 80}, "moe_kept": 60,
}


def _prefill_records():
    spans = [("model.prefill" if s[0] == "model.decode_step" else s[0],
              *s[1:]) for s in RECORDS["spans"]]
    return dict(RECORDS, spans=spans)


@pytest.mark.parametrize("name, records, want", [
    # outside the slice: 0.10, 0.11, 0.13, 0.14, 0.15 ms
    ("enqueue_ms.serve", RECORDS, 0.13),
    # steps 0->1 (0.21 ms) and 4->5 (0.29 ms); 1->2 and 2->3 touch the
    # slice, 3->4 crosses generations
    ("step_gap_ms.serve", RECORDS, 0.25),
    # 30 + 30 idle us inside the span, over 200 us
    ("launch_idle_share.serve", RECORDS, 0.3),
    ("launch_idle_share.prefill", _prefill_records(), 0.3),
    ("expert_row_use.serve", RECORDS, 0.75),
    ("expert_row_use.prefill", RECORDS, 0.75),
])
def test_span_readers(name, records, want):
    got = H.reader(name)(records)
    assert got == pytest.approx(want)
    if name.startswith("launch_idle_share"):
        assert got <= H.reader("idle_share.serve")(records)


# what a traced run of a program without the tracer records
PARENT = {k: RECORDS[k] for k in ("device", "busy_s", "window_s")}
PARENT["trace_start_ns"] = RECORDS["trace_start_ns"]


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_find_nothing_rather_than_zero(name):
    with pytest.raises(H.Missing):
        H.reader(name)(PARENT)


@pytest.mark.parametrize("name, records", [
    # every step inside the slice: nothing outside it
    ("enqueue_ms.serve", dict(RECORDS, slice_ids=list(range(6)))),
    ("step_gap_ms.serve", dict(RECORDS, gen_steps=[1] * 6)),
    ("launch_idle_share.serve", _prefill_records()),
    ("launch_idle_share.prefill", RECORDS),
    # a model with no MoE counts no dispatch
    ("expert_row_use.serve", dict(RECORDS, counters={"engine.steps": 6})),
    ("expert_row_use.prefill", dict(RECORDS, counters={})),
])
def test_span_readers_with_the_tracer_on_but_nothing_to_read(name, records):
    with pytest.raises(H.Missing):
        H.reader(name)(records)


def test_kept_entries_drop_the_last_experts_overwritten_entry():
    # capacity int(1.0 * 5 * 2 / 4) = 2; the last expert overflows with
    # 5 entries, expert 0 with 3: kept 2 + 1 + 1 + 2 - 1
    cfg = SimpleNamespace(num_experts=4, experts_per_token=2,
                          capacity_factor=1.0)
    idx = torch.tensor([[3, 0], [3, 0], [3, 0], [3, 1], [3, 2]])
    assert step_spans.kept_entries([idx], cfg) == 5
    # capacity 1, one entry an expert: every entry kept
    even = torch.tensor([[0, 1], [2, 3]])
    assert step_spans.kept_entries([even], cfg) == 4
    # capacity 1, the last expert's second entry dropped and its first
    # overwritten
    assert step_spans.kept_entries([idx[:2]], cfg) == 1
    assert step_spans.kept_entries([idx, even], cfg) == 9
