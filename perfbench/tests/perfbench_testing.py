"""Shared by the benchmark's CPU tests: the checkout on `sys.path`, small
mixes at the configurations' SMOKE sizes, and a runner that drives a
cell's driver on the CPU (the harness's look for a card is `run.main`'s,
which these skip)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness as H  # noqa: E402

SERVE_MIX = {"driver": "serve", "slots": 4, "max_seq": 64, "eos_id": 1,
             "requests_per_generation": 8, "prompt_len": {"low": 4,
                                                          "high": 10},
             "max_new_tokens": {"low": 4, "high": 10},
             "steps_per_second": 20, "warmup_steps": 1, "trace_steps": 2}
PREFILL_MIX = {"driver": "prefill", "batch": 2, "seq_len": 64,
               "distinct_batches": 2, "compare_batches": 2,
               "warmup_calls": 1, "trace_calls": 1}
MIXES = {"serve": SERVE_MIX, "prefill": PREFILL_MIX}


# a serve window of 60 steps, two generations; a prefill window long
# enough for a call on a loaded CPU
SECONDS = {"serve": 3.0, "prefill": 0.6}


def cell(config: str, kind: str, seed: int = 7, seconds: float = None,
         trace: bool = False, control: str = "") -> H.Cell:
    bench = H.load_benchmark(ROOT)
    return H.Cell(name=f"{config}.{kind}-test",
                  conf=H.config_file(bench, config, ROOT),
                  mix=dict(MIXES[kind]), seed=seed,
                  seconds=SECONDS[kind] if seconds is None else seconds,
                  trace=trace, device="cpu", smoke=True, control=control)


def run(c: H.Cell) -> H.Outcome:
    """The cell's driver, on one CPU thread: the tiny SMOKE ops gain
    nothing from more, and the test workers share the machine."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return H.driver(c.mix["driver"]).run(c)
    finally:
        torch.set_num_threads(threads)
