"""On the card: each cell for its window through `run.run_cell`, its
output held to the reference, the reference's control read beside it,
and the program's own lower-precision path, where the configuration
names one, seen to come out not correct.  Skips
without a card.  `python -m pytest -m gpu perfbench/tests`."""

import pytest

from perfbench_testing import ROOT, H

pytestmark = pytest.mark.gpu

BENCH = H.load_benchmark(ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_and_its_control_does_not(card, cell):
    from perfbench import run as R
    secs = BENCH["run_seconds"]        # a serve window finishes requests
    line, out, missing = R.run_cell(BENCH, cell, 20260101, secs, False,
                                    control="scheme")
    assert line["correct"], line["compared"]
    assert not missing
    assert any(out.control[k] > lim for k, (_, lim) in out.compared.items()
               if k in out.control)
    spec = H.find(BENCH["workloads"], cell, "workload")
    if "program" in H.config_file(BENCH, spec["config"], ROOT)["control"]:
        low, _, _ = R.run_cell(BENCH, cell, 20260101, secs, False,
                               control="program")
        assert not low["correct"], low["compared"]
