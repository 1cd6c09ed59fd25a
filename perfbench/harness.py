"""Finds a cell's files by name and holds what every driver shares.

A later change adds a configuration, mix, cell or per-layer metric by
adding files and entries, never by editing one:

- `BENCHMARK.json` (the checkout's root): cells, configurations and
  metrics;
- `configs/<config>.json`: the model's numbers as run, the program's
  config name, dtype, weight format and kernel path, and the limits of
  the comparison that decides `correct`, by driver;
- `mixes/<traffic>.json`: one traffic mix's parameters and the driver
  (`drivers/<driver>.py`) that runs it;
- `layer_metrics/<metric>.py`: one reader per per-layer metric, whose
  `read(records)` returns a number or raises (`Missing` when the run
  holds nothing for it to read).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Missing(Exception):
    """A reader found nothing to read."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    return load_json(root / find(bench["configs"], name, "config")["file"])


def mix_file(traffic: str, base: Path = HERE) -> dict:
    return load_json(base / "mixes" / f"{traffic}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, base: Path = HERE):
    return _module(base / "drivers" / f"{kind}.py",
                   f"perfbench_driver_{kind}")


def reader(metric: str, base: Path = HERE):
    """The `read` function of `layer_metrics/<metric>.py`."""
    return _module(base / "layer_metrics" / f"{metric}.py",
                   "perfbench_metric_" + metric.replace(".", "_")).read


def reported(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` prints: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric without a
    `workloads` list belongs to every cell (a per-layer one to every cell
    that reports the end-to-end metric it moves)."""
    def has(metric):
        return "workloads" not in metric or cell in metric["workloads"]
    e2e = [x for x in bench["end_to_end"] if has(x)]
    if not trace:
        return e2e
    names = {x["name"] for x in e2e}
    return [x for x in bench["per_layer"] if
            (cell in x["workloads"] if "workloads" in x
             else x["moves"] in names)]


@dataclass
class Cell:
    """One run: the cell's files as read, the seed, the window and where
    to run.  `smoke` takes the program's SMOKE config and the file's
    "smoke" numbers (CPU tests).  `control`: "" runs the program as the
    configuration states; "program" runs the program on its own
    lower-precision path (`control.program`), so that the run's compared
    numbers are the control's; "scheme" also reads the reference one
    precision below (`control.scheme`) beside the program."""
    name: str
    conf: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    smoke: bool = False
    control: str = ""
    t_start: float = field(default_factory=time.perf_counter)

    @property
    def m(self) -> dict:
        return self.conf["smoke" if self.smoke else "model"]

    @property
    def limits(self) -> dict:
        return self.conf["limits"][self.mix["driver"]]

    @property
    def weights(self) -> str:
        """The weight format the program runs: the configuration's, or
        its control path's."""
        src = self.conf["control"]["program"] if self.control == "program" \
            else self.conf["program"]
        return src["weights"]

    @property
    def cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"


@dataclass
class Outcome:
    attempted: int
    failed: int
    setup_s: float
    e2e: dict                    # end-to-end metric -> value
    compared: dict               # number -> (value, limit)
    memory_peak: int
    records: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)
    control: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in
                                        self.compared.values())


def sync(cell: Cell) -> None:
    if cell.cuda:
        torch.cuda.synchronize()


def memory_peak(cell: Cell) -> int:
    return torch.cuda.max_memory_allocated() if cell.cuda else 0


def reset_peak(cell: Cell) -> None:
    if cell.cuda:
        torch.cuda.reset_peak_memory_stats()


def free(cell: Cell) -> None:
    gc.collect()
    if cell.cuda:
        torch.cuda.empty_cache()
