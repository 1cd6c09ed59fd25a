"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Reads `BENCHMARK.json` at the checkout's root, the cell's configuration
and mix files, runs the mix's driver on the card for `--seconds`, checks
what the window served against the plain reference, and prints, as the
last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`compared`: each number the comparison judged, with its limit (also the
last lines of standard error).  Exits non-zero with no result line when
there is no card or too few, when the program or a file is missing, and
when JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"

# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (`repro_torch` is not `repro`)."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def result_line(bench: dict, cell_name: str, cell, out, trace: bool
                ) -> dict:
    import torch

    from perfbench import harness as H
    metrics, missing = {}, []
    for spec in H.reported(bench, cell_name, trace):
        name = spec["name"]
        if trace:
            try:
                value = H.reader(name)(out.records)
            except (H.Missing, KeyError, ZeroDivisionError) as e:
                missing.append(f"{name}: {type(e).__name__} {e}")
                continue
        elif name == "setup_s":
            value = out.setup_s
        elif name in out.e2e:
            value = out.e2e[name]
        else:
            missing.append(f"{name}: not measured")
            continue
        metrics[name] = {"value": float(value), "unit": spec["unit"]}
    device = {"platform": "gpu" if cell.cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cell.cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(out.memory_peak)}
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace and out.records:
        device["busy_s"] = out.records["busy_s"]
        device["window_s"] = out.records["window_s"]
        line["breakdown"] = out.records["breakdown"]
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.compared.items()}
    return line, missing


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, control: str = "", t_start: float = T_START):
    """Run one cell on the card; returns (result line, Outcome, missing
    metrics).  The checks for a card are `main`'s; `control` as
    `harness.Cell`'s (`calibrate.py` and the card's tests set it)."""
    from perfbench import harness as H
    cell_spec = H.find(bench["workloads"], cell_name, "workload")
    conf = H.config_file(bench, cell_spec["config"], ROOT)
    mix = H.mix_file(cell_spec["traffic"])
    cell = H.Cell(name=cell_name, conf=conf, mix=mix, seed=seed,
                  seconds=seconds, trace=trace, control=control,
                  t_start=t_start)
    out = H.driver(mix["driver"]).run(cell)
    line, missing = result_line(bench, cell_name, cell, out, trace)
    return line, out, missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness as H
    bench = H.load_benchmark(ROOT)
    chips = H.find(bench["workloads"], args.workload, "workload")["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line, out, missing = run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 4
    for note in out.notes:
        print(f"perfbench: {note}", file=sys.stderr)
    for m in missing:
        print(f"perfbench: metric left out: {m}", file=sys.stderr)
    print(f"perfbench: correct {line['correct']} (attempted "
          f"{line['attempted']}, failed {line['failed']})", file=sys.stderr)
    for k, v in line["compared"].items():
        print(f"perfbench: compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                    # no result line on any failure
        traceback.print_exc()
        sys.exit(1)
