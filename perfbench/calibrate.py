"""Readings for the limits of the comparison that decides `correct`:
runs one cell on several seeds in one process (set-up paid once per
process, weights drawn anew per seed), each with a window of `--seconds`,
and prints one JSON line per seed: the program's compared numbers, the
end-to-end metrics and, on the first `--controls` seeds, the control's
numbers on the same inputs: the reference one precision below read
beside the program (`control.scheme`), and a second run of the program
on its own lower-precision path (`control.program`), where the
configuration names them.  The benchmark's own runs never read a
control.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 30 --controls 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness as H
    from perfbench.run import run_cell
    bench = H.load_benchmark(ROOT)
    spec = H.find(bench["workloads"], args.workload, "workload")
    ctl = H.config_file(bench, spec["config"], ROOT)["control"]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        controls = i < args.controls
        line, out, _ = run_cell(
            bench, args.workload, seed, args.seconds, False,
            control="scheme" if controls and "scheme" in ctl else "",
            t_start=t)
        row = {"workload": args.workload, "seed": seed,
               "correct": line["correct"],
               "program": {k: v["value"] for k, v in
                           line["compared"].items()},
               "metrics": {k: v["value"] for k, v in
                           line["metrics"].items()},
               "memory_peak_bytes": line["device"]["memory_peak_bytes"],
               "notes": out.notes}
        if out.control:
            row["control_scheme"] = out.control
        if controls and "program" in ctl:
            lo, lo_out, _ = run_cell(bench, args.workload, seed,
                                     args.seconds, False, control="program",
                                     t_start=time.perf_counter())
            row["control_program"] = {k: v["value"] for k, v in
                                      lo["compared"].items()}
            row["control_program_notes"] = lo_out.notes
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
