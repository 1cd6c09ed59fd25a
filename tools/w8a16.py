#!/usr/bin/env python3
"""Check and time the W8A16 GEMM (`csrc/w8a16_gemm.cu`) on one NVIDIA
card: every int8 matmul shape of the configs against the f32 product,
then Phi-3.5-MoE's serve-chat shapes timed against the byte bound, the
plain path (wcast + matmul) and `torch._weight_int8pack_mm`, at the grid
`ops.grid` picks and, with `--grids`, at other block counts.

    python3 tools/w8a16.py [--tree DIR] [--grids 132,264,...] [--out FILE]

`--tree` names the checkout whose `chip_smoke.py`, and so whose kernel,
runs (default: this one); with a `git archive` of another commit unpacked
into a git-ignored directory, run the script on each tree in turns to
compare two kernels in one call.  Prints one JSON object as its last
line, and writes it to `--out` when given.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--grids", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("w8a16: torch.cuda is not available", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    logs = cs._build.build_all(["w8a16_gemm"])
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "Used " in ln or "spill" in ln]
    out = {"tree": str(tree), "device": smi, "torch": torch.__version__,
           "ptxas": ptxas,
           "blocks_per_sm": {M: cs.w8_ops.blocks_per_sm(dev, M)
                             for M in (8, 16, 32, 64)}}
    print(f"[w8a16] {out}", flush=True)
    out["check"] = cs.check_w8a16(dev)
    out["timing"] = cs.w8a16_timings(dev)
    grids = [int(g) for g in args.grids.split(",") if g]
    for name in cs.W8A16_SERVE if grids else ():
        for g in grids:
            res = cs.time_w8a16(name, dev, blocks=g)
            out["timing"][f"{name} at {g} blocks"] = res
            print(f"[w8a16] {name} at {g} blocks: {res}", flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
