#!/usr/bin/env python3
"""Time the f32 flash attention kernel (variant `fma`) on one NVIDIA card:
at its two S=64 main-path shapes, at B=2, S=2048 (causal) at every head
dim a config uses, and inside one f32 SmolLM-360M prefill of 2 x 2048
tokens at full width and depth.

    python3 tools/flash_f32.py [--tree DIR] [--out FILE]

`--tree` names the checkout whose `chip_smoke.py`, and so whose kernels,
are timed (default: this one).  To compare two commits on one card in one
call, unpack the other with `git archive` into a git-ignored directory
(build/...) and run this script on each tree in turns, one process each.
Each shape goes through that tree's `chip_smoke.time_flash` (device ms
from torch.profiler, the plain version, `scaled_dot_product_attention` in
f32 as a yardstick, the bound) and the prefill through its
`timed_prefill` (a warm-up, a timed call, the eager path, a profiled
call).  Prints one JSON object as its last line, and writes it to
`--out` when given.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

# name -> (B, H, Hkv, Sq, Sk, hd, causal, window)
SHAPES = {
    "smollm-360m S=64 (phase 4)": (2, 15, 5, 64, 64, 64, True, 0),
    "phi3.5-moe S=64 (phase 11(a))": (2, 32, 8, 64, 64, 128, True, 0),
    "smollm-360m": (2, 15, 5, 2048, 2048, 64, True, 0),
    "phi-3-vision-4.2b": (2, 32, 32, 2048, 2048, 96, True, 0),
    "zamba2-7b": (2, 32, 32, 2048, 2048, 112, True, 32768),
    "phi3.5-moe": (2, 32, 8, 2048, 2048, 128, True, 0),
    "gemma-7b": (2, 16, 16, 2048, 2048, 256, True, 0),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32: torch.cuda is not available", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    logs = cs._build.build_all(["flash_attention"])
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "Used " in ln or "spill" in ln]
    out = {"tree": str(tree), "device": smi, "torch": torch.__version__,
           "ptxas": ptxas, "flash_f32": {}}
    for name, case in SHAPES.items():
        iters = 200 if case[3] <= 64 else 10
        res = cs.time_flash(case, torch.float32, dev, "fma", iters=iters)
        out["flash_f32"][name] = res
        print(f"[flash_f32] {name} {case}: {res}", flush=True)
    cs.free()

    cfg = cs.get_config("smollm-360m").scaled(attn_impl="pallas",
                                              dtype="float32")
    params = cs.init_params(cfg, seed=0, device=dev)
    pf = cs.timed_prefill(cfg, params, dev, seed=3)
    pf["tokens_per_s"] = 2 * 2048 / pf["wall_s"]
    out["prefill_f32"] = pf
    print(f"[flash_f32] smollm-360m f32 prefill B=2 S=2048: {pf}", flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
