"""Wall time of the drawing `init_params` of SmolLM-360M on the card: one
warm-up call, then the median of three, for the `repro_torch` package
found on PYTHONPATH.  Run it by path, so that it can time another
checkout's package (one without this file) in the same call:

    PYTHONPATH=<checkout>/src python src/repro_torch/launch/init_timing.py

Run parent, change, change, parent in one call to compare two commits.
"""

import statistics
import time

import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.models import init_params


def main() -> None:
    cfg = get_config("smollm-360m")
    init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del params
    print(f"init_params {repro_torch.__file__}: {times} median "
          f"{statistics.median(times)} s", flush=True)


if __name__ == "__main__":
    main()
