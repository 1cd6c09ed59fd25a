"""Batched serving with timeline-consistent weight refresh on the PyTorch
port.

    PYTHONPATH=src python examples/torch_serve.py
    PYTHONPATH=src python examples/torch_serve.py --device cpu

`examples/serve.py` on the port: brings up the continuous-batching
engine on a small model, serves a burst of requests, then demonstrates
the paper's consistency menu applied to serving: a trainer commits new
weights to the Spinnaker store (quorum write + manifest fence) and the
engine picks them up with a *timeline* read — never blocking the
training commit path.  Runs on the card unless `--device cpu` is given.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch.checkpoint import (SpinnakerCheckpointStore,  # noqa: E402
                                    StoreConfig)
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = smoke_config("smollm-360m").scaled(remat=False, dtype="float32")
    params = init_params(cfg, seed=0, device=args.device)
    store = SpinnakerCheckpointStore(StoreConfig())
    store.save(1, params)

    eng = ServingEngine(cfg, params, ServeConfig(slots=4, max_seq=96,
                                                 refresh_every_batches=8),
                        store=store, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(12):
        prompt = rng.integers(2, cfg.vocab_size, rng.integers(3, 9)).tolist()
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=12))
    eng.run_until_drained()
    print(f"served 12 requests on 4 slots in {eng.batches_run} lockstep "
          f"batches ({time.time()-t0:.1f}s wall) on {eng.device}")
    for rid in sorted(eng.finished)[:4]:
        print(f"  req {rid}: {eng.finished[rid].output}")

    # --- trainer commits new weights; engine refreshes via timeline read ----
    new_params = init_params(cfg, seed=7, device=args.device)
    store.save(2, new_params)
    store.sim.run_for(2.0)   # commit period elapses; followers catch up
    refreshed = eng.maybe_refresh_weights()
    print(f"weight refresh via timeline read: step {eng.weights_step} "
          f"(refreshed={refreshed})")
    eng.submit(Request(rid=99, prompt=[5, 6, 7], max_new_tokens=8))
    eng.run_until_drained()
    print(f"req 99 on refreshed weights: {eng.finished[99].output}")


if __name__ == "__main__":
    main()
