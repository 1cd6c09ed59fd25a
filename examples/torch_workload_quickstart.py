"""Workload-engine quickstart on the PyTorch port: drive a 5-node Spinnaker
cluster with a YCSB-style zipfian mix, sampled by torch on the card, while
a fault schedule kills and revives the leader, then print the
availability timeline.

    PYTHONPATH=src python examples/torch_workload_quickstart.py
    PYTHONPATH=src python examples/torch_workload_quickstart.py --device cpu

`examples/workload_quickstart.py` on the port.  The cluster is the host's
discrete-event simulator on either device; only the op stream is drawn
on `--device` (the card unless `--device cpu` is given).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.workload import (ExperimentConfig,  # noqa: E402
                                  WorkloadSpec, run_spinnaker_workload)

SCENARIO = """
# one-file failure scenario: the DSL resolves 'leader of 0' at fire time
at 2.0s  crash leader of 0
at 4.0s  partition {0,1} | {2,3,4}
at 5.5s  heal
at 6.0s  restart crashed
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    spec = WorkloadSpec(num_keys=500, key_dist="zipfian",
                        read_frac=0.6, write_frac=0.4,
                        rmw_frac=0.0, cond_frac=0.0, value_size=1024)
    cfg = ExperimentConfig(n_nodes=5, disk="ssd", n_clients=8,
                           warmup=0.5, duration=9.0, window=0.5,
                           preload_cap=500, device=args.device)
    r = run_spinnaker_workload(spec, cfg, schedule=SCENARIO)

    print(f"op stream sampled on {cfg.device}")
    print("fault events applied:")
    for e in r["fault_events"]:
        print("  ", e)
    print(f"\nreads : p50={r['reads']['p50_ms']:.2f}ms "
          f"p99={r['reads']['p99_ms']:.2f}ms  ({r['reads']['count']} ops)")
    print(f"writes: p50={r['writes']['p50_ms']:.2f}ms "
          f"p99={r['writes']['p99_ms']:.2f}ms  ({r['writes']['count']} ops)")
    print("\nwrite availability timeline (0.5s windows):")
    for w in r["timeline"]["write"]:
        bar = "#" * int(w["throughput"] / 100)
        print(f"  t={w['t_start']:5.1f}s  {w['throughput']:7.0f}/s  {bar}")


if __name__ == "__main__":
    main()
