"""Fault-tolerant training end-to-end on the PyTorch port: the paper's
protocol as the training fleet's state plane.

    PYTHONPATH=src python examples/torch_fault_tolerant_training.py
    PYTHONPATH=src python examples/torch_fault_tolerant_training.py \
        --device cpu

`examples/fault_tolerant_training.py` on the port.  Storyline:
  1. train with checkpoints committed to the 3-way Paxos-replicated store;
  2. a STORAGE node dies mid-run — commits keep flowing (majority alive);
  3. the TRAINER dies; a replacement restores with a STRONG read and
     resumes bit-exactly (deterministic pipeline, a pure step, and
     deterministic CUDA kernels);
  4. a zombie of the old trainer wakes up and tries to commit — the
     conditionalPut manifest fence kills it (split-brain protection);
  5. a host is lost from the training fleet — the controller fences the
     generation and re-plans the mesh (elastic scaling, 8 cards a host).
Each step checks what it shows and exits non-zero if it does not hold.
Runs on the card unless `--device cpu` is given.
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import (SpinnakerCheckpointStore,  # noqa: E402
                                    StaleTrainerError, StoreConfig)
from repro_torch.core.coordination import Coordination  # noqa: E402
from repro_torch.core.sim import Simulator  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenStream  # noqa: E402
from repro_torch.ft.manager import (FTConfig, HostAgent,  # noqa: E402
                                    TrainingController, plan_mesh)
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.optim import OptimizerConfig  # noqa: E402
from repro_torch.train.step import (TrainConfig,  # noqa: E402
                                    init_train_state, make_train_step)
from repro_torch.tree import tree_leaves  # noqa: E402


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {msg}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    # cuBLAS reads its workspace setting at its first call; with it fixed,
    # deterministic algorithms make a resumed step equal an uninterrupted one
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)

    cfg = ModelConfig(name="ft-demo", family="dense", num_layers=4,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=2048, dtype="float32", remat=False)
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                      seed=0)
    stream = TokenStream(dcfg, 0)
    step_fn = make_train_step(cfg, tcfg)

    def run(state, start, n):
        losses = []
        for s in range(start, start + n):
            state, m = step_fn(state, stream.batch_at(s))
            losses.append(float(m["loss"]))
        return state, losses

    store = SpinnakerCheckpointStore(StoreConfig())
    state = init_train_state(cfg, tcfg, seed=0, device=args.device)

    # 1. train + commit
    state, l1 = run(state, 0, 10)
    store.save(10, state)
    check(store.latest_step() == 10, "checkpoint @10 not committed")
    print(f"[1] 10 steps on {state['step'].device}, loss {l1[0]:.3f} -> "
          f"{l1[-1]:.3f}; checkpoint committed (quorum)")

    # 2. storage node dies; commits keep flowing
    store.crash_storage_node(2)
    store.sim.run_for(3.0)
    state, l2 = run(state, 10, 5)
    store.save(15, state)
    check(store.latest_step() == 15, "checkpoint @15 not committed")
    print("[2] storage node 2 down — checkpoint @15 still committed "
          "(majority quorum alive)")

    # 3. trainer dies; replacement restores with a STRONG read
    reference_state, lref = run(state, 15, 5)   # what the run should produce
    del state
    fresh = init_train_state(cfg, tcfg, seed=99, device=args.device)
    step0, restored = store.restore_tree(fresh)
    resumed, l3 = run(restored, step0, 5)
    same = l3 == lref and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(resumed),
                                          tree_leaves(reference_state)))
    print(f"[3] trainer replaced: restored step {step0} via strong read; "
          f"5 resumed steps bit-match reference: {same}")
    check(step0 == 15 and same, "resumed run differs from the reference")

    # 4. zombie trainer is fenced by the conditionalPut
    zombie = SpinnakerCheckpointStore.__new__(SpinnakerCheckpointStore)
    zombie.__dict__.update(store.__dict__)
    zombie._manifest_version = 1                  # stale view of the run
    try:
        zombie.save(11, resumed)
        check(False, "[4] ZOMBIE COMMITTED — fence failed!")
    except StaleTrainerError as e:
        print(f"[4] zombie trainer fenced out by conditionalPut: {e}")
    check(store.latest_step() == 15, "the zombie moved the manifest")

    # 5. elastic re-mesh on host loss
    sim = Simulator(seed=1)
    zk = Coordination(sim, session_timeout=1.0)
    ftc = FTConfig(session_timeout=1.0, heartbeat_interval=0.25)
    plans = []
    ctrl = TrainingController(sim, zk, "run0", ftc,
                              on_replan=lambda h, g: plans.append((h, g)))
    agents = [HostAgent(sim, zk, "run0", i, ftc) for i in range(64)]
    sim.run_for(0.5)
    ctrl.bootstrap()
    d, m = plan_mesh(len(plans[-1][0]), chips_per_host=8)
    print(f"[5] fleet up: {len(plans[-1][0])} hosts -> mesh (data={d}, "
          f"model={m}), generation {plans[-1][1]}")
    agents[13].crash()
    sim.run_for(3.0)
    d, m = plan_mesh(len(plans[-1][0]), chips_per_host=8)
    print(f"    host 13 lost -> generation {plans[-1][1]}, re-planned mesh "
          f"(data={d}, model={m}); old generation fenced: "
          f"{agents[0].fenced()}")
    check(len(plans[-1][0]) == 63 and 13 not in plans[-1][0]
          and agents[0].fenced(), "host loss was not re-planned")


if __name__ == "__main__":
    main()
