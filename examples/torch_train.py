"""End-to-end training on the PyTorch port.

    PYTHONPATH=src python examples/torch_train.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train.py --preset 5m --steps 3 \
        --device cpu

Trains a llama-family model on the deterministic mixture pipeline with
AdamW, the presets and flags of `examples/train.py`: every `--ckpt-every`
steps (0: never) the train state is committed to the Paxos-replicated
checkpoint store.  Runs on the card unless `--device cpu` is given.
Loss curve and throughput are written to results/train_<preset>.json.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import (SpinnakerCheckpointStore,  # noqa: E402
                                    StoreConfig)
from repro_torch.data.pipeline import DataConfig, TokenStream  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.optim import OptimizerConfig  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainConfig, init_train_state, make_train_step)
from repro_torch.tree import tree_leaves  # noqa: E402

PRESETS = {
    # ~name: layers, d_model, heads, kv, d_ff, vocab, batch, seq
    "5m": dict(num_layers=4, d_model=128, heads=4, kv=2, d_ff=512,
               vocab=2048, batch=8, seq=128),
    "25m": dict(num_layers=8, d_model=384, heads=6, kv=2, d_ff=1024,
                vocab=8192, batch=4, seq=256),
    "100m": dict(num_layers=12, d_model=768, heads=12, kv=4, d_ff=2048,
                 vocab=16384, batch=4, seq=256),
}


def make_config(p) -> ModelConfig:
    return ModelConfig(
        name="train-example", family="dense", num_layers=p["num_layers"],
        d_model=p["d_model"], num_heads=p["heads"], num_kv_heads=p["kv"],
        d_ff=p["d_ff"], vocab_size=p["vocab"], activation="swiglu",
        dtype="float32", remat=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="25m", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    p = PRESETS[args.preset]
    cfg = make_config(p)
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=args.lr))
    state = init_train_state(cfg, tcfg, seed=0, device=args.device)
    dev = state["step"].device
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"model: {n_params/1e6:.1f}M params ({args.preset}) on {dev}")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq"],
                      global_batch=p["batch"], seed=0)
    stream = TokenStream(dcfg, 0)
    step_fn = make_train_step(cfg, tcfg)
    store = SpinnakerCheckpointStore(StoreConfig(chunk_bytes=4 << 20))

    losses = []
    t0 = time.time()
    tokens_done = 0
    for s in range(args.steps):
        state, metrics = step_fn(state, stream.batch_at(s))
        loss = float(metrics["loss"])        # waits for the step
        losses.append(loss)
        tokens_done += p["batch"] * p["seq"]
        if s % 10 == 0 or s == args.steps - 1:
            dt = time.time() - t0
            print(f"step {s:4d}  loss {loss:.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"{tokens_done/max(dt,1e-9):.0f} tok/s", flush=True)
        if args.ckpt_every and (s + 1) % args.ckpt_every == 0:
            store.save(s + 1, state)
            print(f"  checkpoint @ step {s+1} committed to replicated "
                  f"store (quorum + manifest fence)", flush=True)

    if not losses[-1] < losses[0]:
        raise SystemExit("loss did not decrease")
    out = Path("results")
    out.mkdir(exist_ok=True)
    (out / f"train_{args.preset}.json").write_text(json.dumps({
        "preset": args.preset, "params": n_params, "steps": args.steps,
        "device": str(dev) if dev.type == "cpu"
        else torch.cuda.get_device_name(dev),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses_every10": losses[::10],
        "wall_s": time.time() - t0,
        "tok_per_s": tokens_done / (time.time() - t0),
    }, indent=2))
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
