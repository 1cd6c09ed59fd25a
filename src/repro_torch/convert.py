"""Carry parameter and train-state trees between the JAX package and
the port.

The port keeps the reference's tree: the same dict keys, layers stacked
on a leading L axis, matmul weights stored (in, out); a train state is
{"params", "opt": AdamW {"m", "v", "count"} or Adafactor {"stats",
"count"}, "step"}, as `repro/train/step.py` builds it.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve


def to_tensor(arr, device: torch.device, dtype=None) -> torch.Tensor:
    """One numpy (or array-like) leaf as a tensor on `device`, in `dtype`
    or else its own."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16, which torch.from_numpy rejects: exact via f32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))        # a writable copy
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, device="cuda"):
    """A nested dict of numpy (or array-like) leaves -> the same dict of
    tensors on `device`, keeping each leaf's dtype."""
    dev = resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return to_tensor(node, dev)
    return walk(tree)


def params_to_numpy(tree):
    """The inverse of `params_from_numpy`: bf16 leaves come back as
    ml_dtypes bfloat16 arrays, as `np.asarray` gives them for JAX."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.float().numpy().astype(ml_dtypes.bfloat16)
        return t.numpy()
    return walk(tree)


def _check_train_state(tree) -> None:
    if set(tree) != {"params", "opt", "step"} or not (
            set(tree["opt"]) in ({"m", "v", "count"}, {"stats", "count"})):
        raise ValueError("not a train state: want {'params', 'opt': "
                         "{'m', 'v', 'count'} or {'stats', 'count'}, "
                         f"'step'}}, got keys {sorted(tree)}")


def train_state_from_numpy(tree, device="cuda") -> dict:
    """A train state of numpy leaves (`jax.tree.map(np.asarray, state)` of
    the reference's) -> the same tree of tensors on `device`: params in
    their dtypes, optimizer moments f32, `count` and `step` 0-d int32.  A
    state trained by JAX continues in the port's `train_step`."""
    _check_train_state(tree)
    return params_from_numpy(tree, device)


def train_state_to_numpy(state) -> dict:
    """The inverse of `train_state_from_numpy`, for the reference's
    `train_step` or a checkpoint."""
    _check_train_state(state)
    return params_to_numpy(state)
