"""Real (small) input batches for smoke tests and examples; a port of
`repro/launch/shapes.py::make_batch` and `make_decode_tokens`.

The same numpy draws in the same order as the reference, returned as
tensors on `device` (default "cuda"; raises without a card).  The
reference's allocation-free input specs come with the launch slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..models.config import ModelConfig
from ..models.model import DTYPES


def _ints(arr, dev) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.int32)).to(dev)


def _floats(arr, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(arr).to(device=dev, dtype=dtype)


def make_batch(cfg: ModelConfig, rng: np.random.Generator, batch: int,
               seq: int, device="cuda") -> dict:
    dev = resolve(device)
    dt = DTYPES[cfg.dtype]
    if cfg.modality == "vlm":
        P = cfg.num_patches
        return {
            "tokens": _ints(rng.integers(0, cfg.vocab_size,
                                         (batch, seq - P)), dev),
            "patches": _floats(rng.standard_normal((batch, P, cfg.d_model)),
                               dt, dev),
            "labels": _ints(rng.integers(0, cfg.vocab_size, (batch, seq)),
                            dev),
        }
    if cfg.modality == "audio" and cfg.frame_embed:
        return {
            "frames": _floats(
                rng.standard_normal((batch, seq, cfg.d_model)) * 0.02, dt,
                dev),
            "labels": _ints(rng.integers(0, cfg.vocab_size, (batch, seq)),
                            dev),
        }
    return {
        "tokens": _ints(rng.integers(0, cfg.vocab_size, (batch, seq)), dev),
        "labels": _ints(rng.integers(0, cfg.vocab_size, (batch, seq)), dev),
    }


def make_decode_tokens(cfg: ModelConfig, rng: np.random.Generator,
                       batch: int, device="cuda") -> torch.Tensor:
    dev = resolve(device)
    if cfg.modality == "audio" and cfg.frame_embed:
        return _floats(rng.standard_normal((batch, 1, cfg.d_model)) * 0.02,
                       DTYPES[cfg.dtype], dev)
    return _ints(rng.integers(0, cfg.vocab_size, (batch, 1)), dev)
