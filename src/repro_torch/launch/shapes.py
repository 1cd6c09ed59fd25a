"""Assigned input shapes, allocation-free input specs and real batches;
a port of `repro/launch/shapes.py`.

Four shapes per architecture (train_4k / prefill_32k / decode_32k /
long_500k).  `input_specs` returns tensors on the meta device, shapes
and dtypes with no storage, in place of the reference's
`jax.ShapeDtypeStruct`s (the dry-run's inputs).  `make_batch` and
`make_decode_tokens` return real (small) batches for smoke tests and
examples: the reference's numpy draws in its order, as tensors on
`device` (default "cuda"; raises without a card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..models.config import ModelConfig
from ..models.model import DTYPES, init_cache


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason).  long_500k needs sub-quadratic context handling:
    only SSM/hybrid archs run it."""
    if shape_name == "long_500k" and not cfg.has_ssm:
        return False, ("pure full-attention arch: a 524k dense KV cache is "
                       "the quadratic blowup long_500k excludes; skipped "
                       "per brief")
    return True, ""


# ---------------------------------------------------------------------------
# specs (meta tensors: no allocation)
# ---------------------------------------------------------------------------


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    B, S = spec.global_batch, spec.seq_len
    dt = DTYPES[cfg.dtype]
    if cfg.modality == "vlm":
        P = cfg.num_patches
        return {"tokens": _spec((B, S - P), torch.int32),
                "patches": _spec((B, P, cfg.d_model), dt),
                "labels": _spec((B, S), torch.int32)}
    if cfg.modality == "audio" and cfg.frame_embed:
        return {"frames": _spec((B, S, cfg.d_model), dt),
                "labels": _spec((B, S), torch.int32)}
    return {"tokens": _spec((B, S), torch.int32),
            "labels": _spec((B, S), torch.int32)}


def decode_input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    B = spec.global_batch
    if cfg.modality == "audio" and cfg.frame_embed:
        tok = _spec((B, 1, cfg.d_model), DTYPES[cfg.dtype])
    else:
        tok = _spec((B, 1), torch.int32)
    return {"tokens": tok,
            "cache": init_cache(cfg, B, spec.seq_len, device="meta")}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    spec = SHAPES[shape_name]
    if spec.kind in ("train", "prefill"):
        return train_input_specs(cfg, spec)
    return decode_input_specs(cfg, spec)


# ---------------------------------------------------------------------------
# real batches (smoke tests, examples)
# ---------------------------------------------------------------------------


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
