"""PyTorch model library (dense, ssm and hybrid families); mirrors
`repro.models`."""

from .config import ModelConfig
from .model import (decode_step, forward, init_cache, init_params, loss_fn,
                    prefill)

__all__ = ["ModelConfig", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "prefill"]
