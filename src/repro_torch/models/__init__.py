"""PyTorch model library (dense, moe, ssm and hybrid families; int8
weights in `quant`); mirrors `repro.models`."""

from .config import ModelConfig
from .model import (decode_step, forward, init_cache, init_params, loss_fn,
                    prefill)

__all__ = ["ModelConfig", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "prefill"]
