"""Weight-only quantisation, worked out from the dense draws: symmetric
per-output-channel absmax codes over the contraction axis (-2), rounded
half to even.  int8 is what the configuration serves; int4 is the
control's step below it; "fp8" keeps e4m3 values per channel, the
other step below bf16."""

from __future__ import annotations

import torch

LEVELS = {"int8": 127, "int4": 7}

# the matmul weights a quantised model holds as codes; embeddings, norms,
# the router and Mamba2's conv and scalars stay dense
QUANTISED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "in_proj",
             "out_proj")


def fake_quant(w: torch.Tensor, scheme: str) -> torch.Tensor:
    """The float32 weight that `scheme`'s codes and scales stand for."""
    w32 = w.float()
    if scheme == "fp8":
        scale = torch.clamp(torch.amax(w32.abs(), dim=-2, keepdim=True)
                            / 448.0, min=1e-12)
        return (w32 / scale).to(torch.float8_e4m3fn).float() * scale
    levels = LEVELS[scheme]
    scale = torch.clamp(torch.amax(w32.abs(), dim=-2, keepdim=True) / levels,
                        min=1e-8)
    return torch.clamp(torch.round(w32 / scale), -levels, levels) * scale


def prepare(tree: dict, scheme: str | None) -> dict:
    """Every leaf as float32; with a scheme, the quantised matmul weights
    as their codes times their scales."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = prepare(v, scheme)
        elif scheme and k in QUANTISED and v.dim() >= 2:
            out[k] = fake_quant(v, scheme)
        else:
            out[k] = v.float()
    return out
