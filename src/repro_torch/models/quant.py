"""Weight-only int8 quantization (W8A16) for serving; a port of
`repro/models/quant.py`.

Keeping a large model's weights resident on one card often fits only
with 8-bit weights: Phi-3.5-MoE's 41.9 B parameters take 83.7 GB in bf16
and 42.2 GB with int8 matmul weights.  Per-output-channel absmax scales
keep the matmul error small; embeddings, norms, the router and the SSM
scalars stay dense.

A quantized weight is the dict {"q": int8 (..., in, out), "s": f32
(..., out)}; `wcast` dequantizes it at every use, so every matmul site
takes both representations.
"""

from __future__ import annotations

import torch

from ..obs import spans


def quantize_weight(w: torch.Tensor) -> dict:
    """Per-output-channel absmax int8: the scale reduces only the
    contraction axis (-2), so stacked (L, D, F) / expert (E, D, F)
    weights keep per-layer/per-expert scales, and quantizing each layer
    alone gives the slices of quantizing the stack."""
    w32 = w.float()
    scale = torch.clamp(torch.amax(w32.abs(), dim=-2) / 127.0, min=1e-8)
    # torch.round, as jnp.round, rounds half to even
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127)
    return {"q": q.to(torch.int8), "s": scale}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


@spans.traced("wcast")
def wcast(w, dtype: torch.dtype) -> torch.Tensor:
    """Weight fetch: dequantize int8 weights or cast dense ones.  Both
    factors are cast to `dtype` before the product, as the reference
    does, so a bf16 product rounds the same way in both packages."""
    if is_quantized(w):
        return w["q"].to(dtype) * w["s"][..., None, :].to(dtype)
    return w.to(dtype)


_QUANT_SUFFIXES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                   "in_proj", "out_proj")


def quantize_tree(params: dict) -> dict:
    """Quantize every matmul weight in a model param tree (embeddings,
    norms, the router, SSM scalars and conv stay dense)."""
    def rec(node, name=""):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if name in _QUANT_SUFFIXES and getattr(node, "ndim", 0) >= 2:
            return quantize_weight(node)
        return node
    return rec(params)


def dequantize_tree(params: dict, dtype=torch.bfloat16) -> dict:
    def rec(node):
        if is_quantized(node):
            return wcast(node, dtype)
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return node
    return rec(params)
