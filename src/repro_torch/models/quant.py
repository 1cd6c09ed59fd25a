"""Weight-only int8 quantization (W8A16) for serving; a port of
`repro/models/quant.py`.

Keeping a large model's weights resident on one card often fits only
with 8-bit weights: Phi-3.5-MoE's 41.9 B parameters take 83.7 GB in bf16
and 42.2 GB with int8 matmul weights.  Per-output-channel absmax scales
keep the matmul error small; embeddings, norms, the router and the SSM
scalars stay dense.

A quantized weight is the dict {"q": int8 (..., in, out), "s": f32
(..., out)}, and every matmul site takes both representations.  Each
site picks its path with `takes_kernel`, from shape, dtype and device
alone: an int8 weight meeting a bf16 activation on the card at decode
shapes (at most 64 rows a matrix) goes through the hand-written W8A16
kernel (`kernel_matmul`, `kernels/w8a16`), which reads the int8 weight
once and scales the f32 accumulator; everything else (dense weights, CPU
tensors, prefill-sized rows, f32 activations) computes `x @ wcast(w,
x.dtype)`, with `wcast` dequantizing the weight at every use.
"""

from __future__ import annotations

import torch

from ..kernels.w8a16 import ops as w8a16_ops
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


def takes_kernel(w, x: torch.Tensor) -> bool:
    """The path of `x @ w` at a matmul site: True for the W8A16 kernel (an
    int8 weight, a bf16 activation on a CUDA device, at most
    `w8a16_ops.MAX_ROWS` rows a matrix, a weight shape the kernel takes),
    False for `x @ wcast(w, x.dtype)`.  x is (..., K) against a (K, N)
    weight, or (E, M, K) against E matrices.  With the tracer on, each
    int8 matmul is counted under its path: `quant.kernel_calls`,
    `quant.dequant_calls`."""
    if not is_quantized(w):
        return False
    q = w["q"]
    K, N = q.shape[-2], q.shape[-1]
    rows = x.numel() // max(1, K * q.shape[:-2].numel())
    kernel = (x.is_cuda and x.dtype == torch.bfloat16
              and w8a16_ops.takes(rows, K, N))
    if spans.ON:
        spans.add("quant.kernel_calls" if kernel else "quant.dequant_calls",
                  1)
    return kernel


def kernel_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x @ w on the W8A16 kernel, for the calls `takes_kernel` sends it:
    x (..., K) against a 2-D weight, or (E, M, K) against E matrices."""
    return w8a16_ops.w8a16_matmul(x.contiguous(), w)


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
