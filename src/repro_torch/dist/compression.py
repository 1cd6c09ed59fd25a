"""Gradient compression: symmetric int8 quantization with optional error
feedback (the residual is carried to the next step so quantization error
does not accumulate into bias); a port of `repro/dist/compression.py`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..tree import tree_map, tree_unzip


def _quantize_leaf(g: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """Round-trip one tensor through int8 (absmax / 127, round half to
    even); returns (dequantized, new residual)."""
    deq, _q, res = quantize_codes(g, residual)
    return deq, res


def quantize_codes(g: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """(dequantized, int8 codes, new residual) of one tensor: the codes are
    what the all-reduce would carry."""
    corrected = g if residual is None else g + residual
    # divide by a tensor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which can miss the quotient by one bit
    scale = torch.amax(torch.abs(corrected)) / torch.tensor(
        127.0, dtype=corrected.dtype, device=corrected.device)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(corrected / safe), -127, 127).to(torch.int8)
    deq = (q.to(corrected.dtype) * safe).to(g.dtype)
    return deq, q, corrected - deq


@torch.no_grad()
def compress_decompress(grads: Any) -> Any:
    """Simulate the all-reduce compression round-trip (no feedback)."""
    return tree_map(lambda g: _quantize_leaf(g)[0], grads)


@torch.no_grad()
def compress_with_feedback(grads: Any, residuals: Optional[Any] = None):
    """Quantize with error feedback.

    Returns `(compressed_grads, new_residuals)`; pass the residuals back in
    on the next call (None on the first step).  The residual bounds the
    *accumulated* error by a single step's quantization error.
    """
    if residuals is None:
        pairs = tree_map(_quantize_leaf, grads)
    else:
        pairs = tree_map(_quantize_leaf, grads, residuals)
    return tree_unzip(pairs, 2)
