"""Distributed-training helpers: the sharding policy and mesh context,
pipeline-parallel schedules and gradient compression; mirrors
`repro.dist`."""

from .compression import compress_decompress, compress_with_feedback
from .pipeline import bubble_fraction, gpipe, pp_vs_dp_napkin

__all__ = [
    "bubble_fraction",
    "compress_decompress",
    "compress_with_feedback",
    "gpipe",
    "pp_vs_dp_napkin",
]
