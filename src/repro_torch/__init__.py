"""PyTorch/CUDA port of the `repro` model substrate.

Mirrors the layout of the JAX package (`models/`, `configs/`, `kernels/`,
`serve/`) without importing it or JAX.  Entry points take a `device`
argument that defaults to "cuda" and raise when no card is present; the
attention kernels are CUDA C++ for Hopper (`csrc/`), compiled with nvcc at
first use on a CUDA tensor.
"""
