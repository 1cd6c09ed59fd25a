"""Hand-written CUDA kernels for Hopper, one package per kernel of the JAX
package's `kernels/`: `ref.py` holds the plain PyTorch version, `ops.py`
the wrapper.  A wrapper takes the plain version for CPU tensors only; for
a CUDA tensor it launches the kernel (built from `csrc/` at first use) or
raises.  Each `ops.py` counts its kernel launches in `ops.launches`.
"""
