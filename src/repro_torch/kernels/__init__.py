"""Hand-written CUDA kernels for Hopper, one package per kernel of the JAX
package's `kernels/`: `ref.py` holds the plain PyTorch version, `ops.py`
the wrapper.  A wrapper takes the plain version for CPU tensors only; for
a CUDA tensor it launches the kernel (built from `csrc/` at first use) or
raises.  Each `ops.py` counts its kernel launches in `ops.launches`, and
the kernels are forward-only: a wrapper raises (`refuse_grad`) when autograd
would need a gradient through it, on every device, as JAX does.
"""

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when gradients are on and an input requires one: the kernels
    (and the plain versions that stand in for them on the CPU) are
    forward-only, as the reference's Pallas kernels are."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernels are forward-only and give no gradient; "
            "train with attn_impl='xla'")
