"""One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates without
sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12        # tensor-core bf16
F32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES = 3.35e12        # HBM3, bytes/s


def bound_s(flops: float, nbytes: float, flops_peak: float = BF16_FLOPS
            ) -> float:
    """The least time the chip could take: the larger of the operations
    over the compute peak and the bytes over the memory bandwidth."""
    return max(flops / flops_peak, nbytes / HBM_BYTES)
