"""PyTorch's eager elementwise and reduction kernels' share of the
device's busy time over the traced prefill calls, outside the dequantisation
(`records.elementwise_share`)."""

from perfbench.records import elementwise_share as read  # noqa: F401
