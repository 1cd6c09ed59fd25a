"""The int8 weights' dequantisation's share of the device's busy time over
the traced serve steps (`records.dequant_share`)."""

from perfbench.records import dequant_share as read  # noqa: F401
