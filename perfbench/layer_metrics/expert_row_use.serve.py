"""The serve window's routed entries that an expert row held over the
rows the expert GEMMs ran (`step_spans.expert_row_use`)."""

from perfbench.step_spans import expert_row_use as read  # noqa: F401
