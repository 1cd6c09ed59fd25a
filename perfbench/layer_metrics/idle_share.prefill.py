"""The device's idle share over the traced prefill calls
(`records.idle_share`)."""

from perfbench.records import idle_share as read  # noqa: F401
