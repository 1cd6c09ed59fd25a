"""The device's idle time in the profiled serve steps that falls inside
the program's `model.decode_step` spans, over the slice
(`step_spans.launch_idle_share`)."""

from perfbench.step_spans import launch_idle_share


def read(records: dict) -> float:
    return launch_idle_share(records, "model.decode_step")
