"""Median host time of the program's `model.decode_step` spans over the
window's steps outside the profiled slice: issuing one step's work,
which waits on nothing (`step_spans`)."""

import statistics

from perfbench.step_spans import program_spans


def read(records: dict) -> float:
    return statistics.median(
        (e - s) / 1e6 for s, e, _ in
        program_spans(records, "model.decode_step", False))
