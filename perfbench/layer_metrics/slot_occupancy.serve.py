"""Occupied slot-steps over slots x steps of the window."""

from perfbench.records import need


def read(records: dict) -> float:
    need(records, "occupied", "slots", "window_steps")
    return records["occupied"] / (records["slots"] * records["window_steps"])
