"""Occupied slot-steps that fed a prompt token over all occupied
slot-steps of the window, from the engine's requests (the engine
prefills a prompt one token a decode step)."""

from perfbench.records import need


def read(records: dict) -> float:
    need(records, "occupied", "prompt_steps")
    return records["prompt_steps"] / records["occupied"]
