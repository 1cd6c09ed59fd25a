"""What the per-layer readers share: picking device operations out of a
traced slice's records (see `trace`)."""

from __future__ import annotations

import re

from .harness import Missing

# PyTorch's eager elementwise and reduction kernels
ELEMENTWISE = re.compile(r"elementwise_kernel|reduce_kernel")


def need(records: dict, *keys: str) -> None:
    for k in keys:
        if k not in records:
            raise Missing(f"the run recorded no {k!r}")


def busy_s(records: dict) -> float:
    need(records, "busy_s")
    if records["busy_s"] <= 0:
        raise Missing("no operation ran on the device in the traced slice")
    return records["busy_s"]


def device_s(records: dict, pattern: str, expect: int, counter: str
             ) -> float:
    """Seconds of the device operations whose name matches `pattern`,
    which must number `expect`, as the program's launch counter
    `counter` counted over the slice."""
    need(records, "device", "launches")
    rx = re.compile(pattern)
    durs = [(e - s) / 1e6 for name, s, e in records["device"]
            if rx.search(name)]
    if not durs:
        raise Missing(f"no device operation matches {pattern!r}")
    launched = records["launches"].get(counter, 0)
    if len(durs) != expect or launched != expect:
        raise Missing(f"{len(durs)} operations match {pattern!r} and "
                      f"{counter} counted {launched}, the slice's calls "
                      f"need {expect}")
    return sum(durs)


def kernel_s(records: dict, keep) -> tuple[float, int]:
    """(seconds, count) of the launched kernels for which
    `keep(name, labels)` holds."""
    need(records, "kernels")
    total, n = 0.0, 0
    for name, secs, labels in records["kernels"]:
        if keep(name, labels):
            total += secs
            n += 1
    return total, n


def dequant_share(records: dict) -> float:
    """Device time of the kernels launched under the program's `wcast`
    (int8 weights dequantised at every matmul, labelled where each caller
    binds it: `layers.wcast` and `moe.wcast`) over the busy time."""
    secs, n = kernel_s(records, lambda name, labels: "wcast" in labels)
    if n == 0:
        raise Missing("no kernel ran under wcast")
    return secs / busy_s(records)


def elementwise_share(records: dict) -> float:
    """Device time of PyTorch's eager elementwise and reduction kernels
    launched outside `wcast` over the busy time."""
    secs, n = kernel_s(records, lambda name, labels:
                       "wcast" not in labels and bool(ELEMENTWISE.search(name)))
    if n == 0:
        raise Missing("no elementwise kernel in the traced slice")
    return secs / busy_s(records)


def idle_share(records: dict) -> float:
    """1 - the union of the device operations' intervals over the slice's
    length on the host clock."""
    need(records, "window_s")
    return 1.0 - busy_s(records) / records["window_s"]
