"""Median host time, over consecutive steps of one generation outside
the profiled slice, from the end of step n's `engine.sync` (its tokens
on the host, the stream drained) to the start of step n+1's
`model.decode_step`: the device idles through it (`step_spans`)."""

import statistics

from perfbench.records import Missing, need


def read(records: dict) -> float:
    need(records, "spans", "slice_ids", "gen_steps")
    skip = set(records["slice_ids"])
    sync_end, dec_start = {}, {}
    for name, s, e, _, step in records["spans"]:
        if name == "engine.sync" and e >= 0:
            sync_end[step] = e
        elif name == "model.decode_step":
            dec_start[step] = s
    gaps, first = [], 0
    for n in records["gen_steps"]:
        for k in range(first, first + n - 1):
            if k in skip or k + 1 in skip:
                continue
            if k in sync_end and k + 1 in dec_start:
                gaps.append((dec_start[k + 1] - sync_end[k]) / 1e6)
        first += n
    if not gaps:
        raise Missing("no consecutive steps outside the profiled slice")
    return statistics.median(gaps)
