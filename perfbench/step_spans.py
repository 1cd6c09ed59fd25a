"""What the readers of the program's step tracer (`repro_torch.obs.spans`)
share.  A traced run that turned the tracer on over its window adds to
its records:

- `spans`: the tracer's (name, start_ns, end_ns, parent, step), on
  `time.perf_counter_ns()`; `step` is the engine step (serve) or the
  prefill call counted from the window's start;
- `counters`: the tracer's {name: int};
- `clock_offset_ns`: `time.time_ns() - time.perf_counter_ns()`, which
  with kineto's `trace_start_ns` places a span on the profiler's clock;
- `slice_ids`: the steps or calls the profiled slice ran;
- `gen_steps` (serve): the window's steps of each generation, in order;
- `moe_kept` (a MoE): the window's routed entries that an expert row
  held, counted from its recorded routes by `kept_entries`.

A program without the tracer records none of them, and every reader of
them raises `Missing`, never 0."""

from __future__ import annotations

from .harness import Missing
from .records import busy_s, need


def program_spans(records: dict, name: str, in_slice: bool) -> list:
    """The program's finished spans named `name`, (start_ns, end_ns,
    step), of the steps or calls inside the profiled slice (`in_slice`)
    or outside it."""
    need(records, "spans", "slice_ids")
    ids = set(records["slice_ids"])
    out = [(s, e, step) for n, s, e, _, step in records["spans"]
           if n == name and e >= 0 and (step in ids) == in_slice]
    if not out:
        raise Missing(f"no {name!r} span {'in' if in_slice else 'outside'}"
                      " the profiled slice")
    return out


def launch_idle_share(records: dict, name: str) -> float:
    """The parts of the device's idle gaps in the slice (`trace.union`
    over its device operations, as `idle_share` takes them) that lie
    inside the program's `name` spans on the profiler's clock, over the
    slice's length: the device waiting while the host issues work."""
    from .trace import union
    need(records, "device", "clock_offset_ns", "trace_start_ns",
         "window_s")
    busy_s(records)
    shift = records["clock_offset_ns"] - records["trace_start_ns"]
    inside = sorted(((s + shift) / 1e3, (e + shift) / 1e3)
                    for s, e, _ in program_spans(records, name, True))
    _, gaps = union(records["device"])
    total = 0.0
    for a, b in gaps:
        for s, e in inside:
            if s >= b:
                break
            total += max(0.0, min(b, e) - max(a, s))
    return total / 1e6 / records["window_s"]


def kept_entries(routes: list, cfg) -> int:
    """The routed entries an expert row held over the dispatches whose
    expert ids (T, K) are `routes`: min(n_e, C) of each expert's n_e, less
    the last expert's entry at row C-1 where it overflowed, which the
    dispatch overwrites with the pad as the reference does."""
    import torch

    from . import program as P
    E, kept = cfg.num_experts, 0
    for ids in routes:
        C = P.moe_mod._capacity(cfg, ids.shape[0])
        n = torch.bincount(ids.reshape(-1), minlength=E)
        kept += int(torch.clamp(n, max=C).sum()) - int(n[E - 1] > C)
    return kept


def expert_row_use(records: dict) -> float:
    """The window's routed entries that an expert row held (`moe_kept`)
    over the rows the expert GEMMs ran (the program's `moe.rows`)."""
    need(records, "counters", "moe_kept")
    rows = records["counters"].get("moe.rows", 0)
    if not rows:
        raise Missing("the program counted no MoE dispatch")
    return records["moe_kept"] / rows
