"""The traced slice of a `--trace 1` run: a fixed stretch of the window
under `torch.profiler` (CPU and CUDA activity), with the program's
functions in `program.LABELS` wrapped in ranges of their names.  After
the slice it becomes the records the per-layer readers take:

- "device": every device operation, (name, start us, end us);
- "kernels": every kernel launched from a CPU event, (name, seconds,
  labels of the ranges around its launch, innermost first);
- "busy_s": the union of the device operations' intervals;
- "window_s": the slice's length on the host clock;
- "launches": the program's launch counters over the slice;
- "breakdown": the device operations that took most time, and the idle
  time between them by what the host was doing (the innermost range or
  operator open on the main thread, "python" where none is).
"""

from __future__ import annotations

import time

import torch

SLICE = "perfbench.slice"


class TracedSlice:
    def __init__(self, program, cuda: bool):
        self.program, self.cuda = program, cuda

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self._sync()
        self.before = self.program.launches()
        self.labels = self.program.labelled()
        self.names = self.labels.__enter__()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.range = record_function(SLICE)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        self.prof.__exit__(*exc)
        self.labels.__exit__(*exc)
        after = self.program.launches()
        self.launches = {k: after[k] - self.before[k] for k in after}
        return False

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def records(self) -> dict:
        from torch.autograd import DeviceType
        events = self.prof.events()
        device, kernels, cpu = [], [], []
        tid = None
        for e in events:
            if e.device_type == DeviceType.CUDA:
                # the profiler mirrors each range onto the device's
                # timeline; those spans are no operation
                if e.name not in self.names and e.name != SLICE:
                    device.append((e.name, e.time_range.start,
                                   e.time_range.end))
                continue
            if e.name == SLICE:
                tid = e.thread
            cpu.append(e)
            if e.kernels:
                chain, p = [], e
                while p is not None:
                    if p.name in self.names:
                        chain.append(p.name)
                    p = p.cpu_parent
                for k in e.kernels:
                    kernels.append((k.name, k.duration / 1e6, tuple(chain)))
        busy, gaps = union(device)
        host = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
                if e.thread == tid and e.name != SLICE]
        return {"device": device, "kernels": kernels, "busy_s": busy / 1e6,
                "window_s": self.window_s, "launches": self.launches,
                "breakdown": breakdown(device, gaps, host)}


def union(device: list) -> tuple[float, list]:
    """(total us covered by the intervals, the gaps between them)."""
    spans = sorted((s, e) for _, s, e in device)
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def host_at(host: list, points: list) -> list:
    """The innermost host event open at each point (sorted points), or
    "python" where none is; host events nest on one thread."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "python")
    return out


def breakdown(device: list, gaps: list, host: list, top: int = 10) -> dict:
    ops: dict = {}
    for name, s, e in device:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    idle: dict = {}
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), name in zip(gaps, host_at(host, mids)):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    def best(d):
        return [[k[:160], v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:top]]
    return {"device_ops": best(ops), "idle_gaps": best(idle)}
