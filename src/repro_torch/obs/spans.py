"""Host-clock spans and counters of the model path: the serving engine's
step, the model's step and prefill, the MoE dispatch and the functions a
profile is read by (`wcast`, `attention`, `moe_ffn`, ...).

Off unless a caller turns it on.  A caller's whole surface is
`enable()`, `disable()` and `collect()`; the program's sites use
`traced` (a function), `span` (a block) and `add` (a counter).

- Off, a site costs one check of the module's flag `ON` (and, for a
  `traced` function, the call into its wrapper): no allocation, no clock
  read, nothing launched on the device.
- On, a span is two reads of `time.perf_counter_ns()` and a list entry,
  a counter a Python int.  Nothing reads the device or waits for it.
- No span opens a `torch.profiler.record_function` range.  The profiler
  mirrors each range onto the device's timeline, where a trace reader
  would count it as device work; the spans stay host records instead,
  placed on kineto's timeline by `clock_offset_ns` (`time.time_ns() -
  time.perf_counter_ns()`, sampled by `enable()`): a span's epoch start
  is `start_ns + clock_offset_ns`, to subtract kineto's
  `trace_start_ns()` from.

A span is (name, start_ns, end_ns, parent, step): `parent` the index of
the span open around it in `collect()["spans"]`, -1 at the top;
`step` the index of the top-level span it belongs to, which is the
engine step or the prefill call whoever opened it.  One thread records;
a span still open when `collect()` runs has end_ns -1.
"""

from __future__ import annotations

import contextlib
import functools
import time

ON = False
_spans: list = []          # [name, start_ns, end_ns, parent, step]
_open: list = []           # indices into _spans, innermost last
_steps = 0
_counters: dict = {}       # name -> int
_offset = 0


def enable() -> None:
    """Start a fresh record: spans and counters emptied, the clock
    offset sampled, recording on."""
    global ON, _steps, _offset
    _spans.clear()
    _open.clear()
    _counters.clear()
    _steps = 0
    _offset = time.time_ns() - time.perf_counter_ns()
    ON = True


def disable() -> None:
    """Stop recording; what was recorded stays for `collect()`."""
    global ON
    ON = False


def collect() -> dict:
    """Stop recording and hand over the record: {"spans": [(name,
    start_ns, end_ns, parent, step), ...] in opening order, "counters":
    {name: int}, "clock_offset_ns": int}; the record is emptied."""
    disable()
    out = {"spans": [tuple(s) for s in _spans],
           "counters": dict(_counters), "clock_offset_ns": _offset}
    _spans.clear()
    _open.clear()
    _counters.clear()
    return out


def _begin(name: str) -> int:
    global _steps
    if _open:
        parent = _open[-1]
        step = _spans[parent][4]
    else:
        parent, step = -1, _steps
        _steps += 1
    i = len(_spans)
    _spans.append([name, time.perf_counter_ns(), -1, parent, step])
    _open.append(i)
    return i


def _end(i: int) -> None:
    t = time.perf_counter_ns()
    # a record emptied while the span was open has no place for its end
    if _open and _open[-1] == i:
        _open.pop()
        _spans[i][2] = t


@contextlib.contextmanager
def _recorded(name: str):
    i = _begin(name)
    try:
        yield
    finally:
        _end(i)


_OFF = contextlib.nullcontext()


def span(name: str):
    """A block's span: `with spans.span("engine.sync"): ...`."""
    return _recorded(name) if ON else _OFF


def traced(name: str):
    """Decorator: each call of the function is a span named `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ON:
                return fn(*args, **kwargs)
            i = _begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _end(i)
        return wrapper
    return deco


def add(name: str, n: int) -> None:
    """Counter `name` += n, a host int.  Call under `if spans.ON:`."""
    _counters[name] = _counters.get(name, 0) + n
