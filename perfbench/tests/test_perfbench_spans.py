"""The program's step tracer (`repro_torch.obs.spans`) seen from the
benchmark: a driver's run records nothing unless the tracer is on; on
over a window, the engine's counters equal the driver's own sums, the
MoE counters a brute-force count of the window's recorded routes, and
the entries kept that `step_spans.kept_entries` counts from those routes
the program's own dispatch tables; the span readers read such a window;
on the profiler's clock the program's spans hold the operators they
issued and attribute operator time as the benchmark's labels
(`program.LABELS`) do.  On the card (`-m gpu`): a traced step waits on
nothing, every launch lies inside a span, and the device clock lies on
the host's: a kernel that ends an idle gap starts a launch's latency
after its host call, and none starts far before its span."""

import numpy as np
import pytest
import torch

from perfbench_testing import ROOT, H, cell, run

from perfbench import program as P
from perfbench import step_spans, traffic
from perfbench.trace import TracedSlice
from repro_torch.obs import spans

SLACK_US = 50
# kineto's device timestamps, moved onto the host's clock, put some
# operations before the host call that launched them: by tens of us, and
# in one profile of eight by up to 0.7 ms, on an H100 (torch 2.11); no
# device start may lie further than this before its launching span, the
# launch itself (the host's clock against the host's) not at all
DEVICE_CLOCK_NS = 2_000_000
# a kernel that starts after the device idled this long was waiting for
# its launch, so it starts a launch's latency after the host's call; the
# median of those delays is held within LATENCY_NS of 0 (a few us on an
# H100), which is how far the device's clock may lie from the host's
IDLE_NS = 50_000
LATENCY_NS = 100_000


@pytest.fixture(autouse=True)
def fresh_tracer():
    spans.collect()
    yield
    spans.collect()


@pytest.fixture
def window(monkeypatch):
    """The tracer turned on where a driver's window opens (its
    `reset_peak` is set-up's last call), and the routes the window's MoE
    dispatches chose."""
    reset = H.reset_peak
    with P.recorded_routes() as calls:
        def open_window(c):
            reset(c)
            calls.clear()
            spans.enable()
        monkeypatch.setattr(H, "reset_peak", open_window)
        yield calls


@pytest.mark.parametrize("config, kind", [("phi35moe-int8", "serve"),
                                          ("mamba2-2.7b", "prefill")])
def test_a_run_records_nothing_with_the_tracer_off(config, kind):
    run(cell(config, kind, trace=True))
    assert spans.collect()["spans"] == []


@pytest.mark.parametrize("config", ["phi35moe-int8", "mamba2-2.7b"])
def test_engine_counters_equal_the_drivers_sums(config, window):
    out = run(cell(config, "serve", trace=True))
    counters = spans.collect()["counters"]
    rec = out.records
    assert out.correct
    assert (counters["engine.steps"], counters["engine.slot_steps"],
            counters["engine.prompt_slot_steps"]) == \
        (rec["window_steps"], rec["occupied"], rec["prompt_steps"])


def _brute(routes, cfg):
    """(routed, rows, kept) over the recorded dispatches: T*K, E*C, and
    min(n_e, C) entries an expert less the last expert's overwritten one
    where it overflows (numpy's count, beside `step_spans`')."""
    E, K = cfg.num_experts, cfg.experts_per_token
    out = np.zeros(3, np.int64)
    for ids in routes:
        T = ids.shape[0]
        C = P.moe_mod._capacity(cfg, T)
        n = np.bincount(ids.reshape(-1).cpu().numpy(), minlength=E)
        out += (T * K, E * C,
                int(np.minimum(n, C).sum()) - int(n[E - 1] > C))
    return tuple(int(x) for x in out)


def _tables_kept(routes, cfg):
    """The entries the program's own dispatch tables give a row."""
    E, K, kept = cfg.num_experts, cfg.experts_per_token, 0
    for ids in routes:
        T = ids.shape[0]
        C = P.moe_mod._capacity(cfg, T)
        _, _, slot = P.moe_mod._dispatch_tables(
            ids, torch.ones(ids.shape), T, E, K, C)
        kept += int((slot < E * C).sum())
    return kept


@pytest.mark.parametrize("kind", ["serve", "prefill"])
def test_moe_counters_equal_a_count_of_the_recorded_routes(kind, window):
    c = cell("phi35moe-int8", kind)
    run(c)
    counters = spans.collect()["counters"]
    cfg = P.config(c.conf, True)
    assert window
    routed, rows, kept = _brute(window, cfg)
    assert (counters["moe.routed"], counters["moe.rows"]) == (routed, rows)
    assert step_spans.kept_entries(window, cfg) == kept == \
        _tables_kept(window, cfg)


def test_span_readers_on_a_traced_smoke_window(window):
    """The readers that need no device trace, on a SMOKE Phi serve
    window recorded as a traced run with the tracer on records it."""
    c = cell("phi35moe-int8", "serve", trace=True)
    out = run(c)
    rec = dict(out.records, **spans.collect())
    cfg = P.config(c.conf, True)
    first = rec["window_steps"] // 2
    rec.update(slice_ids=list(range(first, first + len(rec["steps"]))),
               gen_steps=[rec["window_steps"]],
               moe_kept=step_spans.kept_entries(window, cfg))
    steps = [(e - s) / 1e6 for n, s, e, _, _ in rec["spans"]
             if n == "engine.step"]
    assert len(steps) == rec["window_steps"]
    enqueue = H.reader("enqueue_ms.serve")(rec)
    assert 0 < enqueue < max(steps)
    assert 0 < H.reader("step_gap_ms.serve")(rec) < max(steps)
    use = H.reader("expert_row_use.serve")(rec)
    c_ = rec["counters"]
    assert 0 < use <= min(1.0, c_["moe.routed"] / c_["moe.rows"])


def _traced_phi_steps(steps=3):
    """A few SMOKE Phi serve steps under the benchmark's traced slice,
    with the tracer on: (the slice, the tracer's record, kineto's trace
    start in epoch ns)."""
    c = cell("phi35moe-int8", "serve")
    cfg = P.config(c.conf, smoke=True)
    params = P.build_params(c.weights, c.m, c.seed, "cpu")
    eng = P.engine_mod.ServingEngine(cfg, params, P.engine_mod.ServeConfig(
        slots=c.mix["slots"], max_seq=c.mix["max_seq"]), device="cpu")
    for rid, prompt, new in traffic.requests(c.mix, c.seed, 0,
                                             c.m["vocab_size"]):
        eng.submit(P.engine_mod.Request(rid, prompt, new))
    eng.step_batch()                     # warm
    spans.enable()
    with TracedSlice(P, cuda=False) as sl:
        for _ in range(steps):
            eng.step_batch()
    rec = spans.collect()
    return sl, rec, sl.prof.profiler.kineto_results.trace_start_ns()


def _aligned(rec, start_ns, name):
    """The spans named `name` as (start, end) in the profiler's us."""
    off = rec["clock_offset_ns"] - start_ns
    return [((s[1] + off) / 1e3, (s[2] + off) / 1e3) for s in rec["spans"]
            if s[0] == name]


def _top_ops(events):
    """The operators the program called itself: aten events with no aten
    event around them."""
    def nested(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                return True
            p = p.cpu_parent
        return False
    return [e for e in events if e.name.startswith("aten::")
            and not nested(e)]


def test_decode_step_spans_hold_their_operators_on_the_profiler_clock():
    sl, rec, start_ns = _traced_phi_steps()
    steps = _aligned(rec, start_ns, "model.decode_step")
    labels = sorted((e for e in sl.prof.events() if e.name == "decode_step"),
                    key=lambda e: e.time_range.start)
    assert len(steps) == len(labels) == 3
    for (a, b), label in zip(steps, labels):
        ops = [e for e in _top_ops(sl.prof.events())
               if label.time_range.start <= e.time_range.start
               and e.time_range.end <= label.time_range.end]
        assert ops
        for e in ops:
            assert a - SLACK_US <= e.time_range.start, (e.name, a)
            assert e.time_range.end <= b + SLACK_US, (e.name, b)


def _under(e, label):
    p = e.cpu_parent
    while p is not None:
        if p.name == label:
            return True
        p = p.cpu_parent
    return False


@pytest.mark.parametrize("label", ["wcast", "moe_ffn"])
def test_program_spans_attribute_operator_time_as_the_labels_do(label):
    sl, rec, start_ns = _traced_phi_steps()
    inside = _aligned(rec, start_ns, label)
    both = by_label = by_span = 0.0
    for e in _top_ops(sl.prof.events()):
        mid = (e.time_range.start + e.time_range.end) / 2
        dur = e.time_range.elapsed_us()
        lab = _under(e, label)
        spn = any(a <= mid <= b for a, b in inside)
        by_label += dur * lab
        by_span += dur * spn
        both += dur * (lab and spn)
    assert by_label > 0
    assert both >= 0.99 * by_label and both >= 0.99 * by_span, \
        (both, by_label, by_span)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

SERVE_CELLS = [("phi35moe-int8", "serve-chat"), ("mamba2-2.7b", "serve-wide")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _full_engine(config, traffic_name):
    bench = H.load_benchmark(ROOT)
    conf = H.config_file(bench, config, ROOT)
    mix = H.mix_file(traffic_name)
    cfg = P.config(conf)
    params = P.build_params(conf["program"]["weights"], conf["model"], 1,
                            "cuda")
    eng = P.engine_mod.ServingEngine(cfg, params, P.engine_mod.ServeConfig(
        slots=mix["slots"], max_seq=mix["max_seq"], eos_id=mix["eos_id"]),
        device="cuda")
    for rid, prompt, new in traffic.requests(mix, 1, 0,
                                             conf["model"]["vocab_size"]):
        eng.submit(P.engine_mod.Request(rid, prompt, new))
    for _ in range(2):                   # builds and warms the kernels
        eng.step_batch()
    torch.cuda.synchronize()
    return eng


def _launches(prof):
    """(start and end of a device operation, start of the host call that
    launched it, the operation's name), epoch ns: the runtime call
    sharing its correlation id, else the operator kineto links it to."""
    from torch.autograd import DeviceType
    runtime, ops, dev = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            book = runtime if e.name().startswith("cu") else ops
            book[e.correlation_id()] = e.start_ns()
        else:
            dev.append(e)
    out = []
    for e in dev:
        host = runtime.get(e.correlation_id(),
                           ops.get(e.linked_correlation_id()))
        if host is not None:
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), host,
                        e.name()))
    return sorted(out)


def _after_idle(pairs):
    """Launch delays (device start - host call start, ns) of the
    operations that start after the device idled IDLE_NS or more (the
    first one too: the step starts on an idle device)."""
    out, busy_to = [], None
    for dev_ns, end_ns, host_ns, _ in pairs:
        if busy_to is None or dev_ns > busy_to + IDLE_NS:
            out.append(dev_ns - host_ns)
        busy_to = end_ns if busy_to is None else max(busy_to, end_ns)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("config, traffic_name", SERVE_CELLS)
def test_traced_step_waits_on_nothing_and_kernels_follow_their_spans(
        card, config, traffic_name):
    from torch.profiler import ProfilerActivity, profile
    eng = _full_engine(config, traffic_name)
    tokens = eng._gather_tokens()
    torch.cuda.synchronize()
    spans.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, eng.cache = P.model_mod.decode_step(eng.params, eng.cache, tokens,
                                               eng.cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert any(s[0] == "model.decode_step" for s in spans.collect()["spans"])

    spans.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step_batch()
        torch.cuda.synchronize()
    rec = spans.collect()
    off = rec["clock_offset_ns"]
    tree = [(s[1] + off, s[2] + off, s[0]) for s in rec["spans"]]
    pairs = _launches(prof)
    assert len(pairs) > 100
    outside, late = [], []
    for dev_ns, _, host_ns, name in pairs:
        around = [(a, span) for a, b, span in tree if a <= host_ns <= b]
        if not around:
            outside.append((name[:60], host_ns - tree[0][0]))
            continue
        a, span = max(around)
        if dev_ns < a - DEVICE_CLOCK_NS:
            late.append(((a - dev_ns) / 1e3, span, name[:60]))
    assert not outside, (len(outside), outside[:5])
    skew = max(host - dev for dev, _, host, _ in pairs) / 1e3
    assert not late, (skew, len(late), sorted(late, reverse=True)[:5])
    delays = _after_idle(pairs)
    assert abs(float(np.median(delays))) <= LATENCY_NS, \
        (len(delays), sorted(delays)[:5], sorted(delays)[-5:])
