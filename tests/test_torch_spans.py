"""The port's step tracer (`repro_torch.obs.spans`) on the CPU: off, the
model path records nothing and reads no clock; on, its spans nest as the
engine, the model step and the MoE dispatch open them, its engine
counters count what the engine served, the MoE counters count the
dispatch's entries and rows (the brute-force count they are read with
treats the last expert's overwritten entry as a drop, as the dispatch
does), and counting adds no operation to the step."""

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import init_params, model as tmodel, moe as tmoe
from repro_torch.models.quant import quantize_tree
from repro_torch.obs import spans
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

PHI = "phi3.5-moe-42b-a6.6b"
ARCHS = [PHI, "mamba2-2.7b"]

# what each span's parent is named, on either model
PARENTS = {
    "engine.step": {None},
    "model.decode_step": {"engine.step"}, "engine.sync": {"engine.step"},
    "attention_decode": {"model.decode_step"},
    "mamba2_decode": {"model.decode_step"},
    "model.prefill": {None},
    "attention": {"model.prefill"}, "mamba2_block": {"model.prefill"},
    "moe_ffn": {"model.decode_step", "model.prefill"},
    "unembed": {"model.decode_step", "model.prefill"},
    "wcast": {"attention_decode", "attention", "moe_ffn", "mamba2_decode",
              "mamba2_block"},
}

REQUESTS = [(i, [5 + i, 6, 7, 8, 9][: 2 + i % 4], 3 + i % 3)
            for i in range(6)]


@pytest.fixture(autouse=True)
def fresh_tracer():
    spans.collect()
    yield
    spans.collect()


def _model(arch, int8=True):
    cfg = smoke_config(arch).scaled(remat=False)
    params = init_params(cfg, 0, device="cpu")
    return cfg, quantize_tree(params) if int8 else params


def _serve(cfg, params, slots=3):
    eng = ServingEngine(cfg, params, ServeConfig(slots=slots, max_seq=64),
                        device="cpu")
    for rid, prompt, n in REQUESTS:
        eng.submit(Request(rid, prompt, n))
    eng.run_until_drained()
    return eng


def _prefill(cfg, params):
    tokens = torch.arange(2 * 16).reshape(2, 16) % cfg.vocab_size
    return tmodel.prefill(params, {"tokens": tokens}, cfg, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_off_records_nothing_and_reads_no_clock(arch, monkeypatch):
    cfg, params = _model(arch)

    def no_clock():
        raise AssertionError("a span site read the clock while off")
    monkeypatch.setattr(spans.time, "perf_counter_ns", no_clock)
    _serve(cfg, params)
    _prefill(cfg, params)
    monkeypatch.undo()
    rec = spans.collect()
    assert rec["spans"] == [] and rec["counters"] == {}


def _check_tree(rec, tops):
    got = rec["spans"]
    assert got
    names = [s[0] for s in got]
    for i, (name, t0, t1, parent, step) in enumerate(got):
        assert t1 >= t0, name
        want = PARENTS[name]
        if parent < 0:
            assert None in want, name
            assert step == sum(1 for s in got[:i] if s[3] < 0)
            continue
        assert parent < i and names[parent] in want, (name, names[parent])
        p = got[parent]
        assert p[1] <= t0 and t1 <= p[2], (name, p[0])
        assert step == p[4]
    assert {s[0] for s in got if s[3] < 0} == tops


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_nest_as_named(arch):
    cfg, params = _model(arch)
    spans.enable()
    eng = _serve(cfg, params)
    rec = spans.collect()
    _check_tree(rec, {"engine.step"})
    steps = [s for s in rec["spans"] if s[0] == "engine.step"]
    assert len(steps) == eng.batches_run
    # each step's children in the order the step runs them
    kids = [s[0] for s in rec["spans"] if s[3] == rec["spans"].index(
        steps[0])]
    assert kids == ["model.decode_step", "engine.sync"]
    assert sum(s[0] == "wcast" for s in rec["spans"]) > 0

    spans.enable()
    _prefill(cfg, params)
    _prefill(cfg, params)
    rec = spans.collect()
    _check_tree(rec, {"model.prefill"})
    assert [s[4] for s in rec["spans"] if s[3] < 0] == [0, 1]


def test_engine_counters_count_what_it_served():
    cfg, params = _model("mamba2-2.7b")
    spans.enable()
    eng = _serve(cfg, params)
    counters = spans.collect()["counters"]
    occupied = sum(len(r.prompt) + len(r.output) - 1
                   for r in eng.finished.values())
    # and, on CPU tensors, in_proj and out_proj dequantized a layer a step
    assert counters == {"engine.steps": eng.batches_run,
                        "engine.slot_steps": occupied,
                        "engine.prompt_slot_steps": sum(
                            len(p) for _, p, _ in REQUESTS),
                        "quant.dequant_calls":
                            2 * cfg.num_layers * eng.batches_run}


def test_collect_hands_over_once_and_empties():
    spans.enable()
    with spans.span("outer"):
        with spans.span("inner"):
            spans.add("n", 2)
        spans.add("n", 3)
        rec = spans.collect()           # inside "outer": still open
    assert [s[0] for s in rec["spans"]] == ["outer", "inner"]
    assert rec["spans"][0][2] == -1 and rec["spans"][1][2] > 0
    assert rec["counters"] == {"n": 5}
    assert isinstance(rec["clock_offset_ns"], int)
    assert spans.collect() == {"spans": [], "counters": {},
                               "clock_offset_ns": rec["clock_offset_ns"]}
    spans.enable()
    spans.disable()
    with spans.span("off"):
        pass
    assert spans.collect()["spans"] == []


def _brute(expert_idx, E, C):
    """(routed, rows, kept) of one dispatch, counted from its choices:
    min(n_e, C) entries an expert, less the last expert's overwritten one
    when it overflows."""
    n = np.bincount(expert_idx.reshape(-1).numpy(), minlength=E)
    kept = int(np.minimum(n, C).sum()) - int(n[E - 1] > C)
    return expert_idx.numel(), E * C, kept


def test_moe_counters_equal_a_brute_force_count():
    # the last expert overflows: 5 entries at capacity 2, and expert 0's 3
    E, K, T, C = 4, 2, 5, 2
    idx = torch.tensor([[3, 0], [3, 0], [3, 0], [3, 1], [3, 2]])
    gates = torch.full((T, K), 0.5)
    spans.enable()
    _, _, slot = tmoe._dispatch_tables(idx, gates, T, E, K, C)
    counters = spans.collect()["counters"]
    assert _brute(idx, E, C) == (10, 8, 5)
    assert (counters["moe.routed"], counters["moe.rows"],
            int((slot < E * C).sum())) == (10, 8, 5)


def test_counting_adds_no_operation():
    cfg, params = _model(PHI)

    def ops():
        with torch.profiler.profile() as prof:
            _prefill(cfg, params)
        return [e.name for e in prof.events()]
    off = ops()
    spans.enable()
    on = ops()
    assert spans.collect()["counters"]["moe.rows"] > 0
    assert on == off
