"""Both drivers end to end on the CPU at the configurations' SMOKE sizes:
the program's output held to the plain reference, the control read one
precision below, and a run whose timed path is broken underneath seen to
come out not correct, once for each fault the cell can have."""

import pytest
import torch

from perfbench_testing import cell, run

from perfbench import program as P

CONFIGS = ["phi35moe-int8", "mamba2-2.7b"]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("kind", ["serve", "prefill"])
def test_sound_run_is_correct(config, kind):
    out = run(cell(config, kind))
    assert out.correct, (out.compared, out.notes)
    assert out.attempted > 0 and out.failed == 0
    key = "gen_tokens_per_s" if kind == "serve" else "prefill_tokens_per_s"
    assert out.e2e[key] > 0
    # the port agrees with the reference well inside the limits (a
    # projection's limit lies between the bf16 and int8 readings)
    for name, (value, limit) in out.compared.items():
        assert value < limit / (2 if name == "proj_err" else 3), name


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("kind", ["serve", "prefill"])
def test_control_reads_far_above_the_program(config, kind):
    """The reference one precision below, read beside the program, and
    where the configuration names one, the program on its own
    lower-precision path: each reads some number at three times the
    program's or more."""
    c = cell(config, kind, control="scheme")
    out = run(c)
    name = "token_gap_sd" if kind == "serve" else "logit_err_sd"
    program, control = out.compared[name][0], out.control[name]
    assert control > 3 * program, (program, control)
    if "program" in c.conf["control"]:
        low = run(cell(config, kind, control="program"))
        ratios = {k: low.compared[k][0] / v for k, (v, _) in
                  out.compared.items()}
        assert max(ratios.values()) > 3, ratios


@pytest.mark.parametrize("kind", ["serve", "prefill"])
def test_mamba2_projection_off_by_two_percent_is_not_correct(kind,
                                                             monkeypatch):
    """A Mamba2 projection whose output is 2 % too large fails
    `proj_err`."""
    real = P.mamba2_mod.linear
    monkeypatch.setattr(P.mamba2_mod, "linear",
                        lambda w, x: real(w, x) * 1.02)
    out = run(cell("mamba2-2.7b", kind))
    value, limit = out.compared["proj_err"]
    assert value > limit and not out.correct, out.compared


def _stale(real):
    """A step that returns its state unchanged."""
    def step(params, cache, tokens, cfg):
        saved = P.tree_map(lambda t: t.clone(), cache)
        logits, _ = real(params, cache, tokens, cfg)
        return logits, saved
    return step


def _half(real):
    """Half of the batch left out: its rows take the mean of the rest."""
    def step(*a):
        logits, rest = real(*a)
        logits = logits.clone()
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(0)
        return logits, rest
    return step


def _altered(real):
    """A token altered where it is produced: every fifth step's logits
    shifted by one place, so each slot's choice moves to the next id."""
    n = [0]

    def step(*a):
        logits, rest = real(*a)
        n[0] += 1
        if n[0] % 5 == 0:
            logits = logits.roll(1, dims=-1)
        return logits, rest
    return step


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_serve_fault_is_not_correct(config, fault, monkeypatch):
    monkeypatch.setattr(P.engine_mod, "decode_step",
                        fault(P.engine_mod.decode_step))
    out = run(cell(config, "serve"))
    assert out.e2e["gen_tokens_per_s"] > 0
    assert any(v > lim for v, lim in out.compared.values()), out.compared


def _half_prefill(real):
    def call(*a):
        out = real(*a).clone()
        h = out.shape[0] // 2
        out[h:] = out[:h].mean(0)
        return out
    return call


def _altered_prefill(real):
    def call(*a):
        out = real(*a).clone()
        out[0] = out[0].roll(1)
        return out
    return call


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault", [_half_prefill, _altered_prefill])
def test_prefill_fault_is_not_correct(config, fault, monkeypatch):
    monkeypatch.setattr(P.model_mod, "prefill", fault(P.model_mod.prefill))
    out = run(cell(config, "prefill"))
    assert any(v > lim for v, lim in out.compared.values()), out.compared


def test_moe_route_away_from_the_router_is_not_correct(monkeypatch):
    """Routes the router would not choose fail the route margin."""
    real = P.moe_mod._route

    def worst(params, xf, cfg, group=None):
        gate, ids, aux = real(params, xf, cfg, group)
        probs = torch.softmax(xf.float() @ params["router"].float(), -1)
        low = torch.sort(probs, dim=-1, stable=True).indices[:, :ids.shape[1]]
        return gate, low, aux
    monkeypatch.setattr(P.moe_mod, "_route", worst)
    out = run(cell("phi35moe-int8", "prefill"))
    assert out.compared["route_margin"][0] > \
        out.compared["route_margin"][1]
    assert not out.correct


def test_traced_run_gives_records_on_the_cpu():
    """The traced slice runs on the CPU too; the device readers then find
    nothing to read, and the engine's counters are there."""
    from perfbench import harness as H
    out = run(cell("mamba2-2.7b", "serve", seconds=3.0, trace=True))
    rec = out.records
    assert rec["window_s"] > 0 and rec["steps"] and rec["occupied"] > 0
    assert 0 < H.reader("slot_occupancy.serve")(rec) <= 1
    with pytest.raises(H.Missing):
        H.reader("idle_share.serve")(rec)
