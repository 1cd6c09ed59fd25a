"""The benchmark's files are found by name, and a new mix, metric or cell
is picked up from new files alone."""

import json
import re

import pytest

from perfbench_testing import ROOT, H, run

from perfbench import run as R

BENCH = H.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_config_mix_and_driver(cell):
    spec = H.find(BENCH["workloads"], cell, "workload")
    conf = H.config_file(BENCH, spec["config"], ROOT)
    mix = H.mix_file(spec["traffic"])
    assert conf["name"] == spec["config"]
    assert callable(H.driver(mix["driver"]).run)
    kinds = {x["name"] for x in H.reported(BENCH, cell, False)}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert H.reported(BENCH, cell, True)
    assert set(conf["limits"][mix["driver"]]) >= {"token_gap_sd"} or \
        set(conf["limits"][mix["driver"]]) >= {"logit_err_sd"}


@pytest.mark.parametrize("metric", [x["name"] for x in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(H.reader(metric))


def test_benchmark_json_is_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {x["name"] for x in BENCH["end_to_end"]}
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert {w["config"] for w in BENCH["workloads"]} == configs
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for x in BENCH["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and UNIT.match(x["unit"])
        assert x["source"] in ("host_clock", "device_trace")
        assert set(x.get("workloads", cells)) <= cells
    for x in BENCH["per_layer"]:
        assert x["moves"] in e2e and UNIT.match(x["unit"])
        assert set(x["workloads"]) <= cells
        for cell in x["workloads"]:      # each cell reports what it moves
            assert x["moves"] in {m["name"] for m in
                                  H.reported(BENCH, cell, False)}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_numbers_are_the_programs(config):
    """The numbers the reference reads are the program's config's (and
    its SMOKE config's), so the two cannot drift apart."""
    from perfbench import program as P
    conf = H.config_file(BENCH, config, ROOT)
    for smoke in (False, True):
        cfg = P.config(conf, smoke)
        m = conf["smoke" if smoke else "model"]
        for k, v in m.items():
            got = cfg.resolved_head_dim if k == "head_dim" else \
                getattr(cfg, k)
            assert got == v, (config, smoke, k)


def test_a_new_mix_metric_and_cell_are_picked_up_from_files(tmp_path):
    """A later change adds a mix, a per-layer metric and a cell by adding
    files and entries: nothing of the harness is edited."""
    (tmp_path / "mixes").mkdir()
    (tmp_path / "layer_metrics").mkdir()
    mix = {"driver": "serve", "slots": 2, "max_seq": 32, "eos_id": 1,
           "requests_per_generation": 4, "prompt_len": {"low": 3, "high": 5},
           "max_new_tokens": {"low": 3, "high": 4},
           "steps_per_second": 10, "warmup_steps": 1, "trace_steps": 1}
    (tmp_path / "mixes" / "tiny-chat.json").write_text(json.dumps(mix))
    (tmp_path / "layer_metrics" / "served_per_step.serve.py").write_text(
        "from perfbench.records import need\n\n"
        "def read(records):\n"
        "    need(records, 'occupied', 'window_steps')\n"
        "    return records['occupied'] / records['window_steps']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mamba2-2.7b.tiny-chat",
                               "config": "mamba2-2.7b",
                               "traffic": "tiny-chat", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "served_per_step.serve",
                               "unit": "slots", "better": "higher",
                               "source": "program_counter",
                               "layer": "engine",
                               "moves": "gen_tokens_per_s",
                               "workloads": ["mamba2-2.7b.tiny-chat"]})
    bench["end_to_end"][1]["workloads"].append("mamba2-2.7b.tiny-chat")
    got = H.mix_file("tiny-chat", base=tmp_path)
    assert got == mix
    reported = [x["name"] for x in
                H.reported(bench, "mamba2-2.7b.tiny-chat", True)]
    assert reported == ["served_per_step.serve"]
    read = H.reader("served_per_step.serve", base=tmp_path)
    c = H.Cell(name="mamba2-2.7b.tiny-chat",
               conf=H.config_file(bench, "mamba2-2.7b", ROOT), mix=got,
               seed=3, seconds=3.0, trace=True, device="cpu", smoke=True)
    out = run(c)
    assert out.correct, out.compared
    assert 0 < read(out.records) <= 2


def test_result_line_has_its_keys_in_order():
    from perfbench_testing import cell
    c = cell("mamba2-2.7b", "prefill")
    out = run(c)
    bench = json.loads(json.dumps(BENCH))
    line, missing = R.result_line(bench, "mamba2-2.7b.prefill-2k", c, out,
                                  False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert set(line["metrics"]) == {"setup_s", "prefill_tokens_per_s"}
    assert not missing and line["correct"]
