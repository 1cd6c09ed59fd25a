"""The port's workload engine against the JAX package's.

Torch cannot draw JAX's threefry stream, so parity has three parts:
(a) given the reference's own uniform draws, the port's transform gives
its ranks, ops and sizes exactly and its gaps within an ulp of `log1p`;
(b) with the reference's op stream served into the port's experiment
runner, every stream-driven `run_*` returns the reference's result dict;
(c) the reference's statistical stream tests hold for the port's own
stream on the CPU (on the card: `test_torch_gpu.py`)."""

import dataclasses
import difflib
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.workload as ref_wl
import repro.workload.experiment as ref_exp
import repro.workload.generators as ref_gen
import repro_torch.workload as port_wl
import repro_torch.workload.experiment as port_exp
import repro_torch.workload.generators as port_gen
from torch_stream_checks import (STREAM_CHECKS, TRANSFORM_CASES,
                                 assert_transforms_equal, batch_draws,
                                 transform_on)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# (a) the transform on the reference's draws
# ---------------------------------------------------------------------------


def _reference_draws(case, seed, batch):
    """`_sample_batch`'s draws exactly as it takes them, and its output."""
    n, dist, sizes = case
    vmin, vmax = sizes or (512, 512)
    spec = ref_gen.WorkloadSpec(num_keys=n, key_dist=dist)
    cdf = ref_gen._zipf_cdf(n, 0.99) if dist != "uniform" else None
    mix = jnp.asarray(np.cumsum(spec.mix()), jnp.float32)
    sub = jax.random.split(jax.random.PRNGKey(seed))[1]
    k1, k2, k3, k4 = jax.random.split(sub, 4)
    draws = [jax.random.uniform(k1, (batch,)),
             jax.random.uniform(k2, (batch,)),
             jax.random.randint(k3, (batch,), vmin, vmax + 1)
             if vmax > vmin else None,
             jax.random.uniform(k4, (batch,))]
    out = ref_gen._sample_batch(sub, cdf, mix, n, 512, vmin, vmax, batch)
    return draws, out, cdf, mix


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("case", TRANSFORM_CASES)
def test_transform_of_the_reference_draws_is_the_reference(case, seed):
    draws, want, cdf, mix = _reference_draws(case, seed, batch=8192)
    n = case[0]
    port_cdf = port_gen._zipf_cdf(n, 0.99, "cpu") if cdf is not None \
        else None
    if cdf is not None:
        assert np.array_equal(port_cdf.numpy(), np.asarray(cdf))
    port_mix = torch.tensor(np.cumsum(port_gen.WorkloadSpec(
        num_keys=n).mix()), dtype=torch.float32)
    assert np.array_equal(port_mix.numpy(), np.asarray(mix))
    got = port_gen.sample_transform(
        *[None if d is None else torch.from_numpy(np.asarray(d))
          for d in draws[:3]], torch.from_numpy(np.asarray(draws[3])),
        port_cdf, port_mix, n, 512)
    assert_transforms_equal(got, [torch.from_numpy(np.asarray(w))
                                  for w in want])
    if n > 1 << 24:          # f32 u * n rounds up to n: the clip holds it
        assert int(got[0].max()) <= n - 1


@pytest.mark.parametrize("case", TRANSFORM_CASES)
def test_sample_batch_draws_keys_ops_sizes_gaps_in_order(case):
    out, draws, (cdf, mix, n) = batch_draws(case, "cpu", seed=4)
    assert_transforms_equal(list(out), transform_on("cpu", draws, cdf, mix,
                                                    n))


# ---------------------------------------------------------------------------
# (b) the reference's stream through the port's experiment runner
# ---------------------------------------------------------------------------


class _ServedStream(port_gen.OpStream):
    """The port's stream serving the reference stream's arrays (same spec
    and seed), gaps included, so both runners see the same ops."""

    def __init__(self, spec, seed=0, batch=8192, device="cuda"):
        super().__init__(spec, seed=seed, batch=batch, device=device)
        self._ref = ref_gen.OpStream(
            ref_gen.WorkloadSpec(**dataclasses.asdict(spec)), seed=seed,
            batch=batch)

    def _refill(self):
        ref = self._ref
        ref._refill()
        self._keys, self._ops = ref._keys, ref._ops
        self._vsz, self._gaps = ref._vsz, ref._gaps
        self._i = 0
        self.sampled += self.batch


SPEC = dict(num_keys=60, value_size=256, read_frac=0.5, write_frac=0.4,
            rmw_frac=0.05, cond_frac=0.05)
CFG = dict(disk="mem", n_clients=4, warmup=0.2, duration=1.0,
           preload_cap=60, window=0.25)
KILL = "at 0.3s crash leader of 0\nat 0.8s restart crashed"

# name -> (run_* name, spec overrides, cfg overrides, keyword arguments)
RUNS = {
    "spinnaker_strong": ("run_spinnaker_workload", {}, {}, {}),
    "spinnaker_timeline_monotonic": (
        "run_spinnaker_workload", {"key_dist": "latest"}, {},
        {"consistent_reads": False, "monotonic": True}),
    "spinnaker_leader_kill": ("run_spinnaker_workload", {},
                              {"duration": 1.5}, {"schedule": KILL}),
    "cassandra_quorum": ("run_cassandra_workload", {}, {}, {"quorum": True}),
    "cassandra_eventual": ("run_cassandra_workload", {}, {},
                           {"quorum": False}),
    "cassandra_leader_kill": ("run_cassandra_workload", {}, {},
                              {"schedule": "at 0.3s crash node 1"}),
    "spinnaker_saturation": (
        "run_spinnaker_saturation",
        {"read_frac": 0.0, "write_frac": 1.0, "rmw_frac": 0.0,
         "cond_frac": 0.0, "key_dist": "uniform"}, {"disk": "ssd"},
        {"rates": [500.0, 3000.0], "dwell": 0.5, "settle": 0.1}),
    "spinnaker_rebalance": ("run_spinnaker_rebalance",
                            {"read_frac": 0.2, "write_frac": 0.8,
                             "rmw_frac": 0.0, "cond_frac": 0.0}, {}, {}),
    "spinnaker_txn": ("run_spinnaker_txn",
                      {"read_frac": 0.5, "write_frac": 0.0, "rmw_frac": 0.0,
                       "cond_frac": 0.0, "txn_frac": 0.5},
                      {"duration": 0.5}, {}),
    "spinnaker_profiled": ("run_spinnaker_profiled", {}, {}, {}),
    "cassandra_profiled": ("run_cassandra_profiled", {}, {}, {}),
    "spinnaker_breakdown": ("run_spinnaker_breakdown", {}, {}, {}),
    "cassandra_breakdown": ("run_cassandra_breakdown", {}, {}, {}),
    "spinnaker_open_loop_uniform_sizes": (
        "run_spinnaker_workload",
        {"value_size_dist": "uniform", "value_size_min": 64,
         "key_dist": "uniform"}, {"driver": "open", "open_rate": 800.0}, {}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_gives_the_reference_result_on_the_reference_stream(
        name, monkeypatch):
    fn, spec_kw, cfg_kw, kw = RUNS[name]
    streams = []

    class Served(_ServedStream):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            streams.append(self)

    monkeypatch.setattr(port_exp, "OpStream", Served)
    spec_kw, cfg_kw = {**SPEC, **spec_kw}, {**CFG, **cfg_kw}
    want = getattr(ref_exp, fn)(ref_gen.WorkloadSpec(**spec_kw),
                                ref_exp.ExperimentConfig(**cfg_kw), **kw)
    got = getattr(port_exp, fn)(port_gen.WorkloadSpec(**spec_kw),
                                port_exp.ExperimentConfig(device="cpu",
                                                          **cfg_kw), **kw)
    assert streams and all(st.sampled > 0 for st in streams)
    assert got == want


def test_leader_kill_stops_and_resumes_writes_on_the_port_stream():
    """The reference's failover scenario on the port's own CPU stream:
    writes come back after the leader kill, before the restart."""
    cfg = port_exp.ExperimentConfig(duration=3.0, warmup=0.5, n_clients=4,
                                    disk="mem", preload_cap=50, window=0.25,
                                    device="cpu")
    spec = port_gen.WorkloadSpec(num_keys=50, value_size=256, read_frac=0.2,
                                 write_frac=0.8, rmw_frac=0.0, cond_frac=0.0)
    r = port_exp.run_spinnaker_workload(
        spec, cfg, schedule="at 0.5s crash leader of 0\n"
                            "at 2.5s restart crashed")
    assert any(e.startswith("t=0.5: crash node") for e in r["fault_events"])
    post = [w for w in r["timeline"]["write"] if 0.5 < w["t_start"] < 2.5]
    assert max(w["throughput"] for w in post) > 0


# ---------------------------------------------------------------------------
# the interface is the reference's
# ---------------------------------------------------------------------------


def test_every_run_signature_is_the_references():
    names = [n for n in dir(ref_exp) if n.startswith("run_")]
    assert names == [n for n in dir(port_exp) if n.startswith("run_")]
    assert len(names) == 11
    for n in names:
        assert str(inspect.signature(getattr(port_exp, n))) == \
            str(inspect.signature(getattr(ref_exp, n))), n


def test_experiment_config_is_the_references_plus_device():
    ref = dataclasses.fields(ref_exp.ExperimentConfig)
    port = dataclasses.fields(port_exp.ExperimentConfig)
    assert [f.name for f in port] == [f.name for f in ref] + ["device"]
    for a, b in zip(ref, port):
        assert (a.default, a.type) == (b.default, b.type), a.name
    assert port_exp.ExperimentConfig().device == "cuda"


def test_package_exports_are_the_references():
    assert port_wl.__all__ == ref_wl.__all__
    for name in port_wl.__all__:
        assert hasattr(port_wl, name), name


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_exp.ExperimentConfig()               # constructs; only a stream
    with pytest.raises(RuntimeError, match="CUDA"):
        port_gen.OpStream(port_gen.WorkloadSpec(num_keys=10))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_exp.run_spinnaker_workload(
            port_gen.WorkloadSpec(num_keys=10),
            port_exp.ExperimentConfig(disk="mem", preload_cap=10))


def test_experiment_differs_from_the_reference_only_in_the_device():
    ref = (ROOT / "src/repro/workload/experiment.py").read_text()
    port = (ROOT / "src/repro_torch/workload/experiment.py").read_text()
    diff = [ln for ln in difflib.unified_diff(ref.splitlines(),
                                              port.splitlines(), n=0,
                                              lineterm="")
            if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]
    call = "    stream = OpStream(spec, seed=cfg.seed + 1{})"
    assert sorted(diff) == sorted([
        "+    device: str = \"cuda\"             # where OpStream samples "
        "its ops",
        "-" + call.format(""), "+" + call.format(", device=cfg.device"),
        "-" + call.format(""), "+" + call.format(", device=cfg.device")])


# ---------------------------------------------------------------------------
# (c) the port's own stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("check", STREAM_CHECKS, ids=lambda f: f.__name__)
def test_port_stream_statistics_on_the_cpu(check):
    check("cpu")


def test_coprime_multiplier_bijective():
    for n in (2, 10, 97, 1000, 4096):
        a = port_gen._coprime_multiplier(n)
        assert a == ref_gen._coprime_multiplier(n)
        assert len({(i * a) % n for i in range(n)}) == n


def test_refill_copies_each_batch_to_the_host_once():
    s = port_gen.OpStream(port_gen.WorkloadSpec(num_keys=100), seed=2,
                          batch=256, device="cpu")
    ops = [s.next_op() for _ in range(600)]
    assert s.sampled == 768 and len(ops) == 600
    for arr in (s._keys, s._ops, s._vsz, s._gaps):
        assert isinstance(arr, np.ndarray) and arr.shape == (256,)
    assert s._gaps.dtype == np.float32 and (s._gaps >= 0).all()
