"""The port's chaos harness and Cassandra baseline against the JAX
package's: both are the reference's text (`test_torch_datastore.py`
checks the bytes), and the same seeded runs and inputs give the same
results in both packages, holding the reference tests' own assertions."""

import dataclasses
import importlib
from types import SimpleNamespace

import pytest

PACKAGES = ("repro", "repro_torch")


def _pkg(name):
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(baselines=mod("baselines"), core=mod("core"),
                           chaos=mod("chaos"), mutations=mod("chaos.mutations"),
                           exp=mod("workload.experiment"),
                           scenario=mod("workload.scenario"))


def _both(case):
    """`case` run on the reference, then on the port: equal results."""
    want, got = (case(_pkg(name)) for name in PACKAGES)
    assert got == want
    return got


def _res(r):
    """A client result by value (the packages' enums are distinct)."""
    return (r.code.name, r.value, r.version, r.latency, r.attempts)


# ---------------------------------------------------------------------------
# the Cassandra baseline: tests/test_cassandra_baseline.py's five cases
# ---------------------------------------------------------------------------


def _cassandra(p, n=5, seed=0):
    sim = p.core.Simulator(seed=seed)
    return sim, p.baselines.CassandraCluster(
        sim, p.baselines.CassandraConfig(n_nodes=n))


def quorum_write_then_quorum_read(p):
    sim, cluster = _cassandra(p)
    c = cluster.make_client()
    w = c.sync_write(p.core.key_of(5), "c", b"v", quorum=True)
    got = c.sync_read(p.core.key_of(5), "c", quorum=True)
    assert w.ok and got.ok and got.value == b"v"
    return [_res(w), _res(got), sim.now]


def weak_write_single_ack_faster_than_quorum(p):
    sim, cluster = _cassandra(p)
    c = cluster.make_client()
    lat_w = [c.sync_write(p.core.key_of(5), "c", f"w{i}".encode(),
                          quorum=False).latency for i in range(50)]
    lat_q = [c.sync_write(p.core.key_of(5), "c", f"q{i}".encode(),
                          quorum=True).latency for i in range(50)]
    assert sum(lat_w) / 50 < sum(lat_q) / 50
    return [lat_w, lat_q, sim.now]


def stale_read_possible_after_restart_without_repair(p):
    sim, cluster = _cassandra(p, n=3, seed=7)
    c = cluster.make_client()
    key = p.core.key_of(5)
    c.sync_write(key, "c", b"old", quorum=True)
    sim.run_for(1.0)
    victim = cluster.cohort(cluster.range_of(key))[0]
    cluster.crash_node(victim)
    sim.run_for(0.5)
    assert c.sync_write(key, "c", b"new", quorum=True).ok
    cluster.restart_node(victim)
    sim.run_for(0.5)
    reads = [_res(c.sync_read(key, "c", quorum=False)) for _ in range(12)]
    assert b"new" in {r[1] for r in reads if r[0] == "OK"}
    return [victim, reads, sim.now]


def quorum_read_repairs_stale_replica(p):
    sim, cluster = _cassandra(p, n=3, seed=11)
    c = cluster.make_client()
    key = p.core.key_of(5)
    c.sync_write(key, "c", b"old", quorum=True)
    victim = cluster.cohort(cluster.range_of(key))[0]
    cluster.crash_node(victim)
    sim.run_for(0.5)
    c.sync_write(key, "c", b"new", quorum=True)
    cluster.restart_node(victim)
    sim.run_for(0.5)
    first = [c.sync_read(key, "c", quorum=True) for _ in range(8)]
    assert all(not r.ok or r.value in (b"new", b"old") for r in first)
    sim.run_for(1.0)
    second = [c.sync_read(key, "c", quorum=True) for _ in range(8)]
    assert all(r.value == b"new" for r in second if r.ok)
    return [[_res(r) for r in first + second], sim.now]


def write_survives_one_node_down(p):
    sim, cluster = _cassandra(p, n=3)
    c = cluster.make_client()
    key = p.core.key_of(5)
    cluster.crash_node(cluster.cohort(cluster.range_of(key))[1])
    sim.run_for(0.2)
    w = c.sync_write(key, "c", b"v", quorum=True)
    got = c.sync_read(key, "c", quorum=True)
    assert w.ok and got.ok and got.value == b"v"
    return [_res(w), _res(got), sim.now]


@pytest.mark.parametrize("case", [
    quorum_write_then_quorum_read, weak_write_single_ack_faster_than_quorum,
    stale_read_possible_after_restart_without_repair,
    quorum_read_repairs_stale_replica, write_survives_one_node_down],
    ids=lambda f: f.__name__)
def test_cassandra_baseline_case_in_both_packages(case):
    _both(case)


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------


def test_chaos_run_single_seed_equal_and_all_audits_green():
    r = _both(lambda p: p.exp.run_spinnaker_chaos(seed=3, duration=8.0))
    assert r["linearizability"]["ok"], r["linearizability"]["violations"][:3]
    assert r["availability"]["ok"], r["availability"]["violations"][:3]
    assert not r["lost_acked_writes"], r["lost_acked_writes"][:3]
    assert r["trace_audit"]["ok"], r["trace_audit"]
    assert r["ok"] and r["history_ops"] > 1000
    assert len(r["fault_events"]) >= 5
    assert all(n > 10 for n in r["probe_writes_acked"].values())


@pytest.mark.parametrize("lease_enabled", [True, False])
def test_minority_leader_equal_in_both_packages(lease_enabled):
    r = _both(lambda p: p.exp.run_spinnaker_minority_leader(
        lease_enabled=lease_enabled))
    if lease_enabled:
        bound = r["lease_duration_s"] + 1.0
        assert r["failover_s"] is not None and r["failover_s"] <= bound
        assert not r["stalled_until_heal"]
        assert r["first_ack_gap_s"] <= bound + 0.5
        assert not r["old_leader_lease_valid"]
        assert r["old_leader_role"] != "LEADER"
    else:
        assert r["failover_s"] is None and r["stalled_until_heal"]
        assert r["first_ack_gap_s"] >= r["heal_at_s"] - r["partition_at_s"] \
            - 0.5
        assert r["old_leader_role"] == "LEADER"


def test_mutation_corpus_equal_in_both_packages():
    r = _both(lambda p: p.mutations.run_corpus())
    assert r["ok"]


def test_chaos_schedules_parse_to_the_same_events():
    def case(p):
        out = []
        for seed in range(8):
            text = p.chaos.generate_chaos_schedule(seed)
            events = p.scenario.parse_schedule(text).events
            out.append((text, [dataclasses.astuple(e) for e in events]))
        return out
    assert len({a for ev in _both(case) for a in (e[1] for e in ev[1])}) >= 9


def _history(p):
    def W(client, inv, resp, ver, val=None, ok=True, resolved=None,
          attempts=1):
        return p.chaos.HistOp(client, "write", "k", "c", inv, resp, ok, ver,
                              val if val is not None else f"{client}@{ver}",
                              resolved=ok if resolved is None else resolved,
                              attempts=attempts)

    def R(client, inv, resp, ver, val=None):
        return p.chaos.HistOp(client, "read", "k", "c", inv, resp, True, ver,
                              val)

    return W, R


def test_linearizability_checker_equal_in_both_packages():
    def case(p):
        W, R = _history(p)
        check = p.chaos.check_linearizability
        hists = [
            ([W("a", 0.0, 1.0, 1), W("b", 1.5, 2.0, 2),
              R("r", 2.1, 2.2, 2, "b@2"), R("r", 0.5, 0.9, 0)], None),
            ([W("a", 0.0, 1.0, 1), R("r", 2.0, 2.1, 0)], None),
            ([W("a", 0.0, 1.0, 5), W("b", 2.0, 3.0, 5)], None),
            ([W("a", 0.0, 1.0, 2), W("b", 2.0, 3.0, 1)], None),
            ([W("a", 0.0, 1.0, 1), R("r", 1.2, 1.3, 7)], None),
            ([W("a", 0.0, 1.0, 1), R("r", 1.2, 1.3, 1, "not-a@1")], None),
            ([W("a", 0.0, 1.0, 1),
              W("b", 1.5, 9.0, None, ok=False, resolved=False),
              R("r", 2.0, 2.1, 2), R("r", 2.3, 2.4, 1, "a@1")], None),
            ([W("a", 0.0, 1.0, 1, attempts=3), R("r", 1.2, 1.3, 3)], None),
            ([R("r", 0.1, 0.2, 1)], {("k", "c"): 2}),
            ([W("a", 0.0, 1.0, 1)], {("k", "c"): 1}),
        ]
        return [check(h) if base is None else check(h, base)
                for h, base in hists]
    rules = [sorted({v["rule"] for v in out}) for out in _both(case)]
    assert rules == [[], ["R1"], ["W1", "W2"], ["W2"], ["R2"], ["R3"], [],
                     [], ["R1"], ["W1"]]


def test_availability_audit_equal_in_both_packages():
    def case(p):
        Ev, windows = p.scenario.FaultEvent, p.chaos.majority_healthy_windows
        part = [Ev(2.0, "partition", groups=((0,), (1,), (2, 3, 4))),
                Ev(5.0, "heal")]
        crashes = [Ev(1.0, "crash", node=0), Ev(2.0, "crash", node=1),
                   Ev(6.0, "restart", node=1),
                   Ev(8.0, "partition_oneway", groups=((1,), (2,)))]
        oneway = [Ev(2.0, "partition_oneway", groups=((2,), (3, 4)))]
        out = [windows(part, (0, 1, 2), t_end=10.0, n_nodes=5),
               windows(part, (2, 3, 4), t_end=10.0, n_nodes=5),
               windows(crashes, (0, 1, 2), t_end=10.0, n_nodes=5),
               windows(oneway, (2, 3, 4), t_end=10.0, n_nodes=5)]
        for acks in ([round(0.2 * i, 3) for i in range(90)], [0.2, 0.4, 0.6]):
            out.append(p.chaos.audit_availability(
                [], {0: (0, 1, 2)}, {0: acks}, t_end=18.0,
                recovery_bound=4.0, n_nodes=5))
        return out
    out = _both(case)
    assert out[:4] == [[[0.0, 2.0], [5.0, 10.0]], [[0.0, 10.0]],
                       [[0.0, 2.0], [6.0, 8.0]], [[0.0, 10.0]]]
    assert out[4]["ok"] and not out[5]["ok"]
