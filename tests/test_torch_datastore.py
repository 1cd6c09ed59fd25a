"""The port's copy of the datastore is the reference: every copied module
has the reference's text byte for byte, and seeded schedules (puts and
reads, a leader crash, a one-way partition, a range split, a cross-range
transaction) give the same acknowledgements, reads, simulated time and
protocol journal in both packages.  The reference's lost acknowledged
write under crash-restart is reproduced, not masked."""

import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the modules the port keeps as the reference's own text
VERBATIM = [
    "core/types.py", "core/sim.py", "core/coordination.py",
    "core/storage.py", "core/wal.py", "core/ranges.py", "core/txn.py",
    "core/replica.py", "core/node.py", "core/cluster.py",
    "core/__init__.py",
    "obs/journal.py", "obs/events.py", "obs/metrics.py", "obs/profile.py",
    "obs/trace.py", "obs/watchdog.py", "obs/__init__.py",
    "workload/metrics.py", "ft/manager.py",
    "workload/scenario.py", "workload/drivers.py",
    "baselines/__init__.py", "baselines/cassandra.py",
    "chaos/schedule.py", "chaos/linearizability.py", "chaos/availability.py",
    "chaos/mutations.py", "chaos/__init__.py",
]


@pytest.mark.parametrize("module", VERBATIM)
def test_copied_module_is_the_reference_byte_for_byte(module):
    ref = (ROOT / "src" / "repro" / module).read_bytes()
    port = (ROOT / "src" / "repro_torch" / module).read_bytes()
    assert port == ref, f"src/repro_torch/{module} drifted from the reference"


# ---------------------------------------------------------------------------
# the same seeded schedules through both packages
# ---------------------------------------------------------------------------


def _cluster(core, seed, n=5, commit_period=0.25, session_timeout=2.0):
    sim = core.Simulator(seed=seed)
    cfg = core.ClusterConfig(
        n_nodes=n, num_keys=300, session_timeout=session_timeout,
        node=core.NodeConfig(
            replica=core.ReplicaConfig(commit_period=commit_period)))
    cluster = core.SpinnakerCluster(sim, cfg)
    cluster.start()
    cluster.settle()
    return sim, cluster


class _Recorder:
    """Runs ops through one client and records what each returned, with
    the codes by name (the two packages' enums are distinct classes)."""

    def __init__(self, core, cluster):
        self.core, self.cluster = core, cluster
        self.client = cluster.make_client()
        self.log = []

    def put(self, i, value):
        key = self.core.key_of(i)
        r = self.client.sync_put(key, "c", value)
        self.log.append(("put", key, r.code.name, r.version))
        return r

    def get(self, i, consistent):
        key = self.core.key_of(i)
        r = self.client.sync_get(key, "c", consistent)
        self.log.append(("get", key, consistent, r.code.name, r.version,
                         r.value))
        return r

    def cond_put(self, i, value, version):
        key = self.core.key_of(i)
        r = self.client.sync_cond_put(key, "c", value, version)
        self.log.append(("cond_put", key, r.code.name, r.version))
        return r


def _puts_and_reads(core, rec, sim, cluster):
    for i in range(0, 300, 23):
        rec.put(i, f"v{i}".encode())
    sim.run_for(1.0)                     # a commit period for followers
    for i in range(0, 300, 23):
        rec.get(i, True)
        rec.get(i, False)
    rec.cond_put(23, b"cas-ok", 1)
    rec.cond_put(23, b"cas-stale", 1)


def _leader_crash_restart(core, rec, sim, cluster):
    for i in (10, 11, 12):
        rec.put(i, b"before")
    leader = cluster.leader_replica(cluster.range_of(core.key_of(10)))
    nid = leader.node.node_id
    cluster.crash_node(nid)
    cluster.settle()                     # a successor takes over
    for i in (10, 11, 12):
        rec.put(i, b"during")
        rec.get(i, True)
    cluster.restart_node(nid)
    sim.run_for(5.0)
    for i in (10, 11, 12):
        rec.get(i, False)
    rec.log.append(("leader_was", nid))


def _oneway_partition(core, rec, sim, cluster):
    rid = cluster.range_of(core.key_of(70))
    leader = cluster.leader_replica(rid).node.node_id
    others = set(cluster.cohort(rid)) - {leader}
    rec.put(70, b"a")
    cluster.partition_oneway({leader}, others)
    sim.run_for(4.0)
    rec.put(70, b"b")
    rec.get(70, True)
    cluster.heal()
    sim.run_for(3.0)
    rec.put(71, b"c")
    rec.get(70, True)
    rec.get(71, False)


def _range_split(core, rec, sim, cluster):
    for i in range(0, 60, 3):
        rec.put(i, f"p{i}".encode())
    n_before = len(cluster.ranges)
    assert cluster.admin_split(0)
    sim.run_for(2.0)
    cluster.settle()
    assert len(cluster.ranges) == n_before + 1
    child = max(cluster.ranges)
    rec.log.append(("split", child, cluster.ranges[child].lo))
    for i in range(0, 60, 3):
        rec.get(i, True)
    rec.put(1, b"parent-side")
    rec.put(58, b"child-side")
    rec.get(58, False)


def _cross_range_txn(core, rec, sim, cluster):
    k1, k2 = core.key_of(10), core.key_of(200)
    assert cluster.range_of(k1) != cluster.range_of(k2)
    rec.put(10, b"base")
    ops = [core.WriteOp(core.OpType.PUT, k1, "c", b"t1"),
           core.WriteOp(core.OpType.PUT, k2, "c", b"t2")]
    r = rec.client.sync(rec.client.transaction, ops)
    rec.log.append(("txn", r.code.name, sorted(r.value)))
    bad = [core.WriteOp(core.OpType.COND_PUT, k1, "c", b"x",
                        expected_version=2),
           core.WriteOp(core.OpType.COND_PUT, k2, "c", b"x",
                        expected_version=99)]
    r = rec.client.sync(rec.client.transaction, bad)
    rec.log.append(("txn", r.code.name))
    rec.get(10, True)
    rec.get(200, True)


SCHEDULES = {
    "puts_and_reads": (_puts_and_reads, 0),
    "leader_crash_restart": (_leader_crash_restart, 1),
    "oneway_partition": (_oneway_partition, 2),
    "range_split": (_range_split, 3),
    "cross_range_txn": (_cross_range_txn, 4),
}


def _run_schedule(pkg, name):
    core = importlib.import_module(f"{pkg}.core")
    run, seed = SCHEDULES[name]
    sim, cluster = _cluster(core, seed)
    rec = _Recorder(core, cluster)
    run(core, rec, sim, cluster)
    return rec.log, sim.now, cluster.obs.journal.to_jsonl()


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_same_seed_same_cluster(schedule):
    ref_log, ref_now, ref_journal = _run_schedule("repro", schedule)
    log, now, journal = _run_schedule("repro_torch", schedule)
    assert log == ref_log
    assert now == ref_now
    assert journal == ref_journal
    assert journal.count("\n") > 10            # the journal was on
    acked = [e for e in log if e[0] == "put" and e[2] == "OK"]
    assert acked, "the schedule acknowledged no write"


# ---------------------------------------------------------------------------
# the reference's failing property, replayed on purpose
# ---------------------------------------------------------------------------


def _drive(sim, pred, budget, slice_=0.05):
    """tests/test_properties.py::drive: run in slices until pred()."""
    deadline = sim.now + budget
    while sim.now < deadline and not pred():
        sim.run(until=min(deadline, sim.now + slice_))
    return pred()


def _acked_write_schedule(pkg):
    """The schedule that tests/test_properties.py::
    test_no_acked_write_lost_under_crash_restart fails on (seed 0, six
    puts to key 0, crash node 0, restart node 0), driven as that test
    drives it.  Returns the writes with their acknowledgements, node 0's
    applied cell of the key before the crash and after the restart, and
    the strong read after the cluster heals."""
    core = importlib.import_module(f"{pkg}.core")
    sim = core.Simulator(seed=0)
    cluster = core.SpinnakerCluster(sim, core.ClusterConfig(
        n_nodes=3,
        node=core.NodeConfig(replica=core.ReplicaConfig(commit_period=0.25)),
        session_timeout=1.0))
    cluster.start()
    leaders = lambda: all(cluster.leader_replica(r) is not None  # noqa: E731
                          for r in range(3))
    _drive(sim, leaders, 30.0)
    client = cluster.make_client()
    key = core.key_of(1)
    rid = cluster.range_of(key)
    acks = []
    for w in range(1, 7):
        val = f"{key}-w{w}".encode()
        box = []
        client.put(key, "c", val, lambda r, b=box: b.append(r))
        _drive(sim, lambda b=box: bool(b), 8.0)
        acks.append((val, box[0].code.name, box[0].version))

    def applied():
        cell = cluster.nodes[0].replicas[rid].store.get(key, "c")
        return None if cell is None else (cell.version, cell.value)
    before = applied()
    cluster.crash_node(0, expire_session=True)
    cluster.restart_node(0)
    after = applied()
    _drive(sim, leaders, 60.0)
    sim.run_for(3.0)
    r = client.sync_get(key, "c", True)
    return acks, before, after, (r.code.name, r.version, r.value), sim.now


def test_acked_write_lost_by_a_restarted_replica_in_both_packages():
    """Node 0, a follower of the key's range, has applied the acknowledged
    write w5 (`k000000000001-w5`, version 5) when it crashes; after its
    restart its store holds version 4: the write is gone from that replica
    until it catches up (the property test's P4 check fails: "replica n0
    went back in time").  Both packages lose the same write."""
    ref = _acked_write_schedule("repro")
    port = _acked_write_schedule("repro_torch")
    assert port == ref
    acks, before, after, healed, _ = port
    lost = (b"k000000000001-w5", "OK", 5)
    assert lost in acks
    assert before == (5, b"k000000000001-w5")
    assert after == (4, b"k000000000001-w4")
    # the cluster as a whole still serves the last write after healing
    assert healed == ("OK", 6, b"k000000000001-w6")
