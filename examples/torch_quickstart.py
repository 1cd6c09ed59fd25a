"""Quickstart on the PyTorch port: the Spinnaker datastore API end-to-end
on the simulator, through `repro_torch.core`.

    PYTHONPATH=src python examples/torch_quickstart.py

`examples/quickstart.py` on the port: the paper's API (§3), put/get with
strong vs timeline consistency, conditionalPut optimistic concurrency,
then a leader failure with sub-second failover (§D.1) and a strong read
that proves no committed write was lost.  The cluster is the host's
discrete-event simulator; nothing here runs on a device, so the walk
prints the same lines, at the same simulated times, as the reference's.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import (ClusterConfig, Simulator,  # noqa: E402
                              SpinnakerCluster, key_of)


def main():
    sim = Simulator(seed=0)
    cluster = SpinnakerCluster(sim, ClusterConfig(n_nodes=5))
    cluster.start()
    cluster.settle()
    print(f"cluster up: 5 nodes, 5 key ranges, 3-way cohorts "
          f"(chained declustering), leaders elected in "
          f"{sim.now * 1e3:.1f} ms sim-time")

    c = cluster.make_client()
    key = key_of(1234)

    # --- basic put/get -----------------------------------------------------
    res = c.sync_put(key, "name", b"spinnaker")
    print(f"put:               ok v{res.version} "
          f"({res.latency * 1e3:.2f} ms)")
    res = c.sync_get(key, "name", consistent=True)
    print(f"strong get:        {res.value!r} v{res.version} "
          f"({res.latency * 1e3:.2f} ms)")
    res = c.sync_get(key, "name", consistent=False)
    print(f"timeline get:      {res.value!r} "
          f"({res.latency * 1e3:.2f} ms — any replica, may be stale)")

    # --- optimistic concurrency (§3's counter idiom) -------------------------
    c.sync_put(key, "count", 0)
    cur = c.sync_get(key, "count")
    res = c.sync_cond_put(key, "count", cur.value + 1, cur.version)
    print(f"conditionalPut:    ok -> count=1 v{res.version}")
    stale = c.sync_cond_put(key, "count", 99, cur.version)
    print(f"stale condPut:     {stale.code.value} (as it should be)")

    # --- leader failure + failover -------------------------------------------
    rid = cluster.range_of(key)
    leader = cluster.leader_replica(rid)
    print(f"\ncrashing leader n{leader.node.node_id} of range {rid} ...")
    t0 = sim.now
    cluster.crash_node(leader.node.node_id, expire_session=True)
    while cluster.leader_replica(rid) is None:
        sim.run(until=sim.now + 0.001)
    print(f"new leader n{cluster.leader_replica(rid).node.node_id} open "
          f"for writes after {(sim.now - t0) * 1e3:.0f} ms")

    res = c.sync_get(key, "count", consistent=True)
    if res.value != 1:
        raise SystemExit("committed write lost!")
    print(f"strong get after failover: count={res.value} — no committed "
          f"write lost")
    res = c.sync_put(key, "count", 2)
    print(f"writes accepted again: v{res.version}")


if __name__ == "__main__":
    main()
