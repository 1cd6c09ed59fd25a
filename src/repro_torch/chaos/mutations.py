"""Mutation corpus: known-fixed protocol bugs behind test-only switches.

Each mutation re-introduces a real bug from this repo's history
(`ReplicaConfig.bug_*` switches) and drives a choreography that makes it
bite; the invariant watchdog must pinpoint the bug **at the violating
transition** (the journal entry kind named below), and the same
choreography with the fix in place must run watchdog-silent:

``catchup_starvation`` (PR 6)
    Catch-up retries were paced off the leader-heartbeat clock, which
    lease beats keep fresh — a CATCHUP replica whose data was lost never
    re-requested it.  Violates ``catchup_progress`` at a ``lease_heard``
    beat.
``takeover_wedge`` (PR 6)
    Takeover skipped reloading durable records of the unresolved window
    from the WAL when the in-memory queue had dropped them (an aborted
    CATCHUP join), so the new regime advertised an LST it could never
    re-commit.  Violates ``takeover_completeness`` at the ``takeover``
    transition (``missing`` > 0).
``ack_before_force``
    A follower acked a proposal on receipt instead of after its WAL
    force — the commit rule then counts an ack that a crash can revoke.
    Violates ``acked_durable`` at the first ``ack``.

`run_mutation(name, mutated=...)` runs one choreography; `run_corpus`
runs every mutation both ways and reports per-bug detection plus the
zero-false-positive control results.
"""

from __future__ import annotations

from typing import Callable, Optional


def _run_until(sim, cond: Callable[[], bool], timeout: float,
               step: float = 0.05) -> bool:
    deadline = sim.now + timeout
    while sim.now < deadline:
        if cond():
            return True
        sim.run(until=min(sim.now + step, deadline))
    return cond()


def _build(seed: int, n_nodes: int = 5):
    from ..workload.experiment import ExperimentConfig, build_spinnaker
    cfg = ExperimentConfig(seed=seed, n_nodes=n_nodes, disk="ssd")
    sim, cluster = build_spinnaker(cfg, num_keys=40)
    return sim, cluster


def _range_keys(cluster, rid: int, n: int) -> list[str]:
    from ..core.cluster import key_of
    keys = []
    i = 0
    while len(keys) < n and i < 4000:
        if cluster.range_of(key_of(i)) == rid:
            keys.append(key_of(i))
        i += 1
    return keys


def _seed_writes(cluster, keys, tag: str = "base") -> None:
    c = cluster.make_client(f"mut-{tag}")
    for k in keys:
        c.sync_put(k, "c", b"v-" + tag.encode())


# -- choreographies ---------------------------------------------------------

def _scenario_catchup_starvation(sim, cluster) -> None:
    """Crash+restart a follower so it rejoins through catch-up; the
    `drop_first_catchup` fault hook swallows the first catch-up payload.
    Fixed protocol: the 0.6s retry clock re-requests and the replica
    joins.  Mutated: lease beats keep the (mispaced) retry clock fresh
    and the replica starves in CATCHUP."""
    rid = 0
    keys = _range_keys(cluster, rid, 6)
    _seed_writes(cluster, keys)
    leader = cluster.leader_replica(rid)
    follower = next(m for m in cluster.members[rid]
                    if m != leader.node.node_id)
    cluster.crash_node(follower)
    sim.run_for(1.0)
    _seed_writes(cluster, keys, tag="gap")   # the restarted node is behind
    cluster.restart_node(follower)
    sim.run_for(6.0)                         # beats arrive every 0.25s


def _scenario_takeover_wedge(sim, cluster) -> None:
    """One-way-partition the leader (its sends vanish, it still hears the
    world) with writes in flight.  The followers never saw those commits,
    so when the ex-leader briefly re-wins (max LST), their CATCHUP joins
    drop the volatile tail; its takeover times out without acks, and a
    tail-dropped follower wins the next election.  Fixed protocol: that
    takeover reloads the window from its WAL and re-commits it.  Mutated:
    the reload is skipped and the takeover advertises an LST it can never
    re-send (`missing` > 0) — the range wedges.

    Runs on 3 nodes so every cohort spans the whole cluster: the cut
    silences the ex-leader's lease renewals on every range it leads.
    (On a wider cluster a range sharing only ONE peer with the cut keeps
    acking the old leader's lease through its third member while the cut
    peer deposes it — a genuine gray-failure lease overlap, but a
    different shape than the one this mutation targets.)"""
    from ..core.types import OpType, WriteOp
    rid = 0
    keys = _range_keys(cluster, rid, 8)
    _seed_writes(cluster, keys[:4])
    rep = cluster.leader_replica(rid)
    lnode = rep.node.node_id
    for p in cluster.members[rid]:
        if p != lnode:
            cluster.set_link_fault(lnode, p, drop_p=1.0)
    sim.run_for(0.05)
    for k in keys[4:]:
        # direct submission (not via a Client): retries must not reroute
        # to a successor and mint higher LSNs there
        rep.client_write(WriteOp(OpType.PUT, k, "c", b"stranded"),
                         lambda r: None)
    sim.run_for(0.05)
    assert rep.lst > rep.cmt, "no stranded tail; choreography broken"
    # lease lapse -> deposal -> ex-leader re-wins and stalls -> abdicates
    # suppressed -> a CATCHUP-dropped follower takes over (needs reload)
    sim.run_for(8.0)
    cluster.heal()
    sim.run_for(2.0)


def _scenario_ack_before_force(sim, cluster) -> None:
    """Plain committed write load: with the mutation every follower acks
    at receive time, ahead of its WAL force."""
    keys = _range_keys(cluster, 0, 6) + _range_keys(cluster, 1, 6)
    _seed_writes(cluster, keys)
    sim.run_for(0.5)


MUTATIONS: dict[str, dict] = {
    "catchup_starvation": {
        "switch": "bug_catchup_starvation",
        "hooks": {"drop_first_catchup": True},
        "invariant": "catchup_progress",
        "at_kind": "lease_heard",
        "scenario": _scenario_catchup_starvation,
        "description": "catch-up retries paced off the lease-beat clock "
                       "never fire; CATCHUP starves under a live leader",
    },
    "takeover_wedge": {
        "switch": "bug_takeover_wedge",
        "hooks": {},
        "n_nodes": 3,
        "invariant": "takeover_completeness",
        "at_kind": "takeover",
        "scenario": _scenario_takeover_wedge,
        "description": "takeover skips the WAL reload of the unresolved "
                       "window and advertises records it cannot re-send",
    },
    "ack_before_force": {
        "switch": "bug_ack_before_force",
        "hooks": {},
        "invariant": "acked_durable",
        "at_kind": "ack",
        "scenario": _scenario_ack_before_force,
        "description": "followers ack proposals at receive time, before "
                       "the WAL force that makes the ack true",
    },
}


def run_mutation(name: str, mutated: bool = True, seed: int = 0,
                 export_journal: bool = False) -> dict:
    """Run one mutation choreography and report what the watchdog saw.

    `mutated=False` is the control arm: same choreography, same fault
    hooks, fixed protocol — the watchdog must stay silent."""
    spec = MUTATIONS[name]
    sim, cluster = _build(seed, n_nodes=spec.get("n_nodes", 5))
    rcfg = cluster.cfg.node.replica      # shared by every replica
    for hook, val in spec["hooks"].items():
        setattr(rcfg, hook, val)
    if mutated:
        setattr(rcfg, spec["switch"], True)
    spec["scenario"](sim, cluster)
    wd = cluster.obs.watchdog
    hits = [v for v in wd.violations
            if v["invariant"] == spec["invariant"]
            and v["kind"] == spec["at_kind"]]
    detected = bool(hits)
    first: Optional[dict] = None
    if hits:
        first = {k: hits[0][k] for k in
                 ("t", "invariant", "rid", "node", "kind", "detail")}
    extra = {}
    if export_journal:
        extra["journal_jsonl"] = cluster.obs.journal.to_jsonl()
    return {
        **extra,
        "name": name,
        "mutated": mutated,
        "expected_invariant": spec["invariant"],
        "expected_at_kind": spec["at_kind"],
        "detected": detected,
        "first_violation": first,
        "watchdog": wd.summary(),
        "ok": detected if mutated else wd.ok,
    }


def run_corpus(seed: int = 0) -> dict:
    """Both arms for every mutation: the mutated run must be detected at
    the expected transition, the control run must be watchdog-silent."""
    out: dict = {"mutations": {}, "ok": True}
    for name in MUTATIONS:
        bug = run_mutation(name, mutated=True, seed=seed)
        fix = run_mutation(name, mutated=False, seed=seed)
        out["mutations"][name] = {
            "description": MUTATIONS[name]["description"],
            "detected": bug["detected"],
            "detected_at": bug["first_violation"],
            "control_silent": fix["watchdog"]["ok"],
            "mutated_by_invariant": bug["watchdog"]["by_invariant"],
            "control_by_invariant": fix["watchdog"]["by_invariant"],
        }
        out["ok"] = out["ok"] and bug["detected"] and fix["watchdog"]["ok"]
    return out
