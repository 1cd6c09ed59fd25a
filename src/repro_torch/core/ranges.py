"""Elastic range management: live splits, snapshot-based replica
migration, and hotspot-driven rebalancing.

The paper's §4 key-range partitioning is static (a uniform pre-split at
cluster build time).  This module makes range movement a first-class,
availability-preserving operation on top of the existing Paxos cohorts:

- **Metadata** lives in the coordination service under ``/ranges/<rid>``:
  a ``meta`` znode holding ``(lo, hi, members)``, the existing ``epoch``
  counter and election znodes, and a cluster-wide ``/ranges/version``
  counter bumped on every table change (its data-change watch is the
  client cache-invalidation signal).  A ``migration`` znode records an
  in-flight replica move so a freshly elected leader resumes it unaided.

- **Live split** (CohortReplica.propose_split): the leader runs a SPLIT
  record through the normal replication pipeline as a barrier.  Applying
  it forks the child range locally on every replica with zero data copy
  (Store.detach_range) and registers fresh child metadata here; the child
  cohort then elects a leader of its own.  The child's epoch counter is
  seeded at the parent's epoch so child LSNs order after all forked data.

- **Replica migration** (CohortReplica.start_migration): two-phase and
  log-committed — first a MEMBER_CHANGE adds the destination (cohort
  briefly 4-wide; quorum rules generalize), the destination installs a
  snapshot + WAL catch-up via the §6 follower-recovery path, and only
  once it is in-sync does a second MEMBER_CHANGE retire the source.
  Majorities of the old and new member sets always intersect, so a
  leader kill at any point fails over correctly and the new leader picks
  the migration back up from the intent znode.

- **Hotspot rebalancing** (RangeBalancer): a periodic tick samples
  per-range served-op deltas from the leader replicas and triggers a
  split when one range runs hot, or a follower-replica move when node
  load is skewed.

Clients route through a RangeTable cache of the metadata and re-route on
WRONG_RANGE redirects or a version-watch fire (cluster.Client wires it).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional, TYPE_CHECKING

from .coordination import Coordination, NodeExists, NoNode

if TYPE_CHECKING:
    from .cluster import SpinnakerCluster

RANGES_ROOT = "/ranges"
VERSION_PATH = f"{RANGES_ROOT}/version"
NEXT_RID_PATH = f"{RANGES_ROOT}/next_rid"


# ---------------------------------------------------------------------------
# Metadata schema helpers
# ---------------------------------------------------------------------------

def meta_path(rid: int) -> str:
    return f"{RANGES_ROOT}/{rid}/meta"


def migration_path(rid: int) -> str:
    return f"{RANGES_ROOT}/{rid}/migration"


def get_range_meta(zk: Coordination, rid: int
                   ) -> Optional[tuple[str, str, tuple[int, ...]]]:
    """(lo, hi, members) or None if the range is not registered."""
    try:
        lo, hi, members = zk.get(meta_path(rid))
        return lo, hi, tuple(members)
    except NoNode:
        return None


def set_range_meta(zk: Coordination, rid: int, lo: str, hi: str,
                   members: tuple[int, ...]) -> None:
    """Idempotent create-or-update + table-version bump."""
    data = (lo, hi, tuple(members))
    try:
        if zk.get(meta_path(rid)) == data:
            return  # no-op: don't bump the version for identical state
        zk.set_data(meta_path(rid), data)
    except NoNode:
        try:
            zk.create(meta_path(rid), data=data)
        except NodeExists:
            zk.set_data(meta_path(rid), data)
    bump_table_version(zk)


def unregister_range(zk: Coordination, rid: int) -> None:
    try:
        zk.delete(meta_path(rid))
    except NoNode:
        return
    bump_table_version(zk)


def bump_table_version(zk: Coordination) -> None:
    zk.fetch_and_add(VERSION_PATH, 1, initial=0)


def table_version(zk: Coordination) -> int:
    try:
        return zk.get(VERSION_PATH)
    except NoNode:
        return 0


def alloc_range_id(zk: Coordination, initial: int) -> int:
    """Fresh range id for a split child (atomic counter; `initial` is the
    number of pre-split base ranges, so child ids never collide)."""
    return zk.fetch_and_add(NEXT_RID_PATH, 1, initial=initial - 1)


def seed_child_epoch(zk: Coordination, child_rid: int,
                     parent_epoch: int) -> None:
    """Start the child's epoch counter at the parent's current epoch so the
    child leader's first epoch exceeds it: every LSN the child cohort mints
    orders after the LSNs baked into the forked cells (App. B's
    epoch-in-the-high-bits trick doing double duty)."""
    try:
        zk.create(f"{RANGES_ROOT}/{child_rid}/epoch", data=parent_epoch)
    except NodeExists:
        pass


def load_range_map(zk: Coordination
                   ) -> dict[int, tuple[str, str, tuple[int, ...]]]:
    """rid -> (lo, hi, members) for every registered range."""
    out: dict[int, tuple[str, str, tuple[int, ...]]] = {}
    for name in zk.get_children(RANGES_ROOT):
        if not name.isdigit():
            continue
        meta = get_range_meta(zk, int(name))
        if meta is not None:
            out[int(name)] = meta
    return out


# ---------------------------------------------------------------------------
# Client-side range table cache
# ---------------------------------------------------------------------------

class RangeTable:
    """Client-side cache of the range table.

    Loaded lazily from the ``/ranges/*/meta`` znodes; invalidated by a
    data-change watch on ``/ranges/version`` (armed at load time) or
    explicitly when a WRONG_RANGE redirect proves the cache stale.  Lookups
    between invalidation and the next load pay one metadata scan — the
    read/write path itself never touches coordination (§4.2).
    """

    def __init__(self, zk: Coordination):
        self.zk = zk
        self._los: list[str] = []
        self._rids: list[int] = []
        self._members: dict[int, tuple[int, ...]] = {}
        self._loaded = False
        self.loads = 0            # stats: metadata scans paid
        self.invalidations = 0

    def invalidate(self, _path: str = "") -> None:
        if self._loaded:
            self.invalidations += 1
        self._loaded = False

    def _load(self) -> None:
        rmap = load_range_map(self.zk)
        table = sorted((lo, rid) for rid, (lo, _hi, _m) in rmap.items())
        self._los = [lo for lo, _ in table]
        self._rids = [rid for _, rid in table]
        self._members = {rid: m for rid, (_lo, _hi, m) in rmap.items()}
        self._loaded = True
        self.loads += 1
        # one-shot watch: any later table change flips the cache stale
        self.zk.watch_exists(VERSION_PATH, self.invalidate)

    def lookup(self, key: str) -> Optional[int]:
        """rid owning `key`, or None when no range table is registered."""
        if not self._loaded:
            self._load()
        if not self._los:
            return None
        idx = bisect.bisect_right(self._los, key) - 1
        return self._rids[max(0, idx)]

    def members(self, rid: int) -> tuple[int, ...]:
        if not self._loaded:
            self._load()
        return self._members.get(rid, ())


# ---------------------------------------------------------------------------
# Hotspot-driven rebalancing
# ---------------------------------------------------------------------------

@dataclass
class BalancerConfig:
    period: float = 0.5            # sampling tick
    split_threshold: float = 4000.0  # ops/s on one range before splitting
    move_imbalance: float = 2.0    # max/min node load ratio before a move
    min_node_load: float = 500.0   # don't chase noise on an idle cluster
    cooldown: float = 2.0          # min time between actions
    max_ranges: int = 64           # hard cap: stop splitting past this


class RangeBalancer:
    """Control-plane singleton sampling per-range throughput from node
    stats and shedding hotspots via split/move.

    One action per tick at most, with a cooldown, so the cluster settles
    between moves instead of thrashing.  Decisions use the resource
    profiler's per-range heat (cluster-global served-op counts, so a
    leader change between ticks cannot corrupt the delta); when the
    profiler is disabled they fall back to leader-side served-op
    counters, the closest sim analogue of the per-range load stats a
    real master would scrape.
    """

    def __init__(self, cluster: "SpinnakerCluster",
                 cfg: Optional[BalancerConfig] = None):
        self.cluster = cluster
        self.cfg = cfg or BalancerConfig()
        self.sim = cluster.sim
        self._last: dict[int, int] = {}      # rid -> last sampled op count
        self._last_action_t = -1e9
        self._timer = None
        self.running = False
        self.actions: list[str] = []         # human-readable audit log

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self.running:
            return
        self.running = True
        self._arm()

    def stop(self) -> None:
        self.running = False
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _arm(self) -> None:
        self._timer = self.sim.schedule(self.cfg.period, self._tick)

    # -- sampling -----------------------------------------------------------
    def _sample_loads(self) -> dict[int, float]:
        """ops/s served per range since the last tick (profiler heat, or
        leader counters when the profiler is off)."""
        prof = self.cluster.obs.profiler
        loads: dict[int, float] = {}
        for rid in list(self.cluster.ranges):
            rep = self.cluster.leader_replica(rid)
            if rep is None:
                continue
            if prof.enabled:
                total = prof.range_ops(rid)
            else:
                total = rep.writes_served + rep.reads_served
            prev = self._last.get(rid)
            self._last[rid] = total
            if prev is None:
                continue
            loads[rid] = max(0, total - prev) / self.cfg.period
        return loads

    def _heat_reading(self, rid: int) -> dict:
        """The heat snapshot that triggered a decision (for the event)."""
        return self.cluster.obs.profiler.heat_snapshot(rid)

    def _node_loads(self, loads: dict[int, float]) -> dict[int, float]:
        """Per-node hosted load: leaders carry the full range load,
        followers roughly half of it (log + apply work, no serving)."""
        out: dict[int, float] = {n: 0.0 for n, node in
                                 self.cluster.nodes.items() if node.up}
        for rid, load in loads.items():
            rep = self.cluster.leader_replica(rid)
            if rep is None:
                continue
            for m in self.cluster.members.get(rid, ()):
                if m in out:
                    out[m] += load if m == rep.node.node_id else 0.5 * load
        return out

    # -- decision -----------------------------------------------------------
    def _tick(self) -> None:
        if not self.running:
            return
        loads = self._sample_loads()
        now = self.sim.now
        if loads and now - self._last_action_t >= self.cfg.cooldown:
            if self._maybe_split(loads) or self._maybe_move(loads):
                self._last_action_t = now
        self._arm()

    def _maybe_split(self, loads: dict[int, float]) -> bool:
        if len(self.cluster.ranges) >= self.cfg.max_ranges:
            return False
        for rid, load in sorted(loads.items(), key=lambda kv: -kv[1]):
            if load < self.cfg.split_threshold:
                return False
            self.cluster.obs.events.emit(
                "balancer_split_decision", rid=rid,
                load_ops_s=round(load, 3),
                threshold=self.cfg.split_threshold,
                heat=self._heat_reading(rid))
            if self.cluster.admin_split(rid):
                self.actions.append(
                    f"t={self.sim.now:.2f}: split range {rid} "
                    f"(load {load:.0f}/s)")
                return True
        return False

    def _maybe_move(self, loads: dict[int, float]) -> bool:
        """Shed follower work: move the hottest range's most-loaded
        follower replica to the least-loaded node outside its cohort.
        (Leaders are never moved — leadership follows data via the normal
        election once a migrated replica catches up.)"""
        node_loads = self._node_loads(loads)
        if len(node_loads) < 2:
            return False
        cold = min(node_loads, key=node_loads.get)
        for rid, load in sorted(loads.items(), key=lambda kv: -kv[1]):
            if load < self.cfg.min_node_load:
                return False   # sorted: nothing hotter follows
            members = self.cluster.members.get(rid, ())
            rep = self.cluster.leader_replica(rid)
            if rep is None or cold in members or len(members) != 3:
                continue
            followers = [m for m in members
                         if m != rep.node.node_id and m in node_loads]
            if not followers:
                continue
            src = max(followers, key=node_loads.get)
            if node_loads[src] < self.cfg.min_node_load \
                    or node_loads[src] < self.cfg.move_imbalance * max(
                        node_loads[cold], 1e-9):
                continue
            self.cluster.obs.events.emit(
                "balancer_move_decision", rid=rid, src=src, dst=cold,
                load_ops_s=round(load, 3),
                src_node_load=round(node_loads[src], 3),
                dst_node_load=round(node_loads[cold], 3),
                heat=self._heat_reading(rid))
            if self.cluster.admin_move(rid, src, cold):
                self.actions.append(
                    f"t={self.sim.now:.2f}: move range {rid} replica "
                    f"n{src} -> n{cold} (node load "
                    f"{node_loads[src]:.0f} vs {node_loads[cold]:.0f})")
                return True
        return False
