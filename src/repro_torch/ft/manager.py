"""Fault-tolerance manager: failure detection, elastic re-meshing,
straggler mitigation (DESIGN.md §3).

Failure detection reuses the paper's machinery directly: every training
host holds a session in the same coordination service Spinnaker uses for
leader election; a host death ⇒ session expiry ⇒ ephemeral-znode deletion
⇒ watch fires on the controller.  The controller then:

  1. fences the dead generation (bumps /train/<run>/generation — stragglers
     from the old generation see the bump and exit, mirroring the paper's
     epoch numbers);
  2. computes the largest feasible (data, model) grid from survivors;
  3. restores state *by logical key* from the Spinnaker checkpoint store
     (resharding-safe) and resumes from the committed data-pipeline offset.

Straggler mitigation: per-step host heartbeats with deadline; a host that
misses `straggler_grace` consecutive deadlines is treated as failed-slow
and evicted the same way (at 1000-node scale, slow == dead is the only
scalable policy; cf. the paper's use of ZooKeeper timeouts).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.coordination import Coordination, NoNode
from ..core.sim import Simulator


@dataclass
class FTConfig:
    session_timeout: float = 2.0
    heartbeat_interval: float = 0.5
    straggler_grace: int = 3          # missed step-deadlines before eviction
    step_deadline: float = 60.0       # wall seconds per step at scale


class HostAgent:
    """Runs on each training host: session + heartbeats + generation check."""

    def __init__(self, sim: Simulator, zk: Coordination, run_id: str,
                 host_id: int, cfg: FTConfig):
        self.sim = sim
        self.zk = zk
        self.run = run_id
        self.host_id = host_id
        self.cfg = cfg
        self.session = zk.create_session()
        self.generation_seen = 0
        self.alive = True
        try:
            zk.create(f"/train/{run_id}/hosts/{host_id}", data=sim.now,
                      ephemeral_session=self.session)
        except Exception:
            pass
        self._beat()

    def _beat(self):
        if not self.alive:
            return
        self.zk.heartbeat(self.session)
        self.sim.schedule(self.cfg.heartbeat_interval, self._beat)

    def fenced(self) -> bool:
        """True if a newer generation exists (this host must stop)."""
        try:
            gen = self.zk.get(f"/train/{self.run}/generation")
        except NoNode:
            gen = 0
        return gen > self.generation_seen

    def adopt_generation(self) -> int:
        try:
            self.generation_seen = self.zk.get(f"/train/{self.run}/generation")
        except NoNode:
            self.generation_seen = 0
        return self.generation_seen

    def crash(self):
        self.alive = False
        self.zk.expire_session(self.session)


class TrainingController:
    """Watches host membership; on change, fences and re-plans the mesh."""

    def __init__(self, sim: Simulator, zk: Coordination, run_id: str,
                 cfg: FTConfig, on_replan: Callable[[list[int], int], None]):
        self.sim = sim
        self.zk = zk
        self.run = run_id
        self.cfg = cfg
        self.on_replan = on_replan
        self.replans = 0
        self._known: set[int] = set()
        self._watch()

    def hosts(self) -> list[int]:
        return sorted(int(h) for h in
                      self.zk.get_children(f"/train/{self.run}/hosts"))

    def _watch(self):
        self.zk.watch_children(f"/train/{self.run}/hosts", self._on_change)

    def _on_change(self, _path: str = ""):
        current = set(self.hosts())
        if current != self._known and self._known:
            lost = self._known - current
            gained = current - self._known
            if lost or gained:
                gen = self.zk.fetch_and_add(f"/train/{self.run}/generation", 1)
                self.replans += 1
                self.on_replan(sorted(current), gen)
        self._known = current
        self._watch()

    def bootstrap(self):
        self._known = set(self.hosts())
        gen = self.zk.fetch_and_add(f"/train/{self.run}/generation", 1)
        self.on_replan(sorted(self._known), gen)
        return gen


class StragglerTracker:
    """Deadline-based straggler detection over per-step progress marks."""

    def __init__(self, cfg: FTConfig):
        self.cfg = cfg
        self.missed: dict[int, int] = {}

    def observe_step(self, durations: dict[int, float]) -> list[int]:
        """durations: host -> step wall time.  Returns hosts to evict."""
        evict = []
        for host, dur in durations.items():
            if dur > self.cfg.step_deadline:
                self.missed[host] = self.missed.get(host, 0) + 1
                if self.missed[host] >= self.cfg.straggler_grace:
                    evict.append(host)
            else:
                self.missed[host] = 0
        return evict


def plan_mesh(n_hosts: int, chips_per_host: int = 4,
              prefer_model: int = 16) -> tuple[int, int]:
    """Largest (data, model) grid from surviving chips; model axis shrinks
    before data so TP stays ICI-local."""
    chips = n_hosts * chips_per_host
    model = min(prefer_model, chips)
    while chips % model:
        model -= 1
    return chips // model, model
