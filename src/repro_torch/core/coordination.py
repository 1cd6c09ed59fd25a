"""ZooKeeper-model coordination service (§4.2, §7.1).

Implements the znode tree semantics Spinnaker relies on: persistent /
ephemeral / sequential znodes, one-shot watches on children and on node
deletion, sessions with heartbeat-based expiry.  The service itself is
modeled as a fault-tolerant black box (it is Paxos-replicated ZooKeeper in
the paper); it is **not** on the read/write critical path — only election
and membership traffic touch it, exactly as §4.2 prescribes.

Calls incur a small scheduled delay (ZK serves from memory over the LAN);
watch notifications are delivered asynchronously.  Sessions expire when
heartbeats stop for `session_timeout` (paper §D.1 uses 2 s), which deletes
the session's ephemerals and fires watches — this is the cluster's failure
detector.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .sim import Simulator


@dataclass
class Znode:
    name: str
    data: Any = None
    ephemeral_session: Optional[int] = None
    children: dict[str, "Znode"] = field(default_factory=dict)
    seq_counter: int = 0
    czxid: int = 0  # creation order, breaks election ties (§7.2 line 6)


class CoordinationError(Exception):
    pass


class NodeExists(CoordinationError):
    pass


class NoNode(CoordinationError):
    pass


class Coordination:
    OP_DELAY = 350e-6  # one round trip to the ensemble

    def __init__(self, sim: Simulator, session_timeout: float = 2.0):
        self.sim = sim
        self.session_timeout = session_timeout
        self.root = Znode(name="")
        self._zxid = 0
        # watches: path -> list of callbacks; one-shot (ZK semantics)
        self._child_watches: dict[str, list[Callable]] = {}
        self._exists_watches: dict[str, list[Callable]] = {}
        # sessions: id -> last heartbeat time
        self._sessions: dict[int, float] = {}
        self._session_ephemerals: dict[int, set[str]] = {}
        self._next_session = 1
        self._expiry_timers: dict[int, Any] = {}

    # -- sessions -------------------------------------------------------------
    def create_session(self) -> int:
        sid = self._next_session
        self._next_session += 1
        self._sessions[sid] = self.sim.now
        self._session_ephemerals[sid] = set()
        self._arm_expiry(sid)
        return sid

    def heartbeat(self, sid: int) -> None:
        if sid in self._sessions:
            self._sessions[sid] = self.sim.now
            self._arm_expiry(sid)

    def _arm_expiry(self, sid: int) -> None:
        t = self._expiry_timers.get(sid)
        if t is not None:
            t.cancel()
        self._expiry_timers[sid] = self.sim.schedule(
            self.session_timeout, self._check_expiry, sid)

    def _check_expiry(self, sid: int) -> None:
        last = self._sessions.get(sid)
        if last is None:
            return
        if self.sim.now - last >= self.session_timeout - 1e-9:
            self.expire_session(sid)

    def expire_session(self, sid: int) -> None:
        if sid not in self._sessions:
            return
        del self._sessions[sid]
        timer = self._expiry_timers.pop(sid, None)
        if timer is not None:
            timer.cancel()
        for path in sorted(self._session_ephemerals.pop(sid, ())):
            try:
                self.delete(path)
            except NoNode:
                pass

    def session_alive(self, sid: int) -> bool:
        return sid in self._sessions

    # -- tree ops ---------------------------------------------------------------
    def _walk(self, path: str, create_parents: bool = False) -> tuple[Znode, str]:
        parts = [p for p in path.split("/") if p]
        node = self.root
        for p in parts[:-1]:
            child = node.children.get(p)
            if child is None:
                if not create_parents:
                    raise NoNode(path)
                child = Znode(name=p)
                node.children[p] = child
            node = child
        if not parts:
            raise CoordinationError("root")
        return node, parts[-1]

    def create(self, path: str, data: Any = None, ephemeral_session: Optional[int] = None,
               sequential: bool = False) -> str:
        """Atomic create; raises NodeExists.  Returns the actual path
        (suffixed with a monotonically increasing id when sequential)."""
        parent, name = self._walk(path, create_parents=True)
        if sequential:
            name = f"{name}{parent.seq_counter:010d}"
            parent.seq_counter += 1
        if name in parent.children:
            raise NodeExists(path)
        self._zxid += 1
        parent.children[name] = Znode(name=name, data=data,
                                      ephemeral_session=ephemeral_session,
                                      czxid=self._zxid)
        if ephemeral_session is not None:
            if ephemeral_session not in self._sessions:
                raise CoordinationError("session expired")
            parent_path = path.rsplit("/", 1)[0]
            self._session_ephemerals[ephemeral_session].add(
                f"{parent_path}/{name}")
        parent_path = path.rsplit("/", 1)[0]
        self._fire_child_watches(parent_path)
        full = f"{parent_path}/{name}"
        self._fire_exists_watches(full)
        return full

    def delete(self, path: str) -> None:
        parent, name = self._walk(path)
        node = parent.children.pop(name, None)
        if node is None:
            raise NoNode(path)
        if node.ephemeral_session is not None:
            eph = self._session_ephemerals.get(node.ephemeral_session)
            if eph is not None:
                eph.discard(path)
        self._fire_child_watches(path.rsplit("/", 1)[0])
        self._fire_exists_watches(path)

    def delete_children(self, path: str) -> None:
        try:
            parent, name = self._walk(path)
        except NoNode:
            return
        node = parent.children.get(name)
        if node is None:
            return
        for child in list(node.children):
            self.delete(f"{path}/{child}")

    def get(self, path: str) -> Any:
        parent, name = self._walk(path)
        node = parent.children.get(name)
        if node is None:
            raise NoNode(path)
        return node.data

    def set_data(self, path: str, data: Any) -> None:
        parent, name = self._walk(path)
        node = parent.children.get(name)
        if node is None:
            raise NoNode(path)
        node.data = data
        self._zxid += 1
        # NodeDataChanged: ZK delivers data-change events to exists watches;
        # range-table version bumps rely on this to invalidate client caches
        self._fire_exists_watches(path)

    def exists(self, path: str) -> bool:
        try:
            parent, name = self._walk(path)
        except NoNode:
            return False
        return name in parent.children

    def get_children(self, path: str) -> dict[str, tuple[Any, int]]:
        """name -> (data, czxid); empty dict if the node doesn't exist."""
        try:
            parent, name = self._walk(path)
        except NoNode:
            return {}
        node = parent.children.get(name)
        if node is None:
            return {}
        return {n: (c.data, c.czxid) for n, c in node.children.items()}

    def fetch_and_add(self, path: str, delta: int = 1, initial: int = 0) -> int:
        """Atomic counter (epoch numbers, App. B)."""
        if not self.exists(path):
            try:
                self.create(path, data=initial)
            except NodeExists:
                pass
        val = self.get(path) + delta
        self.set_data(path, val)
        return val

    # -- watches ------------------------------------------------------------------
    def watch_children(self, path: str, cb: Callable) -> None:
        self._child_watches.setdefault(path, []).append(cb)

    def watch_exists(self, path: str, cb: Callable) -> None:
        self._exists_watches.setdefault(path, []).append(cb)

    def _fire_child_watches(self, path: str) -> None:
        cbs = self._child_watches.pop(path, [])
        for cb in cbs:
            self.sim.schedule(self.OP_DELAY, cb, path)

    def _fire_exists_watches(self, path: str) -> None:
        cbs = self._exists_watches.pop(path, [])
        for cb in cbs:
            self.sim.schedule(self.OP_DELAY, cb, path)
