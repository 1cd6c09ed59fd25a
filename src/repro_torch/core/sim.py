"""Deterministic discrete-event simulator.

Every component of the Spinnaker reproduction (nodes, disks, network,
coordination service, clients) runs on this simulator so that arbitrary
failure schedules are reproducible bit-for-bit from a seed.  Time is in
seconds (float).  Events with equal timestamps are ordered by insertion
sequence, which makes runs deterministic regardless of heap tie-breaking.
"""

from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class Event:
    """A cancellable scheduled callback."""

    __slots__ = ("time", "seq", "fn", "args", "cancelled")

    def __init__(self, time: float, seq: int, fn: Callable, args: tuple):
        self.time = time
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)


class Simulator:
    """Event loop with a virtual clock."""

    def __init__(self, seed: int = 0):
        self.now: float = 0.0
        self._heap: list[Event] = []
        self._seq = itertools.count()
        self.rng = random.Random(seed)
        self.events_processed = 0

    # -- scheduling ---------------------------------------------------------
    def schedule(self, delay: float, fn: Callable, *args: Any) -> Event:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        ev = Event(self.now + delay, next(self._seq), fn, args)
        heapq.heappush(self._heap, ev)
        return ev

    def at(self, time: float, fn: Callable, *args: Any) -> Event:
        return self.schedule(max(0.0, time - self.now), fn, *args)

    # -- execution ----------------------------------------------------------
    def step(self) -> bool:
        """Run one event.  Returns False when the queue is exhausted."""
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            if ev.time < self.now - 1e-12:
                raise RuntimeError("event scheduled in the past")
            self.now = max(self.now, ev.time)
            self.events_processed += 1
            ev.fn(*ev.args)
            return True
        return False

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000) -> None:
        """Run events until the queue empties or the clock passes `until`."""
        n = 0
        while self._heap:
            ev = self._heap[0]
            if ev.cancelled:
                heapq.heappop(self._heap)
                continue
            if until is not None and ev.time > until:
                self.now = until
                return
            if not self.step():
                return
            n += 1
            if n > max_events:
                raise RuntimeError(f"simulation exceeded {max_events} events")
        if until is not None:
            self.now = max(self.now, until)

    def run_until_idle(self, max_events: int = 50_000_000) -> None:
        self.run(until=None, max_events=max_events)

    def run_for(self, dt: float) -> None:
        """Advance the clock by dt (periodic timers keep the queue non-empty
        forever, so bounded runs are the normal driving mode)."""
        self.run(until=self.now + dt)

    # -- randomness helpers ---------------------------------------------------
    def jitter(self, mean: float, cv: float = 0.25) -> float:
        """Log-normal-ish positive jittered latency with coefficient of variation cv."""
        if mean <= 0:
            return 0.0
        lo = mean * max(0.05, 1.0 - 2.0 * cv)
        x = self.rng.gauss(mean, mean * cv)
        return max(lo, x)


# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------


class FifoServer:
    """A single-server FIFO queue (models per-node CPU or a disk head).

    `submit(service_time, cb)` enqueues a job; `cb` fires when the job
    completes.  Utilisation and queue statistics are tracked so benchmarks
    can report saturation points.
    """

    def __init__(self, sim: Simulator, name: str = "srv"):
        self.sim = sim
        self.name = name
        self.busy_until: float = 0.0
        self.queue_len = 0
        self.total_busy = 0.0
        self.jobs = 0
        self._open = True
        self.slow_factor = 1.0  # gray-failure degradation multiplier

    def reset(self) -> None:
        """Drop queued work (e.g. on node crash)."""
        self.busy_until = self.sim.now
        self.queue_len = 0

    def close(self) -> None:
        self._open = False
        self.reset()

    def open(self) -> None:
        self._open = True
        self.busy_until = self.sim.now

    def submit(self, service_time: float, cb: Optional[Callable] = None,
               *args: Any) -> float:
        """Enqueue a job; returns its completion time."""
        if not self._open:
            return float("inf")
        service_time *= self.slow_factor
        start = max(self.sim.now, self.busy_until)
        done = start + service_time
        self.busy_until = done
        self.total_busy += service_time
        self.jobs += 1
        if cb is not None:
            gen = self._gen  # crash-generation guard
            def fire():
                if self._open and self._gen == gen:
                    cb(*args)
            self.sim.schedule(done - self.sim.now, fire)
        return done

    _gen = 0

    def bump_generation(self) -> None:
        self._gen += 1

    def queue_delay(self) -> float:
        """Seconds of already-accepted work ahead of a job submitted now —
        the queue-depth gauge the metrics registry scrapes (the header
        `queue_len` counter is not maintained by `submit`)."""
        return max(0.0, self.busy_until - self.sim.now)


@dataclass
class NetParams:
    base_latency: float = 200e-6      # one-way cold-path cost, 1 GbE rack:
    #                                   propagation + switch + the full
    #                                   per-message OS/NIC stack traversal
    bandwidth: float = 117e6          # bytes/sec usable on 1 Gbit
    jitter_cv: float = 0.20
    cross_switch_extra: float = 120e-6  # second-level switch hop
    # Message-coalescing path: consecutive messages on an active (src, dst)
    # connection are framed onto the already-hot pipeline (socket open, NIC
    # ring warm, interrupts coalesced), so they pay only the propagation
    # floor + serialization instead of the full per-message stack overhead.
    # This is the "per-message cost once, per-record cost n times" behavior
    # measured for batched Paxos messaging ("The Performance of Paxos in
    # the Cloud"): per-message overhead, not the protocol, dominates.  A
    # connection goes cold after `stream_idle` of send silence.
    stream_floor: float = 40e-6       # propagation + switch + warm NIC
    stream_idle: float = 50e-3        # send gap after which the pipeline
    #                                   drains and full overhead returns
    #                                   (order of a TCP RTO / slow-start-
    #                                   after-idle, not a NIC timescale)


class Network:
    """Point-to-point reliable in-order messaging (TCP model, §A.1).

    Per (src, dst) pair delivery is FIFO: a later send never arrives before
    an earlier one.  Messages to/from a down endpoint are dropped, like a
    broken TCP connection.
    """

    def __init__(self, sim: Simulator, params: NetParams | None = None):
        self.sim = sim
        self.p = params or NetParams()
        self._last_delivery: dict[tuple[Any, Any], float] = {}
        # last successful send per (src, dst): the message-coalescing path
        # charges only `stream_floor` while the connection stays warm
        self._last_send: dict[tuple[Any, Any], float] = {}
        self._down: set[Any] = set()
        self._group: dict[Any, int] = {}   # partition membership
        # one-way partitions: messages src∈A -> dst∈B are blocked, B -> A flow
        self._oneway: list[tuple[frozenset, frozenset]] = []
        # per-link gray faults: (src, dst) -> (drop_p, dup_p, delay_factor)
        self._link_faults: dict[tuple[Any, Any], tuple[float, float, float]] = {}
        self.bytes_sent = 0
        self.msgs_sent = 0
        self.msgs_warm = 0      # sends that rode the coalescing path
        self.dropped = 0
        # resource profiler attribution (obs/profile.py); accounting only
        self.profiler = None

    def set_down(self, endpoint: Any, down: bool = True) -> None:
        if down:
            self._down.add(endpoint)
            # connections to/from a dead endpoint reset: reconnection pays
            # the cold per-message cost again
            self._last_send = {k: t for k, t in self._last_send.items()
                               if endpoint not in k}
        else:
            self._down.discard(endpoint)

    def is_down(self, endpoint: Any) -> bool:
        return endpoint in self._down

    # -- partitions -----------------------------------------------------------
    def set_partition(self, groups) -> None:
        """Partition the network into `groups` of endpoints.

        Messages between endpoints in *different* groups are dropped (both
        at send and delivery time, so in-flight traffic is cut too).
        Endpoints in no group — clients, the coordination service — keep
        full connectivity, mirroring the paper's deployment where ZooKeeper
        sits outside the data path."""
        self._group = {}
        for gi, members in enumerate(groups):
            for e in members:
                self._group[e] = gi

    def clear_partition(self) -> None:
        self._group = {}

    def set_oneway_partition(self, src_group, dst_group) -> None:
        """Block messages from `src_group` to `dst_group` only — the reverse
        direction keeps flowing (asymmetric / gray partition).  Cumulative:
        each call adds one directed cut."""
        self._oneway.append((frozenset(src_group), frozenset(dst_group)))

    def clear_oneway_partitions(self) -> None:
        self._oneway = []

    # -- per-link gray faults -------------------------------------------------
    def set_link_fault(self, src: Any, dst: Any, drop_p: float = 0.0,
                       dup_p: float = 0.0, delay_factor: float = 1.0) -> None:
        """Degrade the directed link src -> dst: drop each message with
        probability `drop_p`, duplicate it with probability `dup_p`, and
        multiply its latency by `delay_factor`."""
        self._link_faults[(src, dst)] = (drop_p, dup_p, delay_factor)

    def update_link_fault(self, src: Any, dst: Any,
                          drop_p: Optional[float] = None,
                          dup_p: Optional[float] = None,
                          delay_factor: Optional[float] = None) -> None:
        """Merge into an existing link fault: only the given aspects change,
        so `drop` + `slow link` directives on the same link compose."""
        cur = self._link_faults.get((src, dst), (0.0, 0.0, 1.0))
        self._link_faults[(src, dst)] = (
            cur[0] if drop_p is None else drop_p,
            cur[1] if dup_p is None else dup_p,
            cur[2] if delay_factor is None else delay_factor)

    def clear_link_fault(self, src: Any, dst: Any) -> None:
        self._link_faults.pop((src, dst), None)

    def clear_link_faults(self) -> None:
        self._link_faults = {}

    def clear_faults(self) -> None:
        """Heal everything: symmetric + one-way partitions and link faults."""
        self.clear_partition()
        self.clear_oneway_partitions()
        self.clear_link_faults()

    def partitioned(self, src: Any, dst: Any) -> bool:
        gs, gd = self._group.get(src), self._group.get(dst)
        if gs is not None and gd is not None and gs != gd:
            return True
        for sg, dg in self._oneway:
            if src in sg and dst in dg:
                return True
        return False

    def _blocked(self, src: Any, dst: Any) -> bool:
        return src in self._down or dst in self._down \
            or self.partitioned(src, dst)

    def send(self, src: Any, dst: Any, handler: Callable, *args: Any,
             nbytes: int = 256, cross_switch: bool = False,
             component: Optional[str] = None, rid: Any = None) -> None:
        if self._blocked(src, dst):
            self.dropped += 1
            return  # dropped
        fault = self._link_faults.get((src, dst))
        copies = 1
        delay_factor = 1.0
        if fault is not None:
            drop_p, dup_p, delay_factor = fault
            if drop_p and self.sim.rng.random() < drop_p:
                self.dropped += 1
                return  # silently eaten by the flaky link
            if dup_p and self.sim.rng.random() < dup_p:
                copies = 2
        prof = self.profiler
        # message-coalescing path: a send while the (src, dst) connection is
        # warm is framed onto the in-flight pipeline and pays the propagation
        # floor; the first send after an idle gap pays the full per-message
        # stack overhead (FIFO delivery clamp below keeps ordering intact)
        link = (src, dst)
        last = self._last_send.get(link)
        warm = last is not None \
            and self.sim.now - last <= self.p.stream_idle
        self._last_send[link] = self.sim.now
        overhead = self.p.stream_floor if warm else self.p.base_latency
        if warm:
            self.msgs_warm += 1
        for _ in range(copies):
            lat = self.sim.jitter(overhead, self.p.jitter_cv)
            lat += nbytes / self.p.bandwidth
            if cross_switch:
                lat += self.p.cross_switch_extra
            lat *= delay_factor
            key = (src, dst)
            deliver_at = max(self.sim.now + lat,
                             self._last_delivery.get(key, 0.0) + 1e-9)
            self._last_delivery[key] = deliver_at
            self.bytes_sent += nbytes
            self.msgs_sent += 1
            if prof is not None and prof.enabled:
                prof.net_msg(src, component or "other", nbytes, rid)

            def deliver():
                # recheck liveness and partition membership at delivery time
                if self._blocked(src, dst):
                    self.dropped += 1
                    return
                handler(*args)

            self.sim.at(deliver_at, deliver)


@dataclass
class DiskParams:
    """Log-device model.  Defaults are the paper's SATA HDD logging disk."""
    force_latency: float = 4.0e-3      # rotational + metadata seek, §C
    force_cv: float = 0.35
    bandwidth: float = 80e6            # sequential bytes/sec
    kind: str = "hdd"

    @staticmethod
    def hdd() -> "DiskParams":
        return DiskParams()

    @staticmethod
    def ssd() -> "DiskParams":
        # FusionIO ioXtreme-class device (App. D.4)
        return DiskParams(force_latency=90e-6, force_cv=0.25, bandwidth=500e6,
                          kind="ssd")

    @staticmethod
    def memory() -> "DiskParams":
        # main-memory "log" (App. D.6.2): a force is just a memcpy
        return DiskParams(force_latency=4e-6, force_cv=0.10, bandwidth=8e9,
                          kind="mem")


class Disk:
    """Serial log device with FIFO forcing; used by the WAL's group commit."""

    def __init__(self, sim: Simulator, params: DiskParams | None = None,
                 name: str = "disk"):
        self.sim = sim
        self.p = params or DiskParams()
        self.name = name
        self.busy = False
        # (nbytes, cb, component, rid)
        self._waiters: list[tuple[int, Callable, Optional[str], Any]] = []
        self.forces = 0
        self.bytes_forced = 0
        self.total_busy = 0.0
        self._gen = 0
        self.slow_factor = 1.0  # gray-failure degradation multiplier
        # resource profiler attribution (obs/profile.py); accounting only
        self.profiler = None
        self.profiler_node = None

    def crash(self) -> None:
        """Drop in-flight IO (node crash).  Durable state is kept by the WAL."""
        self._gen += 1
        self._waiters.clear()
        self.busy = False

    def queue_depth(self) -> int:
        """Force requests queued or in flight (metrics gauge)."""
        return len(self._waiters) + (1 if self.busy else 0)

    def force(self, nbytes: int, cb: Callable,
              component: Optional[str] = None, rid: Any = None) -> None:
        """Request a durable write of `nbytes`; `cb()` fires on completion.

        Requests arriving while the head is busy are coalesced into one
        batch force when the head frees up — this IS group commit [13].
        """
        self._waiters.append((nbytes, cb, component, rid))
        if not self.busy:
            self._start_batch()

    def _start_batch(self) -> None:
        if not self._waiters:
            return
        batch = self._waiters
        self._waiters = []
        self.busy = True
        total = sum(b[0] for b in batch)
        lat = self.sim.jitter(self.p.force_latency, self.p.force_cv)
        lat += total / self.p.bandwidth
        lat *= self.slow_factor
        gen = self._gen
        self.forces += 1
        self.bytes_forced += total
        self.total_busy += lat
        prof = self.profiler
        if prof is not None and prof.enabled:
            # attribute the batch's head time proportionally by bytes (equal
            # split when the batch carries no payload) so component sums
            # match total_busy exactly
            for nb, _cb, comp, rid in batch:
                share = lat * (nb / total) if total else lat / len(batch)
                prof.disk_busy(self.profiler_node, comp or "wal.force",
                               share, nb, rid)

        def done():
            if gen != self._gen:
                return
            self.busy = False
            for b in batch:
                b[1]()
            self._start_batch()

        self.sim.schedule(lat, done)


# ---------------------------------------------------------------------------
# Statistics helper
# ---------------------------------------------------------------------------


class LatencyStats:
    def __init__(self):
        self.samples: list[float] = []

    def add(self, v: float) -> None:
        self.samples.append(v)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else float("nan")

    def percentile(self, p: float) -> float:
        if not self.samples:
            return float("nan")
        s = sorted(self.samples)
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[idx]
