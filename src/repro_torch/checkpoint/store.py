"""Spinnaker-backed replicated checkpoint & metadata store.

This is the paper's technique deployed as the framework's fault-tolerance
plane (DESIGN.md §3):

- training state is flattened to (key → bytes) with keys range-partitioned
  across a Spinnaker cluster (3-way cohorts, chained declustering);
- a checkpoint commit = quorum writes of every chunk, then ONE
  `conditionalPut` on the manifest key — the paper's per-row optimistic
  concurrency is the *split-brain fence*: a zombie trainer holding a stale
  manifest version loses the conditional and cannot clobber a newer
  checkpoint;
- a restarting trainer restores with STRONG reads (must see the committed
  manifest); serving replicas poll with TIMELINE reads (staleness bounded
  by the commit period — §5's trade-off, applied verbatim).

The Spinnaker cluster runs on the deterministic simulator; the store
drives the event loop to completion for each synchronous call (in
production these would be real sockets — the protocol logic is
identical).

A copy of `repro/checkpoint/store.py` whose pytree half works over nested
dicts of torch tensors: leaves (torch tensors on any device, numpy arrays
or numpy scalars) are named and ordered as the reference's, and their
bytes and dtype names are the ones the reference writes, so a checkpoint
written by either package restores in the other.
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..core import (ClusterConfig, DiskParams, ErrorCode, NodeConfig,
                    ReplicaConfig, Result, Simulator, SpinnakerCluster)
from ..tree import tree_leaves_with_path, tree_unflatten

# the manifest's dtype names (`str(np.asarray(leaf).dtype)`, as the
# reference writes them) and the torch dtypes they restore to
DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


class CheckpointError(Exception):
    pass


class StaleTrainerError(CheckpointError):
    """Raised when the manifest conditionalPut loses: another trainer
    committed a newer checkpoint (we are a zombie — stop)."""


@dataclass
class StoreConfig:
    n_nodes: int = 5
    chunk_bytes: int = 1 << 20
    commit_period: float = 1.0
    disk: str = "ssd"            # checkpoints want SSD logs (App. D.4)
    seed: int = 0


class SpinnakerCheckpointStore:
    """Synchronous facade over a simulated Spinnaker cluster."""

    def __init__(self, cfg: StoreConfig | None = None):
        self.cfg = cfg or StoreConfig()
        self.sim = Simulator(seed=self.cfg.seed)
        disk = DiskParams.ssd() if self.cfg.disk == "ssd" else \
            (DiskParams.memory() if self.cfg.disk == "memory"
             else DiskParams.hdd())
        ccfg = ClusterConfig(
            n_nodes=self.cfg.n_nodes,
            node=NodeConfig(
                replica=ReplicaConfig(commit_period=self.cfg.commit_period,
                                      flush_threshold=64 << 20),
                disk=disk))
        self.cluster = SpinnakerCluster(self.sim, ccfg)
        self.cluster.start()
        self.cluster.settle()
        self.client = self.cluster.make_client("ckpt-writer")
        self.reader = self.cluster.make_client("ckpt-reader")
        self._manifest_version: Optional[int] = None

    # -- low-level sync ops --------------------------------------------------
    def _put(self, key: str, value: Any) -> Result:
        res = self.client.sync_put(key, "d", value)
        if not res.ok:
            raise CheckpointError(f"put {key}: {res.code}")
        return res

    def _get(self, key: str, consistent: bool = True) -> Result:
        c = self.client if consistent else self.reader
        return c.sync(c.get, key, "d", consistent)

    # -- pytree <-> chunks -------------------------------------------------------
    @staticmethod
    def _leaf_bytes(leaf) -> tuple[str, list[int], bytes]:
        """(dtype name, shape, little-endian bytes in C order) of a torch
        tensor, numpy array or numpy scalar."""
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            name = _DTYPE_NAMES.get(t.dtype)
            shape = list(t.shape)
            data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        else:
            arr = np.asarray(leaf)
            name, shape, data = str(arr.dtype), list(arr.shape), \
                arr.tobytes()
        if name not in DTYPES:
            raise CheckpointError(f"unsupported leaf dtype "
                                  f"{getattr(leaf, 'dtype', type(leaf))}")
        return name, shape, data

    def save(self, step: int, tree, run_id: str = "run0") -> dict:
        """Commit a checkpoint; fences against concurrent trainers."""
        leaves = tree_leaves_with_path(tree)     # the reference's order
        index = []
        for name, leaf in leaves:
            dtype, shape, data = self._leaf_bytes(leaf)
            crc = zlib.crc32(data)
            nchunks = max(1, (len(data) + self.cfg.chunk_bytes - 1)
                          // self.cfg.chunk_bytes)
            for i in range(nchunks):
                chunk = data[i * self.cfg.chunk_bytes:
                             (i + 1) * self.cfg.chunk_bytes]
                self._put(self._chunk_key(run_id, step, name, i), chunk)
            index.append({"name": name, "dtype": dtype,
                          "shape": shape, "nchunks": nchunks,
                          "crc": crc})
        manifest = {"step": step, "index": index}
        self._commit_manifest(run_id, manifest)
        return manifest

    def _chunk_key(self, run_id: str, step: int, name: str, i: int) -> str:
        # hash-prefix spreads chunks across range partitions
        h = zlib.crc32(f"{run_id}/{step}/{name}/{i}".encode()) % 100_000
        return f"k{h:012d}/{run_id}/{step}/{name}/{i}"

    def _commit_manifest(self, run_id: str, manifest: dict) -> None:
        """conditionalPut fence (§3 of the paper → §3 of DESIGN.md)."""
        key = f"k{0:012d}/manifest/{run_id}"
        blob = json.dumps(manifest)
        if self._manifest_version is None:
            cur = self._get(key, consistent=True)
            if cur.code == ErrorCode.NOT_FOUND:
                res = self.client.sync_put(key, "d", blob)
                if not res.ok:
                    raise CheckpointError(f"manifest put: {res.code}")
                self._manifest_version = res.version
                return
            self._manifest_version = cur.version
        res = self.client.sync_cond_put(key, "d", blob,
                                        self._manifest_version)
        if res.code == ErrorCode.VERSION_MISMATCH:
            raise StaleTrainerError(
                f"manifest advanced to v{res.version}; this trainer is "
                f"fenced out")
        if not res.ok:
            raise CheckpointError(f"manifest cond_put: {res.code}")
        self._manifest_version = res.version

    # -- restore -------------------------------------------------------------------
    def latest_step(self, run_id: str = "run0",
                    consistent: bool = True) -> Optional[int]:
        res = self._get(f"k{0:012d}/manifest/{run_id}", consistent)
        if not res.ok:
            return None
        return json.loads(res.value)["step"]

    def restore(self, step: Optional[int] = None, run_id: str = "run0",
                consistent: bool = True
                ) -> tuple[int, dict[str, torch.Tensor]]:
        """Strong read for trainer restart; timeline for serving refresh.
        The leaves come back as CPU tensors in their saved dtypes."""
        res = self._get(f"k{0:012d}/manifest/{run_id}", consistent)
        if not res.ok:
            raise CheckpointError(f"no manifest: {res.code}")
        if consistent:
            # adopt the committed version so our next save fences correctly
            self._manifest_version = res.version
        manifest = json.loads(res.value)
        if step is not None and manifest["step"] != step:
            raise CheckpointError(
                f"manifest has step {manifest['step']}, wanted {step}")
        step = manifest["step"]
        out: dict[str, torch.Tensor] = {}
        for ent in manifest["index"]:
            parts = []
            for i in range(ent["nchunks"]):
                r = self._get(self._chunk_key(run_id, step, ent["name"], i),
                              consistent)
                if not r.ok:
                    raise CheckpointError(
                        f"chunk {ent['name']}/{i}: {r.code}")
                parts.append(r.value)
            data = bytearray().join(parts)      # writable, for frombuffer
            if zlib.crc32(data) != ent["crc"]:
                raise CheckpointError(f"crc mismatch on {ent['name']}")
            dtype = DTYPES.get(ent["dtype"])
            if dtype is None:
                raise CheckpointError(f"unsupported dtype {ent['dtype']} "
                                      f"of {ent['name']}")
            out[ent["name"]] = (torch.frombuffer(data, dtype=dtype)
                                if data else torch.empty(0, dtype=dtype)
                                ).reshape(ent["shape"])
        return step, out

    def restore_tree(self, like_tree, step: Optional[int] = None,
                     run_id: str = "run0"):
        """Restore into the structure of `like_tree` (resharding-safe:
        lookup is by logical key, not device layout).  Each tensor leaf
        comes back in the dtype and on the device of `like_tree`'s leaf;
        any other leaf as the CPU tensor read."""
        step, flat = self.restore(step, run_id)
        out = []
        for name, leaf in tree_leaves_with_path(like_tree):
            if name not in flat:
                raise CheckpointError(f"missing leaf {name}")
            t = flat[name]
            out.append(t.to(device=leaf.device, dtype=leaf.dtype)
                       if isinstance(leaf, torch.Tensor) else t)
        return step, tree_unflatten(like_tree, out)

    # -- failure injection passthrough (tests/examples) ----------------------------
    def crash_storage_node(self, nid: int, lose_disk: bool = False) -> None:
        self.cluster.crash_node(nid, lose_disk=lose_disk)

    def restart_storage_node(self, nid: int) -> None:
        self.cluster.restart_node(nid)
        self.sim.run_for(5.0)
