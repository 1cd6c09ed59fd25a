"""Sharding policy on a `DeviceMesh`: map parameter/batch/cache trees to
DTensor placements; a port of `repro/dist/sharding.py`.

`ShardingPolicy` decides which mesh dims carry tensor parallelism (TP),
data parallelism (DP/FSDP) and expert parallelism (EP).  `param_spec`
assigns a parameter the reference's PartitionSpec from its tree path, as
a plain tuple with one entry per tensor dim (None, a mesh dim's name, or
a tuple of names: what `tuple(PartitionSpec)` gives); indivisible entries
are dropped (`_drop_indivisible`) rather than erroring, so one policy
covers every architecture in `repro_torch.configs`.  `to_placements`
turns such a spec into one DTensor placement per mesh dim.

`MeshContext` is the activation half: entering it publishes the context
to `repro_torch.dist.context` and installs the `pshard` activation hook
in `repro_torch.models.layers`.  Inside it the model runs SPMD, one
process per mesh position, on this rank's rows of the batch
(`local_batch`) with the parameters replicated.  The code that couples
rows issues its collectives over the process groups of the mesh dims
(`group`): the loss's token count, the MoE router's capacity and aux
loss, the expert-parallel all-to-all and the hd-sharded decode.  Nothing
computes with sharded parameters yet: `shard_tree` lays a tree out as
DTensors for storage.  Process groups are NCCL's for a CUDA mesh and
gloo's for a CPU mesh, as `init_process_group` made them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..tree import tree_map, tree_map_with_path
from . import context as _context

# parameter names whose LAST dim is the TP (output-feature) dim
_TP_LAST = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "unembed"}
# parameter names whose SECOND-TO-LAST dim is the TP (input-feature) dim
_TP_SECOND = {"wo", "w_down", "out_proj"}


def path_str(path) -> str:
    """'/'-joined tree path: the port's names ("layers/attn/wq") pass as
    they are; a sequence of keys, indices or objects with .key/.idx/.name
    is joined as the reference joins it."""
    if isinstance(path, str):
        return path
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _names(axes) -> tuple:
    """Mesh dim names: one name, or a sequence of them."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _entry(axes):
    """A spec entry as `PartitionSpec` keeps it: one name alone, several
    as a tuple."""
    names = _names(axes)
    return names[0] if len(names) == 1 else names


@dataclass
class ShardingPolicy:
    """Which mesh dims carry which kind of parallelism."""
    tp_axis: str = "model"
    dp_axes: tuple = ("data",)          # batch/activation axes
    fsdp_axes: tuple = ("data",)        # parameter-sharding axes
    ep_axes: tuple = ("data",)          # expert-parallel axes
    seq_parallel: bool = False

    @classmethod
    def for_mesh(cls, mesh: DeviceMesh, seq_parallel: bool = False,
                 shard_params_on_pod: bool = False) -> "ShardingPolicy":
        axes = tuple(mesh.mesh_dim_names)
        tp = "model" if "model" in axes else axes[-1]
        dp = tuple(a for a in axes if a != tp)
        fsdp = tuple(a for a in dp if a != "pod" or shard_params_on_pod)
        ep = tuple(a for a in dp if a != "pod") or dp
        return cls(tp_axis=tp, dp_axes=dp, fsdp_axes=fsdp, ep_axes=ep,
                   seq_parallel=seq_parallel)


def _axis_size(mesh: DeviceMesh, entry) -> int:
    if entry is None:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in _names(entry):
        n *= sizes[a]
    return n


def _drop_indivisible(spec: tuple, leaf, mesh: DeviceMesh) -> tuple:
    """Replace spec entries whose axis product doesn't divide the dim."""
    shape = getattr(leaf, "shape", leaf)
    out = []
    for d, entry in enumerate(tuple(spec)):
        if entry is not None and d < len(shape) \
                and shape[d] % _axis_size(mesh, entry) == 0:
            out.append(entry)
        else:
            out.append(None)
    return tuple(out)


def param_spec(path, leaf, pol: ShardingPolicy, cfg=None) -> tuple:
    """The spec of one parameter, from its name and rank.

    Weights are (..., in, out), usually stacked over layers at dim 0.  TP
    shards the feature dim named by `_TP_LAST`/`_TP_SECOND`; FSDP shards
    the opposite matrix dim.  Vectors and norms replicate.
    """
    if leaf.ndim <= 1:
        return (None,) * leaf.ndim
    name = path_str(path).rsplit("/", 1)[-1]
    spec: list = [None] * leaf.ndim
    fsdp = _entry(pol.fsdp_axes) if pol.fsdp_axes else None
    if name in _TP_LAST:
        spec[-1] = pol.tp_axis
        if fsdp:
            spec[-2] = fsdp
    elif name in _TP_SECOND:
        spec[-2] = pol.tp_axis
        if fsdp:
            spec[-1] = fsdp
    elif name == "embed":
        if fsdp:
            spec[0] = fsdp
    else:
        # unknown >=2D weight: FSDP on its largest dim
        if fsdp:
            spec[max(range(leaf.ndim), key=lambda d: leaf.shape[d])] = fsdp
    return tuple(spec)


def to_placements(spec: tuple, mesh: DeviceMesh) -> tuple:
    """One DTensor placement per mesh dim: `Shard(d)` for a mesh dim that
    the spec names at tensor dim d, `Replicate()` for the others.  A
    tensor dim over several mesh dims is split major to minor in mesh
    order, as the reference's tuple entry; raises on a name that is not a
    mesh dim, a mesh dim named twice, or a tuple out of mesh order."""
    names = tuple(mesh.mesh_dim_names)
    placements: list = [Replicate()] * len(names)
    seen: set = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        dims = []
        for a in _names(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, which is not a "
                                 f"dim of the mesh {names}")
            if a in seen:
                raise ValueError(f"spec {spec} names mesh dim {a!r} twice")
            seen.add(a)
            dims.append(names.index(a))
        if dims != sorted(dims):
            raise ValueError(f"spec {spec} splits dim {d} over mesh dims "
                             f"out of the mesh's order {names}")
        for i in dims:
            placements[i] = Shard(d)
    return tuple(placements)


class _SumOverGroup(torch.autograd.Function):
    """all_reduce(sum) whose backward passes the gradient through: each
    rank differentiates its own share of a value the sum made global, and
    the grads are summed afterwards (the train step's all-reduce)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, on every one of them;
    the gradient reaches each rank's `x` unchanged."""
    return _SumOverGroup.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """`psum(x, group)` over the group's size."""
    return psum(x, group) / dist.get_world_size(group)


class MeshContext:
    """Activate a (mesh, config, policy) triple.

    Inside the `with` block, `repro_torch.dist.context.current_ctx()`
    returns this object and the model's `pshard` hook moves a DTensor
    activation's batch dim onto the DP dims.  Provides the placement
    constructors, this rank's rows of a batch, and the process groups of
    the mesh dims.
    """

    def __init__(self, mesh: DeviceMesh, cfg: Any, pol: ShardingPolicy):
        self.mesh = mesh
        self.cfg = cfg
        self.pol = pol
        self._prev_ctx = None
        self._groups: dict = {}

    # -- placements -----------------------------------------------------------
    def replicated(self) -> tuple:
        return (Replicate(),) * self.mesh.ndim

    def _named(self, spec: tuple, leaf) -> tuple:
        return to_placements(_drop_indivisible(spec, leaf, self.mesh),
                             self.mesh)

    def param_shardings(self, tree_shape):
        def one(path, leaf):
            return self._named(param_spec(path, leaf, self.pol, self.cfg),
                               leaf)
        return tree_map_with_path(one, tree_shape)

    def _batch_spec(self, leaf) -> tuple:
        """The leading (batch) dim over DP, before dropping; () (the
        reference's `replicated()`) with no DP dims or for a 0-d leaf."""
        nd = getattr(leaf, "ndim", 0)
        if nd == 0 or not self.pol.dp_axes:
            return ()
        return (_entry(self.pol.dp_axes),) + (None,) * (nd - 1)

    def batch_sharding(self, batch):
        """Shard the leading (batch) dim of every input leaf over DP."""
        return tree_map(
            lambda leaf: self._named(self._batch_spec(leaf), leaf), batch)

    def _cache_spec(self, leaf) -> tuple:
        """KV/SSM cache: (L, B, heads, ...) — batch on DP, heads on TP."""
        dp = _entry(self.pol.dp_axes) if self.pol.dp_axes else None
        nd = getattr(leaf, "ndim", 0)
        if nd <= 1:
            return (dp,) if nd == 1 and dp else (None,) * nd
        entries: list = [None] * nd
        if dp:
            entries[1] = dp
        if nd >= 4:
            entries[2] = self.pol.tp_axis
        return tuple(entries)

    def cache_sharding(self, cache_shape):
        return tree_map(
            lambda leaf: self._named(self._cache_spec(leaf), leaf),
            cache_shape)

    def shard_tree(self, tree, shardings):
        """`tree` laid out on the mesh as DTensors with `shardings`' leaf
        placements (every rank passes the same full tensors)."""
        return tree_map(
            lambda t, pl: distribute_tensor(t, self.mesh, list(pl)),
            tree, shardings)

    # -- this rank's share ----------------------------------------------------
    def size(self, axes) -> int:
        """Ranks along the mesh dims `axes` (one name or a sequence)."""
        return _axis_size(self.mesh, _entry(axes)) if _names(axes) else 1

    def index(self, axes) -> int:
        """This rank's position along `axes`, the first dim major."""
        names = tuple(self.mesh.mesh_dim_names)
        coord = self.mesh.get_coordinate()
        i = 0
        for a in _names(axes):
            d = names.index(a)
            i = i * self.mesh.shape[d] + coord[d]
        return i

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along `axes`, ranked by `index(axes)`.  Several dims make a group
        of their own, made once, by every rank of the world together."""
        names = _names(axes)
        if len(names) == 1:
            return self.mesh.get_group(names[0])
        if names not in self._groups:
            dims = [self.mesh.mesh_dim_names.index(a) for a in names]
            rest = [d for d in range(self.mesh.ndim) if d not in dims]
            ranks = self.mesh.mesh.permute(*rest, *dims).reshape(
                -1, self.size(names))
            self._groups[names], _ = dist.new_subgroups_by_enumeration(
                ranks.tolist())
        return self._groups[names]

    def dp_group(self):
        """The DP dims' process group, or None when the policy has none."""
        return self.group(self.pol.dp_axes) if self.pol.dp_axes else None

    def local_batch(self, batch):
        """This rank's rows of every leaf of `batch`: the leading dim cut
        into one block per DP position, block `index(dp_axes)` (the
        reference's batch sharding).  0-d leaves pass as they are."""
        n = self.size(self.pol.dp_axes)
        i = self.index(self.pol.dp_axes)

        def one(x):
            if x.ndim == 0 or n == 1:
                return x
            if x.shape[0] % n:
                raise ValueError(f"batch dim {x.shape[0]} does not split "
                                 f"over {n} DP ranks")
            rows = x.shape[0] // n
            return x[i * rows:(i + 1) * rows]
        return tree_map(one, batch)

    # -- activation hook ------------------------------------------------------
    def _shard_activation(self, x, kind: str):
        """A DTensor moves to its batch dim over DP (indivisible dims
        replicate); a plain tensor is already this rank's rows and passes
        as it is."""
        dp = tuple(self.pol.dp_axes)
        if not isinstance(x, DTensor) or not dp or x.ndim == 0:
            return x
        spec = _drop_indivisible((_entry(dp),) + (None,) * (x.ndim - 1),
                                 x, self.mesh)
        return x.redistribute(self.mesh, to_placements(spec, self.mesh))

    # -- context protocol -----------------------------------------------------
    def __enter__(self) -> "MeshContext":
        from ..models.layers import install_shard_hook
        self._prev_ctx = _context.current_ctx()
        _context.set_ctx(self)
        install_shard_hook(self._shard_activation)
        return self

    def __exit__(self, *exc) -> None:
        from ..models.layers import install_shard_hook
        _context.set_ctx(self._prev_ctx)
        install_shard_hook(self._prev_ctx._shard_activation
                           if self._prev_ctx is not None else None)
