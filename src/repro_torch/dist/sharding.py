"""Sharding policy on a `DeviceMesh`: map parameter/batch/cache trees to
DTensor placements, and compute with TP/FSDP-sharded parameters; a port
of `repro/dist/sharding.py`.

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
(`local_batch`; a batch the DP ranks do not divide is replicated).  The
code that couples rows issues its collectives over the process groups of
the mesh dims (`group`): the loss's token count, the MoE router's
capacity and aux loss, the expert-parallel all-to-all and the hd-sharded
decode.

Parameters are either replicated (every rank passes the whole tree) or
sharded: `shard_params` keeps this rank's block of every leaf, as
`param_shardings` places it.  The model then asks `materialize` for each
layer's parameters just before the layer runs: the FSDP dims are
all-gathered (the backward reduce-scatters the grads to the block), and
the matmuls that carry the FLOPs stay split over TP, Megatron-style --
attention column-parallel on wq/wk/wv (this rank's heads) and
row-parallel on wo, the MLP and the MoE experts over their d_ff -- with
the input entering the TP group (`tp_enter`: the backward all-reduces
its grad) and the output summed over it (`psum`).  Leaves whose TP split
cuts across a packed layout (Mamba2's in_proj, the vocab of embed and
unembed) are gathered whole.  `reduce_grads` then sums each grad over
the DP dims that do not shard its leaf, and `global_norm` adds the
blocks' squares for the optimizer.  `shard_tree` lays a tree out as
DTensors for storage.  Process groups are NCCL's for a CUDA mesh and
gloo's for a CPU mesh, as `init_process_group` made them.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..tree import (tree_leaves, tree_leaves_with_path, tree_map,
                    tree_map_with_path)
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
    rank differentiates its own share of a value the sum made global --
    its DP rows, whose grads the train step sums afterwards, or a
    TP-split module's partial product, whose input's grad `tp_enter`
    sums (Megatron's g)."""

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


class _EnterTP(torch.autograd.Function):
    """Identity whose backward sums the gradient over the TP group: the
    input of a TP-split module, whose ranks each contribute a part of its
    grad (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """`x` entering a TP-split module on the ranks of `group`."""
    return _EnterTP.apply(x, group)


class _Gather(torch.autograd.Function):
    """All-gather of dim `dim` over `group` (n ranks, this one at i).  The
    backward keeps this rank's block of the grad, summed over the group
    first (a reduce-scatter) when `summed`: the ranks computed on other
    rows; else they computed the same grad."""

    @staticmethod
    def forward(ctx, x, dim, group, n, i, summed):
        ctx.args = (dim, group, n, i, summed)
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        dim, group, n, i, summed = ctx.args
        gt = grad.movedim(dim, 0)
        rows = gt.shape[0] // n
        if summed:
            out = gt.new_empty((rows,) + tuple(gt.shape[1:]))
            dist.reduce_scatter_tensor(out, gt.contiguous(), group=group)
        else:
            out = gt[i * rows:(i + 1) * rows]
        return out.movedim(0, dim), None, None, None, None, None


class _SliceOfReplicated(torch.autograd.Function):
    """Block i of n along `dim` of a tensor every rank of `group` holds
    whole; the backward all-gathers the blocks' grads, so every rank has
    the whole tensor's grad."""

    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.args = (dim, group, n)
        size = x.shape[dim] // n
        return x.narrow(dim, i * size, size)

    @staticmethod
    def backward(ctx, grad):
        dim, group, n = ctx.args
        gt = grad.movedim(dim, 0).contiguous()
        out = gt.new_empty((n * gt.shape[0],) + tuple(gt.shape[1:]))
        dist.all_gather_into_tensor(out, gt, group=group)
        return out.movedim(0, dim), None, None, None, None


def tp_slice(x: torch.Tensor, dim: int, group, n: int,
             i: int) -> torch.Tensor:
    """Block i of n along `dim` of a replicated tensor, its grad made
    whole again over `group`."""
    return _SliceOfReplicated.apply(x, dim, group, n, i)


class TPLocal(dict):
    """A module's parameters split over the TP group `tp_group` (this
    rank's heads or d_ff columns): what `MeshContext.materialize` gives a
    layer that computes TP-parallel."""

    def __init__(self, items, tp_group):
        super().__init__(items)
        self.tp_group = tp_group


def tp_group(params):
    """The TP group a module's parameters are split over, or None."""
    return getattr(params, "tp_group", None)


def _tp_dim(name: str):
    """The dim `param_spec` puts TP on for a parameter named `name` (-1,
    -2), or None: the dim a TP-split module keeps split."""
    return -1 if name in _TP_LAST else -2 if name in _TP_SECOND else None


class MeshContext:
    """Activate a (mesh, config, policy) triple.

    Inside the `with` block, `repro_torch.dist.context.current_ctx()`
    returns this object and the model's `pshard` hook moves a DTensor
    activation's batch dim onto the DP dims.  Provides the placement
    constructors, this rank's rows of a batch, the process groups of the
    mesh dims, and this rank's blocks of the parameters (`shard_params`,
    `shard_state`, `shard_cache`), gathered for the model by
    `materialize`.
    """

    def __init__(self, mesh: DeviceMesh, cfg: Any, pol: ShardingPolicy):
        self.mesh = mesh
        self.cfg = cfg
        self.pol = pol
        self._prev_ctx = None
        self._groups: dict = {}
        # whether the rows the model computes on are split over DP: False
        # only inside `rows` of a batch the DP ranks do not divide
        self.rows_split = True
        # path -> (spec, whole shape) of each leaf shard_params has cut
        self._layout: dict = {}

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

    # -- sharded parameters ---------------------------------------------------
    def block(self, x, spec: tuple):
        """This rank's block of `x` under `spec` (`Shard` placements of
        divisible dims: equal blocks, a tuple entry major to minor)."""
        for d, entry in enumerate(spec):
            if entry is not None:
                n, i = self.size(entry), self.index(entry)
                rows = x.shape[d] // n
                x = x.narrow(d, i * rows, rows)
        return x

    def shard_params(self, params):
        """This rank's block of every leaf of a whole parameter tree (real
        tensors, or meta: shapes only), as `param_shardings` places it,
        each a tensor of its own.  The spec and whole shape of each leaf
        are kept by path for `materialize`, `reduce_grads` and
        `global_norm`."""
        def one(path, leaf):
            spec = _drop_indivisible(param_spec(path, leaf, self.pol,
                                                self.cfg), leaf, self.mesh)
            self._layout[path] = (spec, tuple(leaf.shape))
            return self.block(leaf, spec).clone()
        return tree_map_with_path(one, params)

    def opt_spec(self, path: str) -> tuple:
        """The spec of an optimizer-state leaf of a sharded tree: its
        parameter's (AdamW's m and v mirror the tree), less the reduced
        dim for a factored Adafactor statistic (vr the last, vc the second
        to last); counts replicate.  `shard_params` has seen the
        parameters."""
        parts = path.split("/")
        tail = parts[-1]
        name = "/".join(p for p in parts[1:]
                        if p not in ("stats", "vr", "vc", "v"))
        if path == "count" or name not in self._layout:
            return ()
        spec = list(self._layout[name][0])
        if tail in ("vr", "vc"):
            del spec[-1 if tail == "vr" else -2]
        return tuple(spec)

    def shard_state(self, state):
        """This rank's block of a whole train state {"params", "opt",
        "step"}: the parameters by `shard_params`, the optimizer state by
        `opt_spec`."""
        params = self.shard_params(state["params"])
        opt = tree_map_with_path(
            lambda path, leaf: self.block(leaf, self.opt_spec(path)).clone(),
            state["opt"])
        return {"params": params, "opt": opt, "step": state["step"]}

    def shard_cache(self, cache):
        """This rank's block of a whole cache (`cache_sharding`): its rows
        of the batch (all of them when the DP ranks do not divide it) and
        its KV heads when they split over TP.  The SSM state and conv
        window keep every head: the Mamba2 block computes whole over TP
        (its in_proj packs z, x, B, C and dt)."""
        def one(path, leaf):
            spec = self._cache_spec(leaf)
            if path.startswith("ssm/"):
                spec = spec[:2] + (None,) * (len(spec) - 2)
            return self.block(leaf, _drop_indivisible(spec, leaf,
                                                      self.mesh)).clone()
        return tree_map_with_path(one, cache)

    def _split_axes(self, path: str) -> tuple:
        """The mesh dims a stored leaf is split over, in mesh order."""
        spec = self._layout.get(path, ((),))[0]
        used = {a for e in spec if e is not None for a in _names(e)}
        return tuple(a for a in self.mesh.mesh_dim_names if a in used)

    def _sharded(self, leaf, path: str) -> bool:
        entry = self._layout.get(path)
        return entry is not None and tuple(leaf.shape) != entry[1]

    def _tp_module(self, node: dict, prefix: str, cfg):
        """The TP group when the module `node` computes TP-split, else
        None: its matmul weights are cut blocks (`shard_params`), dense
        ones stored split over TP on the dim the module keeps split (int8
        ones are gathered whole and cut there: `_gather_int8`), and an
        attention has whole KV heads a rank."""
        n = self.size(self.pol.tp_axis)
        if n == 1:
            return None
        if "wq" in node:
            keys = ("wq", "wk", "wv", "wo")
            if cfg.num_kv_heads % n:
                return None
        elif "w_gate" in node:
            keys = ("w_gate", "w_up", "w_down")
        else:
            return None
        for k in keys:
            path = f"{prefix}/{k}" if prefix else k
            leaf = node.get(k)
            if isinstance(leaf, dict):                  # int8 {"q", "s"}
                q = leaf.get("q")
                if q is None or not self._sharded(q, f"{path}/q") \
                        or q.shape[_tp_dim(k)] % n:
                    return None
            elif not isinstance(leaf, torch.Tensor) \
                    or not self._sharded(leaf, path) \
                    or self._layout[path][0][_tp_dim(k)] != self.pol.tp_axis:
                return None
        return self.group(self.pol.tp_axis)

    def _gather(self, leaf, path: str, index, keep):
        """One leaf as the model computes with it: every split dim but
        `keep` all-gathered; layer `index` of a stack."""
        if not self._sharded(leaf, path):
            return leaf if index is None else leaf[index]
        spec = self._layout[path][0]
        if index is not None and spec[0] is None:
            leaf, spec, index = leaf[index], spec[1:], None
        x = leaf
        for d, entry in enumerate(spec):
            if entry is None or (keep is not None and d == keep % len(spec)):
                continue
            axes = _names(entry)
            # the DP ranks computed on other rows: sum their grads
            summed = self.rows_split and all(a in self.pol.dp_axes
                                             for a in axes)
            x = _Gather.apply(x, d, self.group(axes), self.size(axes),
                              self.index(axes), summed)
        return x if index is None else x[index]

    def _gather_int8(self, w: dict, path: str, index, keep):
        """An int8 weight {"q", "s"} of a TP-split module: both gathered
        whole, then cut to this rank's block on the kept dim (the scale
        has the out features only).  Serving only: int8 weights are not
        trained, and the cut's backward would not sum over TP."""
        n, i = self.size(self.pol.tp_axis), self.index(self.pol.tp_axis)
        out = {}
        for k, leaf in w.items():
            x = self._gather(leaf, f"{path}/{k}", index, None)
            d = keep if k == "q" else (-1 if keep == -1 else None)
            if d is not None:
                size = x.shape[d] // n
                x = x.narrow(d, i * size, size)
            out[k] = x
        return out

    def materialize(self, tree, prefix: str, cfg, index=None):
        """`tree` (a leaf or a dict of them, at `prefix` in the parameter
        tree; with `index`, layer `index` of the stacks) as the model
        computes with it.  Replicated leaves pass as they are; the blocks
        `shard_params` cut are gathered: a module that computes TP-split
        (`_tp_module`) keeps its matmul weights split over TP and comes as
        a `TPLocal`; every other leaf is gathered whole."""
        if not isinstance(tree, dict):
            return self._gather(tree, prefix, index, None)
        tp = self._tp_module(tree, prefix, cfg)
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            keep = _tp_dim(k) if tp is not None else None
            if isinstance(v, dict) and keep is not None:
                out[k] = self._gather_int8(v, path, index, keep)
            elif isinstance(v, dict):
                out[k] = self.materialize(v, path, cfg, index)
            else:
                out[k] = self._gather(v, path, index, keep)
        return TPLocal(out, tp) if tp is not None else out

    def reduce_grads(self, grads):
        """Sum each grad, in place, over the DP dims whose rows it has not
        seen: those that do not shard its leaf (the gathers' backward
        summed over the others).  Nothing when the rows are replicated."""
        if self.rows_split:
            for path, g in tree_leaves_with_path(grads):
                split = self._split_axes(path) if self._sharded(g, path) \
                    else ()
                rest = tuple(a for a in self.pol.dp_axes if a not in split)
                if rest:
                    dist.all_reduce(g, group=self.group(rest))
        return grads

    def full_shape(self, path: str, leaf) -> tuple:
        """The whole shape of a parameter of which `leaf` is this rank's
        block (its own shape when it is not cut)."""
        return self._layout[path][1] if self._sharded(leaf, path) \
            else tuple(leaf.shape)

    def sum_blocks(self, x, path: str, leaf, dims=None):
        """`x`, a sum over dims `dims` (None: all) of this rank's block
        `leaf` of a parameter, summed over the ranks holding the other
        blocks of those dims: the sum over the whole parameter's dims."""
        if not self._sharded(leaf, path):
            return x
        spec = self._layout[path][0]
        dims = range(len(spec)) if dims is None else dims
        used = {a for d in dims if spec[d] is not None
                for a in _names(spec[d])}
        axes = tuple(a for a in self.mesh.mesh_dim_names if a in used)
        if axes:
            x = x.clone()
            dist.all_reduce(x, group=self.group(axes))
        return x

    def global_norm(self, grads) -> torch.Tensor:
        """The whole tree's norm from this rank's blocks: each leaf's sum
        of squares summed over the ranks holding its other blocks (one
        all-reduce for each set of mesh dims), the leaves then added in
        `jax.tree.leaves` order, as `optim.global_norm`."""
        named = tree_leaves_with_path(grads)
        sums = [torch.sum(torch.square(g.float())) for _, g in named]
        by_axes: dict = {}
        for k, (path, g) in enumerate(named):
            if self._sharded(g, path):
                by_axes.setdefault(self._split_axes(path), []).append(k)
        for axes, ks in by_axes.items():
            v = torch.stack([sums[k] for k in ks])
            dist.all_reduce(v, group=self.group(axes))
            for j, k in enumerate(ks):
                sums[k] = v[j]
        return torch.sqrt(sum(sums))

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
            # the rank table is real even under FakeTensorMode (dry-run)
            with unset_fake_temporarily():
                ranks = self.mesh.mesh.permute(*rest, *dims).reshape(
                    -1, self.size(names)).tolist()
            self._groups[names], _ = dist.new_subgroups_by_enumeration(ranks)
        return self._groups[names]

    def dp_group(self):
        """The DP dims' process group, or None when the policy has none."""
        return self.group(self.pol.dp_axes) if self.pol.dp_axes else None

    def divides(self, batch) -> bool:
        """Whether the DP ranks divide the leading dim of every leaf of
        `batch` (0-d leaves aside)."""
        n = self.size(self.pol.dp_axes)
        return all(x.shape[0] % n == 0 for x in tree_leaves(batch) if x.ndim)

    def local_batch(self, batch):
        """This rank's rows of every leaf of `batch`: the leading dim cut
        into one block per DP position, block `index(dp_axes)` (the
        reference's batch sharding).  0-d leaves pass as they are.  A
        batch whose leading dim the DP ranks do not divide is replicated,
        as the reference's `_drop_indivisible` replicates its spec: every
        rank takes the whole batch (compute on it inside `rows`)."""
        n = self.size(self.pol.dp_axes)
        i = self.index(self.pol.dp_axes)
        split = self.divides(batch)

        def one(x):
            if x.ndim == 0 or n == 1 or not split:
                return x
            rows = x.shape[0] // n
            return x[i * rows:(i + 1) * rows]
        return tree_map(one, batch)

    @contextmanager
    def rows(self, batch):
        """Inside the block the model computes on `local_batch(batch)`:
        rows split over DP, or the whole batch on every rank when the DP
        ranks do not divide it, and then the DP reductions (`row_group`,
        `reduce_grads`) do not count the same rows once per rank.  Outside
        it a caller's rows are taken as its own block of a split batch."""
        prev = self.rows_split
        self.rows_split = self.divides(batch)
        try:
            yield
        finally:
            self.rows_split = prev

    def row_group(self):
        """The group over which the rows are split: the DP dims' group, or
        None when there are none or the rows are replicated (`rows`).  The
        sums that make a row-wise value global (the loss's token count and
        ce, the router's statistics and capacity, the grads) run over it."""
        return self.dp_group() if self.rows_split else None

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
