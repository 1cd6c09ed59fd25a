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
the matmuls that carry the FLOPs stay split over TP, Megatron-style,
wherever the reference's policy keeps them split (`tp_plan`):
attention column-parallel on wq/wk/wv (this rank's q heads and the KV
heads they read, shared with other ranks when TP does not divide the KV
heads) and row-parallel on wo; the MLP and the MoE experts over their
d_ff; Mamba2 head-parallel (its heads' z, x and dt columns of the packed
in_proj, the B/C groups they read, its heads' rows of out_proj); the
untied unembedding over the vocab.  A split module's input enters the
TP group (`tp_enter`: the backward all-reduces its grad) and its output
is summed over it (`psum`).  Where a rank needs columns that other
ranks store (a shared KV head, Mamba2's packed segments), an all-to-all
brings them (`_exchange_columns`; the backward sends the grads home and
sums them).  Only a tied embedding and an attention whose q heads TP
does not divide compute whole on every TP rank.  `reduce_grads` then
sums each grad over the DP dims that do not shard its leaf, and
`global_norm` adds the blocks' squares for the optimizer.  `shard_tree`
lays a tree out as DTensors for storage.  Process groups are NCCL's for
a CUDA mesh and gloo's for a CPU mesh, as `init_process_group` made
them.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
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
# a head-parallel Mamba2 block's replicated leaves (the norm's scale among
# them): each rank takes its heads' entries of their last dim
_SSM_LAST = {"conv_w", "conv_b", "dt_bias", "A_log", "D", "scale"}
# (kind, the key that marks a module of that kind, the weights that must
# be stored split over TP for it to compute split)
_TP_KINDS = (("attention", "wq", ("wq", "wo")),
             ("mlp", "w_gate", ("w_gate", "w_up", "w_down")),
             ("ssm", "in_proj", ("out_proj",)),
             ("unembed", "unembed", ("unembed",)))


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


# ---------------------------------------------------------------------------
# what computes split over TP, and each rank's share
# ---------------------------------------------------------------------------


def _groups_read(H: int, G: int, n: int, r: int) -> tuple[int, int]:
    """(first, count) of the G groups (KV heads, or Mamba2's B/C groups)
    that rank r's H/n heads read, head h reading group h // (H/G).
    Raises where a rank's heads would read parts of two groups unequally:
    no layout of whole groups serves them."""
    hl, rep = H // n, H // G
    if hl % rep == 0:
        return r * hl // rep, hl // rep
    if rep % hl == 0:
        return r * hl // rep, 1
    raise ValueError(f"TP {n}: a rank's {hl} of {H} heads read parts of "
                     f"groups of {rep} heads; no split takes that")


def tp_plan(cfg, n: int) -> dict:
    """How the leaves that the reference's policy splits over TP compute
    at a TP size of n, from the config alone: each kind "split" (every TP
    rank computes its share) or "whole" (gathered whole and computed on
    every TP rank).  `MeshContext.materialize` follows it, and
    chip_smoke.py's `duplicate_flops` counts the FLOPs TP duplicates from
    it.
    - "unembed": split (a rank's V/n logits) when the unembedding is a
      leaf of its own and n divides the vocab; whole when it is the tied
      `embed`, on which the reference's spec puts no TP.
    - "attention": split when n divides the q heads: a rank computes its
      H/n q heads and the KV heads they read (its Hkv/n, or where n does
      not divide Hkv the one KV head it shares with other ranks).  Whole
      when n does not divide H: wq's TP blocks then cut q heads apart, so
      no rank holds whole heads, and equal shares of whole heads do not
      exist.
    - "ssm": split when n divides Mamba2's heads: a rank computes its
      heads' z, x and dt columns of in_proj and the B/C groups they read,
      the conv on those channels, the scan on its heads, and its heads'
      rows of out_proj.
    Raises where n divides the heads but a rank's heads would read parts
    of groups (`_groups_read`)."""
    plan = {"unembed": "whole" if cfg.tie_embeddings
            or cfg.vocab_size % n else "split"}
    if cfg.has_attention:
        split = cfg.num_heads % n == 0
        if split:
            _groups_read(cfg.num_heads, cfg.num_kv_heads, n, 0)
        plan["attention"] = "split" if split else "whole"
    if cfg.has_ssm:
        split = cfg.ssm_heads % n == 0
        if split:
            _groups_read(cfg.ssm_heads, cfg.ssm_groups, n, 0)
        plan["ssm"] = "split" if split else "whole"
    return plan


def tp_columns(kind: str, key: str, size: int, cfg, n: int,
               r: int) -> list:
    """Rank r's runs [a, b), ascending, along the TP dim (of whole size
    `size`) of leaf `key` of a module of `kind` that computes split over n
    TP ranks (`tp_plan`): its block r of n, but an attention's wk and wv
    give the columns of the KV heads its q heads read, and a Mamba2
    block's leaves its heads' entries of each packed segment (in_proj: z,
    x, B, C, dt; the conv: x, B, C) with the B/C groups they read."""
    if kind == "attention" and key in ("wk", "wv"):
        hd = cfg.resolved_head_dim
        g0, ng = _groups_read(cfg.num_heads, cfg.num_kv_heads, n, r)
        return [(g0 * hd, (g0 + ng) * hd)]
    if kind == "ssm" and key != "out_proj":
        Din, N, H, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_groups
        hl = H // n
        h0 = r * hl
        g0, ng = _groups_read(H, G, n, r)
        # the conv's channels: its heads' x, then B and C of their groups
        conv = [(h0 * cfg.ssm_head_dim, (h0 + hl) * cfg.ssm_head_dim),
                (Din + g0 * N, Din + (g0 + ng) * N),
                (Din + (G + g0) * N, Din + (G + g0 + ng) * N)]
        if key in ("dt_bias", "A_log", "D"):
            return [(h0, h0 + hl)]
        if key == "scale":
            return conv[:1]
        if key in ("conv_w", "conv_b"):
            return conv
        # in_proj packs z (d_inner wide), the conv's channels, then dt
        dt0 = 2 * Din + 2 * G * N + h0
        return conv[:1] + [(a + Din, b + Din) for a, b in conv] \
            + [(dt0, dt0 + hl)]
    c = size // n
    return [(r * c, (r + 1) * c)]


def _split_dim(kind: str, key: str):
    """The dim a module of `kind` that computes split over TP keeps split
    for its leaf `key` (-1, -2), or None for a leaf it takes whole."""
    return -1 if kind == "ssm" and key in _SSM_LAST else _tp_dim(key)


def _index(runs, device) -> torch.Tensor:
    """The indices of `runs`, in order, as an int64 tensor."""
    parts = [torch.arange(a, b, device=device) for a, b in runs]
    return torch.cat(parts) if parts else \
        torch.empty(0, dtype=torch.long, device=device)


def _clip(runs, lo: int, hi: int) -> list:
    """`runs` cut to [lo, hi)."""
    return [(max(a, lo), min(b, hi)) for a, b in runs
            if max(a, lo) < min(b, hi)]


def _count(runs) -> int:
    return sum(b - a for a, b in runs)


def tp_share(tree: dict, kind: str, cfg, n: int, r: int) -> dict:
    """Rank r's share of a whole module's parameters when the module
    computes split over n TP ranks, cut here, with no process group: the
    tensors `MeshContext.materialize` gives that rank (one layer's; the
    leaves it takes whole pass as they are)."""
    def one(key, v):
        if kind == "ssm" and key == "norm":
            return {k: one(k, x) for k, x in v.items()}
        dim = _split_dim(kind, key)
        if dim is None:
            return v
        return v.index_select(dim % v.ndim, _index(
            tp_columns(kind, key, v.shape[dim], cfg, n, r), v.device))
    return {k: one(k, v) for k, v in tree.items()}


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


class _SumShared(torch.autograd.Function):
    """all_reduce(sum) whose backward all-reduces the gradient as well: a
    sum each rank then uses on its own share of the work (the gated
    norm's mean square over Mamba2's heads split over TP), so that each
    rank's grad of it holds only its share's part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, which each then uses on
    its own share of the work; the gradient is summed over them too."""
    return _SumShared.apply(x, group)


class _TakeOfReplicated(torch.autograd.Function):
    """Entries `idx` of dim `dim` of a tensor every rank of `group` holds
    whole; the backward adds their grads into the whole tensor's and sums
    that over the group (the ranks' entries may overlap), so every rank
    has the whole tensor's grad."""

    @staticmethod
    def forward(ctx, x, dim, idx, group):
        ctx.args = (dim, idx, group, x.shape)
        return x.index_select(dim, idx)

    @staticmethod
    def backward(ctx, grad):
        dim, idx, group, shape = ctx.args
        g = grad.new_zeros(shape).index_add_(dim, idx, grad)
        dist.all_reduce(g, group=group)
        return g, None, None, None


def tp_take(x: torch.Tensor, dim: int, idx: torch.Tensor,
            group) -> torch.Tensor:
    """Entries `idx` of `dim` of a tensor replicated over `group`, its
    grad made whole again over the group."""
    return _TakeOfReplicated.apply(x, dim % x.ndim, idx, group)


def tp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of `dim` all-gathered over `group` (the TP
    group, whose ranks then compute the same on the whole): the backward
    keeps this rank's block of the grad."""
    return _Gather.apply(x, dim % x.ndim, group, dist.get_world_size(group),
                         dist.get_rank(group), False)


def _exchange_columns(x: torch.Tensor, dim: int, runs_of, group, n: int,
                      i: int) -> torch.Tensor:
    """Rank i's runs `runs_of(i)` of dim `dim` of a leaf stored in n equal
    blocks over `group`, x being block i: every rank sends each other the
    entries of its block that the other's runs hold (one all-to-all), in
    ascending order.  The backward sends the grads back to the blocks
    they came from, summed where the runs of several ranks overlap (a KV
    head or a B/C group that ranks share)."""
    c = x.shape[dim]
    lo, hi = i * c, (i + 1) * c
    send, in_splits = [], []
    for r in range(n):
        cut = _clip(runs_of(r), lo, hi)
        send += [(a - lo, b - lo) for a, b in cut]
        in_splits.append(_count(cut))
    mine = runs_of(i)
    out_splits = [_count(_clip(mine, o * c, (o + 1) * c)) for o in range(n)]
    xt = x.movedim(dim, 0).index_select(0, _index(send, x.device))
    y = fc.wait_tensor(fc.all_to_all_single_autograd(
        xt.contiguous(), out_splits, in_splits, group))
    return y.movedim(0, dim)


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
        """This rank's block of a whole cache: its rows of the batch (all
        of them when the DP ranks do not divide it; `cache_sharding`'s DP
        entry) and, over TP, what the modules that compute split
        (`tp_plan`) read and write on this rank: the KV heads its q heads
        read, the SSM state's heads (both `cache_sharding`'s block where
        TP divides the heads), and the conv window's channels of its
        heads and their B/C groups.  Where TP does not divide the KV heads
        the reference's spec replicates them over TP and this rank keeps
        the one it reads; the reference's spec names the conv window's
        taps, which no TP size of the configs divides, so it replicates
        the window.  A module that computes whole keeps its whole cache."""
        cfg, tp = self.cfg, self.pol.tp_axis
        n, r = self.size(tp), self.index(tp)
        plan = tp_plan(cfg, n)

        def heads(path):
            """(dim, runs) of this rank's part over TP, or None."""
            if path in ("k", "v") and plan.get("attention") == "split":
                g0, ng = _groups_read(cfg.num_heads, cfg.num_kv_heads, n, r)
                return 2, [(g0, g0 + ng)]
            if path.startswith("ssm/") and plan.get("ssm") == "split":
                key = "dt_bias" if path == "ssm/state" else "conv_b"
                return (2 if key == "dt_bias" else 3), tp_columns(
                    "ssm", key, 0, cfg, n, r)
            return None

        def one(path, leaf):
            spec = self._cache_spec(leaf)[:2]
            spec += (None,) * (leaf.ndim - len(spec))
            x = self.block(leaf, _drop_indivisible(spec, leaf, self.mesh))
            part = heads(path) if n > 1 else None
            if part is not None:
                return x.index_select(part[0], _index(part[1], x.device))
            return x.clone()
        return tree_map_with_path(one, cache)

    def _split_axes(self, path: str) -> tuple:
        """The mesh dims a stored leaf is split over, in mesh order."""
        spec = self._layout.get(path, ((),))[0]
        used = {a for e in spec if e is not None for a in _names(e)}
        return tuple(a for a in self.mesh.mesh_dim_names if a in used)

    def _sharded(self, leaf, path: str) -> bool:
        entry = self._layout.get(path)
        return entry is not None and tuple(leaf.shape) != entry[1]

    def _tp_kind(self, node: dict, prefix: str, cfg):
        """The kind of the module `node` ("attention", "mlp", "ssm" or
        "unembed") when it computes split over TP, else None.  It does
        when `tp_plan` splits its kind (the MLP and the experts: when
        their d_ff is stored split) and its anchor weights are cut blocks
        (`shard_params`): dense ones stored split over TP on the dim the
        module keeps split, int8 ones gathered whole and cut there
        (`_gather_int8`).  A replicated tree computes whole."""
        n = self.size(self.pol.tp_axis)
        if n == 1:
            return None
        for kind, found, anchors in _TP_KINDS:
            if found in node:
                break
        else:
            return None
        if kind != "mlp" and tp_plan(cfg, n)[kind] != "split":
            return None
        for k in anchors:
            path = f"{prefix}/{k}" if prefix else k
            leaf = node.get(k)
            if isinstance(leaf, dict):                  # int8 {"q", "s"}
                q = leaf.get("q")
                if q is None or not self._sharded(q, f"{path}/q") \
                        or (kind == "mlp" and q.shape[_tp_dim(k)] % n):
                    return None
            elif not isinstance(leaf, torch.Tensor) \
                    or not self._sharded(leaf, path) \
                    or self._layout[path][0][_tp_dim(k)] != self.pol.tp_axis:
                return None
        return kind

    def _gather(self, leaf, path: str, index, keep, take=None):
        """One leaf as the model computes with it: every split dim but
        `keep` all-gathered; layer `index` of a stack.  `take`, when
        given, first maps this rank's block of a leaf stored split on the
        dim `keep` to the entries of that dim this rank computes with."""
        if not self._sharded(leaf, path):
            return leaf if index is None else leaf[index]
        spec = self._layout[path][0]
        if index is not None and spec[0] is None:
            leaf, spec, index = leaf[index], spec[1:], None
        x = leaf if take is None else take(leaf)
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

    def _gather_int8(self, w: dict, path: str, index, dim: int, cols):
        """An int8 weight {"q", "s"} of a TP-split module: both gathered
        whole, then cut to this rank's runs `cols(size)` of the split dim
        (the scale has the out features only).  Serving only: int8
        weights are not trained, and the cut's backward would not sum
        over TP."""
        out = {}
        for k, leaf in w.items():
            x = self._gather(leaf, f"{path}/{k}", index, None)
            d = dim if k == "q" else (-1 if dim == -1 else None)
            if d is not None:
                x = x.index_select(d % x.ndim,
                                   _index(cols(x.shape[d]), x.device))
            out[k] = x
        return out

    def _tp_leaf(self, v, path: str, index, kind: str, key: str, cfg):
        """Leaf `key` of a module of `kind` that computes split over TP,
        as this rank computes with it (`tp_columns` on the dim
        `_split_dim` names): its stored TP block with the other split
        dims gathered; the entries other ranks store, exchanged
        (`_exchange_columns`); or, for a leaf replicated over TP, its
        entries taken (`tp_take`).  Leaves the module takes whole, and a
        nested module (the experts' shared MLP), go to `materialize`."""
        if kind == "ssm" and key == "norm":
            return {k: self._tp_leaf(x, f"{path}/{k}", index, kind, k, cfg)
                    for k, x in v.items()}
        dim = _split_dim(kind, key)
        if dim is None:
            return self.materialize(v, path, cfg, index)
        tp = self.pol.tp_axis
        n, i, group = self.size(tp), self.index(tp), self.group(tp)

        def cols(size, r=i):
            return tp_columns(kind, key, size, cfg, n, r)
        if isinstance(v, dict):                         # int8 {"q", "s"}
            return self._gather_int8(v, path, index, dim, cols)
        if self._sharded(v, path) and self._layout[path][0][dim] == tp:
            size = self._layout[path][1][dim]
            c, take = size // n, None
            if cols(size) != [(i * c, (i + 1) * c)]:
                def take(x):
                    return _exchange_columns(
                        x, dim, lambda r: cols(size, r), group, n, i)
            return self._gather(v, path, index, dim, take)
        x = self._gather(v, path, index, None)
        return tp_take(x, dim, _index(cols(x.shape[dim]), x.device), group)

    def materialize(self, tree, prefix: str, cfg, index=None):
        """`tree` (a leaf or a dict of them, at `prefix` in the parameter
        tree; with `index`, layer `index` of the stacks) as the model
        computes with it.  Replicated leaves pass as they are; the blocks
        `shard_params` cut are gathered: a module that computes split
        over TP (`_tp_kind`) comes as a `TPLocal` of this rank's share
        (`_tp_leaf`); every other leaf is gathered whole."""
        if not isinstance(tree, dict):
            return self._gather(tree, prefix, index, None)
        kind = self._tp_kind(tree, prefix, cfg)
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out[k] = self.materialize(v, path, cfg, index) if kind is None \
                else self._tp_leaf(v, path, index, kind, k, cfg)
        return TPLocal(out, self.group(self.pol.tp_axis)) \
            if kind is not None else out

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
