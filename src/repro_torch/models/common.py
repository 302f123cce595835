"""Parameter descriptors, the model-parallel context, and shared layer
math (counterpart of ``repro.models.common``).

Every model builds a tree of :class:`ParamDesc` (shape, dtype, init
recipe and the reference's logical axes).  The same tree serves:

* :func:`materialize`      -> real parameters (under a model mesh: this
                              rank's shard of each leaf);
* :func:`abstract`         -> ``meta`` tensors (no allocation);
* :func:`partition_specs`  -> per-dimension mesh axes via the active
                              :class:`MeshAxes`, the reference's
                              ``PartitionSpec`` entries.

The reference states shardings and lets GSPMD place the collectives.  The
port places them by hand, Megatron-style, on the model axis of a
``launch.mesh.Mesh`` (:func:`model_mesh`): q / k / v and the MLP's gate /
up projections are column-parallel (:func:`column_parallel`; other
entries into a split region pass :func:`copy_to_model`: identity
forward, all-reduce of the gradient), ``wo`` and the MLP's down
projection row-parallel (:func:`row_parallel`: fp32 partials, one
all-reduce, one cast; :func:`column_parallel` forms the column-parallel
products' input gradients so too), the vocabulary split over the
embedding (a masked lookup and an all-reduce) and the logits
(:func:`masked_ce` with all-reduced max and sum of exponentials).  :meth:`MeshAxes.logical_to_spec`
is the one source both for slicing a leaf (:func:`shard_slice`) and for
where those collectives go.  With no multi-rank model axis the same code
runs the padded model whole on one device under
:func:`mesh_axes_scope`, as the reference does.

Logical axis names (the reference's):
  "embed"   d_model            (replicated)
  "heads"   attention heads    -> "model"
  "kv"      kv heads           -> "model" only when divisible
  "ff"      mlp hidden         -> "model"
  "vocab"   vocabulary         -> "model"
  "expert"  MoE experts        -> "model" when E % par == 0
  "ff_inner" expert ff         -> "model" when the experts cannot split
  "layers"  stacked layers     (never split)
  "batch"   a cache's rows     -> the data axes (batch > 1)
  "seq_*"   a long cache span  -> the data axes, the model axis or both

A decode cache's descs carry the last two, so :func:`materialize` gives
this rank's shard of a cache too, and :func:`batch_block` /
:func:`gather_batch` cut and join its rows.

The reference's two other layouts: ``MeshAxes.seq_par`` holds the
residual stream as each rank's block of the sequence between the split
sub-blocks (:class:`seq_parallel`: :func:`gather_seq` at each entry,
:func:`exit_sum`'s reduce-scatter at each exit, the gradients of the
region between them summed by the entry's reduce-scatter), and
``MeshAxes.expert_fsdp`` lays the MoE tables over the data axes too
(``"ff_inner"`` / ``"expert_embed"``; :func:`shard_slice` cuts them,
:func:`fsdp_gather` gathers each for its use and reduce-scatters its
gradient).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_structure, tree_unflatten

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# The model-parallel context.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Maps logical axes to mesh axis names (the reference's fields)."""
    data: tuple[str, ...] = ("data",)      # worker / data-parallel axes
    model: str = "model"
    model_par: int = 1                      # size of the model axis
    shard_kv: bool = True                   # kv heads divisible by model_par
    shard_expert: bool = True               # experts divisible by model_par
    expert_fsdp: bool = False               # ZeRO-3 experts over data axes
    seq_par: bool = False                   # sequence-parallel residual stream
    workers_on_data: bool = False           # activation specs omit the data axes
    pad_kv_to_mesh: bool = False            # pad kv heads to the mesh

    def logical_to_spec(self, axes: tuple[Optional[str], ...]) -> tuple:
        """Per-dimension mesh axes of a leaf with logical ``axes``: a tuple
        of None / an axis name / a tuple of names, trailing Nones dropped,
        equal to the entries of the reference's ``PartitionSpec``."""
        # PartitionSpec writes a one-axis tuple as the axis name.
        data = self.data[0] if len(self.data) == 1 else tuple(self.data)
        parts: list = []
        for ax in axes:
            if ax in ("heads", "ff", "vocab"):
                parts.append(self.model)
            elif ax == "kv":
                parts.append(self.model if self.shard_kv else None)
            elif ax == "expert":
                parts.append(self.model if self.shard_expert else None)
            elif ax == "ff_inner":
                if self.shard_expert:
                    parts.append(data if self.expert_fsdp else None)
                else:
                    parts.append(self.model)
            elif ax == "expert_embed":
                parts.append(data if self.expert_fsdp and not self.shard_expert
                             else None)
            elif ax == "ff_act":
                parts.append(None if self.shard_expert else self.model)
            elif ax in ("batch", "seq_shard"):
                parts.append(None if self.workers_on_data else data)
            elif ax == "seq_model":
                parts.append(self.model)
            elif ax == "seq_both":
                parts.append(self.model if self.workers_on_data
                             else tuple(self.data) + (self.model,))
            else:
                parts.append(None)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)


_CTX: list = [None]


def set_mesh_axes(axes: Optional[MeshAxes]) -> None:
    _CTX[0] = axes


def get_mesh_axes() -> Optional[MeshAxes]:
    return _CTX[0]


class mesh_axes_scope:
    """Make ``axes`` the active :class:`MeshAxes` inside the scope."""

    def __init__(self, axes: Optional[MeshAxes]):
        self.axes = axes

    def __enter__(self):
        self.prev = _CTX[0]
        _CTX[0] = self.axes
        return self.axes

    def __exit__(self, *exc):
        _CTX[0] = self.prev
        return False


def model_mesh():
    """The ``launch.mesh.Mesh`` whose model axis this process's layers are
    split over, or None: the padded model runs whole.  Split when a
    :class:`MeshAxes` with ``model_par > 1`` is active and the active mesh
    (``launch.mesh.use_mesh``) has its model axis; that axis must then
    hold ``model_par`` ranks."""
    axes = get_mesh_axes()
    if axes is None or axes.model_par <= 1:
        return None
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or axes.model not in mesh.axis_names:
        return None
    if mesh.size(axes.model) != axes.model_par:
        raise ValueError(f"MeshAxes.model_par={axes.model_par} but the mesh's "
                         f"{axes.model!r} axis holds "
                         f"{mesh.size(axes.model)} ranks")
    return mesh


def constrain(x: Tensor, *logical: Optional[str],
              full: Optional[tuple] = None) -> Tensor:
    """The reference's sharding constraint.  Nothing moves here: on a model
    mesh ``x`` is already this rank's block, and with ``full`` (the
    unsplit shape) its shape is checked against the shard's."""
    mesh = model_mesh()
    if mesh is None or full is None:
        return x
    axes = get_mesh_axes()
    spec = axes.logical_to_spec(tuple(logical))
    want = tuple(n // axes.model_par if i < len(spec) and spec[i] == axes.model
                 else n for i, n in enumerate(full))
    if tuple(x.shape) != want:
        raise ValueError(f"constrain{logical}: shard shape {tuple(x.shape)}, "
                         f"expected {want} of {tuple(full)}")
    return x


# ---------------------------------------------------------------------------
# Collectives on the model axis (autograd-aware).
# ---------------------------------------------------------------------------

def _model_all_reduce(t: Tensor, op: str = "sum") -> Tensor:
    """fp32 all-reduce over the model axis (a ``mesh.all_reduce`` entry in
    ``collective_log``), cast back to ``t``'s dtype."""
    mesh = model_mesh()
    buf = t.detach().float().contiguous().clone()
    mesh.all_reduce(buf, get_mesh_axes().model, op, record=False)
    return buf.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.partial = seq_split()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g if ctx.partial else _model_all_reduce(g)


class _SumGrads(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis (fp32,
    cast once), whatever the mode."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g)


class _FirstRankGrad(torch.autograd.Function):
    """Identity forward; the gradient kept on model rank 0, zero on the
    others."""

    @staticmethod
    def forward(ctx, x):
        ctx.first = model_mesh().index(get_mesh_axes().model) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g if ctx.first else torch.zeros_like(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _model_all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    """(..., w) blocks -> (..., k w) in model-rank order; the gradient of
    a replicated consumer is sliced back."""

    @staticmethod
    def forward(ctx, x):
        mesh, axes = model_mesh(), get_mesh_axes()
        ctx.k, ctx.j, ctx.w = axes.model_par, mesh.index(axes.model), x.shape[-1]
        ctx.partial = seq_split()
        rows = x.detach().reshape(-1, ctx.w).mT.float().contiguous()
        full = mesh.all_gather(rows, axes.model, record=False)  # (k w, L)
        return full.mT.reshape(x.shape[:-1] + (ctx.k * ctx.w,)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:         # each rank's gradient is a part: sum them
            g = _model_all_reduce(g)
        return g[..., ctx.j * ctx.w:(ctx.j + 1) * ctx.w].contiguous()


class _AllGatherModel(torch.autograd.Function):
    """(..., w) blocks -> (..., k w) in model-rank order, for consumers
    that differ by rank: the whole gradient is summed over the model axis
    (fp32, cast once) and this rank's block kept, a reduce-scatter."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return _GatherFromModel.forward(ctx, x)

    @staticmethod
    def backward(ctx, g):
        full = _model_all_reduce(g.float())
        return full[..., ctx.j * ctx.w:(ctx.j + 1) * ctx.w].to(
            ctx.dtype).contiguous()


class _SumOverModel(torch.autograd.Function):
    """fp32 sum over the model axis of a partial that every rank then
    reads for its own block: the gradient is summed too."""

    @staticmethod
    def forward(ctx, x):
        return _model_all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g)


class _ColumnParallel(torch.autograd.Function):
    """``x @ w`` with ``w`` this rank's column block: each output is its
    full contraction, as on one device; the input's gradient, a sum over
    the column blocks, is formed from fp32 partials all-reduced and cast
    once, so it rounds where one device's product rounds."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        ctx.partial = seq_split()
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g.float() @ w.float().mT
        if not ctx.partial:
            gx = _model_all_reduce(gx)
        gx = gx.to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
        return gx, gw


class _SeqEntries:
    """The column-parallel entries that read one gathered sequence
    (:func:`gather_seq`): their input gradients' fp32 partials, summed as
    their backwards run, and how many of those are still to run."""

    def __init__(self):
        self.pending = 0
        self.acc: Optional[Tensor] = None


class _ColumnParallelSeq(torch.autograd.Function):
    """:class:`_ColumnParallel` reading the gathered sequence ``xg`` of
    this rank's block ``blk``: the fp32 partials of the input gradients of
    every such entry of ``xg`` (``entries``) are summed, and the last
    entry's backward reduce-scatters the sum straight to the block, cast
    once (the others add exact zeros): one collective a sub-block, and no
    bf16 partial rounded before the ranks' sum, where it could cancel."""

    @staticmethod
    def forward(ctx, blk, xg, w, entries):
        ctx.save_for_backward(xg, w)
        ctx.entries, ctx.dtype, ctx.shape = entries, blk.dtype, blk.shape
        entries.pending += 1
        return xg.to(w.dtype) @ w

    @staticmethod
    def backward(ctx, g):
        xg, w = ctx.saved_tensors
        sh = ctx.entries
        part = g.float() @ w.float().mT
        sh.acc = part if sh.acc is None else sh.acc + part
        sh.pending -= 1
        if sh.pending == 0:
            gx = _seq_reduce_scatter(sh.acc).to(ctx.dtype)
            sh.acc = None
        else:
            gx = torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)
        x = xg.to(w.dtype)
        gw = x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
        return gx, None, gw, None


def column_parallel(x: Tensor, w: Tensor) -> Tensor:
    """Enter a model-split region through a column-parallel product
    (q / k / v, the MLP's gate and up, the vocabulary head, a split
    router); ``x @ w`` whole on one device.  Under :func:`seq_split`, on
    the gathered sequence itself, the entries of one sub-block
    reduce-scatter their input gradients' fp32 sum once
    (:class:`_ColumnParallelSeq`)."""
    if model_mesh() is None:
        return x @ w
    blk = getattr(x, "_seq_block", None)
    if blk is not None and seq_split():
        return _ColumnParallelSeq.apply(blk, x.detach(), w, x._seq_entries)
    return _ColumnParallel.apply(x, w)


def copy_to_model(x: Tensor) -> Tensor:
    """Enter a model-split region: identity forward, gradient all-reduced
    over the model axis (each rank's branch holds a part of it)."""
    return _CopyToModel.apply(x) if model_mesh() is not None else x


def reduce_from_model(x: Tensor) -> Tensor:
    """Leave a model-split region: partials summed in fp32 over the model
    axis, forward; the replicated gradient passes through."""
    return _ReduceFromModel.apply(x) if model_mesh() is not None else x


def gather_from_model(x: Tensor) -> Tensor:
    """Concatenate the ranks' last-dimension blocks (router logits, a
    forward's logits)."""
    return _GatherFromModel.apply(x) if model_mesh() is not None else x


def all_gather_model(x: Tensor) -> Tensor:
    """The whole last dimension from the ranks' blocks, for a region whose
    ranks each read another part of it (the Mamba2 projection, its conv
    weights): the gradient is summed over the model axis and cut back to
    this rank's block.  ``x`` itself on one device."""
    return _AllGatherModel.apply(x) if model_mesh() is not None else x


def replicated_rows(leaf: Tensor, lo: int, hi: int) -> Tensor:
    """Rows [lo, hi) of a leaf that every rank holds whole but reads only
    in part (rwkv6's ``u``, Mamba2's ``a_log`` / ``dt_bias`` / ``d_skip``,
    per head): entered through :func:`copy_to_model`, so each rank's
    gradient of the leaf is the whole leaf's, every rank's rows summed."""
    return copy_to_model(leaf)[lo:hi]


def row_parallel(h: Tensor, w: Tensor, dtype: torch.dtype) -> Tensor:
    """``h @ w`` with the contraction split over the model axis: the fp32
    partial product of this rank's rows summed over the axis
    (:func:`exit_sum`: all-reduced, or under :func:`seq_split`
    reduce-scattered to this rank's sequence block), cast once to
    ``dtype`` (a bf16 layer rounds where one device rounds).  Whole on
    one device."""
    if model_mesh() is None:
        return h @ w
    return exit_sum(h.float() @ w.float(), dtype)


def exit_sum(part: Tensor, dtype: torch.dtype) -> Tensor:
    """Leave a model-split region: the ranks' partial sums ``part`` (B, S,
    ...) summed over the model axis in fp32 and cast once to ``dtype``:
    all-reduced, or under :func:`seq_split` reduce-scattered over the
    sequence (dim 1), each rank keeping its block.  ``part`` itself, cast,
    off a model mesh."""
    if seq_split():
        return _ScatterSeqSum.apply(part, dtype)
    return reduce_from_model(part).to(dtype)


def reduce_grads(leaf: Tensor) -> Tensor:
    """A parameter leaf read whole on every rank, its gradient summed over
    the model axis (fp32, cast once): under :func:`seq_split` every such
    leaf's gradient on a rank is a part (its sequence block's, or its
    share of a replicated region's), ``DecoderLM`` reads each once through
    this.  ``leaf`` itself off a model mesh."""
    return _SumGrads.apply(leaf) if model_mesh() is not None else leaf


def first_rank_grad(x: Tensor) -> Tensor:
    """A replicated value computed inside a split sequence region and read
    by the replicated loss (the MoE's aux): its gradient enters the region
    on model rank 0 alone, so the ranks' parts sum to it once.  ``x``
    itself outside :func:`seq_split`."""
    return _FirstRankGrad.apply(x) if seq_split() else x


# ---------------------------------------------------------------------------
# Sequence parallelism (``MeshAxes.seq_par``).
# ---------------------------------------------------------------------------

_SEQ: list = [False]


class seq_parallel:
    """Inside the scope (with ``on``), model code on a model mesh holds
    the residual stream as this rank's block of the sequence
    (:func:`seq_split`): each split sub-block enters through
    :func:`gather_seq` and leaves through :func:`exit_sum`'s
    reduce-scatter (Megatron-style sequence parallelism).  Between the two
    a replicated tensor's gradient on a rank is a PART of the whole, the
    parts summed by :func:`gather_seq`'s backward: the entry products
    (:func:`column_parallel`, :func:`copy_to_model`) do not all-reduce the
    input's gradient, :func:`gather_from_model` sums its gradient before
    it slices, and the leaves read whole take :func:`reduce_grads`.  Each
    operator reads the mode when it runs forward; a recomputed region
    (``torch.utils.checkpoint``) re-enters the scope through its
    ``context_fn``."""

    def __init__(self, on: bool = True):
        self.on = bool(on)

    def __enter__(self):
        self.prev = _SEQ[0]
        _SEQ[0] = self.on
        return self

    def __exit__(self, *exc):
        _SEQ[0] = self.prev
        return False


def seq_split() -> bool:
    """True inside :class:`seq_parallel` on a model mesh."""
    return _SEQ[0] and model_mesh() is not None


def _seq_all_gather(x: Tensor) -> Tensor:
    """(B, s, ...) blocks -> the (B, k s, ...) sequence in model-rank
    order, in fp32."""
    mesh, axes = model_mesh(), get_mesh_axes()
    rows = x.detach().movedim(1, 0).float().contiguous()
    return mesh.all_gather(rows, axes.model, record=False).movedim(0, 1)


def _seq_reduce_scatter(x: Tensor) -> Tensor:
    """(B, S, ...) partial sums -> this rank's (B, S / k, ...) block of
    their fp32 sum over the model axis."""
    mesh, axes = model_mesh(), get_mesh_axes()
    rows = x.detach().movedim(1, 0).float().contiguous()
    return mesh.reduce_scatter(rows, axes.model, record=False).movedim(0, 1)


class _GatherSeq(torch.autograd.Function):
    """Forward: the whole sequence from the ranks' blocks (all-gather);
    backward: the ranks' partial gradients summed in fp32 and cut back to
    this rank's block (reduce-scatter), cast once."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return _seq_all_gather(x).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _seq_reduce_scatter(g).to(ctx.dtype)


class _ScatterSeqSum(torch.autograd.Function):
    """Forward: partial sums reduce-scattered over the sequence in fp32,
    cast once to ``dtype``; backward: the blocks' gradients all-gathered
    (every rank's partial reads the whole)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = x.dtype
        return _seq_reduce_scatter(x).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return _seq_all_gather(g).to(ctx.dtype), None


def gather_seq(x: Tensor) -> Tensor:
    """Enter a split sub-block under :func:`seq_split`: this rank's (B, S
    / k, ...) block of the residual stream -> the whole (B, S, ...)
    sequence (backward: a reduce-scatter of the parts).  The result
    remembers the block, for :func:`column_parallel`.  ``x`` itself
    otherwise."""
    if not seq_split():
        return x
    out = _GatherSeq.apply(x)
    out._seq_block, out._seq_entries = x, _SeqEntries()
    return out


def seq_rows(x: Tensor) -> Tensor:
    """This rank's block of the sequence (dim 1) of a tensor computed
    whole on every rank (rwkv6's channel-mix gate) under
    :func:`seq_split`; ``x`` itself otherwise."""
    if not seq_split():
        return x
    w = x.shape[1] // get_mesh_axes().model_par
    j = model_mesh().index(get_mesh_axes().model)
    return x[:, j * w:(j + 1) * w]


# ---------------------------------------------------------------------------
# Expert FSDP (``MeshAxes.expert_fsdp``): tables split over the data axes.
# ---------------------------------------------------------------------------

def _reduce_scatter_dim(t: Tensor, dim: int, part, mesh) -> Tensor:
    """:func:`gather_dim`'s inverse for a gradient: dimension ``dim`` of
    the fp32 ``t`` summed over the axes of the spec entry ``part`` and cut
    to this rank's block, over each axis in turn, the slowest first (the
    row-major layout of :func:`shard_slice`)."""
    rows = t.movedim(dim, 0).float().contiguous()
    for name in spec_axes(part):
        if mesh.size(name) > 1:
            rows = mesh.reduce_scatter(rows, name, record=False)
    return rows.movedim(0, dim)


def _gather_bits(t: Tensor, dim: int, part, mesh) -> Tensor:
    """:func:`gather_dim` in ``t``'s own dtype: a gather only moves bits,
    so bf16 travels as its 16 bits (viewed as float16, which every
    transport carries), at half the fp32 staging's bytes."""
    wire = t.view(torch.float16) if t.dtype == torch.bfloat16 else t
    for name in reversed(spec_axes(part)):
        if mesh.size(name) > 1:
            wire = mesh.all_gather(wire.movedim(dim, 0).contiguous(), name,
                                   record=False).movedim(0, dim)
    return wire.view(t.dtype)


class _GatherData(torch.autograd.Function):
    """Forward: dimension ``dim`` of a leaf's shard all-gathered over the
    data axes of ``part``, in its own dtype; backward: the gradient
    reduce-scattered over them in fp32 (the data ranks' workers summed),
    cast once."""

    @staticmethod
    def forward(ctx, t, dim, part):
        ctx.dim, ctx.part, ctx.dtype = dim, part, t.dtype
        return _gather_bits(t.detach(), dim, part, model_mesh())

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter_dim(g, ctx.dim, ctx.part,
                                    model_mesh()).to(ctx.dtype), None, None)


def fsdp_gather(t: Tensor, logical: tuple) -> Tensor:
    """A leaf (one layer's view) with logical axes ``logical``, whole
    along the dimensions expert FSDP splits over the data axes: each
    all-gathered just before its use (:class:`_GatherData`; the gradient
    reduce-scattered back, so a rank's gradient of its shard sums every
    data rank's worker).  ``t`` itself without ``expert_fsdp`` on a model
    mesh."""
    mesh, axes = model_mesh(), get_mesh_axes()
    if mesh is None or not axes.expert_fsdp:
        return t
    data = set(axes.data)
    for i, part in enumerate(axes.logical_to_spec(tuple(logical))):
        names = spec_axes(part)
        if names and set(names) <= data and mesh.size(names) > 1:
            t = _GatherData.apply(t, i, part)
    return t


def model_block(n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's block of an ``n``-long model-split
    dimension ((0, n) when the model runs whole)."""
    mesh = model_mesh()
    if mesh is None:
        return 0, n
    axes = get_mesh_axes()
    k, j = axes.model_par, mesh.index(axes.model)
    if n % k:
        raise ValueError(f"a dimension of {n} does not split over "
                         f"{k} model ranks")
    return j * (n // k), (j + 1) * (n // k)


# ---------------------------------------------------------------------------
# Parameter descriptors.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # stddev multiplier (normal) / value (ones)
    axes: tuple = ()              # the reference's logical axes, per dim

    def __post_init__(self):
        assert len(self.axes) in (0, len(self.shape)), (self.shape, self.axes)


def _is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def leaf_spec(d: ParamDesc, axes: Optional[MeshAxes] = None) -> tuple:
    """One leaf's spec under ``axes`` (default: the active scope)."""
    axes = axes or get_mesh_axes()
    return axes.logical_to_spec(d.axes) if d.axes else ()


def abstract(tree) -> Any:
    """ParamDesc tree -> ``meta`` tensors of the full shapes (no
    allocation; the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), tree)


def partition_specs(tree) -> Any:
    """ParamDesc tree -> per-leaf spec tuples via the active scope."""
    axes = get_mesh_axes()
    assert axes is not None, "partition_specs requires a mesh-axes scope"
    return tree_map(lambda d: leaf_spec(d, axes), tree)


def leaf_specs(tree) -> tuple:
    """Every leaf's spec under the active scope, in leaf order (the
    trainer's ``TrainerConfig.param_specs``)."""
    axes = get_mesh_axes()
    assert axes is not None, "leaf_specs requires a mesh-axes scope"
    return tuple(leaf_spec(d, axes) for d in tree_leaves(tree))


def spec_axes(part) -> tuple:
    """A spec entry as a tuple of mesh axis names (() for None)."""
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


def shard_slice(d: ParamDesc, axes: Optional[MeshAxes], mesh) -> tuple:
    """The index (a tuple of slices) of this rank's block of leaf ``d``:
    every dimension whose spec names mesh axes is cut to this rank's block
    of it (it must divide).  A dimension over several axes (a cache's
    ``"seq_both"``: the data axes, then the model axis) is cut row-major
    over them, the first the slowest, as a ``PartitionSpec`` lays it out.
    Data-axis entries are a decode cache's batch and sequence, and under
    ``expert_fsdp`` an expert table's ``ff_inner`` or ``expert_embed``
    (over ``("pod", "data")`` on the multi-pod mesh, row-major)."""
    idx = [slice(None)] * len(d.shape)
    if axes is None or mesh is None or axes.model_par <= 1 \
            or axes.model not in mesh.axis_names:
        return tuple(idx)
    for i, part in enumerate(leaf_spec(d, axes)):
        names = spec_axes(part)
        if not names:
            continue
        k, j = mesh.size(names), mesh.index(names)
        if d.shape[i] % k:
            raise ValueError(f"leaf {d.shape} {d.axes}: dimension {i} "
                             f"({d.shape[i]}) does not split over {k} ranks")
        w = d.shape[i] // k
        idx[i] = slice(j * w, (j + 1) * w)
    return tuple(idx)


def gather_dim(t: Tensor, dim: int, part, mesh) -> Tensor:
    """The whole of dimension ``dim`` of ``t`` from every rank's block of
    it, split over the spec entry ``part`` (:func:`shard_slice`'s layout):
    all-gathered over each of its axes, the fastest first, in fp32
    (integers as they are)."""
    for name in reversed(spec_axes(part)):
        if mesh.size(name) == 1:
            continue
        rows = t.movedim(dim, 0)
        if rows.is_floating_point():
            rows = rows.float()
        t = mesh.all_gather(rows.contiguous(), name,
                            record=False).movedim(0, dim)
    return t


def _batch_part():
    """The spec entry of a cache's ``"batch"`` dimension."""
    spec = get_mesh_axes().logical_to_spec(("batch",))
    return spec[0] if spec else None


def batch_block(n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's rows of an ``n``-row decode batch: a
    cache's ``"batch"`` dimension lies over the data axes when n > 1
    (:func:`shard_slice`); (0, n) off a model mesh and for one row."""
    mesh = model_mesh()
    if mesh is None or n == 1:
        return 0, n
    names = spec_axes(_batch_part())
    k, j = mesh.size(names), mesh.index(names)
    if n % k:
        raise ValueError(f"a batch of {n} rows does not split over {k} "
                         "data ranks")
    return j * (n // k), (j + 1) * (n // k)


def gather_batch(t: Tensor, n: int) -> Tensor:
    """The whole ``n``-row batch from every data rank's rows (dimension 0
    of ``t``, :func:`batch_block`'s layout); ``t`` itself where the batch
    does not split."""
    mesh = model_mesh()
    if mesh is None or n == 1:
        return t
    return gather_dim(t, 0, _batch_part(), mesh)


def materialize(tree, seed: int, device: torch.device):
    """Initialize a ParamDesc tree from one seeded ``torch.Generator``,
    leaves in jax's order, with the reference's stds (``scale /
    sqrt(fan_in)``, fan_in = shape[-2] for a >=2-D "normal" leaf, else
    shape[-1]) and constants (a "ones" leaf holds ``scale``).  The numbers
    differ from the reference's threefry draws; tests carry the
    reference's parameters across with ``interop``.  On a model mesh
    (:func:`model_mesh`) each drawn leaf is drawn whole, so every rank
    draws the same numbers, and this rank's block (:func:`shard_slice`) is
    kept; a constant leaf (a decode cache's zeros) is made at its block's
    shape."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mesh, axes = model_mesh(), get_mesh_axes()

    def init_one(d: ParamDesc) -> Tensor:
        if d.init in ("zeros", "ones"):
            shape = d.shape if mesh is None else tuple(
                len(range(*s.indices(n)))
                for s, n in zip(shard_slice(d, axes, mesh), d.shape))
            return torch.full(shape, 0.0 if d.init == "zeros"
                              else d.scale or 1.0, dtype=d.dtype,
                              device=device)
        if d.init in ("normal", "embed"):
            fan_in = d.shape[-2] if len(d.shape) >= 2 and d.init == "normal" \
                else d.shape[-1]
            std = d.scale / math.sqrt(max(1, fan_in))
            w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=device).mul_(std)
        else:
            raise ValueError(d.init)
        if mesh is None:
            return w.to(d.dtype)
        # The block cast alone: the whole leaf is held in fp32 only.
        return w[shard_slice(d, axes, mesh)].to(d.dtype, copy=True)

    leaves = [init_one(d) for d in tree_leaves(tree)]
    return tree_unflatten(tree_structure(tree), leaves)


def pad_heads(hq: int, hkv: int, par: int, *, pad_kv: bool = False
              ) -> tuple[int, int, bool, bool]:
    """MaxText-style mesh padding of attention heads (the reference's
    policy): (hq_padded, hkv_padded, shard_q, shard_kv).  With hq < par
    attention replicates; otherwise hq pads to a multiple of par, hkv
    bumps to a divisor of hq_padded if the groups break, and kv shards
    only when hkv_padded % par == 0.  ``pad_kv`` pads hkv up to par."""
    if par <= 1 or hq < par:
        return hq, hkv, False, False
    hq_p = -(-hq // par) * par
    hkv_p = hkv
    if hq_p % hkv_p != 0:
        hkv_p = [h for h in range(hkv, hq_p + 1) if hq_p % h == 0][0]
    if pad_kv and hkv_p % par != 0:
        hkv_p = par
    return hq_p, hkv_p, True, hkv_p % par == 0


def embed_lookup(table: Tensor, tokens: Tensor,
                 prefix: Optional[Tensor] = None) -> Tensor:
    """Token embeddings (B, S, d), after the replicated rows ``prefix``
    (B, P, d) when given (a VLM's projected patches).  On a model mesh
    ``table`` is this rank's block of the vocabulary rows: a lookup into
    it (zero outside it) summed over the model axis; under
    :func:`seq_split` the sum is reduce-scattered over the whole sequence
    (the prefix counted from model rank 0) and this rank's block of it is
    returned."""
    tokens = tokens.long()
    if model_mesh() is None:
        x = table[tokens]
        return x if prefix is None else torch.cat([prefix.to(x.dtype), x],
                                                  dim=1)
    lo, hi = model_block(table.shape[0] * get_mesh_axes().model_par)
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = table[local.clamp(0, hi - lo - 1)] * inside[..., None].to(
        table.dtype)
    if seq_split():
        if prefix is not None:
            first = model_mesh().index(get_mesh_axes().model) == 0
            rows = torch.cat([prefix.to(rows.dtype) * float(first), rows],
                             dim=1)
        return exit_sum(rows, table.dtype)
    x = reduce_from_model(rows)
    return x if prefix is None else torch.cat([prefix.to(x.dtype), x], dim=1)


def masked_ce(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean next-token cross-entropy over the positions with labels >= 0.
    On a model mesh ``logits`` is this rank's block of the padded
    vocabulary (``pad_to(V, 128)`` columns, :func:`model_block`): the max
    and the sum of exponentials over the whole vocabulary, and the label's
    logit, are all-reduced over the model axis."""
    labels = labels.long()
    mask = (labels >= 0).float()
    if model_mesh() is None:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
        return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    lo, hi = model_block(logits.shape[-1] * get_mesh_axes().model_par)
    top = _model_all_reduce(logits.detach().amax(dim=-1, keepdim=True), "max")
    z = logits - top
    lse = torch.log(reduce_from_model(torch.exp(z).sum(dim=-1)))
    local = labels - lo
    inside = ((local >= 0) & (local < hi - lo)).to(z.dtype)
    picked = torch.gather(z, -1, local.clamp(0, hi - lo - 1)[..., None])[..., 0]
    ll = reduce_from_model(picked * inside) - lse
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def layer_views(blocks: dict) -> list[dict]:
    """Per-layer parameter dicts of a layer-stacked (L, ...) tree:
    ``unbind`` views of its leaves (one stacked gradient per leaf)."""
    skeleton = tree_structure(blocks)
    cols = [leaf.unbind(0) for leaf in tree_leaves(blocks)]
    return [tree_unflatten(skeleton, list(per)) for per in zip(*cols)]


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def split_rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-5) -> Tensor:
    """:func:`rms_norm` over a last dimension split over the model axis
    (rwkv6's ``ln_g`` over the heads, Mamba2's ``norm_g``): each rank's
    fp32 sum of squares is summed over the axis (and so is its gradient)
    and divided by the whole padded width, as the reference's padded
    model divides.  :func:`rms_norm` on one device."""
    if model_mesh() is None:
        return rms_norm(x, gamma, eps)
    xf = x.float()
    sq = _SumOverModel.apply((xf * xf).sum(dim=-1, keepdim=True))
    var = sq / (xf.shape[-1] * get_mesh_axes().model_par)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor, eps: float = 1e-5
               ) -> Tensor:
    """Two-pass fp32 mean and variance, gain and bias in fp32, cast back
    (the reference's arithmetic, written out)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 1e4,
               device: Optional[torch.device] = None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 1e4) -> Tensor:
    """Rotary embedding.  x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs     # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int,
                         device: Optional[torch.device] = None) -> Tensor:
    """(seq, dim) sin | cos table, built in float64 numpy and returned in
    fp32, as the reference builds it."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)
