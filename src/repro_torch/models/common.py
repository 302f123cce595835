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

A decode cache's descs carry the last two (:data:`CACHE_DATA_AXES`), so
:func:`materialize` gives this rank's shard of a cache too, and
:func:`batch_block` / :func:`gather_batch` cut and join its rows.
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
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g)


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
        rows = x.detach().reshape(-1, ctx.w).mT.float().contiguous()
        full = mesh.all_gather(rows, axes.model, record=False)  # (k w, L)
        return full.mT.reshape(x.shape[:-1] + (ctx.k * ctx.w,)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
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
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = _model_all_reduce(g.float() @ w.float().mT).to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
        return gx, gw


def column_parallel(x: Tensor, w: Tensor) -> Tensor:
    """Enter a model-split region through a column-parallel product
    (q / k / v, the MLP's gate and up, the vocabulary head); ``x @ w``
    whole on one device."""
    if model_mesh() is None:
        return x @ w
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
    partial product of this rank's rows, all-reduced, cast once to
    ``dtype`` (a bf16 layer rounds where one device rounds).  Whole on
    one device."""
    if model_mesh() is None:
        return h @ w
    return reduce_from_model(h.float() @ w.float()).to(dtype)


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


#: Logical axes that lie over the data axes of a mesh: a decode cache's
#: batch rows and, for long spans, its sequence.  A weight's data-axis
#: entry (expert FSDP) is refused.
CACHE_DATA_AXES = ("batch", "seq_shard", "seq_both")


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
    Data-axis entries are taken for a cache's batch and sequence
    (:data:`CACHE_DATA_AXES`) and refused for a weight (expert FSDP): the
    workers, not the weights, lie on the data axis."""
    idx = [slice(None)] * len(d.shape)
    if axes is None or mesh is None or axes.model_par <= 1 \
            or axes.model not in mesh.axis_names:
        return tuple(idx)
    for i, part in enumerate(leaf_spec(d, axes)):
        names = spec_axes(part)
        if not names:
            continue
        if names != (axes.model,) and d.axes[i] not in CACHE_DATA_AXES:
            raise ValueError(f"leaf {d.shape} {d.axes}: dimension {i} splits "
                             f"over {part!r}; only the model axis splits "
                             "weights here (expert_fsdp waits, ROADMAP "
                             "queue 1, item 19)")
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


def embed_lookup(table: Tensor, tokens: Tensor) -> Tensor:
    """Token embeddings; on a model mesh ``table`` is this rank's block of
    the vocabulary rows: a lookup into it (zero outside it) summed over
    the model axis."""
    tokens = tokens.long()
    if model_mesh() is None:
        return table[tokens]
    lo, hi = model_block(table.shape[0] * get_mesh_axes().model_par)
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = table[local.clamp(0, hi - lo - 1)] * inside[..., None].to(
        table.dtype)
    return reduce_from_model(rows)


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
