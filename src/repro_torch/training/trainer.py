"""Robust distributed training: the paper's Alg. 1 (D-GD) and Alg. 3
(D-SHB) as train steps over arbitrary models.

Counterpart of ``repro.training.trainer``.  One step:

  1. per-worker gradients, one worker at a time;
  2. worker momentum (D-SHB): m_i <- beta m_i + (1-beta) g_i;
  3. Byzantine injection: the last f rows of a copy of the stack are
     overwritten by the configured attack;
  4. robust aggregation over the worker axis -> direction R_t, plus the
     kappa-hat diagnostic of paper Eq. (26) and, with
     ``TrainerConfig.taps``, the health taps (:mod:`repro_torch.obs.taps`);
  5. the server optimizer applies R_t.

Selective robustness (``TrainerConfig.fsdp_keys``, the reference's giant-MoE
deployment): leaves whose key path contains one of the keys (jax's
``keystr`` spelling, e.g. ``"['moe']['wi']"``) take no part in steps 2-4.
Their direction is the gradient of the mean over workers of the
per-worker losses, merged beside the robust aggregate before the
optimizer; the momentum, the attack, the aggregate, kappa-hat and the
taps see the robust leaves only.  The reference takes that gradient in a
second pass (``jax.grad`` of the vmapped mean loss); here it rides on the
per-worker backward the robust gradients need anyway: each worker's
gradient of an FSDP leaf is added to an fp32 sum at once (no per-worker
copy outlives its worker), and the sum over n, cast once to the leaf's
dtype, is the mean loss's gradient (what n backward passes summed in fp32
would give, bit for bit, at half the forward / backward passes).

Memory layout (differs from the reference, same arithmetic): the momentum
is ONE preallocated flat (n, D) fp32 buffer whose per-leaf views follow
jax's leaf order over the robust leaves (every leaf without ``fsdp_keys``).
Each worker's gradient is folded into its row in place as soon as it is
computed, so the reference's separate (n, D) gradient
stack and its concatenation into a flat buffer never exist; the attacked
stack is one flat copy of the momentum with its last f rows overwritten,
and the kernel path aggregates it through a zero-copy (n, D) view.  The
Byzantine rows keep honest momentum, as in the reference: their
transmitted values are attacked, not their local state.

Under a mesh (``TrainerConfig.worker_axes`` inside ``launch.mesh.
use_mesh``; the reference's ``vmap(spmd_axis_name=worker_axes)``) the
per-worker passes are dealt over the world's ranks, worker ``j W + r`` to
rank r in round j, so no worker's gradient is computed twice (without
model parallelism every rank of the mesh takes workers, not only those
along ``worker_axes``).  Each
round's gradient rows are resharded at once, by one all-to-all, from
worker rows to the column blocks of the aggregation axis
(``kernels.shard.column_block``): the momentum, its fold and the attacked
copy exist only as this rank's (n, D/k) block.  The attack runs on the
block (ALIE / FOE / SF / NaN / inf per column; the finite-row masks,
mimic's honest Gram and an ``_opt`` search's damages all-reduced), the
aggregate through ``robust_lib.robust_aggregate_block`` ("cuda_sharded" /
"cuda_hier"), kappa-hat and the taps from all-reduced sums.  The
aggregate's slices are gathered and every rank applies the same update to
its own copy of the parameters, so the copies stay equal bit for bit.
Under ``fsdp_keys`` the FSDP leaves' fp32 gradient sums are all-reduced
over the ranks that dealt the workers.

On a model mesh (``models.common.model_mesh``: a ``MeshAxes`` scope whose
model axis the active ``(data, model)`` mesh holds; ``worker_axes`` names
the data axis, ``TrainerConfig.param_specs`` the leaves' specs) each rank
holds its shard of the parameters and the workers are dealt over the data
axis: worker ``j K + d`` runs in round j on every model rank of data
index d, its forward and backward split over them.  A rank's gradient is
its model shard's columns of the worker's row (``kernels.shard.
ModelColumns``), handed over the data axis by one all-to-all per round:
"cuda_sharded" splits those columns further over the data axis and
all-reduces the Gram over both axes; "cuda_hier" keeps them whole on
every data rank and tiles the worker rows over the data axis.  No rank
gathers the (n, D) stack.  The aggregate's block is gathered over the
data axis, its replicated leaves over the model axis, and updates the
rank's shard; norms (``direction_norm``, the optimizer's clip) sum the
split leaves over the model axis (``optim.sharded_norm``).  The sketch
Gram's signs are drawn on the whole leaves' widths, and each rank folds
its block where the whole leaves hold its elements (``kernels.dispatch.
sketch_fold_model``); the partial sketches are all-reduced over both
axes before their Gram.

Under ``MeshAxes.expert_fsdp`` the expert tables (``fsdp_keys`` leaves,
required) also lie over the data axis the workers are dealt over: a
rank's fp32 sum of such a leaf is its shard's, and each backward's
reduce-scatter (``models.common.fsdp_gather``) has already summed the
round's workers over the data ranks into it, so it is not all-reduced
again; a data rank with no worker in a round runs a zero-seeded pass to
join those collectives.  The optimizer updates the shard, the norms sum
its squares over the data axis too, and ``options.checkpoint`` snapshots
it with the rank's carry.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import robust as robust_lib
from repro_torch.core.attacks import attack_flat_
from repro_torch.core.theory import (
    kappa_hat_from_sums, kappa_hat_sums,
)
from repro_torch.core.types import AggregatorSpec
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels import shard as shardlib
from repro_torch.models import common as model_common
from repro_torch.obs import runtime as obs_runtime
from repro_torch.obs.taps import health_taps, tap_columns, tap_metrics
from repro_torch.optim import Optimizer, global_norm
from repro_torch.optim.optimizers import sharded_norm
from repro_torch.resilience import (
    CarryCheckpointer, SnapshotStore, check_signature, concat_metrics,
    resolve_checkpoint, restore_carry, restored_metrics,
)
from repro_torch.rounds import (
    RoundEngine, RoundOptions, cadence_boundaries, fetch_metrics,
    resolve_options, round_generator, round_seeds, stack_rounds,
)
from repro_torch.tree import (
    tree_leaves, tree_map, tree_paths, tree_structure, tree_unflatten,
)

PyTree = Any
Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ByzantineConfig:
    """Simulation of f Byzantine workers executing ``attack``."""
    f: int = 0
    attack: str = "none"           # a name of core.types.ATTACKS
    eta: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    algorithm: str = "dshb"        # dgd (full grads, no momentum) | dshb
    beta: float = 0.9              # momentum coefficient (dshb)
    agg: AggregatorSpec = AggregatorSpec()
    byz: ByzantineConfig = ByzantineConfig()
    track_kappa_hat: bool = True
    #: In-round health taps (repro_torch.obs.taps): side outputs of the
    #: step, riding its metrics as ``taps.<field>``; a tapped run equals
    #: an untapped one bit for bit.  Refused with ``agg.hier``.
    taps: bool = False
    #: Selective robustness (giant MoE): parameters whose key path
    #: contains one of these substrings get the mean gradient over workers
    #: (no per-worker copy, no momentum) instead of the robust path.
    fsdp_keys: tuple[str, ...] = ()
    #: Mesh axes the per-worker passes are split over (the reference's
    #: ``spmd_axis_name``): inside ``launch.mesh.use_mesh`` the step deals
    #: the workers over the mesh's ranks and aggregates the stack's column
    #: blocks (module docstring); the axes must name axes of that mesh.
    worker_axes: Optional[tuple[str, ...]] = None
    #: On a model mesh: every parameter leaf's spec, in leaf order
    #: (``models.common.leaf_specs(model.param_descs())`` inside the
    #: ``MeshAxes`` scope); which leaves the model axis splits.
    param_specs: Optional[tuple] = None


#: TrainState is a plain dict: params / opt_state / step, plus the flat
#: (n, D) fp32 ``momentum`` for dshb.
TrainState = dict


def to_device(batch: PyTree, device: torch.device) -> PyTree:
    """A numpy (or torch) batch as tensors on ``device``."""
    return tree_map(lambda b: torch.as_tensor(np.asarray(b)).to(device), batch)


def _split_info(params: PyTree, fsdp_keys: tuple[str, ...]):
    """(skeleton, key paths, is_fsdp per leaf) of ``params``, in jax's
    leaf order."""
    paths = tree_paths(params)
    is_fsdp = [any(k in path for k in fsdp_keys) for path in paths]
    return tree_structure(params), paths, is_fsdp


def split_params(params: PyTree, fsdp_keys: tuple[str, ...]):
    """(robust leaves, fsdp leaves), each a list in leaf order."""
    _, _, is_fsdp = _split_info(params, fsdp_keys)
    leaves = tree_leaves(params)
    robust = [leaf for leaf, f in zip(leaves, is_fsdp) if not f]
    fsdp = [leaf for leaf, f in zip(leaves, is_fsdp) if f]
    return robust, fsdp


def merge_params(robust: list, fsdp: list, skeleton: PyTree,
                 is_fsdp: list) -> PyTree:
    """Inverse of :func:`split_params` for a skeleton of ``params``."""
    it_r, it_f = iter(robust), iter(fsdp)
    return tree_unflatten(skeleton,
                          [next(it_f) if f else next(it_r) for f in is_fsdp])


def _spec(cfg: TrainerConfig) -> AggregatorSpec:
    return dataclasses.replace(cfg.agg, f=cfg.byz.f) \
        if cfg.agg.f != cfg.byz.f else cfg.agg


def model_columns(cfg: TrainerConfig, params: PyTree
                  ) -> Optional[shardlib.ModelColumns]:
    """This rank's columns of the worker stack on a model mesh under
    ``worker_axes`` (module docstring), else None."""
    if not cfg.worker_axes or model_common.model_mesh() is None:
        return None
    axes = model_common.get_mesh_axes()
    leaves = tree_leaves(params)
    if cfg.param_specs is None or len(cfg.param_specs) != len(leaves):
        raise ValueError("worker_axes on a model mesh needs TrainerConfig."
                         "param_specs: models.common.leaf_specs("
                         "model.param_descs()), one spec per leaf")
    _, _, is_fsdp = _split_info(params, cfg.fsdp_keys)
    robust = [(leaf, spec) for leaf, spec, f
              in zip(leaves, cfg.param_specs, is_fsdp) if not f]
    # A split leaf's shard lies in its whole leaf in runs of its split
    # dimension's block times every later dimension.
    runs = [math.prod(leaf.shape[spec.index(axes.model):])
            if axes.model in spec else 0 for leaf, spec in robust]
    return shardlib.ModelColumns.build(
        [leaf.numel() for leaf, _ in robust],
        [axes.model in spec for _, spec in robust], axes.model_par,
        model_common.model_mesh().index(axes.model), runs)


def trainer_shard(cfg: TrainerConfig, device: torch.device,
                  mc: Optional[shardlib.ModelColumns] = None
                  ) -> Optional[shardlib.ShardCtx]:
    """This rank's shard of the worker stack under ``cfg.worker_axes``
    (None without them): the active mesh and its aggregation axes, as the
    aggregation backend resolves them, or with ``mc`` (a model mesh) the
    model shard's columns.  Raises without an active multi-rank mesh, for
    axes the mesh lacks and for a backend that is not a sharded one."""
    if not cfg.worker_axes:
        return None
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or mesh.devices < 2:
        raise ValueError("worker_axes needs an active multi-rank mesh "
                         "(launch.mesh.use_mesh)")
    missing = [a for a in cfg.worker_axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"worker_axes {missing} are not axes of the mesh "
                         f"{mesh.axis_names}")
    spec = _spec(cfg)
    backend = kdispatch.resolve_backend(spec.backend, device,
                                        hier=robust_lib._hier_active(spec))
    if backend not in kdispatch.SHARDED_BACKENDS:
        raise ValueError(
            f"worker_axes shards the stack's columns over the mesh: the "
            f"aggregation backend must be 'cuda_sharded' or 'cuda_hier' "
            f"('auto' on CUDA), got {spec.backend!r} -> {backend!r}")
    if mc is not None:
        return _model_shard_ctx(cfg, mesh, backend, mc)
    if backend == "cuda_hier":
        _, worker_axis, axis = kdispatch.resolve_hier_mesh()
        return shardlib.ShardCtx(mesh, axis, worker_axis)
    return shardlib.ShardCtx(*kdispatch.resolve_shard_mesh())


def _model_shard_ctx(cfg: TrainerConfig, mesh, backend: str,
                     mc: shardlib.ModelColumns) -> shardlib.ShardCtx:
    model = model_common.get_mesh_axes().model
    if len(cfg.worker_axes) != 1 or model in cfg.worker_axes:
        raise ValueError(f"worker_axes on a model mesh is the one data axis "
                         f"the workers are dealt over, got {cfg.worker_axes}")
    data = cfg.worker_axes[0]
    off, width = mc.offset, mc.width
    if backend == "cuda_hier":
        worker = data if mesh.size(data) > 1 else None
        return shardlib.ShardCtx(mesh, model, worker, span=(off, off + width),
                                 columns=mc)
    b0, b1 = shardlib.column_block(width, mesh.size(data), mesh.index(data))
    return shardlib.ShardCtx(mesh, (model, data), span=(off + b0, off + b1),
                             columns=mc)


def init_state(params: PyTree, optimizer: Optimizer, n_workers: int,
               cfg: TrainerConfig) -> TrainState:
    """The step-0 state; with ``worker_axes`` under a mesh the momentum is
    this rank's (n, c1 - c0) column block."""
    state = dict(params=params, opt_state=optimizer.init(params), step=0)
    if cfg.algorithm == "dshb":
        leaves, _ = split_params(params, cfg.fsdp_keys)
        width = sum(leaf.numel() for leaf in leaves)
        mc = model_columns(cfg, params)
        sh = trainer_shard(cfg, leaves[0].device, mc)
        if sh is not None:
            c0, c1 = sh.cols(width if mc is None else mc.total)
            width = c1 - c0
        state["momentum"] = torch.zeros((n_workers, width), dtype=torch.float32,
                                        device=leaves[0].device)
    return state


def stack_layout(params: PyTree, n_workers: int) -> kdispatch.StackLayout:
    """Layout of a worker stack shaped like ``params`` (jax leaf order)."""
    return kdispatch.stack_layout(tree_map(
        lambda p: torch.empty((n_workers,) + tuple(p.shape), device="meta"),
        params))


def kappa_hat_masked(agg: PyTree, stack: PyTree, n_honest,
                     internals: Optional[dict] = None) -> Tensor:
    """Eq. (26) with the honest rows selected by mask (row < n_honest), as
    the reference's fleet form computes it (a 0/1 mask multiplies the
    rows, so a non-finite row spreads NaN as there).

    ``n_honest`` an int or a 0-d tensor: one lane (agg leaves (...),
    stack leaves (n, ...)), returns a 0-d tensor.  A (B,) tensor: a lane
    axis leads every leaf (agg (B, ...), stack (B, n, ...)), returns (B,);
    the count stays on the device.  ``internals``: as
    :func:`repro_torch.core.theory.tree_kappa_hat` fills it, per lane."""
    leaves = tree_leaves(stack)
    dev = leaves[0].device
    nh = torch.as_tensor(n_honest, device=dev)
    lanes = nh.dim() == 1
    if not lanes:
        agg = tree_map(lambda a: a[None], agg)
        leaves = [s[None] for s in leaves]
        nh = nh.reshape(1)
    b = leaves[0].shape[0]
    num = torch.zeros((b,), dtype=torch.float32, device=dev)
    den = torch.zeros((b,), dtype=torch.float32, device=dev)
    cnt = torch.clamp_min(nh.float(), 1.0)
    dot = torch.zeros((b,), dtype=torch.float32, device=dev)
    msq = torch.zeros((b,), dtype=torch.float32, device=dev)
    for a, s in zip(tree_leaves(agg), leaves):
        x = s.float()
        n = x.shape[1]
        w = (torch.arange(n, device=dev)[None] < nh[:, None]).float()
        wl = w.reshape((b, n) + (1,) * (x.dim() - 2))
        mbar = (x * wl).sum(dim=1) / cnt.reshape((b,) + (1,) * (x.dim() - 2))
        num += torch.sum(((a.float() - mbar) ** 2).reshape(b, -1), dim=1)
        sq = torch.sum(((x - mbar[:, None]) ** 2).reshape(b, n, -1), dim=2)
        den += (sq * w).sum(dim=1) / cnt
        if internals is not None:
            dot += torch.sum((a.float() * mbar).reshape(b, -1), dim=1)
            msq += torch.sum((mbar * mbar).reshape(b, -1), dim=1)
    if internals is not None:
        internals.update((k, v if lanes else v[0]) for k, v in
                         (("honest_sq_dist", num), ("honest_dot", dot),
                          ("honest_mean_sq", msq)))
    out = torch.sqrt(num / (den + 1e-20))
    return out if lanes else out[0]


class _Solo:
    """The step's view of the worker stack on one device: every column of
    the (n, D) stack, the aggregate as a tree of leaves, identity
    collectives (``reduce`` None)."""
    reduce = None

    def __init__(self, spec: AggregatorSpec, layout: kdispatch.StackLayout):
        self.spec, self.layout = spec, layout
        self.cols = (0, layout.width)
        self.segments = [(off, size) for off, size, _ in layout.segments]

    def views(self, flat: Tensor) -> PyTree:
        return kdispatch.stack_views(flat, self.layout)

    def aggregate(self, flat: Tensor, perm, signs, internals=None):
        return robust_lib.robust_aggregate(self.views(flat), self.spec,
                                           perm=perm, signs=signs,
                                           internals=internals)

    def parts(self, agg) -> PyTree:
        return agg

    def robust_leaves(self, agg) -> list:
        return tree_leaves(agg)


class _Block:
    """The step's view under ``worker_axes``: this rank's column block
    [c0, c1) of the (n, D) stack (on the 2-D hierarchical form its
    aggregate takes the block's worker tile), each leaf's part of it as a
    column segment (size 0 outside the block), the aggregate as this
    rank's slice, and sums over D all-reduced along the aggregation axis
    by ``reduce``."""

    def __init__(self, sh: shardlib.ShardCtx, spec: AggregatorSpec,
                 layout: kdispatch.StackLayout, n: int):
        self.sh, self.spec, self.layout, self.n = sh, spec, layout, n
        self.cols = c0, c1 = sh.cols(layout.width)
        self.global_segments = [(off, size)
                                for off, size, _ in layout.segments]
        self.segments = []
        for off, size in self.global_segments:
            a, b = max(off, c0), min(off + size, c1)
            self.segments.append((a - c0, b - a) if a < b else (0, 0))
        s = robust_lib.bucketlib.clamp_bucket_size(n, spec.bucket_size,
                                                   spec.f)
        self.tiles = robust_lib._hier_tiles(spec, sh, n, s)

    def reduce(self, t: Tensor, op: str = "sum") -> Tensor:
        return self.sh.mesh.all_reduce(t.contiguous(), self.sh.axis, op,
                                       record=False)

    def views(self, flat: Tensor) -> list:
        return [flat[:, a:a + size] for a, size in self.segments]

    def aggregate(self, flat: Tensor, perm, signs, internals=None) -> Tensor:
        if self.tiles:
            r0, r1 = self.sh.rows(self.n)
            flat = flat[r0:r1].contiguous()
        return robust_lib.robust_aggregate_block(
            flat, self.spec, d=self.layout.width, n=self.n, perm=perm,
            signs=signs, segments=self.global_segments, internals=internals)

    def parts(self, vec: Tensor) -> list:
        return [vec[a:a + size] for a, size in self.segments]

    def robust_leaves(self, vec: Tensor) -> list:
        return tree_leaves(kdispatch.unflatten_aggregate(
            self.sh.gather(vec, self.layout.width), self.layout))

    def deal(self) -> "_Deal":
        """Every rank of the world deals workers; rank q keeps its column
        block along the aggregation axis."""
        mesh, d = self.sh.mesh, self.layout.width
        world = mesh.devices
        return _Deal(
            world, mesh.rank,
            [shardlib.column_block(d, self.sh.k, mesh.index_of(q, self.sh.axis))
             for q in range(world)],
            [(off, size, 0) for off, size in self.global_segments],
            lambda t: mesh.all_to_all_world(t, world), mesh.all_reduce_world)


class _ModelBlock(_Block):
    """The step's view on a model mesh: this rank's block of its model
    shard's columns (``mc``; :meth:`_Block.reduce` sums over the axes the
    block splits D over), each robust leaf's piece of it as a segment, and
    the aggregate rebuilt as this rank's shard of every leaf."""

    def __init__(self, sh: shardlib.ShardCtx, spec: AggregatorSpec,
                 mc: shardlib.ModelColumns, like: list, n: int, data: str):
        self.sh, self.spec, self.n, self.mc, self.like = sh, spec, n, mc, like
        self.data = data
        self.model = model_common.get_mesh_axes().model
        self.cols = c0, c1 = sh.cols(mc.total)
        self.local = (c0 - mc.offset, c1 - mc.offset)   # of the shard's columns
        self.global_segments = None
        self.segments = []
        for off, size in mc.segments():
            a = max(off, self.local[0])
            b = min(off + size, self.local[1])
            self.segments.append((a - self.local[0], b - a) if a < b
                                 else (0, 0))
        s = robust_lib.bucketlib.clamp_bucket_size(n, spec.bucket_size,
                                                   spec.f)
        self.tiles = robust_lib._hier_tiles(spec, sh, n, s)

    def deal(self) -> "_Deal":
        """The data axis deals workers; data rank q keeps its columns of
        this model shard (all of them on the hierarchical form)."""
        mesh, data, width = self.sh.mesh, self.data, self.mc.width
        k = mesh.size(data)
        if self.sh.worker_axis is not None or self.sh.axis == self.model:
            dest = [(0, width)] * k
        else:
            dest = [shardlib.column_block(width, k, q) for q in range(k)]
        return _Deal(
            k, mesh.index(data), dest,
            [(off, size, a) for (off, size), (a, _)
             in zip(self.mc.segments(), self.mc.pieces)],
            lambda t: mesh.all_to_all(t, data, k),
            lambda t: mesh.all_reduce(t, data, record=False))

    def aggregate(self, flat: Tensor, perm, signs, internals=None) -> Tensor:
        if self.tiles:
            r0, r1 = self.sh.rows(self.n)
            flat = flat[r0:r1].contiguous()
        return robust_lib.robust_aggregate_block(
            flat, self.spec, d=self.mc.total, n=self.n, perm=perm,
            signs=signs, internals=internals, sh=self.sh)

    def robust_leaves(self, vec: Tensor) -> list:
        if self.local != (0, self.mc.width):
            vec = shardlib.gather_columns(vec, self.mc.width,
                                          mesh=self.sh.mesh, axis=self.data)
        return self.mc.unflatten(vec, self.like, mesh=self.sh.mesh,
                                 axis=self.model)


def _pass_a(loss_fn, leaves: list, skeleton, is_fsdp: list, batch: PyTree,
            n: int, layout, stack: Tensor, fsdp_sum: list, fold) -> Tensor:
    """Per-worker gradients on one device, each folded into its row of
    ``stack`` at once; the FSDP leaves' gradients summed into
    ``fsdp_sum`` from the same backward.  Returns the (n,) fp32 losses."""
    losses = torch.empty((n,), dtype=torch.float32, device=stack.device)
    for i in range(n):
        losses[i], grads = _worker_grads(loss_fn, leaves, skeleton, is_fsdp,
                                         tree_map(lambda b: b[i], batch),
                                         fsdp_sum)
        row = stack[i]
        for (off, size, _), g in zip(layout.segments, grads):
            fold(row[off:off + size], g.reshape(-1).float())
        del grads
    return losses


def _worker_grads(loss_fn, leaves: list, skeleton, is_fsdp: list,
                  wbatch: PyTree, fsdp_sum: list, zero: bool = False):
    """One worker's loss and robust-leaf gradients; its FSDP leaves'
    gradients are added to ``fsdp_sum`` at once.  ``zero``: the backward
    is seeded with 0 (a pass that only joins the data axes' collectives,
    its own gradients all zero)."""
    req = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, _ = loss_fn(tree_unflatten(skeleton, req), wbatch)
    grads = torch.autograd.grad(
        loss, req, grad_outputs=torch.zeros_like(loss) if zero else None)
    for acc, g in zip(fsdp_sum, [g for g, fl in zip(grads, is_fsdp) if fl]):
        acc.add_(g)                         # fp32 += the leaf's dtype
    return loss.detach().float(), [g for g, fl in zip(grads, is_fsdp)
                                   if not fl]


@dataclasses.dataclass
class _Deal:
    """How pass A deals the workers over ranks: ``k`` dealing ranks (this
    one ``idx``), ``dest[q]`` the columns of a gradient row that rank q
    keeps, ``segs`` each robust leaf's (row offset, size, offset in the
    flattened leaf), ``exchange`` the all-to-all of a round's (k, w)
    rows and ``reduce`` the sum over the dealing ranks.  ``split[i]``:
    FSDP leaf i lies over the dealing ranks (expert FSDP), its gradient
    already their workers' sum."""
    k: int
    idx: int
    dest: list
    segs: list
    exchange: Callable
    reduce: Callable
    split: tuple = ()


def _pass_a_dealt(loss_fn, leaves: list, skeleton, is_fsdp: list,
                  batch: PyTree, n: int, stack: Tensor, fsdp_sum: list,
                  fold, deal: _Deal) -> Tensor:
    """Pass A under ``worker_axes``: round j computes worker j k + idx's
    gradient, and one all-to-all hands every dealing rank its columns of
    the round's rows, folded into its block ``stack`` at once; the FSDP
    sums are summed over the dealing ranks, except those of leaves that
    lie over them (``deal.split``: each backward reduce-scattered the
    round's workers into them already).  Where such leaves exist, a rank
    with no worker in a round still runs a zero-seeded pass, so it joins
    their gathers and reduce-scatters.  Returns the (n,) fp32 losses,
    summed over the dealing ranks."""
    dev = stack.device
    k, idx = deal.k, deal.idx
    wmax = max(b - a for a, b in deal.dest)
    own = deal.dest[idx][1] - deal.dest[idx][0]
    losses = torch.zeros((n,), dtype=torch.float32, device=dev)
    for j in range(-(-n // k)):
        send = torch.zeros((k, wmax), dtype=torch.float32, device=dev)
        i = j * k + idx
        if i < n:
            losses[i], grads = _worker_grads(
                loss_fn, leaves, skeleton, is_fsdp,
                tree_map(lambda b: b[i], batch), fsdp_sum)
            for (off, size, src), g in zip(deal.segs, grads):
                g = g.reshape(-1)
                for q, (a, b) in enumerate(deal.dest):
                    lo, hi = max(a, off), min(b, off + size)
                    if lo < hi:
                        send[q, lo - a:hi - a] = \
                            g[src + lo - off:src + hi - off]
            del grads
        elif any(deal.split):
            _worker_grads(loss_fn, leaves, skeleton, is_fsdp,
                          tree_map(lambda b: b[0], batch), fsdp_sum,
                          zero=True)
        recv = deal.exchange(send)
        del send
        for r in range(min(k, n - j * k)):
            fold(stack[j * k + r], recv[r, :own])
        del recv
    for acc, split in zip(fsdp_sum, deal.split or [False] * len(fsdp_sum)):
        if not split:
            deal.reduce(acc)
    return deal.reduce(losses)


def _data_split(param_specs: tuple) -> list:
    """Per leaf, the data axes of the model mesh its spec splits it over
    (expert FSDP's tables; () for the rest)."""
    data = model_common.get_mesh_axes().data
    return [tuple(a for a in data if any(
        a in model_common.spec_axes(p) for p in spec)) for spec in param_specs]


def _fsdp_split(cfg: TrainerConfig, is_fsdp: list) -> list:
    """Per FSDP leaf, whether expert FSDP lays it over the data axes of a
    model mesh.  Raises for what that cannot run: such a leaf outside
    ``fsdp_keys`` (a worker's gradient of it never exists, only the data
    ranks' sum) or data axes other than the ``worker_axes`` the workers
    are dealt over."""
    axes = model_common.get_mesh_axes()
    if model_common.model_mesh() is None or not axes.expert_fsdp:
        return [False] * sum(is_fsdp)
    if cfg.param_specs is None:
        raise ValueError("expert_fsdp on a model mesh needs TrainerConfig."
                         "param_specs (models.common.leaf_specs)")
    data = _data_split(cfg.param_specs)
    robust = [i for i, (d, f) in enumerate(zip(data, is_fsdp)) if d and not f]
    if robust:
        raise ValueError(
            f"expert_fsdp lays leaves {robust} over the data axes "
            f"{axes.data}: a worker's gradient of them never exists, so "
            "they must be fsdp_keys leaves (launch_config.FSDP_KEYS)")
    if any(d and d != tuple(cfg.worker_axes or ()) for d in data):
        raise ValueError(
            f"expert_fsdp lays the expert tables over {axes.data}: the "
            "workers must be dealt over the same axes (TrainerConfig."
            f"worker_axes, got {cfg.worker_axes})")
    return [bool(d) for d, f in zip(data, is_fsdp) if f]


def _split_sq_sum(param_specs: tuple) -> Callable:
    """The model-sharded sum of per-leaf squares: the leaves split over the
    model axis all-reduced over it (those split over data axes too, expert
    FSDP's, first summed over those), the replicated ones counted once."""
    model = model_common.get_mesh_axes().model
    split = [model in spec for spec in param_specs]
    data = _data_split(param_specs)
    mesh = model_common.model_mesh()

    def sq_sum(sq: list) -> Tensor:
        zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
        part = sum((t for t, sp, d in zip(sq, split, data) if sp and not d),
                   zero)
        for axes in dict.fromkeys(d for d in data if d):
            over = sum((t for t, d in zip(sq, data) if d == axes), zero)
            over = mesh.all_reduce(over.clone(), axes, record=False)
            part = part + over      # every such leaf is model-split too
        part = mesh.all_reduce(part.clone(), model, record=False)
        return part + sum((t for t, sp in zip(sq, split) if not sp), zero)
    return sq_sum


def build_train_step(loss_fn: Callable, optimizer: Optimizer,
                     cfg: TrainerConfig, lr_schedule: Callable) -> Callable:
    """Returns ``step(state, batch, internals=None, *, generator=None,
    perm=None, signs=None) -> (state, metrics)``.

    ``loss_fn(params, worker_batch) -> (scalar, metrics_dict)`` is the
    per-worker loss; ``batch`` carries a leading worker axis on every leaf
    and lies on the parameters' device.  ``internals``: pass a dict and the
    step stores the attacked flat stack (``"attacked"``; under
    ``worker_axes`` this rank's block), its layout (``"layout"``, over the
    list of robust leaves, always the whole stack's), the block's columns
    (``"cols"``, [c0, c1); [0, D) on one device), the sketch's ``"signs"``
    when drawn, and under ``alie_opt`` / ``foe_opt`` the chosen ``"eta"``
    and the grid's ``"damages"`` (device tensors).  With ``cfg.taps`` the
    metrics carry the health taps as ``taps.<field>`` (the deployed
    aggregate's only, never the eta search's candidates).
    ``generator`` (the reference's ``key``) draws the bucket permutation
    of a ``hier`` / ``pre="bucketing"`` spec and then the signs of a
    ``sketch_dim`` one, ONCE a step (``robust_lib.draw_randomness``), and
    is not touched otherwise; ``perm`` / ``signs`` give them explicitly.
    The optimized attacks' 12 candidate aggregates and the deployed one
    all see that one draw, as the reference's closure shares its
    ``agg_key``; the search overwrites the f rows of the one attacked
    copy in place.  Under ``worker_axes`` only pass A differs
    (:func:`_pass_a_dealt`); the rest runs on :class:`_Block` (on a model
    mesh :class:`_ModelBlock`) what it runs on :class:`_Solo` on one
    device.
    """
    if cfg.algorithm not in ("dshb", "dgd"):
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}")
    spec = _spec(cfg)
    if cfg.taps:
        robust_lib.validate_taps(spec)
    # fp32 constants as the reference's jnp arithmetic forms them.
    beta = float(np.float32(cfg.beta))
    one_minus_beta = float(np.float32(1.0) - np.float32(cfg.beta))

    def fold(dst: Tensor, g: Tensor) -> None:
        if cfg.algorithm == "dshb":
            dst.mul_(beta).add_(g, alpha=one_minus_beta)
        else:
            dst.copy_(g)

    def step(state: TrainState, batch: PyTree,
             internals: Optional[dict] = None, *,
             generator: Optional[torch.Generator] = None,
             perm: Optional[Tensor] = None,
             signs: Optional[list] = None):
        params = state["params"]
        leaves = tree_leaves(params)
        dev = leaves[0].device
        skeleton, _, is_fsdp = _split_info(params, cfg.fsdp_keys)
        n = tree_leaves(batch)[0].shape[0]
        f = cfg.byz.f
        n_honest = n - f
        robust_p, fsdp_p = split_params(params, cfg.fsdp_keys)
        layout = stack_layout(robust_p, n)
        mc = model_columns(cfg, params)
        sh = trainer_shard(cfg, dev, mc)
        if sh is None:
            part = _Solo(spec, layout)
        elif mc is None:
            part = _Block(sh, spec, layout, n)
        else:
            part = _ModelBlock(sh, spec, mc, robust_p, n, cfg.worker_axes[0])
        c0, c1 = part.cols
        # Pass B's fp32 sums of the per-worker FSDP gradients.
        fsdp_sum = [torch.zeros(leaf.shape, dtype=torch.float32,
                                device=leaf.device) for leaf in fsdp_p]

        if cfg.algorithm == "dshb":
            stack = state["momentum"]          # updated in place
        else:
            stack = torch.empty((n, c1 - c0), dtype=torch.float32, device=dev)

        # Pass A: per-worker gradients, each folded into its row at once.
        if sh is None:
            _fsdp_split(cfg, is_fsdp)       # no worker axes: raises if split
            losses = _pass_a(loss_fn, leaves, skeleton, is_fsdp, batch, n,
                             layout, stack, fsdp_sum, fold)
        else:
            deal = part.deal()
            deal.split = tuple(_fsdp_split(cfg, is_fsdp))
            losses = _pass_a_dealt(loss_fn, leaves, skeleton, is_fsdp, batch,
                                   n, stack, fsdp_sum, fold, deal)

        # One randomness draw for every aggregate of the step (the bucket
        # permutation of the n workers, then the sketch's signs per leaf,
        # on the whole leaves' widths on a model mesh).
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        shapes = [tuple(leaf.shape) for leaf in robust_p] if mc is None \
            else [(w,) for w in mc.whole]
        perm, signs = robust_lib.draw_randomness(
            [zero.expand((n,) + shape) for shape in shapes],
            spec, generator=generator, perm=perm, signs=signs)

        def closure(flat):
            return part.parts(part.aggregate(flat, perm, signs))

        # Byzantine simulation: a copy of the stack with the last f rows
        # overwritten (the honest state itself is not touched).
        attack = cfg.byz.attack
        if f == 0 or attack in ("none", "lf"):
            attacked = stack
        else:
            attacked = attack_flat_(
                attack, stack.clone(), f, eta=cfg.byz.eta,
                segments=part.segments,
                agg_closure=closure if attack.endswith("_opt") else None,
                internals=internals, reduce=part.reduce)
        attacked_tree = part.views(attacked)
        if internals is not None:
            internals.update(attacked=attacked, layout=layout, cols=(c0, c1))
            if signs is not None:
                internals["signs"] = signs

        tap_internals = {} if cfg.taps else None
        agg = part.aggregate(attacked, perm, signs, tap_internals)
        # The FSDP leaves' direction is the mean loss's gradient, in each
        # leaf's dtype (bf16 beside the fp32 robust direction, as the
        # reference's).
        fsdp_dir = [acc.div_(n).to(leaf.dtype)
                    for acc, leaf in zip(fsdp_sum, fsdp_p)]
        del fsdp_sum
        direction = merge_params(part.robust_leaves(agg), fsdp_dir, skeleton,
                                 is_fsdp)
        lr = lr_schedule(state["step"])
        with sharded_norm(None if mc is None
                          else _split_sq_sum(cfg.param_specs)):
            new_params, new_opt = optimizer.update(
                direction, state["opt_state"], params, lr)
            direction_norm = global_norm(direction)
        new_state = dict(params=new_params, opt_state=new_opt,
                         step=state["step"] + 1)
        if cfg.algorithm == "dshb":
            new_state["momentum"] = stack

        metrics = {
            "loss": losses[:n_honest].mean(),
            "lr": lr,
            "direction_norm": direction_norm,
        }
        agg_tree = part.parts(agg)
        if cfg.track_kappa_hat:
            sums = kappa_hat_sums(agg_tree, attacked_tree, n_honest,
                                  moments=tap_internals is not None)
            if part.reduce is not None:
                sums = part.reduce(sums)
            metrics["kappa_hat"] = kappa_hat_from_sums(sums, tap_internals)
        if cfg.taps:
            metrics.update(tap_metrics(health_taps(
                attacked_tree, agg_tree, n_honest=n_honest, f=spec.f,
                rule=spec.rule, pre=spec.pre, internals=tap_internals,
                reduce=part.reduce)))
        return new_state, metrics

    return step


def _check_same_start(mesh, start: int, path: str) -> None:
    """Every rank of a sharded run resumes from the same step."""
    t = torch.tensor([start, -start], dtype=torch.float64)
    mesh.all_reduce_world(t, "max")
    if int(t[0]) != -int(t[1]):
        from repro_torch.resilience.faults import CheckpointError
        raise CheckpointError(
            f"the ranks' latest snapshots disagree (steps {-int(t[1])} .. "
            f"{int(t[0])}) under {path}",
            hint="resume every rank from one directory written by one run")


def _empty_history() -> dict:
    return {"loss": [], "direction_norm": [], "kappa_hat": [], "lr": [],
            "eval": [], "eval_step": []}


def train_loop(loss_fn, params, batches, optimizer, cfg: TrainerConfig,
               lr_schedule, steps: int, *, seed: int = 0,
               eval_fn: Optional[Callable] = None, eval_every: int = 0,
               track_best: bool = True, engine: Optional[str] = None,
               chunk: Optional[int] = None,
               options: Optional[RoundOptions] = None):
    """Runs ``steps`` iterations; returns (final_params, {"history",
    "best", "state"} and, on the scan engine, "scan_report").

    Implements the paper's model selection: theta_hat is the iterate with
    the smallest aggregate norm (Alg. 1), i.e. the iterate ENTERING the
    best step.  ``batches`` is an iterator of numpy batches (or one batch
    reused every step); they are moved to the parameters' device.

    ``engine="scan"`` (default) stacks the ``steps`` batches up front and
    runs the steps as segments of a :class:`~repro_torch.rounds.RoundEngine`
    cut at the eval cadence and at ``chunk`` steps (None = only at evals):
    the best-iterate selection stays on the device in the carry
    (``torch.where`` per leaf) and the metrics reach the host once a run.
    ``"scan_report"`` holds ``trace_count``, ``chunk_shapes``,
    ``transfers`` and ``segments`` (``(start, end, seconds)``, host clock
    around work ending in a synchronize) and, when checkpointing,
    ``snapshots`` and ``resumed_from`` (each snapshot's bytes and
    seconds are ``obs_runtime``'s ``resilience.snapshot`` spans).
    ``engine="loop"`` runs the same step one at a time, its metrics
    fetched every step (the history also records each step's wall time in
    ``"ms"``).  With ``cfg.taps`` (or ``options.taps``) the history's
    ``"taps"`` holds ``{field: (steps, ...) array}`` on both engines.  Both draw step t's bucket
    permutation (``hier`` / ``pre="bucketing"``) from a generator seeded
    with ``round_seeds(seed, steps)[t]``, so they agree bit for bit and a
    resumed run needs no generator state.

    ``options`` is the shared :class:`~repro_torch.rounds.RoundOptions`;
    the ``engine=`` / ``chunk=`` keywords win when passed.
    ``options.checkpoint`` makes a scan run resumable: the carry, the
    metrics so far and the eval points are snapshotted at segment
    boundaries, and a rerun into the same directory resumes from the
    latest snapshot.  Under ``worker_axes`` every rank snapshots its own
    carry (its parameter shard, its momentum block) into ``rank<r>/``,
    the signature holds ``launch.mesh.mesh_signature()`` (a resume on
    another mesh raises), and the ranks must resume from one step.
    """
    opts = resolve_options(options, engine=engine, chunk=chunk)
    cfg = opts.apply_config(cfg)
    engine, chunk = opts.engine or "scan", opts.chunk
    if opts.checkpoint is not None and engine != "scan":
        raise ValueError("options.checkpoint requires engine='scan' "
                         "(the loop path has no chunk boundaries to "
                         "snapshot at)")
    if engine == "loop":
        return _train_loop_loop(loss_fn, params, batches, optimizer, cfg,
                                lr_schedule, steps, seed=seed,
                                eval_fn=eval_fn, eval_every=eval_every,
                                track_best=track_best)
    if engine != "scan":
        raise ValueError(f"engine must be 'scan' or 'loop', got {engine!r}")

    device = tree_leaves(params)[0].device
    hist = _empty_history()
    best = {"norm": np.inf, "params": params, "acc": -np.inf}
    if hasattr(batches, "__next__"):
        per_step = [next(batches) for _ in range(max(steps, 1))]
        first = per_step[0]
        stacked = stack_rounds([tree_map(np.asarray, b)
                                for b in per_step[:steps]]) if steps else None
    else:
        first = batches
        # One batch reused every step: a zero-copy view along the step axis.
        stacked = tree_map(lambda x: np.broadcast_to(
            np.asarray(x)[None], (steps,) + np.shape(x)), batches)
    n_workers = tree_leaves(first)[0].shape[0]
    state = init_state(params, optimizer, n_workers, cfg)
    if steps == 0:
        return params, {"history": hist, "best": best, "state": state,
                        "scan_report": {"trace_count": 0, "chunk_shapes": (),
                                        "transfers": 0, "segments": []}}

    step_fn = build_train_step(loss_fn, optimizer, cfg, lr_schedule)

    def body(carry, op):
        state, best_norm, best_params = carry
        prev = state["params"]
        state, metrics = step_fn(state, op["batch"],
                                 generator=round_generator(op["key"]))
        if track_best:
            dn = metrics["direction_norm"]
            better = dn < best_norm
            # theta_hat is the iterate ENTERING the best step (Alg. 1's
            # selection), hence prev, not the stepped params.
            best_params = tree_map(
                lambda new, old: torch.where(better, new, old),
                prev, best_params)
            best_norm = torch.where(better, dn, best_norm)
        return (state, best_norm, best_params), metrics

    def prepare(seg):
        return dict(seg, batch=to_device(tree_map(np.ascontiguousarray,
                                                  seg["batch"]), device))

    def on_boundary(end: int, carry):
        if eval_fn and eval_every and end % eval_every == 0:
            acc = float(eval_fn(carry[0]["params"]))
            hist["eval"].append(acc)
            hist["eval_step"].append(end)
            best["acc"] = max(best["acc"], acc)

    eng = RoundEngine(body, chunk=chunk, prepare=prepare)
    carry0 = (state, torch.tensor(np.inf, dtype=torch.float32, device=device),
              params)
    del state               # the carry owns it (a restore replaces it)

    # Resilience: resume from the last segment-boundary snapshot (if any)
    # and keep snapshotting carry + metrics so far at every boundary.
    ckpt_cfg = resolve_checkpoint(opts.checkpoint)
    checkpointer, start_step, saved_cols = None, 0, {}
    if ckpt_cfg is not None:
        signature = {"surface": "trainer", "steps": steps, "chunk": chunk,
                     "seed": seed,
                     "eval_every": eval_every if eval_fn else 0,
                     **({"taps": True} if cfg.taps else {})}
        mesh = None
        if cfg.worker_axes:
            # Every rank snapshots its own shards and momentum block.
            from repro_torch.launch.mesh import current_mesh, mesh_signature
            mesh = current_mesh()
            signature["mesh"] = list(mesh_signature())
        store = SnapshotStore.from_config(
            ckpt_cfg, subdir=None if mesh is None else f"rank{mesh.rank}")
        snap = store.load_latest() if ckpt_cfg.resume else None
        if mesh is not None:
            _check_same_start(mesh, 0 if snap is None else snap[0],
                              store.path)
        if snap is not None:
            start_step, arrays, meta = snap
            check_signature(meta["signature"], signature, store.path)
            carry0 = restore_carry(arrays, meta, carry0)
            saved_cols = restored_metrics(arrays)
            del arrays, snap        # the host copy of the carry
            payload = meta.get("payload", {})
            hist["eval"] = list(payload.get("eval", []))
            hist["eval_step"] = [int(s) for s in payload.get("eval_step", [])]
            best["acc"] = float(payload.get("best_acc", -np.inf))
        checkpointer = CarryCheckpointer(
            store, signature=signature, total=steps, every=ckpt_cfg.every,
            base_columns=saved_cols,
            payload_fn=lambda end: {"eval": hist["eval"],
                                    "eval_step": hist["eval_step"],
                                    "best_acc": best["acc"]})

    try:
        (state, best_norm, best_params), metrics = eng.run(
            carry0, {"batch": stacked, "key": round_seeds(seed, steps)},
            boundaries=cadence_boundaries(steps, eval_every if eval_fn else 0),
            on_boundary=on_boundary,
            on_segment=checkpointer.on_segment if checkpointer else None,
            start=start_step)
    finally:
        if checkpointer is not None:
            checkpointer.close()

    cols = dict(saved_cols) if metrics is None \
        else concat_metrics(saved_cols, metrics)
    for k in ("loss", "direction_norm", "kappa_hat", "lr"):
        if k in cols:
            hist[k] = [float(x) for x in cols[k]]
    if tap_columns(cols):
        hist["taps"] = tap_columns(cols)
    if track_best:
        best["norm"] = float(best_norm)
        best["params"] = best_params
    report = {"trace_count": eng.trace_count,
              "chunk_shapes": tuple(sorted(eng.chunk_shapes)),
              "transfers": eng.transfer_count,
              "segments": list(eng.segment_log)}
    if ckpt_cfg is not None:
        report["snapshots"] = checkpointer.store.snapshots_written
        report["resumed_from"] = start_step
    return state["params"], {"history": hist, "best": best, "state": state,
                             "scan_report": report}


def _train_loop_loop(loss_fn, params, batches, optimizer, cfg: TrainerConfig,
                     lr_schedule, steps: int, *, seed: int = 0,
                     eval_fn: Optional[Callable] = None, eval_every: int = 0,
                     track_best: bool = True):
    """The per-step loop: one step, one metric transfer (counted in
    ``obs_runtime``'s ``rounds.transfers``) and one host-side best-iterate
    check at a time.  The scan engine's parity baseline."""
    device = tree_leaves(params)[0].device
    first = next(batches) if hasattr(batches, "__next__") else batches
    n_workers = tree_leaves(first)[0].shape[0]
    state = init_state(params, optimizer, n_workers, cfg)
    step_fn = build_train_step(loss_fn, optimizer, cfg, lr_schedule)
    seeds = round_seeds(seed, steps)

    hist = dict(_empty_history(), ms=[])
    best = {"norm": np.inf, "params": params, "acc": -np.inf}
    tap_rows: list = []
    batch = first
    for t in range(steps):
        prev_params = state["params"]
        t0 = time.perf_counter()
        state, metrics = step_fn(state, to_device(batch, device),
                                 generator=round_generator(seeds[t]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        hist["ms"].append(1e3 * (time.perf_counter() - t0))
        host = {k: v[0] for k, v in fetch_metrics([metrics]).items()}
        obs_runtime.inc("rounds.transfers")
        for k in ("loss", "direction_norm", "kappa_hat", "lr"):
            if k in host:
                hist[k].append(float(host[k]))
        if cfg.taps:
            tap_rows.append(tap_columns(host))
        dn = hist["direction_norm"][-1]
        if track_best and dn < best["norm"]:
            best["norm"], best["params"] = dn, prev_params
        if eval_fn and eval_every and (t + 1) % eval_every == 0:
            acc = float(eval_fn(state["params"]))
            hist["eval"].append(acc)
            hist["eval_step"].append(t + 1)
            best["acc"] = max(best["acc"], acc)
        if hasattr(batches, "__next__") and t + 1 < steps:
            batch = next(batches)
    if tap_rows:
        hist["taps"] = {k: np.stack([row[k] for row in tap_rows])
                        for k in tap_rows[0]}
    return state["params"], {"history": hist, "best": best, "state": state}
