"""Kernel backend layer: route the aggregation hot path to CUDA or torch.

Counterpart of ``repro.kernels.dispatch``.  ``repro_torch.core.robust``
declares ``AggregatorSpec.backend`` ("torch" | "cuda" | "auto") and this
module turns it into calls over ONE contiguous ``(n, D)`` view of the
worker-stacked pytree:

* **flatten** — :func:`flatten_worker_stack` returns the stack as one
  (n, D) buffer: a zero-copy view when the leaves already are column
  views of one such buffer (the trainer's momentum layout), else a
  concatenation;
* **gram** (K1), **combine** (K3), **mixtrim** (K2), **bucketgram** (K6)
  and **bucketmeans** (K7) — the hand-written kernels of ``kernels/csrc``
  for a CUDA stack.  A CPU stack runs each kernel's plain version, and
  that is RECORDED as a fallback;
* the fleet's lane-batched forms over a (B, n, D) stack, one launch for
  all lanes: **gram_batched** (K5), **mixtrim_dyn** (K4, f an int tensor
  per lane), and the forms the reference's ``jax.vmap`` gives its static
  kernels: **bucketgram_lanes** / **bucketmeans_lanes** (K6 / K7, each
  lane its own bucket ids), **combine_lanes** (K3, the gram rules) and
  **mixtrim_lanes** (K2's median, the cwmed lanes);
* the **sketch Gram** of ``AggregatorSpec.sketch_dim``
  (:func:`dispatch_sketch_gram`): a signed fold of each leaf's segment
  into (n, sketch_dim), then its (n, n) Gram.  The reference computes it
  with an einsum outside any Pallas kernel, so the port runs torch
  contractions and records them by name (``"sketch_gram"``).

Under a multi-rank mesh (:mod:`repro_torch.launch.mesh`), "cuda_sharded"
and "cuda_hier" run the same primitives on each rank's block
(:mod:`repro_torch.kernels.shard`, passed as ``sh``): the Grams (K1, K5,
K6's) all-reduce their (n, n) partials, combine / mixtrim / meamed stay
shard-local, and the hierarchical stage's 2-D form all-reduces the
partial bucket means of K7 over the worker axis.  Each collective is a
``collective:<op>`` decision with its transport (``nccl`` or
``gloo``).  :func:`resolve_shard_mesh` / :func:`resolve_hier_mesh`
find the mesh; without one the pipeline degrades, and the degrade is a
recorded ``pipeline`` fallback (``core.robust``).

Every decision lands on a :class:`DispatchRecord` in a bounded ring
(:func:`last_dispatch`), so a requested kernel
path that quietly ran torch ops is detectable; each record is also a
``kernels.dispatch`` event of ``repro_torch.obs.runtime``, so a trace
export carries it.  PyTorch runs eagerly, so a record describes the call
that opened it (the reference's records describe the most recent jit
trace).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import torch

from repro_torch.core.types import BACKENDS
from repro_torch.kernels import shard as shardlib
from repro_torch.kernels.bucketgram import REG_NB as _BUCKETGRAM_REG_NB
from repro_torch.kernels.bucketgram import assignment_matrix as _assignment_matrix
from repro_torch.kernels.bucketgram import bucket_means_gram_ref as _bucketgram_ref
from repro_torch.kernels.bucketgram import bucket_means_gram_lanes_ref as _bucketgram_lanes_ref
from repro_torch.kernels.bucketgram import bucketgram as _bucketgram_op
from repro_torch.kernels.bucketgram import bucketgram_lanes as _bucketgram_lanes_op
from repro_torch.kernels.bucketgram import bucketgram_lanes_perms as _bucketgram_perms_op
from repro_torch.kernels.bucketgram import bucketmeans as _bucketmeans_op
from repro_torch.kernels.bucketgram import bucketmeans_lanes as _bucketmeans_lanes_op
from repro_torch.kernels.bucketgram import bucketmeans_lanes_perms as _bucketmeans_perms_op
from repro_torch.kernels.bucketgram import perm_assignment as _perm_assignment
from repro_torch.kernels.combine import combine as _combine_op
from repro_torch.kernels.combine import combine_lanes as _combine_lanes_op
from repro_torch.kernels.combine import combine_lanes_ref as _combine_lanes_ref
from repro_torch.kernels.combine import combine_ref as _combine_ref
from repro_torch.kernels.gram import gram as _gram_op
from repro_torch.kernels.gram import gram_batched as _gram_batched_op
from repro_torch.kernels.gram import gram_batched_ref as _gram_batched_ref
from repro_torch.kernels.gram import gram_ref as _gram_ref
from repro_torch.kernels.mixtrim import mixtrim as _mixtrim_op
from repro_torch.kernels.mixtrim import mixtrim_dyn as _mixtrim_dyn_op
from repro_torch.kernels.mixtrim import mixtrim_dyn_ref as _mixtrim_dyn_ref
from repro_torch.kernels.mixtrim import mixtrim_lanes as _mixtrim_lanes_op
from repro_torch.kernels.mixtrim import mixtrim_lanes_ref as _mixtrim_lanes_ref
from repro_torch.kernels.mixtrim import mixtrim_ref as _mixtrim_ref
from repro_torch.tree import tree_leaves, tree_map, tree_structure, tree_unflatten

PyTree = Any

#: The kernel wrappers of the port, by primitive name (the ``_lanes``
#: entries are the lane forms of K2's median, K3, K6 and K7).
KERNELS = {"gram": _gram_op, "mixtrim": _mixtrim_op, "combine": _combine_op,
           "mixtrim_dyn": _mixtrim_dyn_op, "gram_batched": _gram_batched_op,
           "bucketgram": _bucketgram_op, "bucketmeans": _bucketmeans_op,
           "bucketgram_lanes": _bucketgram_lanes_op,
           "bucketmeans_lanes": _bucketmeans_lanes_op,
           "combine_lanes": _combine_lanes_op,
           "mixtrim_lanes": _mixtrim_lanes_op}

#: Backends that run the kernels (the remaining ones run torch ops).
KERNEL_BACKENDS = ("cuda", "cuda_sharded", "cuda_hier")

#: Backends whose primitives run on each rank's block of a mesh.
SHARDED_BACKENDS = ("cuda_sharded", "cuda_hier")


def launch_counts() -> dict[str, int]:
    """Kernel launches per primitive since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def resolve_backend(requested: str, device: torch.device, *,
                    hier: bool = False) -> str:
    """Resolve "auto": on a CUDA stack "cuda_hier" (``hier``) or
    "cuda_sharded" when a mesh with more than one rank along its
    aggregation axis is active (:func:`resolve_shard_mesh`), else "cuda";
    the torch path for a CPU stack.  Explicit requests are honoured:
    "cuda_sharded" / "cuda_hier" without a mesh degrade at dispatch time,
    recorded."""
    if requested not in BACKENDS:
        raise ValueError(
            f"unknown backend {requested!r}; expected one of {BACKENDS}")
    if requested == "auto":
        if device.type != "cuda":
            return "torch"
        if resolve_shard_mesh() is None:
            return "cuda"
        return "cuda_hier" if hier else "cuda_sharded"
    return requested


def resolve_shard_mesh():
    """(mesh, axis) for the sharded backend, or None without a multi-rank
    mesh (``launch.mesh.aggregation_mesh``)."""
    from repro_torch.launch.mesh import aggregation_mesh
    return aggregation_mesh()


def resolve_hier_mesh():
    """(mesh, worker_axis | None, model_axis) for the hierarchical
    backend, or None without a multi-rank mesh (worker_axis None: the
    1-D form, D split only)."""
    from repro_torch.launch.mesh import hier_aggregation_mesh
    return hier_aggregation_mesh()


# ---------------------------------------------------------------------------
# Decision record.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KernelDecision:
    """One primitive-level routing decision."""
    primitive: str          # "gram" | "combine" | "mixtrim" | "bucketgram" |
                            # ... | "collective:<op>" (requested "mesh")
    requested: str          # backend asked for at this call site
    used: str               # "cuda" | "plain" (a kernel's plain version) |
                            # "torch" | "skipped" (s = 1 hierarchical stage)
                            # | a collective's transport
    reason: str = ""        # why `used` differs from the kernel path

    @property
    def fell_back(self) -> bool:
        return self.requested in KERNEL_BACKENDS and self.used not in (
            "cuda", "skipped")


@dataclasses.dataclass
class DispatchRecord:
    """The decision trail of one ``robust_aggregate`` call."""
    requested: str          # AggregatorSpec.backend as given ("auto" kept)
    backend: str            # resolved backend
    rule: str
    pre: Optional[str]
    #: Hierarchical stage: whether this call ran a bucketed pre-reduction
    #: and its requested bucket size (None = the floor(n/2f) default).
    hier: bool = False
    bucket_size: Optional[int] = None
    #: Dynamic-f path (f an int tensor) and its lane count (None = the
    #: static path).
    dyn: bool = False
    lanes: Optional[int] = None
    #: The mesh the sharded backends ran over: ranks the stack was split
    #: across (1: unsharded; a "cuda_sharded" / "cuda_hier" record with 1
    #: is a DEGRADED request, paired with a recorded "pipeline" fallback),
    #: the axis D was split along, and on the 2-D hierarchical form the
    #: axis the worker rows were split along.
    mesh_devices: int = 1
    mesh_axis: Optional[str] = None
    mesh_worker_axis: Optional[str] = None
    decisions: list = dataclasses.field(default_factory=list)

    @property
    def fallbacks(self) -> list:
        """Decisions where a requested kernel ran as torch ops."""
        return [d for d in self.decisions if d.fell_back]

    def describe(self) -> str:
        hier = f" hier(s={self.bucket_size or 'auto'})" if self.hier else ""
        dyn = f" dyn lanes={self.lanes}" if self.dyn else ""
        mesh = f" mesh={self.mesh_devices}x{self.mesh_axis}" \
            if self.mesh_axis else ""
        if self.mesh_worker_axis:
            mesh += f" workers={self.mesh_worker_axis}"
        parts = [f"{self.requested}->{self.backend} rule={self.rule} "
                 f"pre={self.pre or 'none'}{hier}{dyn}{mesh}"]
        for d in self.decisions:
            why = f" ({d.reason})" if d.reason else ""
            parts.append(f"  {d.primitive}: {d.used}{why}")
        return "\n".join(parts)


DISPATCH_HISTORY_LIMIT = 256
_HISTORY: deque = deque(maxlen=DISPATCH_HISTORY_LIMIT)
_OPENED = 0                 # lifetime records opened (the ring may drop)


def last_dispatch() -> Optional[DispatchRecord]:
    """The most recently opened dispatch record, or None."""
    return _HISTORY[-1] if _HISTORY else None


def dispatch_history(limit: Optional[int] = None) -> list:
    """The most recent dispatch records, oldest first (bounded by
    :data:`DISPATCH_HISTORY_LIMIT`); ``limit`` keeps only the newest N."""
    records = list(_HISTORY)
    return records if limit is None else records[-limit:]


def dispatch_count() -> int:
    """Records ever opened in this process (monotone, unlike the ring)."""
    return _OPENED


def open_record(*, requested: str, backend: str, rule: str,
                pre: Optional[str], hier: bool = False,
                bucket_size: Optional[int] = None, dyn: bool = False,
                lanes: Optional[int] = None, mesh_devices: int = 1,
                mesh_axis: Optional[str] = None,
                mesh_worker_axis: Optional[str] = None) -> DispatchRecord:
    global _OPENED
    rec = DispatchRecord(requested=requested, backend=backend, rule=rule,
                         pre=pre, hier=hier, bucket_size=bucket_size,
                         dyn=dyn, lanes=lanes, mesh_devices=mesh_devices,
                         mesh_axis=mesh_axis,
                         mesh_worker_axis=mesh_worker_axis)
    _HISTORY.append(rec)
    _OPENED += 1
    # The runtime ring holds the live record: the decisions appended below
    # reach its exports.  Imported here: obs.runtime re-exports this module.
    from repro_torch.obs import runtime as obs_runtime
    obs_runtime.event("kernels.dispatch", record=rec)
    return rec


#: Every fallback decision since :func:`reset_fallbacks` (kept apart from
#: the bounded ring, so a long run's fallbacks are all seen).
_FALLBACKS: list = []


def record_decision(primitive: str, requested: str, used: str,
                    reason: str = "") -> None:
    if _HISTORY:
        dec = KernelDecision(primitive, requested, used, reason)
        _HISTORY[-1].decisions.append(dec)
        if dec.fell_back:
            _FALLBACKS.append(dec)


def fallback_log() -> list:
    """The fallback decisions recorded since :func:`reset_fallbacks`."""
    return list(_FALLBACKS)


def reset_fallbacks() -> None:
    _FALLBACKS.clear()


# ---------------------------------------------------------------------------
# Flatten / unflatten: one contiguous (n, D) view of the worker stack.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackLayout:
    """Leaf-segment metadata of a flattened worker stack."""
    structure: PyTree       # the tree with leaves replaced by None
    segments: tuple         # of (offset, size, trailing_shape)
    n: int                  # worker count
    width: int              # total feature width D


def stack_layout(tree: PyTree) -> StackLayout:
    """Layout of a worker-stacked pytree in jax's leaf order."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    segs, off = [], 0
    for leaf in leaves:
        size = leaf.numel() // n
        segs.append((off, size, tuple(leaf.shape[1:])))
        off += size
    return StackLayout(tree_structure(tree), tuple(segs), n, off)


def _as_flat_view(leaves: list, layout: StackLayout) -> Optional[torch.Tensor]:
    """The (n, D) buffer the leaves are column views of, or None."""
    base = leaves[0]
    n, width = layout.n, layout.width
    storage = base.untyped_storage().data_ptr()
    start = base.storage_offset()
    for leaf, (off, _, shape) in zip(leaves, layout.segments):
        if (leaf.dtype != base.dtype or leaf.device != base.device
                or leaf.untyped_storage().data_ptr() != storage
                or leaf.storage_offset() != start + off
                or (n > 1 and leaf.stride(0) != width)):
            return None
        inner = 1
        for size, stride in reversed(list(zip(shape, leaf.stride()[1:]))):
            if size > 1 and stride != inner:
                return None
            inner *= size
    need = (start + n * width) * base.element_size()
    if need > base.untyped_storage().nbytes():
        return None
    return base.as_strided((n, width), (width, 1), start)


def flatten_worker_stack(tree: PyTree) -> tuple[torch.Tensor, StackLayout]:
    """One contiguous (n, D) view of a worker-stacked pytree (leaves in
    jax's order).  Zero-copy when the leaves are column views of one
    (n, D) buffer; a concatenation otherwise."""
    leaves = tree_leaves(tree)
    layout = stack_layout(tree)
    flat = _as_flat_view(leaves, layout)
    if flat is None:
        flat = torch.cat([leaf.reshape(layout.n, -1) for leaf in leaves],
                         dim=1)
    return flat, layout


def stack_views(flat: torch.Tensor, layout: StackLayout) -> PyTree:
    """Per-leaf (n, ...) views of a flat (n, D) stack."""
    leaves = [flat[:, off:off + size].view((layout.n,) + shape)
              for off, size, shape in layout.segments]
    return tree_unflatten(layout.structure, leaves)


def unflatten_aggregate(vec: torch.Tensor, layout: StackLayout) -> PyTree:
    """The aggregated pytree (worker axis removed) as views of a (D,)
    vector."""
    leaves = [vec[off:off + size].view(shape)
              for off, size, shape in layout.segments]
    return tree_unflatten(layout.structure, leaves)


def flatten_lane_stack(tree: PyTree) -> tuple[torch.Tensor, StackLayout]:
    """A lane-batched worker stack (every leaf (B, n, ...)) as one
    contiguous (B, n, D) buffer, and the layout of one lane."""
    leaves = tree_leaves(tree)
    b, n = leaves[0].shape[:2]
    layout = stack_layout(tree_map(lambda leaf: leaf[0], tree))
    if len(leaves) == 1:
        flat = leaves[0].reshape(b, n, -1).contiguous()
    else:
        flat = torch.cat([leaf.reshape(b, n, -1) for leaf in leaves], dim=2)
    return flat, layout


def unflatten_lane_aggregate(vec: torch.Tensor, layout: StackLayout) -> PyTree:
    """Per-lane aggregates (B, D) as a pytree of (B, ...) views."""
    b = vec.shape[0]
    leaves = [vec[:, off:off + size].view((b,) + shape)
              for off, size, shape in layout.segments]
    return tree_unflatten(layout.structure, leaves)


# ---------------------------------------------------------------------------
# Primitive dispatchers.
# ---------------------------------------------------------------------------

def _used(x: torch.Tensor) -> tuple[str, str]:
    if x.device.type == "cuda":
        return "cuda", ""
    return "plain", "CPU stack: the kernel's plain version"


def dispatch_gram(x: torch.Tensor, *, backend: str,
                  sh: Optional[shardlib.ShardCtx] = None) -> torch.Tensor:
    """(n, D) -> (n, n) fp32 Gram matrix through the chosen backend; with
    ``sh`` ``x`` is this rank's block and the partials are all-reduced."""
    if sh is not None:
        record_decision("gram", backend, *_used(x))
        return shardlib.sharded_gram(x, mesh=sh.mesh, axis=sh.axis)
    if backend == "cuda":
        record_decision("gram", backend, *_used(x))
        return _gram_op(x)
    record_decision("gram", backend, "torch")
    return _gram_ref(x)


#: Columns of one row folded per step of :func:`sketch_fold` (bounds its
#: temporaries; a bf16 stack widens to fp32 one such step at a time).
SKETCH_CHUNK = 1 << 24


def sketch_fold(x: torch.Tensor, segments, sketch_dim: int, signs: list,
                *, chunk: int = SKETCH_CHUNK,
                out: Optional[torch.Tensor] = None,
                c0: int = 0) -> torch.Tensor:
    """The signed sketch (L, n, sketch_dim) fp32 of an (L, n, D) stack.

    Every ``(offset, size)`` of ``segments`` is one leaf: cut from its own
    offset into chunks of ``sketch_dim`` columns, the last one padded with
    zeros, and chunk c of lane l added with sign ``signs[i][l, c]`` (leaf
    i's (L, ceil(size / sketch_dim)) ±1 tensor; a (C,) tensor when L = 1).
    A segment's full chunks are folded as (n, k, sketch_dim) views, a
    partial chunk at either end on its own, so no padded copy of the stack
    is made.  ``out``: an (L, n, sketch_dim) fp32 sketch to add into (and
    return).  ``c0``: ``x`` holds the global columns [c0, c0 + w) of a
    wider stack (one rank's block; ``segments`` stay global): its part of
    the sketch, which summed over the blocks is the whole stack's."""
    lanes, n, w = x.shape
    s = sketch_dim
    sk = out if out is not None else torch.zeros(
        (lanes, n, s), dtype=torch.float32, device=x.device)
    step = max(1, chunk // s)
    for (off, size), sg in zip(segments, signs):
        # The leaf's columns [lo, hi) that lie in the block.
        lo, hi = max(off, c0) - off, min(off + size, c0 + w) - off
        if lo >= hi:
            continue
        sg = torch.as_tensor(sg).to(device=x.device,
                                    dtype=torch.float32).reshape(lanes, -1)
        base = off - c0                     # x's column of the leaf's 0
        head = min(hi, -(-lo // s) * s)     # lo's chunk, when lo is inside it
        if head > lo:
            v = x[:, :, base + lo:base + head].float()
            sk[:, :, lo % s:lo % s + head - lo] += \
                sg[:, lo // s, None, None] * v
        first, full = head // s, hi // s
        for k0 in range(first, full, step):
            k1 = min(k0 + step, full)
            v = x[:, :, base + k0 * s:base + k1 * s].reshape(
                lanes, n, k1 - k0, s).float()
            sk += torch.matmul(sg[:, None, None, k0:k1], v)[:, :, 0]
        t = max(head, full * s)
        if hi > t:
            v = x[:, :, base + t:base + hi].float()
            sk[:, :, :hi - t] += sg[:, full, None, None] * v
    return sk


def sketch_fold_model(x: torch.Tensor, sketch_dim: int, signs: list, *,
                      mc: shardlib.ModelColumns, local: tuple,
                      chunk: int = SKETCH_CHUNK) -> torch.Tensor:
    """A model shard's part of the whole leaves' sketch: ``x`` (L, n, w)
    holds the columns [local[0], local[1]) of the shard's ``mc`` columns;
    each of its elements is folded at ``g % sketch_dim`` with the sign of
    chunk ``g // sketch_dim``, ``g`` its flat index in the WHOLE leaf
    (``signs[i]`` leaf i's, drawn on the whole widths ``mc.whole``).  A
    replicated leaf's piece is contiguous in its whole leaf; a split
    leaf's shard is runs of ``mc.runs[i]`` elements, one in every k, and
    a group of runs is folded from a buffer that holds them at their
    whole-leaf places (zeros between), at most ``chunk`` runs' elements
    at a time.  Summed over the model shards and their blocks, this is
    :func:`sketch_fold` of the whole stack."""
    lanes, n, _ = x.shape
    l0, l1 = local
    k, j = mc.k, mc.index
    sk = torch.zeros((lanes, n, sketch_dim), dtype=torch.float32,
                     device=x.device)
    for i, ((off, size), (a, _)) in enumerate(zip(mc.segments(), mc.pieces)):
        c0, c1 = max(off, l0), min(off + size, l1)
        if c0 >= c1:
            continue
        e0, e1 = a + c0 - off, a + c1 - off     # the leaf's local elements
        seg, sg = [(0, mc.whole[i])], [signs[i]]

        def cols(lo, hi):
            return x[:, :, c0 - l0 + lo - e0:c0 - l0 + hi - e0]
        if not mc.split[i]:
            sketch_fold(cols(e0, e1), seg, sketch_dim, sg, out=sk, c0=e0)
            continue
        run = mc.runs[i]
        step = max(1, chunk // (k * run))
        for ra in range(e0 // run, -(-e1 // run), step):
            rb = min(ra + step, -(-e1 // run))
            lo, hi = max(e0, ra * run), min(e1, rb * run)
            if rb - ra == 1:                    # one run: contiguous
                sketch_fold(cols(lo, hi), seg, sketch_dim, sg, out=sk,
                            c0=(ra * k + j) * run + lo - ra * run)
                continue
            part = x.new_zeros((lanes, n, (rb - ra) * run))
            part[:, :, lo - ra * run:hi - ra * run] = cols(lo, hi)
            buf = x.new_zeros((lanes, n, rb - ra, k, run))
            buf[:, :, :, j] = part.view(lanes, n, rb - ra, run)
            del part
            sketch_fold(buf.view(lanes, n, -1), seg, sketch_dim, sg, out=sk,
                        c0=ra * k * run)
            del buf
    return sk


def dispatch_sketch_gram(x: torch.Tensor, segments, sketch_dim: int,
                         signs: list, *, backend: str,
                         sh: Optional[shardlib.ShardCtx] = None,
                         d: Optional[int] = None) -> torch.Tensor:
    """The sketch Gram of an (n, D) stack ((B, n, D) with (B, C_i) signs
    per leaf gives (B, n, n)): :func:`sketch_fold`, then sk sk^T, both
    torch ops on every backend, recorded as the ``"sketch_gram"``
    decision (no kernel: K1 is skipped).  With ``sh``, ``x`` is this
    rank's column block of a D-wide stack: its part of the sketch
    (:func:`sketch_fold` from its first column) is all-reduced before
    the product; a block of a model shard's columns (``sh.columns``) is
    folded where its whole leaves hold its elements
    (:func:`sketch_fold_model`)."""
    record_decision("sketch_gram", backend, "torch",
                    "sketch_dim: the signed sketch fold and its Gram are "
                    "torch contractions (no kernel in the reference either)")
    lanes = x.dim() == 3
    x3 = x if lanes else x[None]
    if sh is not None:
        mc = sh.columns
        if mc is not None:
            sk = sketch_fold_model(x3, sketch_dim, signs, mc=mc,
                                   local=(sh.span[0] - mc.offset,
                                          sh.span[1] - mc.offset))
        else:
            sk = sketch_fold(x3, segments, sketch_dim, signs,
                             c0=sh.cols(d)[0])
        sk = sh.mesh.all_reduce(sk, sh.axis)
    else:
        sk = sketch_fold(x3, segments, sketch_dim, signs)
    g = sk @ sk.mT
    return g if lanes else g[0]


def dispatch_gram_batched(x: torch.Tensor, *, backend: str,
                          sh: Optional[shardlib.ShardCtx] = None
                          ) -> torch.Tensor:
    """(B, n, D) -> (B, n, n): the lane-batched Gram pass, one launch for a
    whole fleet bucket (K5); with ``sh`` K5 on this rank's block and an
    all-reduce of the partials."""
    if sh is not None:
        record_decision("gram_batched", backend, *_used(x))
        return shardlib.sharded_gram(x, mesh=sh.mesh, axis=sh.axis)
    if backend == "cuda":
        record_decision("gram_batched", backend, *_used(x))
        return _gram_batched_op(x)
    record_decision("gram_batched", backend, "torch")
    return _gram_batched_ref(x)


def dispatch_bucketgram(x: torch.Tensor, assignment: torch.Tensor,
                        n_buckets: int, *, backend: str,
                        with_gram: bool = True,
                        sh: Optional[shardlib.ShardCtx] = None
                        ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(n, D) stack + (n,) bucket ids -> (bucket means (n_b, D) in the
    stack dtype, reduced (n_b, n_b) fp32 Gram | None): the hierarchical
    pre-reduction.  "cuda" launches K6 (``with_gram``) or K7; the torch
    backend runs the dense plain version.

    The lane form: x (B, n, D) and (B, n) bucket ids, one row a lane ->
    ((B, n_b, D), (B, n_b, n_b) | None), every lane in one launch of K6 /
    K7's lane form (K5 on the means above 8 buckets).

    With ``sh`` (one lane): ``x`` is this rank's block ((n, D/k), or its
    worker tile on the 2-D form) and ``shard.sharded_bucketgram`` runs K6
    / K7 on it with its collectives."""
    if sh is not None:
        two_d = sh.worker_axis is not None
        name = "bucketmeans" if two_d or not with_gram else "bucketgram"
        record_decision(name, backend, *_used(x))
        if two_d and with_gram:
            record_decision("gram", backend, _used(x)[0],
                            "2-D hierarchical form: the Gram of the summed "
                            "means is a K1 launch")
        elif with_gram and n_buckets > _BUCKETGRAM_REG_NB:
            record_decision("gram", backend, _used(x)[0],
                            f"n_b={n_buckets} > {_BUCKETGRAM_REG_NB}: the "
                            f"Gram of the fp32 means is a K1 launch")
        return shardlib.sharded_bucketgram(
            x, assignment, n_buckets, mesh=sh.mesh,
            worker_axis=sh.worker_axis, model_axis=sh.axis,
            with_gram=with_gram)
    lanes = x.dim() == 3
    name = ("bucketgram" if with_gram else "bucketmeans") + (
        "_lanes" if lanes else "")
    if backend == "cuda":
        record_decision(name, backend, *_used(x))
        if with_gram and n_buckets > _BUCKETGRAM_REG_NB:
            record_decision("gram_batched" if lanes else "gram", backend,
                            _used(x)[0],
                            f"n_b={n_buckets} > {_BUCKETGRAM_REG_NB}: the "
                            f"Gram of the fp32 means is a "
                            f"{'K5' if lanes else 'K1'} launch")
        if lanes:
            if with_gram:
                return _bucketgram_lanes_op(x, assignment, n_buckets)
            return _bucketmeans_lanes_op(x, assignment, n_buckets), None
        if with_gram:
            return _bucketgram_op(x, assignment, n_buckets)
        return _bucketmeans_op(x, assignment, n_buckets), None
    record_decision(name, backend, "torch")
    if lanes:
        return _bucketgram_lanes_ref(x, assignment, n_buckets,
                                     with_gram=with_gram)
    bmat = _assignment_matrix(assignment.to(x.device), n_buckets)
    return _bucketgram_ref(x, bmat, with_gram=with_gram)


def dispatch_bucketgram_perms(x: torch.Tensor, perms: torch.Tensor,
                              bucket_size: int, *, backend: str,
                              with_gram: bool = True
                              ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The lane form of :func:`dispatch_bucketgram` from what the
    hierarchical lanes hold: (B, n, D) and each lane's (B, n) int64
    permutation, buckets of ``bucket_size`` in permutation order (worker i
    in bucket argsort(perms[b])[i] // s) -> ((B, n_b, D), (B, n_b, n_b) |
    None).  "cuda" launches K6 / K7's lane form, which builds each lane's
    plan on the device: no value is read back and no torch op runs before
    the launch; the torch backend runs the dense plain version on those
    ids."""
    n_buckets = -(-x.shape[1] // bucket_size)
    name = ("bucketgram" if with_gram else "bucketmeans") + "_lanes"
    perms = perms.contiguous()
    if backend == "cuda":
        record_decision(name, backend, *_used(x))
        if with_gram and n_buckets > _BUCKETGRAM_REG_NB:
            record_decision("gram_batched", backend, _used(x)[0],
                            f"n_b={n_buckets} > {_BUCKETGRAM_REG_NB}: the "
                            f"Gram of the fp32 means is a K5 launch")
        if with_gram:
            return _bucketgram_perms_op(x, perms, bucket_size)
        return _bucketmeans_perms_op(x, perms, bucket_size), None
    record_decision(name, backend, "torch")
    return _bucketgram_lanes_ref(x, _perm_assignment(perms, bucket_size),
                                 n_buckets, with_gram=with_gram)


def dispatch_combine(x: torch.Tensor, coeff: torch.Tensor, *,
                     backend: str, sh: Optional[shardlib.ShardCtx] = None
                     ) -> torch.Tensor:
    """(n, D), (n,) -> (D,): streamed linear combination; (B, n, D), (B,
    n) -> (B, D): every lane in one launch of K3's lane form.  With
    ``sh``: this rank's slice, shard-local."""
    lanes = x.dim() == 3
    name = "combine_lanes" if lanes else "combine"
    if sh is not None:
        record_decision(name, backend, *_used(x))
        return shardlib.sharded_combine(x, coeff, mesh=sh.mesh, axis=sh.axis)
    if backend == "cuda":
        record_decision(name, backend, *_used(x))
        return (_combine_lanes_op if lanes else _combine_op)(x, coeff)
    record_decision(name, backend, "torch")
    return (_combine_lanes_ref if lanes else _combine_ref)(x, coeff)


def dispatch_mixtrim(x: torch.Tensor, m: Optional[torch.Tensor], f, *,
                     mode: str, backend: str, dyn: bool = False,
                     sh: Optional[shardlib.ShardCtx] = None
                     ) -> torch.Tensor:
    """(n, D) -> (D,): fused mix + coordinate trim/median (``m=None``
    skips the mix).

    ``dyn=True`` is the fleet's form: x (B, n, D), m (B, n, n) or None and
    f a (B,) int tensor -> (B, D), every lane in one launch: "trim" runs
    K4; "med" ignores f and runs K2's median lane form (the reference
    vmaps its static kernel there).  With ``sh``: this rank's slice,
    shard-local."""
    if sh is not None:
        name = "mixtrim" if not dyn else (
            "mixtrim_dyn" if mode == "trim" else "mixtrim_lanes")
        record_decision(name, backend, *_used(x))
        return shardlib.sharded_mixtrim(x, m, f, mode=mode, mesh=sh.mesh,
                                        axis=sh.axis, dyn=dyn)
    if dyn:
        return _dispatch_mixtrim_lanes(x, m, f, mode=mode, backend=backend)
    f = 0 if mode == "med" else int(f)
    if backend == "cuda":
        record_decision("mixtrim", backend, *_used(x))
        return _mixtrim_op(x, m, f, mode=mode)
    record_decision("mixtrim", backend, "torch")
    return _mixtrim_ref(x, m, f, mode)


def _dispatch_mixtrim_lanes(x: torch.Tensor, m: Optional[torch.Tensor], f,
                            *, mode: str, backend: str) -> torch.Tensor:
    trim = mode == "trim"
    name = "mixtrim_dyn" if trim else "mixtrim_lanes"
    if backend == "cuda":
        record_decision(name, backend, *_used(x))
        return _mixtrim_dyn_op(x, m, f, mode=mode) if trim \
            else _mixtrim_lanes_op(x, m)
    record_decision(name, backend, "torch")
    return _mixtrim_dyn_ref(x, m, f, mode) if trim \
        else _mixtrim_lanes_ref(x, m)


def dispatch_meamed(x: torch.Tensor, m: Optional[torch.Tensor], f, *,
                    backend: str, dyn: bool = False,
                    sh: Optional[shardlib.ShardCtx] = None) -> torch.Tensor:
    """meamed on the flat buffer.  No kernel exists (as in the reference),
    so this is always a RECORDED torch-ops decision.  ``dyn=True``: x (B,
    n, D), m (B, n, n) or None, f (B,) int tensor -> (B, D).  With
    ``sh`` the torch form runs on this rank's block (shard-local)."""
    if sh is not None:
        record_decision("mixtrim", backend, "torch",
                        "meamed has no fused kernel (shard-local torch form)")
        return shardlib.sharded_meamed(x, m, f, mesh=sh.mesh, axis=sh.axis,
                                       dyn=dyn)
    record_decision("mixtrim", backend, "torch", "meamed has no fused kernel")
    from repro_torch.core.robust import _coordinate_rule, _coordinate_rule_lanes
    mixed = x if m is None else m.float() @ x.float()
    if dyn:
        return _coordinate_rule_lanes(mixed, "meamed", f)
    return _coordinate_rule(mixed, "meamed", f)
