"""Robust aggregation over *pytrees* of per-worker stacks (static f).

Counterpart of ``repro.core.robust.robust_aggregate``.  Inputs are pytrees
whose every leaf carries a leading worker axis n; the output is the
aggregated pytree without it.

Two execution strategies, as in the reference:

* **gram path** (average / krum / multikrum / gm / autogm / mda, with or
  without NNM): the (n, n) Gram matrix, coefficients from G alone, one
  linear combination.
* **coordinate path** (cwtm / cwmed / meamed): optionally mix with the NNM
  matrix, then sort / trim along the worker axis.

``AggregatorSpec.backend`` routes through :mod:`repro_torch.kernels.dispatch`:
"torch" is the leaf-streamed path below (the reference's "xla"); "cuda"
flattens the stack to one (n, D) buffer and runs the gram (K1), combine
(K3) and fused mix+trim (K2) kernels, so the NNM-mixed stack never exists
in device memory; "auto" is "cuda" for a CUDA stack and "torch" otherwise.

Bucketing stages (both need a permutation: a ``torch.Generator`` or an
explicit ``perm``, where the reference takes a PRNG ``key``):

* ``pre="bucketing"`` — the paper's randomized baseline: the gather form
  (:func:`_tree_bucket`, torch ops on every backend, as in the reference)
  feeds ceil(n/s) bucket means and the adjusted f to the pipeline;
* ``hier=True`` — hierarchical aggregation: on "cuda" the bucketgram
  kernel reduces the flat stack to the bucket means AND their Gram in one
  pass (K6; means only, K7, when no Gram consumer follows), so the K1
  pass is skipped; on "torch" the gather form runs.  Bucket size 1 is
  the identity and stays bitwise the dense pipeline (no permutation is
  drawn).

Dynamic-f path (the fleet): :func:`robust_aggregate_dyn` takes f as an
int tensor and :func:`batched_robust_aggregate` a lane-batched stack
(every leaf (B, n, ...)) with one f per lane.  Trimming and neighbour
selection go through rank masks (``*_dyn`` in :mod:`repro_torch.core.gram`).
The reference gets its lane axis from ``jax.vmap``; the CUDA kernels
cannot run under ``torch.func.vmap``, so the port writes the lane axis
out: on "cuda" the stacks flatten to (B, n, D), hierarchical lanes reduce
to their bucket means in one launch (K6 / K7's lane form, each lane with
its own permutation), K5 gives every lane's Gram in one launch (skipped
when K6 gave it), the (n, n) math runs batched in torch, and one launch
applies every lane's rule: K4 trims, K2's median lane form takes cwmed,
K3's lane form the gram rules.  On "torch" the leaf-streamed math runs
with the lane axis batched (hier: the gather form).  Hierarchical lanes
need an explicit ``bucket_size``, clamped to ``max(1, min(s, n))`` (the
dynamic form; the floor(n/2f) default depends on f).

Sketch Gram (``AggregatorSpec.sketch_dim``): the Gram is taken of a
signed (n, sketch_dim) sketch of the stack (:func:`tree_sketch_gram`;
one ±1 sign per ``sketch_dim``-column chunk of each leaf, drawn per leaf
in leaf order, the reference's ``fold_in(key, i)``); the rule's
coefficients come from it (Krum, Multi-Krum, GM, AutoGM, MDA and NNM's
neighbours), and they are applied to the exact stack.  The sketch runs
only when randomness is given: a ``generator`` (drawn after the bucket
permutation) or explicit ``signs``; with neither the exact Gram is taken,
as the reference does with ``key=None``.  On "cuda" it replaces K1.
:func:`draw_randomness` draws once what an aggregate would draw, so
that several aggregates (the ``_opt`` eta searches) share one draw.

Multi-rank backends (the reference's ``pallas_sharded`` / ``pallas_hier``):
under a mesh of a ``torch.distributed`` world (:mod:`repro_torch.launch.
mesh`), "cuda_sharded" runs the kernel pipeline on each rank's column
block of the flat stack (:mod:`repro_torch.kernels.shard`: the Grams
all-reduced, combine / mix+trim shard-local) and gathers the aggregate;
"cuda_hier" implies the hierarchical stage (:func:`_hier_active`) and, on
a 2-D (workers x model) mesh, splits the stack along worker rows too.
:func:`robust_aggregate` and the dynamic / lane forms take the whole
(replicated) stack on every rank and return the whole aggregate;
:func:`robust_aggregate_block` takes one rank's block and returns its
slice (the trainer's ``worker_axes`` path).  Without a multi-rank mesh
"cuda_sharded" runs the torch path and "cuda_hier" the dense bucketing
path, each with a recorded ``pipeline`` fallback naming why, as the
reference degrades.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import bucketing as bucketlib
from repro_torch.core import gram as gramlib
from repro_torch.core.aggregators import _median
from repro_torch.core.types import AggregatorSpec, COORDINATE_RULES, GRAM_RULES
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels import shard as shardlib
from repro_torch.kernels._common import sort_nan_last
from repro_torch.kernels.gram import gram_batched_ref, gram_ref
from repro_torch.tree import (
    tree_leaves, tree_map, tree_structure, tree_unflatten,
)

PyTree = Any
Tensor = torch.Tensor


def tree_gram(tree: PyTree) -> Tensor:
    """Accumulate the (n, n) fp32 Gram matrix over all leaves (fp32
    products of the leaf's own values: a bf16 stack widens exactly; wide
    leaves contract in column chunks, see ``gram_ref``)."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    g = torch.zeros((n, n), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        g = g + gram_ref(leaf.reshape(n, -1))
    return g


def leaf_widths(tree: PyTree) -> list:
    """Per-leaf flat width of a worker-stacked pytree (leaves (n, ...))."""
    return [leaf[0].numel() for leaf in tree_leaves(tree)]


def draw_signs(widths, sketch_dim: int, generator: torch.Generator,
               device=None) -> list:
    """The sketch's signs: for each leaf of flat width d, in leaf order,
    ceil(d / sketch_dim) fp32 ±1 values drawn from ``generator`` (the
    reference draws ``rademacher(fold_in(key, i), ...)`` for leaf i)."""
    out = []
    for d in widths:
        bits = torch.randint(0, 2, (-(-int(d) // sketch_dim),),
                             generator=generator, device=generator.device)
        out.append((bits.float() * 2.0 - 1.0).to(device))
    return out


def tree_sketch_gram(tree: PyTree, sketch_dim: int, signs: list) -> Tensor:
    """(n, n) fp32 Gram of the signed sketch of a worker-stacked pytree:
    each leaf's rows, cut into ``sketch_dim``-column chunks (the last one
    zero-padded) and summed with the leaf's per-chunk ``signs``, added up
    over the leaves into one (n, sketch_dim) sketch.  Distance ranks are
    preserved with high probability; coefficients still apply to the
    exact stack.  Leaves (B, n, ...) with (B, C_i) signs give (B, n, n)
    (see :func:`tree_sketch_gram_lanes`)."""
    return tree_sketch_gram_lanes(tree_map(lambda leaf: leaf[None], tree),
                                  sketch_dim,
                                  [torch.as_tensor(sg)[None] for sg in signs])[0]


def tree_sketch_gram_lanes(tree: PyTree, sketch_dim: int, signs: list
                           ) -> Tensor:
    """:func:`tree_sketch_gram` per lane: leaves (B, n, ...), signs one
    (B, C_i) tensor per leaf; returns (B, n, n).  Each leaf is padded to
    whole chunks and contracted with its signs, as the reference does;
    the kernel backend's ``kdispatch.sketch_fold`` folds the flat stack
    without the padded copy and is held against this form."""
    leaves = tree_leaves(tree)
    b, n = leaves[0].shape[:2]
    sk = torch.zeros((b, n, sketch_dim), dtype=torch.float32,
                     device=leaves[0].device)
    for leaf, sg in zip(leaves, signs):
        x = leaf.reshape(b, n, -1)
        x = torch.nn.functional.pad(x, (0, (-x.shape[2]) % sketch_dim))
        sg = torch.as_tensor(sg).to(device=x.device, dtype=torch.float32)
        sk = sk + torch.einsum("bncs,bc->bns",
                               x.reshape(b, n, -1, sketch_dim).float(),
                               sg.reshape(b, -1))
    return sk @ sk.mT


def _sketch_signs(tree: PyTree, spec: AggregatorSpec,
                  generator: Optional[torch.Generator],
                  signs: Optional[list]) -> Optional[list]:
    """The sketch's per-leaf signs: ``signs`` as given, else drawn from
    ``generator``; None (the exact Gram) without ``sketch_dim`` or
    randomness."""
    if not spec.sketch_dim:
        return None
    dev = tree_leaves(tree)[0].device
    if signs is not None:
        return [torch.as_tensor(sg).to(device=dev, dtype=torch.float32)
                for sg in signs]
    if generator is None:
        return None
    return draw_signs(leaf_widths(tree), spec.sketch_dim, generator, dev)


def draw_randomness(tree: PyTree, spec: AggregatorSpec, *,
                    generator: Optional[torch.Generator] = None,
                    perm: Optional[Tensor] = None,
                    signs: Optional[list] = None
                    ) -> tuple[Optional[Tensor], Optional[list]]:
    """(perm, signs): the randomness of one aggregate of ``tree`` under
    ``spec``, in its draw order from ``generator``: the bucket permutation
    (``pre="bucketing"``, or ``hier`` with buckets of more than one), then
    the sketch's signs (``sketch_dim``); given values pass through.
    :func:`robust_aggregate` draws through here, so a caller that runs
    several aggregates on one draw (the ``_opt`` eta searches) calls it
    once and passes ``perm=`` / ``signs=``: ``generator`` then ends where
    one aggregate leaves it."""
    leaf = tree_leaves(tree)[0]
    n = leaf.shape[0]
    if perm is None and generator is not None and (
            spec.pre == "bucketing"
            or (_hier_active(spec) and bucketlib.clamp_bucket_size(
                n, spec.bucket_size, spec.f) > 1)):
        perm = bucketlib.draw_perm(n, generator=generator, device=leaf.device)
    return perm, _sketch_signs(tree, spec, generator, signs)


def tree_combine(tree: PyTree, coeff: Tensor) -> PyTree:
    """R = coeff @ X leaf by leaf; coeff is rounded to the leaf's dtype and
    the contraction accumulates in fp32."""
    def comb(leaf):
        n = leaf.shape[0]
        c = coeff.to(leaf.dtype).float()
        return (c @ leaf.reshape(n, -1).float()).reshape(leaf.shape[1:])
    return tree_map(comb, tree)


def tree_mix(tree: PyTree, m: Tensor) -> PyTree:
    """Y = M @ X leaf by leaf, keeping the worker axis; M is rounded to the
    leaf's dtype, the result is fp32."""
    def mix(leaf):
        n = leaf.shape[0]
        y = m.to(leaf.dtype).float() @ leaf.reshape(n, -1).float()
        return y.reshape((m.shape[0],) + tuple(leaf.shape[1:]))
    return tree_map(mix, tree)


def _coordinate_rule(x: Tensor, rule: str, f: int,
                     internals: Optional[dict] = None) -> Tensor:
    """A coordinate-wise rule along axis 0 of one (n, ...) stack, fp32;
    cwtm appends its sorted stack to ``internals["sorted_leaves"]``."""
    n = x.shape[0]
    x = x.float()
    if rule == "cwmed":
        return _median(x)
    if rule == "cwtm":
        if f == 0:
            return x.mean(dim=0)
        xs = sort_nan_last(x, 0)
        if internals is not None:
            internals.setdefault("sorted_leaves", []).append(xs)
        return xs[f: n - f].mean(dim=0)
    if rule == "meamed":
        med = _median(x)[None]
        order = torch.argsort(torch.abs(x - med), dim=0, stable=True)
        xs = torch.take_along_dim(x, order, dim=0)
        return xs[: n - f].mean(dim=0)
    raise ValueError(rule)


def _tree_coordinate_rule(tree: PyTree, rule: str, f: int,
                          internals: Optional[dict] = None) -> PyTree:
    """Apply a coordinate-wise rule along the worker axis of every leaf,
    in leaf order (``internals``: see :func:`_coordinate_rule`)."""
    return tree_unflatten(tree_structure(tree), [
        _coordinate_rule(leaf, rule, f, internals)
        for leaf in tree_leaves(tree)])


def _tree_bucket(tree: PyTree, f: int, perm: Tensor,
                 bucket_size: Optional[int]) -> tuple[PyTree, int]:
    """Bucketing on pytrees (the gather form): one shared permutation
    across all leaves, ragged tail renormalized by its true occupancy,
    fp32 accumulation cast back to each leaf's dtype.

    When every leaf has one dtype the means land in ONE (n_b, D) buffer
    and the leaves come back as views of it, so the kernel path flattens
    them without a copy."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    s = bucketlib.clamp_bucket_size(n, bucket_size, f)
    nb = bucketlib.num_buckets(n, s)
    pad = nb * s - n
    counts = bucketlib.bucket_counts(n, s, device=leaves[0].device)

    def bucket(leaf):
        acc = torch.promote_types(leaf.dtype, torch.float32)
        x = leaf[perm].to(acc)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(leaf.shape[1:]))])
        sums = x.reshape((nb, s) + tuple(leaf.shape[1:])).sum(dim=1)
        means = sums / counts.to(acc).reshape((nb,) + (1,) * (leaf.dim() - 1))
        return means.to(leaf.dtype)

    f_adj = bucketlib.adjusted_f(f, nb)
    if len({leaf.dtype for leaf in leaves}) != 1:
        return tree_map(bucket, tree), f_adj
    layout = kdispatch.stack_layout(tree)
    flat = torch.empty((nb, layout.width), dtype=leaves[0].dtype,
                       device=leaves[0].device)
    for leaf, (off, size, _) in zip(leaves, layout.segments):
        flat[:, off:off + size] = bucket(leaf).reshape(nb, size)
    return kdispatch.stack_views(flat, dataclasses.replace(layout, n=nb)), f_adj


def _stack_perm(tree: PyTree, perm: Tensor) -> Tensor:
    leaf = tree_leaves(tree)[0]
    return bucketlib.draw_perm(leaf.shape[0], perm=perm, device=leaf.device)


def _hier_active(spec: AggregatorSpec) -> bool:
    """A hierarchical bucketing stage runs when the spec opts in OR the
    hierarchical backend is requested (the backend implies the stage)."""
    return bool(spec.hier) or spec.backend == "cuda_hier"


def _validate_hier(spec: AggregatorSpec) -> None:
    if spec.pre == "bucketing":
        raise ValueError(
            "hierarchical aggregation IS a bucketing stage; composing it "
            "with pre='bucketing' would bucket twice — use pre='nnm' or "
            "pre=None")
    if spec.sketch_dim:
        raise ValueError(
            "hierarchical aggregation is incompatible with sketch_dim: the "
            "signed-sketch gram has no reduced-population form")


def validate_taps(spec: AggregatorSpec) -> None:
    """Health taps are refused with the hierarchical stage: it aggregates
    ceil(n/s) bucket means, so the NNM matrix and the trim act on those
    rows and not on the n workers' (the reference's taps fail there with
    a broadcasting TypeError, (n_b,) against (n,), or count the raw rows'
    trim the rule never made)."""
    if _hier_active(spec):
        raise ValueError(
            "health taps are not defined with hier=True: the hierarchical "
            "stage aggregates ceil(n/s) bucket means, so the NNM matrix and "
            "the trim act on n_b rows, not on the n workers' rows (the "
            "reference's taps fail there with a broadcasting TypeError, "
            "shapes (n_b,) and (n,)); run the taps with pre='nnm' or "
            "pre=None")


def _validate(spec: AggregatorSpec) -> None:
    if _hier_active(spec):
        _validate_hier(spec)
    if spec.pre not in (None, "none", "nnm", "bucketing"):
        raise ValueError(f"unknown pre-aggregation {spec.pre!r}")
    if spec.transport_dtype not in (None, "bf16"):
        raise ValueError(f"unknown transport_dtype {spec.transport_dtype!r}")


def _need_perm_source(generator, perm, what: str) -> None:
    if generator is None and perm is None:
        raise ValueError(f"{what} requires a torch.Generator or a perm")


_HIER_S1_NOTE = "s=1: singleton buckets, identity reduction (skipped)"


def _hier_reduce_flat(flat: Tensor, spec: AggregatorSpec, f: int, *,
                      perm: Optional[Tensor], backend: str,
                      sh: Optional[shardlib.ShardCtx] = None,
                      n: Optional[int] = None
                      ) -> tuple[Tensor, int, Optional[Tensor]]:
    """The hierarchical pre-reduction on the flattened (n, D) stack (with
    ``sh``: this rank's block or, on the 2-D form, its worker tile of the
    ``n`` workers).

    Returns (reduced stack (ceil(n/s), D), adjusted f, reduced fp32 Gram
    or None).  s = 1 short-circuits to the identity (no permutation is
    drawn for it), which keeps hier(s=1) bitwise the dense pipeline."""
    n = flat.shape[0] if n is None else n
    s = bucketlib.clamp_bucket_size(n, spec.bucket_size, f)
    if s == 1:
        kdispatch.record_decision("bucketgram", backend, "skipped",
                                  _HIER_S1_NOTE)
        return flat, f, None
    nb = bucketlib.num_buckets(n, s)
    assign = bucketlib.bucket_assignment(n, s, perm=perm, device=flat.device)
    need_gram = spec.rule in GRAM_RULES or spec.pre == "nnm"
    y, g = kdispatch.dispatch_bucketgram(flat, assign, nb, backend=backend,
                                         with_gram=need_gram, sh=sh)
    return y, bucketlib.adjusted_f(f, nb), g


def _hier_tiles(spec: AggregatorSpec, sh: Optional[shardlib.ShardCtx],
                n: int, s: int) -> bool:
    """Whether this rank holds a worker tile (the 2-D hierarchical form
    with buckets of more than one) rather than all n rows."""
    return sh is not None and sh.worker_axis is not None \
        and _hier_active(spec) and s > 1


def _flat_pipeline(x: Tensor, segments: list, spec: AggregatorSpec, f: int,
                   *, perm=None, signs=None, internals: Optional[dict] = None,
                   backend: str = "cuda",
                   sh: Optional[shardlib.ShardCtx] = None,
                   n: Optional[int] = None, d: Optional[int] = None
                   ) -> tuple[Tensor, Optional[Tensor]]:
    """The kernel pipeline on one (n, D) buffer (with ``sh``: this rank's
    block of an n x D stack): [bucketgram (K6 / K7) when hier] -> gram
    (K1, skipped when K6 gave the Gram; the sketch Gram instead when
    ``signs``, over the leaf ``segments``) -> NNM / coefficients ->
    combine (K3) or fused mix+trim (K2).  Returns (the (D,) fp32 vector,
    or this rank's slice of it; the coefficients of a gram rule or None).
    ``internals`` gets the NNM matrix only: K2 writes no mixed or sorted
    stack."""
    mix_matrix, g = None, None
    if _hier_active(spec):
        x, f, g = _hier_reduce_flat(x, spec, f, perm=perm, backend=backend,
                                    sh=sh, n=n)
    if (spec.rule in GRAM_RULES or spec.pre == "nnm") and g is None:
        if signs is not None:
            g = kdispatch.dispatch_sketch_gram(
                x, segments, spec.sketch_dim, signs, backend=backend, sh=sh,
                d=d)
        else:
            g = kdispatch.dispatch_gram(x, backend=backend, sh=sh)
    if spec.pre == "nnm":
        mix_matrix = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g), f)
        if internals is not None:
            internals["mix_matrix"] = mix_matrix
        g = gramlib.mixed_gram(g, mix_matrix)

    if spec.rule in GRAM_RULES:
        if spec.rule == "autogm":
            kdispatch.record_decision(
                "autogm_coeff", backend, "torch",
                "autogm adaptive-weight solve is gram-space math with no "
                "kernel form")
        coeff = gramlib.coeff_for_rule(
            spec.rule, g, f, gm_iters=spec.gm_iters, gm_eps=spec.gm_eps,
            autogm_lamb=spec.autogm_lamb, autogm_iters=spec.autogm_iters)
        if mix_matrix is not None:
            coeff = coeff @ mix_matrix   # R = c^T (M X) = (c^T M) X
        vec = kdispatch.dispatch_combine(x, coeff.contiguous(),
                                         backend=backend, sh=sh)
        return vec, coeff

    if spec.rule in COORDINATE_RULES:
        # With NNM, M is rounded to the stack dtype first — the rounding
        # tree_mix applies — so bf16-transport runs agree across backends.
        m = None if mix_matrix is None else mix_matrix.to(x.dtype)
        if spec.rule == "meamed":
            vec = kdispatch.dispatch_meamed(x, m, f, backend=backend, sh=sh)
        else:
            mode = "med" if spec.rule == "cwmed" else "trim"
            vec = kdispatch.dispatch_mixtrim(x, m, f, mode=mode,
                                             backend=backend, sh=sh)
        return vec, None

    raise ValueError(f"unknown rule {spec.rule!r}")


def _aggregate_flat(work: PyTree, spec: AggregatorSpec, f: int, *,
                    return_coeff: bool, perm=None, signs=None,
                    internals: Optional[dict] = None, backend: str = "cuda",
                    sh: Optional[shardlib.ShardCtx] = None) -> PyTree:
    """Kernel pipeline (:func:`_flat_pipeline`) on the stack as one
    (n, D) buffer -> aggregated pytree (views of one (D,) fp32 vector).
    With ``sh`` every rank takes its block of the (replicated) stack, runs
    the pipeline on it and the slices are gathered."""
    flat, layout = kdispatch.flatten_worker_stack(work)
    segments = [(off, size) for off, size, _ in layout.segments]
    if sh is None:
        vec, coeff = _flat_pipeline(flat, segments, spec, f, perm=perm,
                                    signs=signs, internals=internals,
                                    backend=backend)
    else:
        n = layout.n
        s = bucketlib.clamp_bucket_size(n, spec.bucket_size, f)
        block = sh.take(flat, tile=_hier_tiles(spec, sh, n, s))
        local, coeff = _flat_pipeline(block, segments, spec, f, perm=perm,
                                      signs=signs, internals=internals,
                                      backend=backend, sh=sh, n=n,
                                      d=layout.width)
        vec = sh.gather(local, layout.width)
    out = kdispatch.unflatten_aggregate(vec, layout)
    return (out, coeff) if return_coeff else out


def _open_routed_record(spec: AggregatorSpec, device: torch.device, *,
                        dyn: bool = False, lanes: Optional[int] = None,
                        sh: Optional[shardlib.ShardCtx] = None
                        ) -> tuple[str, Optional[shardlib.ShardCtx]]:
    """Resolve the backend (and the mesh of the sharded ones), open the
    dispatch record, and record the degrade of "cuda_sharded" /
    "cuda_hier" without a multi-rank mesh (to the torch path, the hier
    stage kept: the dense bucketing path).  Returns (effective backend,
    this rank's shard context or None).  A given ``sh`` (the trainer's
    model shard) is used as it is under a sharded backend."""
    hier = _hier_active(spec)
    backend = kdispatch.resolve_backend(spec.backend, device, hier=hier)
    degraded = None
    if backend not in kdispatch.SHARDED_BACKENDS:
        sh = None
    if sh is not None:
        pass                            # the caller's shard, as it is
    elif backend == "cuda_hier":
        ctx = kdispatch.resolve_hier_mesh()
        if ctx is None:
            backend = "torch"
            degraded = ("cuda_hier",
                        "no multi-rank mesh: dense bucketing path")
        else:
            mesh, worker_axis, axis = ctx
            sh = shardlib.ShardCtx(mesh, axis, worker_axis)
    elif backend == "cuda_sharded":
        ctx = kdispatch.resolve_shard_mesh()
        if ctx is None:
            backend = "torch"
            degraded = ("cuda_sharded",
                        "no multi-rank mesh: leaf-streamed torch path")
        else:
            sh = shardlib.ShardCtx(*ctx)
    kdispatch.open_record(
        requested=spec.backend, backend=backend, rule=spec.rule, pre=spec.pre,
        hier=hier, bucket_size=spec.bucket_size, dyn=dyn, lanes=lanes,
        mesh_devices=1 if sh is None else sh.devices,
        mesh_axis=None if sh is None else sh.axis,
        mesh_worker_axis=None if sh is None else sh.worker_axis)
    if degraded is not None:
        kdispatch.record_decision("pipeline", degraded[0], "torch",
                                  degraded[1])
    return backend, sh


def robust_aggregate(tree: PyTree, spec: AggregatorSpec, *,
                     generator: Optional[torch.Generator] = None,
                     perm: Optional[Tensor] = None,
                     signs: Optional[list] = None,
                     return_coeff: bool = False,
                     internals: Optional[dict] = None) -> PyTree:
    """Pre-aggregation + rule on a worker-stacked pytree; returns the
    aggregated pytree (worker axis removed).  With ``return_coeff=True``
    also returns the effective coefficient vector of a gram rule (else
    None).  ``generator`` (the reference's ``key``) draws the bucket
    permutation of ``pre="bucketing"`` and ``hier``, then the sketch's
    signs of ``sketch_dim``; ``perm`` / ``signs`` give them explicitly
    (one (C_i,) tensor per leaf, :func:`draw_signs`).  Decisions land on
    ``kdispatch.last_dispatch()``.

    ``internals`` (the health taps' input, :mod:`repro_torch.obs.taps`):
    pass a dict and every backend stores the fp32 NNM matrix in it
    (``"mix_matrix"``); the torch backend also the mixed stack's leaves
    (``"mixed"``) and cwtm's sorted leaves (``"sorted_leaves"``).  It is
    refused with ``hier`` (:func:`validate_taps`)."""
    _validate(spec)
    if internals is not None:
        validate_taps(spec)
    if spec.pre == "bucketing":
        _need_perm_source(generator, perm, "bucketing")
    if _hier_active(spec):
        _need_perm_source(generator, perm, "hierarchical aggregation")
    perm, signs = draw_randomness(tree, spec, generator=generator, perm=perm,
                                  signs=signs)
    f = spec.f
    work = tree
    if spec.pre == "bucketing":
        work, f = _tree_bucket(work, f, _stack_perm(work, perm),
                               spec.bucket_size)
    if spec.transport_dtype == "bf16":
        work = tree_map(lambda leaf: leaf.to(torch.bfloat16), work)

    backend, sh = _open_routed_record(spec, tree_leaves(work)[0].device)
    if backend in kdispatch.KERNEL_BACKENDS:
        return _aggregate_flat(work, spec, f, return_coeff=return_coeff,
                               perm=perm, signs=signs, internals=internals,
                               backend=backend, sh=sh)
    kdispatch.record_decision("pipeline", "torch", "torch",
                              "leaf-streamed torch path")

    if _hier_active(spec):
        # The gather form, with the same permutation — and so the same
        # bucket grouping — as the kernel path.
        n = tree_leaves(work)[0].shape[0]
        s = bucketlib.clamp_bucket_size(n, spec.bucket_size, f)
        if s == 1:
            kdispatch.record_decision("bucketgram", "torch", "skipped",
                                      _HIER_S1_NOTE)
        else:
            kdispatch.record_decision(
                "bucketgram", "torch", "torch",
                "dense leaf-streamed bucketing (gather form)")
            work, f = _tree_bucket(work, f, _stack_perm(work, perm), s)

    if signs is not None:
        kdispatch.record_decision("sketch_gram", "torch", "torch",
                                  "sketch_dim: the leaf-streamed signed sketch")
        g = tree_sketch_gram(work, spec.sketch_dim, signs)
    else:
        g = tree_gram(work)
    mix_matrix = None
    if spec.pre == "nnm":
        mix_matrix = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g), f)
        if internals is not None:
            internals["mix_matrix"] = mix_matrix
        g = gramlib.mixed_gram(g, mix_matrix)

    if spec.rule in GRAM_RULES:
        coeff = gramlib.coeff_for_rule(spec.rule, g, f,
                                       gm_iters=spec.gm_iters,
                                       gm_eps=spec.gm_eps,
                                       autogm_lamb=spec.autogm_lamb,
                                       autogm_iters=spec.autogm_iters)
        if mix_matrix is not None:
            coeff = coeff @ mix_matrix
        out = tree_combine(work, coeff)
        return (out, coeff) if return_coeff else out

    if spec.rule in COORDINATE_RULES:
        if mix_matrix is not None:
            work = tree_mix(work, mix_matrix)
            if internals is not None:
                internals["mixed"] = tree_leaves(work)
        out = _tree_coordinate_rule(work, spec.rule, f, internals)
        return (out, None) if return_coeff else out

    raise ValueError(f"unknown rule {spec.rule!r}")


def robust_aggregate_block(block: Tensor, spec: AggregatorSpec, *, d: int,
                           n: Optional[int] = None,
                           perm: Optional[Tensor] = None,
                           signs: Optional[list] = None,
                           segments: Optional[list] = None,
                           internals: Optional[dict] = None,
                           return_coeff: bool = False,
                           sh: Optional[shardlib.ShardCtx] = None):
    """One rank's part of :func:`robust_aggregate` under a multi-rank mesh:
    ``block`` is this rank's columns (``ShardCtx.cols(d)``) of the global
    (n, D) flat worker stack, and on the 2-D hierarchical form (buckets of
    more than one) only its worker rows (``ShardCtx.rows(n)``); returns its
    fp32 slice of the aggregate (``ShardCtx.gather`` rebuilds the whole)
    and, with ``return_coeff``, the replicated coefficients of a gram rule
    (else None).  ``perm`` is the bucket permutation of ``pre=
    "bucketing"`` / hier over all n workers; ``signs`` the sketch's, one
    per leaf of ``segments`` ((offset, size) columns of the global stack,
    one leaf spanning D when None).  The backend must resolve to
    "cuda_sharded" / "cuda_hier" under a multi-rank mesh: a block cannot
    degrade to the single-device path.  ``sh``: this rank's shard context
    as the caller holds it (the model-sharded trainer's explicit columns),
    else the active mesh's."""
    _validate(spec)
    if internals is not None:
        validate_taps(spec)
    n = block.shape[0] if n is None else n
    f = spec.f
    if (spec.pre == "bucketing" or _hier_active(spec)) and perm is None \
            and bucketlib.clamp_bucket_size(n, spec.bucket_size, f) > 1:
        raise ValueError("bucketing / hierarchical aggregation of a block "
                         "needs the permutation (perm=)")
    if spec.sketch_dim and signs is not None and segments is None:
        segments = [(0, d)]
    if not spec.sketch_dim:
        signs = None
    backend, sh = _open_routed_record(spec, block.device, sh=sh)
    if sh is None:
        raise ValueError(
            f"robust_aggregate_block needs backend 'cuda_sharded' or "
            f"'cuda_hier' under a multi-rank mesh; {spec.backend!r} resolved "
            f"to {backend!r}")
    work = block
    if spec.pre == "bucketing":
        means, f = _tree_bucket({"x": block}, f, perm.to(block.device),
                                spec.bucket_size)
        work = means["x"]
        n = work.shape[0]
    if spec.transport_dtype == "bf16":
        work = work.to(torch.bfloat16)
    s = bucketlib.clamp_bucket_size(n, spec.bucket_size, f)
    if sh.worker_axis is not None and _hier_active(spec) and s == 1 \
            and work.shape[0] != n:
        # The identity reduction needs every worker row: gather the tiles.
        rows = -(-n // sh.kw)
        pad = work.new_zeros((rows,) + tuple(work.shape[1:]))
        pad[:work.shape[0]] = work
        work = sh.mesh.all_gather(pad, sh.worker_axis)[:n]
    vec, coeff = _flat_pipeline(work.contiguous(), segments or [(0, d)], spec,
                                f, perm=perm, signs=signs,
                                internals=internals, backend=backend, sh=sh,
                                n=n, d=d)
    return (vec, coeff) if return_coeff else vec


# ---------------------------------------------------------------------------
# Dynamic-f pipeline (fleet engine): f is an int tensor, one per lane.  The
# rule / pre-aggregation / bucket size stay static; trimming and neighbour
# selection use rank masks.  Every helper below takes a lane axis: leaves
# (B, n, ...), f (B,).  The single-lane entry point is B = 1.
# ---------------------------------------------------------------------------

def _lane_f(f, b: int, device) -> Tensor:
    return torch.as_tensor(f, device=device).to(torch.int64).reshape(b)


def tree_gram_lanes(tree: PyTree) -> Tensor:
    """Every lane's (n, n) fp32 Gram, accumulated over the leaves."""
    leaves = tree_leaves(tree)
    b, n = leaves[0].shape[:2]
    g = torch.zeros((b, n, n), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        g = g + gram_batched_ref(leaf.reshape(b, n, -1))
    return g


def tree_combine_lanes(tree: PyTree, coeff: Tensor) -> PyTree:
    """:func:`tree_combine` per lane: coeff (B, n), leaves (B, n, ...)."""
    def comb(leaf):
        b, n = leaf.shape[:2]
        c = coeff.to(leaf.dtype).float()[:, None]
        return (c @ leaf.reshape(b, n, -1).float()).reshape(
            (b,) + tuple(leaf.shape[2:]))
    return tree_map(comb, tree)


def tree_mix_lanes(tree: PyTree, m: Tensor) -> PyTree:
    """:func:`tree_mix` per lane: M (B, n, n), leaves (B, n, ...)."""
    def mix(leaf):
        b, n = leaf.shape[:2]
        y = m.to(leaf.dtype).float() @ leaf.reshape(b, n, -1).float()
        return y.reshape(leaf.shape)
    return tree_map(mix, tree)


def _coordinate_rule_lanes(x: Tensor, rule: str, f: Tensor,
                           internals: Optional[dict] = None) -> Tensor:
    """A coordinate-wise rule along axis 1 of a (B, n, ...) stack with a
    (B,) f, fp32: the rank-mask arithmetic of the reference's
    ``_tree_coordinate_rule_dyn`` (so a non-finite value in a trimmed
    rank gives NaN, inf * 0); cwtm appends its sorted stack to
    ``internals["sorted_leaves"]``."""
    b, n = x.shape[:2]
    x = x.float()
    if rule == "cwmed":
        return _median(x.movedim(1, 0))
    i = torch.arange(n, device=x.device).reshape((1, n) + (1,) * (x.dim() - 2))
    fl = f.reshape((b, 1) + (1,) * (x.dim() - 2))
    if rule == "cwtm":
        xs = sort_nan_last(x, 1)
        if internals is not None:
            internals.setdefault("sorted_leaves", []).append(xs)
        keep = ((i >= fl) & (i < n - fl)).float()
        return (xs * keep).sum(dim=1) / torch.clamp_min(
            (n - 2 * fl[:, 0]).float(), 1.0)
    if rule == "meamed":
        med = _median(x.movedim(1, 0))[:, None]
        order = torch.argsort(torch.abs(x - med), dim=1, stable=True)
        xs = torch.take_along_dim(x, order, dim=1)
        keep = (i < n - fl).float()
        return (xs * keep).sum(dim=1) / torch.clamp_min(
            (n - fl[:, 0]).float(), 1.0)
    raise ValueError(rule)


def _tree_coordinate_rule_dyn(tree: PyTree, rule: str, f) -> PyTree:
    """Coordinate-wise rules with an int-tensor trim count (one lane:
    leaves (n, ...), a 0-d f)."""
    return tree_map(lambda leaf: _coordinate_rule_lanes(
        leaf[None], rule, _lane_f(f, 1, leaf.device))[0], tree)


def _lane_perms(n: int, b: int, device, generators, perms) -> Tensor:
    """(B, n) int64 permutations: ``perms`` as given, else one drawn from
    each lane's generator."""
    if perms is None:
        if generators is None or len(generators) != b:
            raise ValueError("bucketing and hierarchical lanes need one "
                             "torch.Generator per lane or a (B, n) perms "
                             "tensor")
        perms = torch.stack([bucketlib.draw_perm(n, generator=g)
                             for g in generators])
    perms = torch.as_tensor(perms).to(device=device, dtype=torch.int64)
    if perms.shape != (b, n):
        raise ValueError(f"perms must have shape ({b}, {n}), got "
                         f"{tuple(perms.shape)}")
    return perms


def _bucket_size_dyn(bucket_size: int, n: int) -> int:
    """The dynamic path's bucket size: ``max(1, min(s, n))`` (not
    :func:`~repro_torch.core.bucketing.clamp_bucket_size`'s static clamp,
    whose floor(n/2f) default depends on f)."""
    return max(1, min(int(bucket_size), n))


def _tree_bucket_lanes(tree: PyTree, f: Tensor, perms: Tensor,
                       bucket_size: int) -> tuple[PyTree, Tensor]:
    """The gather-form bucketing of every lane with its own permutation;
    returns (bucket means (B, ceil(n/s), ...), adjusted f (B,))."""
    leaves = tree_leaves(tree)
    b, n = leaves[0].shape[:2]
    s = _bucket_size_dyn(bucket_size, n)
    nb = bucketlib.num_buckets(n, s)
    pad = nb * s - n
    counts = bucketlib.bucket_counts(n, s, device=leaves[0].device)
    lanes = torch.arange(b, device=leaves[0].device)[:, None]

    def bucket(leaf):
        acc = torch.promote_types(leaf.dtype, torch.float32)
        x = leaf[lanes, perms].to(acc)
        if pad:
            x = torch.cat([x, x.new_zeros((b, pad) + tuple(leaf.shape[2:]))],
                          dim=1)
        sums = x.reshape((b, nb, s) + tuple(leaf.shape[2:])).sum(dim=2)
        means = sums / counts.to(acc).reshape(
            (1, nb) + (1,) * (leaf.dim() - 2))
        return means.to(leaf.dtype)

    return tree_map(bucket, tree), bucketlib.adjusted_f_dyn(f, nb).to(
        torch.int64)


def _tree_bucket_dyn(tree: PyTree, f, bucket_size: int, *,
                     generator: Optional[torch.Generator] = None,
                     perm: Optional[Tensor] = None) -> tuple[PyTree, Tensor]:
    """:func:`_tree_bucket` with an int-tensor f (one lane).  The bucket
    size must be given: the floor(n/2f) default cannot depend on a tensor
    f.  The permutation comes from ``generator`` or ``perm``."""
    leaf = tree_leaves(tree)[0]
    n = leaf.shape[0]
    p = bucketlib.draw_perm(n, generator=generator, perm=perm,
                            device=leaf.device)
    out, f_adj = _tree_bucket_lanes(tree_map(lambda l: l[None], tree),
                                    _lane_f(f, 1, leaf.device), p[None],
                                    bucket_size)
    return tree_map(lambda l: l[0], out), f_adj[0]


def _validate_dyn(spec: AggregatorSpec) -> None:
    _validate(spec)
    if _hier_active(spec) and spec.bucket_size is None:
        raise ValueError(
            "dynamic-f hierarchical aggregation needs an explicit "
            "bucket_size (the floor(n/2f) default is shape-level); set "
            "AggregatorSpec.bucket_size")
    if spec.pre == "bucketing" and spec.bucket_size is None:
        raise ValueError(
            "dynamic-f bucketing needs an explicit bucket_size (the "
            "floor(n/2f) default depends on f); set AggregatorSpec.bucket_size")


def _lane_signs(tree: PyTree, spec: AggregatorSpec, generators, signs
                ) -> Optional[list]:
    """The lanes' sketch signs, one (B, C_i) tensor per leaf: ``signs``
    as given, else drawn from each lane's generator (after its bucket
    permutation); None without ``sketch_dim`` or randomness."""
    if not spec.sketch_dim:
        return None
    leaves = tree_leaves(tree)
    b, dev = leaves[0].shape[0], leaves[0].device
    if signs is not None:
        return [torch.as_tensor(sg).to(device=dev, dtype=torch.float32)
                .reshape(b, -1) for sg in signs]
    if generators is None:
        return None
    widths = [leaf[0, 0].numel() for leaf in leaves]
    per_lane = [draw_signs(widths, spec.sketch_dim, g, dev)
                for g in generators]
    return [torch.stack(col) for col in zip(*per_lane)]


def _aggregate_lanes(tree: PyTree, spec: AggregatorSpec, f: Tensor, *,
                     batched: bool, generators=None, perms=None,
                     signs=None, internals: Optional[dict] = None) -> PyTree:
    """The dynamic pipeline on a lane-batched stack (leaves (B, n, ...),
    f (B,)); ``batched=False`` is the single-lane entry point (B = 1),
    whose kernel path takes K1 for the Gram (the sketch Gram when the
    lanes have ``signs``).  ``internals`` as in :func:`robust_aggregate`,
    every entry lane-stacked."""
    _validate_dyn(spec)
    if internals is not None:
        validate_taps(spec)
    leaves = tree_leaves(tree)
    b, n = leaves[0].shape[:2]
    dev = leaves[0].device
    f = _lane_f(f, b, dev)
    work = tree
    if spec.pre == "bucketing":
        work, f = _tree_bucket_lanes(
            work, f, _lane_perms(n, b, dev, generators, perms),
            spec.bucket_size)
    hier_perms = None
    if _hier_active(spec) and _bucket_size_dyn(spec.bucket_size, n) > 1:
        hier_perms = _lane_perms(n, b, dev, generators, perms)
    signs = _lane_signs(work, spec, generators, signs)
    if spec.transport_dtype == "bf16":
        work = tree_map(lambda leaf: leaf.to(torch.bfloat16), work)

    backend, sh = _open_routed_record(spec, dev, dyn=True, lanes=b)
    if backend in kdispatch.KERNEL_BACKENDS:
        return _aggregate_flat_lanes(work, spec, f, batched=batched,
                                     perms=hier_perms, signs=signs,
                                     internals=internals, backend=backend,
                                     sh=sh)
    kdispatch.record_decision("pipeline", "torch", "torch",
                              "leaf-streamed torch path")

    if _hier_active(spec):
        # The gather form, with each lane's permutation (the kernel path's
        # bucket grouping).
        if hier_perms is None:
            kdispatch.record_decision("bucketgram", "torch", "skipped",
                                      _HIER_S1_NOTE)
        else:
            kdispatch.record_decision(
                "bucketgram", "torch", "torch",
                "dense leaf-streamed bucketing (gather form)")
            work, f = _tree_bucket_lanes(work, f, hier_perms,
                                         spec.bucket_size)

    if signs is not None:
        kdispatch.record_decision("sketch_gram", "torch", "torch",
                                  "sketch_dim: the leaf-streamed signed sketch")
        g = tree_sketch_gram_lanes(work, spec.sketch_dim, signs)
    else:
        g = tree_gram_lanes(work)
    mix_matrix = None
    if spec.pre == "nnm":
        mix_matrix = gramlib.nnm_matrix_dyn(gramlib.pdist_sq_from_gram(g), f)
        if internals is not None:
            internals["mix_matrix"] = mix_matrix
        g = gramlib.mixed_gram(g, mix_matrix)
    if spec.rule in GRAM_RULES:
        coeff = gramlib.coeff_for_rule_dyn(
            spec.rule, g, f, gm_iters=spec.gm_iters, gm_eps=spec.gm_eps,
            autogm_lamb=spec.autogm_lamb, autogm_iters=spec.autogm_iters)
        if mix_matrix is not None:
            coeff = (coeff[:, None] @ mix_matrix)[:, 0]
        return tree_combine_lanes(work, coeff)
    if spec.rule in COORDINATE_RULES:
        if mix_matrix is not None:
            work = tree_mix_lanes(work, mix_matrix)
            if internals is not None:
                internals["mixed"] = tree_leaves(work)
        return tree_unflatten(tree_structure(work), [
            _coordinate_rule_lanes(leaf, spec.rule, f, internals)
            for leaf in tree_leaves(work)])
    raise ValueError(f"unknown rule {spec.rule!r}")


def _hier_reduce_lanes(flat: Tensor, spec: AggregatorSpec, f: Tensor, *,
                       perms: Optional[Tensor], batched: bool,
                       backend: str = "cuda",
                       sh: Optional[shardlib.ShardCtx] = None,
                       n: Optional[int] = None
                       ) -> tuple[Tensor, Tensor, Optional[Tensor]]:
    """The hierarchical pre-reduction of a (B, n, D) lane stack: (bucket
    means (B, n_b, D), adjusted f (B,), their (B, n_b, n_b) fp32 Gram or
    None).  ``perms`` None is s = 1: the identity, recorded as skipped
    (bitwise the dense pipeline).  The lanes take K6 / K7's lane form; the
    single-lane entry point (``batched=False``) the single-lane K6 / K7.
    With ``sh`` (this rank's block, or its worker tile of the ``n``
    workers) each lane takes the sharded single-lane form in turn: the
    lane forms on a mesh wait for the sharded fleet."""
    if perms is None:
        kdispatch.record_decision("bucketgram", backend, "skipped",
                                  _HIER_S1_NOTE)
        return flat, f, None
    n = flat.shape[1] if n is None else n
    s = _bucket_size_dyn(spec.bucket_size, n)
    nb = bucketlib.num_buckets(n, s)
    need_gram = spec.rule in GRAM_RULES or spec.pre == "nnm"
    if batched and sh is None:
        # The permutations as they are: K6 / K7's lane form builds each
        # lane's buckets on the device, so nothing waits for the card.
        y, g = kdispatch.dispatch_bucketgram_perms(
            flat, perms, s, backend=backend, with_gram=need_gram)
        return y, bucketlib.adjusted_f_dyn(f, nb).to(torch.int64), g
    # Worker i of lane b goes to bucket argsort(perms[b])[i] // s, as
    # bucketlib.bucket_assignment groups one lane.
    assign = torch.div(torch.argsort(perms, dim=1), s, rounding_mode="floor")
    if sh is not None:
        outs = [kdispatch.dispatch_bucketgram(
            flat[k], assign[k], nb, backend=backend, with_gram=need_gram,
            sh=sh) for k in range(flat.shape[0])]
        y = torch.stack([o[0] for o in outs])
        g = torch.stack([o[1] for o in outs]) if need_gram else None
    else:
        y, g = kdispatch.dispatch_bucketgram(flat[0], assign[0], nb,
                                             backend=backend,
                                             with_gram=need_gram)
        y, g = y[None], None if g is None else g[None]
    return y, bucketlib.adjusted_f_dyn(f, nb).to(torch.int64), g


def _aggregate_flat_lanes(work: PyTree, spec: AggregatorSpec, f: Tensor, *,
                          batched: bool, perms=None, signs=None,
                          internals: Optional[dict] = None,
                          backend: str = "cuda",
                          sh: Optional[shardlib.ShardCtx] = None) -> PyTree:
    """Kernel pipeline of the dynamic path: the lanes as one (B, n, D)
    buffer -> [bucket means (K6 / K7, each lane's ``perms``) when hier] ->
    Gram (K5, skipped when K6 gave it; K1 for the single-lane entry point;
    the sketch Gram when ``signs``) -> batched NNM / coefficients -> one
    launch for every lane: combine (K3), mix + trim (K4) or median (K2)
    -> (B, ...) leaves.  ``internals`` gets the NNM matrices only.  With
    ``sh`` every rank runs it on its block of the (replicated) lanes and
    the (B, D/k) slices are gathered."""
    flat, layout = kdispatch.flatten_lane_stack(work)
    segments = [(off, size) for off, size, _ in layout.segments]
    n = layout.n
    x = flat
    if sh is not None:
        tile = perms is not None and _hier_tiles(
            spec, sh, n, _bucket_size_dyn(spec.bucket_size, n))
        x = sh.take(flat, tile=tile)
    mix_matrix, g = None, None
    if _hier_active(spec):
        x, f, g = _hier_reduce_lanes(x, spec, f, perms=perms, batched=batched,
                                     backend=backend, sh=sh, n=n)
    need_gram = (spec.rule in GRAM_RULES or spec.pre == "nnm") and g is None
    if need_gram and signs is not None:
        g = kdispatch.dispatch_sketch_gram(
            x, segments, spec.sketch_dim, signs, backend=backend, sh=sh,
            d=layout.width)
    elif need_gram:
        if batched:
            g = kdispatch.dispatch_gram_batched(x, backend=backend, sh=sh)
        else:
            g = kdispatch.dispatch_gram(x[0], backend=backend, sh=sh)[None]
    if spec.pre == "nnm":
        mix_matrix = gramlib.nnm_matrix_dyn(gramlib.pdist_sq_from_gram(g), f)
        if internals is not None:
            internals["mix_matrix"] = mix_matrix
        g = gramlib.mixed_gram(g, mix_matrix)

    if spec.rule in GRAM_RULES:
        if spec.rule == "autogm":
            kdispatch.record_decision(
                "autogm_coeff", backend, "torch",
                "autogm adaptive-weight solve is gram-space math with no "
                "kernel form")
        coeff = gramlib.coeff_for_rule_dyn(
            spec.rule, g, f, gm_iters=spec.gm_iters, gm_eps=spec.gm_eps,
            autogm_lamb=spec.autogm_lamb, autogm_iters=spec.autogm_iters)
        if mix_matrix is not None:
            coeff = (coeff[:, None] @ mix_matrix)[:, 0]
        vec = kdispatch.dispatch_combine(x, coeff.contiguous(),
                                         backend=backend, sh=sh)
    elif spec.rule in COORDINATE_RULES:
        m = None if mix_matrix is None else mix_matrix.to(x.dtype)
        if spec.rule == "meamed":
            vec = kdispatch.dispatch_meamed(x, m, f, backend=backend,
                                            dyn=True, sh=sh)
        else:
            mode = "med" if spec.rule == "cwmed" else "trim"
            vec = kdispatch.dispatch_mixtrim(x, m, f, mode=mode,
                                             backend=backend, dyn=True, sh=sh)
    else:
        raise ValueError(f"unknown rule {spec.rule!r}")
    if sh is not None:
        vec = sh.gather(vec, layout.width)
    return kdispatch.unflatten_lane_aggregate(vec, layout)


def robust_aggregate_dyn(tree: PyTree, spec: AggregatorSpec, f, *,
                         generator: Optional[torch.Generator] = None,
                         perm: Optional[Tensor] = None,
                         signs: Optional[list] = None,
                         internals: Optional[dict] = None) -> PyTree:
    """:func:`robust_aggregate` with an int-tensor Byzantine count.

    ``spec.f`` is ignored; ``f`` (a 0-d int tensor or an int) takes its
    place and is never read on the host.  ``spec.pre == "bucketing"`` and
    ``spec.hier`` need an explicit ``spec.bucket_size`` and a
    ``generator`` or ``perm`` (hier with ``max(1, min(bucket_size, n))``
    = 1 draws none and is the dense pipeline bit for bit); ``sketch_dim``
    draws its signs from ``generator`` (after the permutation) or takes
    ``signs`` (one (C_i,) tensor per leaf).  MDA has no dynamic form.
    ``internals`` as in :func:`robust_aggregate` (refused with hier:
    :func:`validate_taps`)."""
    leaf = tree_leaves(tree)[0]
    lane_internals = None if internals is None else {}
    out = _aggregate_lanes(
        tree_map(lambda l: l[None], tree), spec, _lane_f(f, 1, leaf.device),
        batched=False, generators=None if generator is None else [generator],
        perms=None if perm is None else torch.as_tensor(perm)[None],
        signs=None if signs is None else [torch.as_tensor(sg)[None]
                                          for sg in signs],
        internals=lane_internals)
    for k, v in (lane_internals or {}).items():
        internals[k] = [t[0] for t in v] if isinstance(v, list) else v[0]
    return tree_map(lambda l: l[0], out)


def batched_robust_aggregate(tree: PyTree, spec: AggregatorSpec, fs, *,
                             generators: Optional[list] = None,
                             perms: Optional[Tensor] = None,
                             signs: Optional[list] = None,
                             internals: Optional[dict] = None) -> PyTree:
    """Lane-batched aggregation: every leaf carries a leading lane axis
    (B, n, ...) and ``fs`` (B,) is the per-lane Byzantine count; returns
    the (B, ...) aggregates.  Bucketing and hierarchical lanes take one
    generator per lane or a (B, n) ``perms``; sketch lanes draw their signs from the same
    generators (after the permutation) or take ``signs``, one (B, C_i)
    tensor per leaf.  ``internals`` as in :func:`robust_aggregate`, every
    entry lane-stacked: the (B, n, n) NNM matrices, and on the torch
    backend the mixed and sorted (B, n, ...) leaves."""
    leaf = tree_leaves(tree)[0]
    return _aggregate_lanes(tree, spec, _lane_f(fs, leaf.shape[0], leaf.device),
                            batched=True, generators=generators, perms=perms,
                            signs=signs, internals=internals)
