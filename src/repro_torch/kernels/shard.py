"""Multi-rank forms of the aggregation kernels (counterpart of
``repro.kernels.shard``: ``backend="cuda_sharded"`` / ``"cuda_hier"``).

The reference shard_maps each single-device Pallas kernel over a mesh
axis, with the global (n, D) array split by ``PartitionSpec``.  Here every
rank of a ``torch.distributed`` world holds its own block, so the API
changes shape: a rank passes ITS block of the global flat stack, the
columns :func:`column_block` gives it along the D axis ((n, D/k); on the
2-D hierarchical mesh the (n/w, D/k) tile of the worker rows
:func:`row_block` gives it), and gets back its (D/k,) slice of the
aggregate; :func:`gather_columns` rebuilds the whole vector.  The
columns split as the reference's: ceil(D/k) per rank, the last rank
short (the reference's zero padding, which adds nothing to a Gram and
whose outputs are cut off).

* :func:`sharded_gram` — K1 (K5 for a (B, n, D/k) lane block) on the
  block, then an all-reduce of the (n, n) partial Grams: the pipeline's
  only collective;
* :func:`sharded_combine` (K3 / its lane form), :func:`sharded_mixtrim`
  (K2 static f; K4 and K2's median lane form on the dynamic path) and
  :func:`sharded_meamed` (torch ops: meamed has no kernel) — shard-local,
  per column;
* :func:`sharded_bucketgram` — the hierarchical pre-reduction.  1-D: K6
  (K7 without a Gram) on the (n, D/k) block, then an all-reduce of the
  partial Gram.  2-D (workers x model): K7 on the (n/w, D/k) tile with
  the GLOBAL 1/|bucket| weights and bucket count (a tile may miss a
  bucket; its workers' weights are not its own count's), an all-reduce of
  the (n_b, D/k) partial means over the worker axis, K1 on the means and
  an all-reduce of their Gram over the model axis.  A NaN row on one
  tile makes every bucket of its columns NaN (0 * NaN in K7's dense
  semantics) and the sum keeps it.

Model shards (the trainer on a ``(data, model)`` mesh, or a multi-pod
``(pod, data, model)`` one): a rank's block
is not an even :func:`column_block` but the columns its model shard
holds (:class:`ModelColumns`): every leaf split over the model axis
contributes this rank's shard, flattened, and every leaf replicated over
it (norms, replicated kv heads) contributes the :func:`column_block` of
its flattened whole that this rank's model index gives, so each column of
the robust stack is held by exactly one model rank.  The model ranks'
columns lie side by side in a global order (rank 0's first), and
:class:`ShardCtx` takes the block as an explicit ``span`` of it; with
``axis`` a tuple of mesh axes the Gram's all-reduce spans them all.  The
column order differs from the reference's leaf order; the Gram, the
per-column rules and the combine do not depend on it.  The sketch Gram
does (its chunks and signs follow each whole leaf's flat order): a split
leaf's shard lies in its whole leaf as runs of :attr:`ModelColumns.runs`
elements, one in every ``k`` of them, and ``kernels.dispatch.
sketch_fold_model`` folds a block of ``ShardCtx.columns`` where the whole
leaf holds its elements.

On CPU blocks the wrappers run their plain versions (the tests' gloo
worlds).  Routing and decision records stay in
:mod:`repro_torch.kernels.dispatch`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.bucketgram import bucketgram as _bucketgram_op
from repro_torch.kernels.bucketgram import bucketmeans as _bucketmeans_op
from repro_torch.kernels.combine import combine as _combine_op
from repro_torch.kernels.combine import combine_lanes as _combine_lanes_op
from repro_torch.kernels.gram import gram as _gram_op
from repro_torch.kernels.gram import gram_batched as _gram_batched_op
from repro_torch.kernels.mixtrim import mixtrim as _mixtrim_op
from repro_torch.kernels.mixtrim import mixtrim_dyn as _mixtrim_dyn_op
from repro_torch.kernels.mixtrim import mixtrim_lanes as _mixtrim_lanes_op

Tensor = torch.Tensor


def axis_size(mesh, axis: str) -> int:
    """Rank count along one named mesh axis."""
    return mesh.size(axis)


def column_block(d: int, k: int, j: int) -> tuple[int, int]:
    """Columns [c0, c1) of block j of a D-wide stack split over k ranks:
    ceil(D/k) each, the last block short."""
    w = -(-d // k)
    c0 = min(j * w, d)
    return c0, min(c0 + w, d)


def row_block(n: int, w: int, j: int) -> tuple[int, int]:
    """Worker rows [r0, r1) of tile j of n workers split over w ranks:
    ceil(n/w) each, the last tile short (the reference's phantom rows)."""
    return column_block(n, w, j)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """One rank's place in a sharded aggregation: the mesh, the axis D is
    split over (a tuple of axes: all of them, the Gram all-reduced over
    each), (2-D hierarchical form) the axis the worker rows are split
    over, and ``span``: this rank's columns [c0, c1) of the stack when
    they are given explicitly (a model shard's) rather than by
    :func:`column_block`, and ``columns``: the model shard's
    :class:`ModelColumns` that ``span`` is a block of (the sketch folds
    by it)."""
    mesh: object
    axis: object
    worker_axis: Optional[str] = None
    span: Optional[tuple] = None
    columns: Optional[ModelColumns] = None

    @property
    def k(self) -> int:
        return self.mesh.size(self.axis)

    @property
    def kw(self) -> int:
        return 1 if self.worker_axis is None else self.mesh.size(
            self.worker_axis)

    @property
    def devices(self) -> int:
        return self.k * self.kw

    def cols(self, d: int) -> tuple[int, int]:
        if self.span is not None:
            return self.span
        return column_block(d, self.k, self.mesh.index(self.axis))

    def rows(self, n: int) -> tuple[int, int]:
        if self.worker_axis is None:
            return 0, n
        return row_block(n, self.kw, self.mesh.index(self.worker_axis))

    def take(self, flat: Tensor, *, tile: bool = False) -> Tensor:
        """This rank's contiguous block of a replicated (n, D) or (B, n,
        D) stack; ``tile`` also cuts its worker rows (2-D form)."""
        c0, c1 = self.cols(flat.shape[-1])
        x = flat[..., c0:c1]
        if tile and self.worker_axis is not None:
            r0, r1 = self.rows(flat.shape[-2])
            x = x[..., r0:r1, :]
        return x.contiguous()

    def gather(self, local: Tensor, d: int) -> Tensor:
        """The whole (D,) (or (B, D)) vector from every rank's slice along
        :attr:`axis`: padded to ceil(D/k), all-gathered, cut to D."""
        return gather_columns(local, d, mesh=self.mesh, axis=self.axis)


@dataclasses.dataclass(frozen=True)
class ModelColumns:
    """One model rank's columns of the (n, D) worker stack, leaf by leaf
    (module docstring).  ``pieces[i]`` is the [lo, hi) of robust leaf i's
    flattened LOCAL tensor this rank holds (the whole shard of a split
    leaf, its :func:`column_block` of a replicated one), ``split[i]``
    whether the leaf is split over the model axis, ``widths`` every model
    rank's column count, ``index`` this rank's model coordinate.
    ``runs[i]``: a split leaf's shard, flattened, is runs of this many
    elements, run r at ``(r k + index) runs[i]`` in the whole leaf's flat
    order (its split dimension's block times every later dimension); 0
    for a replicated leaf.  ``whole[i]``: the whole leaf's element count.
    Only the sketch reads these two."""
    pieces: tuple
    split: tuple
    widths: tuple
    index: int
    runs: tuple
    whole: tuple

    @classmethod
    def build(cls, numels: list, split: list, k: int, j: int,
              runs: list) -> "ModelColumns":
        """From the robust leaves' LOCAL element counts and split flags,
        on a model axis of ``k`` ranks, for model index ``j``; ``runs`` as
        the field."""
        def pieces_of(m):
            return tuple((0, size) if sp else column_block(size, k, m)
                         for size, sp in zip(numels, split))
        widths = tuple(sum(b - a for a, b in pieces_of(m)) for m in range(k))
        return cls(pieces_of(j), tuple(bool(x) for x in split), widths, j,
                   tuple(runs),
                   tuple(size * k if sp else size
                         for size, sp in zip(numels, split)))

    @property
    def k(self) -> int:
        """The model axis's rank count."""
        return len(self.widths)

    @property
    def width(self) -> int:
        return self.widths[self.index]

    @property
    def offset(self) -> int:
        return sum(self.widths[:self.index])

    @property
    def total(self) -> int:
        """D: every model rank's columns together."""
        return sum(self.widths)

    def segments(self) -> list:
        """(offset, size) of each leaf's piece in this rank's columns."""
        out, off = [], 0
        for a, b in self.pieces:
            out.append((off, b - a))
            off += b - a
        return out

    def unflatten(self, vec: Tensor, like: list, *, mesh, axis: str) -> list:
        """Leaves shaped like ``like`` from this rank's (W,) ``vec``: a split
        leaf's shard is its piece; a replicated leaf is rebuilt from every
        model rank's piece, all-gathered over ``axis`` in one collective."""
        segs = self.segments()
        rep = [i for i, sp in enumerate(self.split) if not sp]
        out: list = [None] * len(like)
        for i, sp in enumerate(self.split):
            if sp:
                off, size = segs[i]
                out[i] = vec[off:off + size].reshape(like[i].shape)
        if not rep:
            return out
        k = len(self.widths)
        sizes = [[column_block(like[i].numel(), k, m) for i in rep]
                 for m in range(k)]
        rmax = max(sum(b - a for a, b in row) for row in sizes)
        buf = vec.new_zeros((1, rmax))
        pos = 0
        for i in rep:
            off, size = segs[i]
            buf[0, pos:pos + size] = vec[off:off + size]
            pos += size
        full = mesh.all_gather(buf, axis) if k > 1 else buf     # (k, rmax)
        parts: dict = {i: [] for i in rep}
        for m in range(k):
            pos = 0
            for i, (a, b) in zip(rep, sizes[m]):
                parts[i].append(full[m, pos:pos + b - a])
                pos += b - a
        for i in rep:
            out[i] = torch.cat(parts[i]).reshape(like[i].shape)
        return out


def gather_columns(local: Tensor, d: int, *, mesh, axis) -> Tensor:
    """(..., D) from each rank's (..., c1 - c0) column slice along ``axis``
    (:func:`column_block`), in rank order (over a tuple of axes, the
    row-major order of ``Mesh.index``: the multi-pod trainer's
    ``("pod", "data")``)."""
    k = mesh.size(axis)
    w = -(-d // k)
    lead = tuple(local.shape[:-1])
    buf = local.new_zeros(lead + (w,))
    buf[..., :local.shape[-1]] = local
    rows = buf.reshape(-1, w).mT.contiguous()          # (w, L)
    full = mesh.all_gather(rows, axis)                  # (k w, L)
    return full.mT.reshape(lead + (k * w,))[..., :d].contiguous()


def sharded_gram(block: Tensor, *, mesh, axis: str) -> Tensor:
    """(n, D/k) -> replicated (n, n) fp32 Gram: K1 on the block, then an
    all-reduce of the partials ((B, n, D/k) -> (B, n, n): K5)."""
    lanes = block.dim() == 3
    if block.shape[-1] == 0:
        n = block.shape[-2]
        g = torch.zeros(block.shape[:-2] + (n, n), dtype=torch.float32,
                        device=block.device)
    else:
        g = (_gram_batched_op if lanes else _gram_op)(block)
    return mesh.all_reduce(g.contiguous(), axis)


def sharded_combine(block: Tensor, coeff: Tensor, *, mesh, axis: str
                    ) -> Tensor:
    """(n, D/k), replicated (n,) -> this rank's (D/k,) slice of c X (the
    lane form for (B, n, D/k) and (B, n)).  Shard-local."""
    del mesh, axis
    if block.shape[-1] == 0:
        return block.new_zeros(block.shape[:-2] + (0,), dtype=torch.float32)
    return (_combine_lanes_op if block.dim() == 3 else _combine_op)(
        block, coeff)


def sharded_mixtrim(block: Tensor, m: Optional[Tensor], f, *, mode: str,
                    mesh, axis: str, dyn: bool = False) -> Tensor:
    """(n, D/k) -> this rank's (D/k,) slice of the fused mix + trim /
    median (K2).  ``dyn``: a (B, n, D/k) lane block with (B, n, n) or no
    mix and (B,) f -> (B, D/k): K4 trims, K2's median lane form takes the
    median.  Shard-local."""
    del mesh, axis
    if block.shape[-1] == 0:
        return block.new_zeros(block.shape[:-2] + (0,), dtype=torch.float32)
    if dyn:
        if mode == "trim":
            return _mixtrim_dyn_op(block, m, f, mode=mode)
        return _mixtrim_lanes_op(block, m)
    return _mixtrim_op(block, m, 0 if mode == "med" else int(f), mode=mode)


def sharded_meamed(block: Tensor, m: Optional[Tensor], f, *, mesh, axis: str,
                   dyn: bool = False) -> Tensor:
    """(n, D/k) -> (D/k,): mean around the median, torch ops on the block
    (no kernel exists; it is coordinate-wise, so it stays shard-local)."""
    del mesh, axis
    from repro_torch.core.robust import _coordinate_rule, _coordinate_rule_lanes
    mixed = block if m is None else m.float() @ block.float()
    if dyn:
        return _coordinate_rule_lanes(mixed, "meamed", f)
    return _coordinate_rule(mixed, "meamed", f)


def bucket_weights(assignment: Tensor, n_buckets: int) -> Tensor:
    """Each worker's GLOBAL B weight, 1/|bucket| over all n workers."""
    assign = assignment.long()
    counts = torch.bincount(assign, minlength=n_buckets)
    return (1.0 / counts.float())[assign]


def sharded_bucketgram(block: Tensor, assignment: Tensor, n_buckets: int, *,
                       mesh, worker_axis: Optional[str], model_axis: str,
                       with_gram: bool = True
                       ) -> tuple[Tensor, Optional[Tensor]]:
    """The hierarchical pre-reduction of one rank's block: (bucket means
    (n_b, D/k) in the stack dtype, replicated (n_b, n_b) fp32 Gram |
    None).  ``assignment`` holds all n workers' bucket ids.

    ``worker_axis=None`` (1-D): ``block`` is (n, D/k); K6 gives the means
    and the partial Gram in one pass (K7 without a Gram), and the Gram is
    all-reduced over ``model_axis``.  Otherwise ``block`` is the tile of
    the worker rows :func:`row_block` gives this rank's ``worker_axis``
    coordinate (zero rows past them are phantom workers of weight 0); K7
    with the global weights and bucket count gives partial means, summed
    over ``worker_axis``; K1 on the means and an all-reduce over
    ``model_axis`` give the Gram."""
    n = assignment.shape[0]
    assign = assignment.to(device=block.device, dtype=torch.int64)
    if worker_axis is None:
        if block.shape[-1] == 0:
            y = block.new_zeros((n_buckets, 0))
            g = torch.zeros((n_buckets, n_buckets), dtype=torch.float32,
                            device=block.device) if with_gram else None
        elif with_gram:
            y, g = _bucketgram_op(block, assign, n_buckets)
        else:
            y, g = _bucketmeans_op(block, assign, n_buckets), None
        if g is not None:
            g = mesh.all_reduce(g.contiguous(), model_axis)
        return y, g
    kw = mesh.size(worker_axis)
    r0, r1 = row_block(n, kw, mesh.index(worker_axis))
    rows = block.shape[0]
    if rows < r1 - r0:
        raise ValueError(f"tile holds {rows} rows; workers [{r0}, {r1}) "
                         f"need {r1 - r0}")
    weight = bucket_weights(assign, n_buckets)
    ids = torch.zeros(rows, dtype=torch.int64, device=block.device)
    w = torch.zeros(rows, dtype=torch.float32, device=block.device)
    ids[:r1 - r0] = assign[r0:r1]
    w[:r1 - r0] = weight[r0:r1]
    if rows == 0 or block.shape[-1] == 0:
        y = block.new_zeros((n_buckets, block.shape[-1]))
    else:
        y = _bucketmeans_op(block, ids, n_buckets, weight=w)
    y = mesh.all_reduce(y.contiguous(), worker_axis)
    if not with_gram:
        return y, None
    g = _gram_op(y) if y.shape[-1] else torch.zeros(
        (n_buckets, n_buckets), dtype=torch.float32, device=y.device)
    return y, mesh.all_reduce(g.contiguous(), model_axis)
