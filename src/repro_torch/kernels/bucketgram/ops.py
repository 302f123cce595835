"""K6 / K7 · bucket means Y = B X of a (n, D) worker stack and (K6) their
reduced Gram G = Y Y^T.

B is the (n_b, n) row-normalized bucket-assignment matrix
(``repro_torch.core.bucketing.bucket_matrix``): one non-zero per column,
``B[b, i] = 1/|bucket b|`` iff worker i landed in bucket b.

* :func:`bucketgram` (K6) and :func:`bucketmeans` (K7) are the wrappers:
  for a CUDA stack they launch the kernels of ``csrc/bucketgram.cu`` (the
  counterparts of the TPU kernel
  ``repro/kernels/bucketgram/kernel.py::bucketgram_pallas`` with
  ``with_gram=True`` / ``False``); for a CPU stack they run
  :func:`bucket_means_gram_ref`.  Each counts its launches in
  ``.launches``.  Above :data:`REG_NB` buckets K6 writes fp32 means and
  folds G from them with the K1 gram kernel, whose own counter counts that
  second launch.
* :func:`bucket_means_gram` is the reference's entry point
  (``repro.kernels.bucketgram.bucket_means_gram``): a dense ``bmat`` or an
  ``assignment``, and ``with_gram`` picks K6 or K7.
* :func:`bucket_means_gram_ref` is the plain version and follows
  ``ref.py``'s contract: the dense fp32 ``B @ X`` (in column chunks), cast
  to X's dtype, and the Gram of the fp32 means BEFORE that cast.  Its
  dense contraction defines the non-finite semantics the kernels keep:
  0 * inf = NaN, so a non-finite X[i, c] makes every bucket other than
  i's NaN in column c.

* :func:`bucketgram_lanes` (K6) and :func:`bucketmeans_lanes` (K7) are
  the lane forms (``bucketgram_pallas`` under the reference's
  ``jax.vmap``: the fleet's hierarchical lanes, one launch a
  bucket-round): a (B, n, D) stack and each lane's (B, n) bucket ids ->
  means (B, n_b, D) (+ the (B, n_b, n_b) fp32 Gram).  Lane b's means
  equal :func:`bucketgram` / :func:`bucketmeans` on lane b bit for bit,
  and so does its Gram up to :data:`REG_NB` buckets; above, the Gram of
  the fp32 means is a K5 launch (``gram_batched``, counted by its own
  counter), as the single-lane form takes K1.
  :func:`bucket_means_gram_lanes_ref` is their plain version,
  :func:`bucket_means_gram_ref` on each lane.  They count their launches
  in ``.launches``.

The TPU layout padding (n_b to 8, n to ``block_n``, D to ``block_d``) is
not carried over: the kernels mask nothing and pad nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_lanes, check_stack, device_guard, stream_of,
)
from repro_torch.kernels.gram import gram as _gram_op
from repro_torch.kernels.gram import gram_batched as _gram_batched_op
from repro_torch.kernels.gram import gram_ref

_THREADS = 256
_BLOCKS_PER_SM = 16
#: Largest bucket count whose Gram K6 folds in registers
#: (csrc/bucketgram.cu NB).
REG_NB = 8
#: Column chunk of the plain version's dense contraction (bounds the fp32
#: copy of a bf16 stack).
PLAIN_CHUNK = 1 << 24

Tensor = torch.Tensor


def bucket_means_gram_ref(x: Tensor, bmat: Tensor, *, with_gram: bool = True
                          ) -> tuple[Tensor, Optional[Tensor]]:
    """Plain version: Y = B @ X with fp32 products and sums, cast back to
    X's dtype; the Gram is taken of the fp32 Y before the cast (K1's plain
    version, in column chunks)."""
    d = x.shape[1]
    b = bmat.float()
    y32 = torch.empty((b.shape[0], d), dtype=torch.float32, device=x.device)
    for c in range(0, d, PLAIN_CHUNK):
        y32[:, c:c + PLAIN_CHUNK] = b @ x[:, c:c + PLAIN_CHUNK].float()
    y = y32.to(x.dtype)
    if not with_gram:
        return y, None
    return y, gram_ref(y32)


def _weights(assign: Tensor, n_buckets: int) -> Tensor:
    """Per-worker B weight 1/|bucket| (fp32, as bucket_matrix forms it)."""
    counts = torch.bincount(assign, minlength=n_buckets)
    return (1.0 / counts.float())[assign]


def assignment_matrix(assignment: Tensor, n_buckets: int,
                      weight: Optional[Tensor] = None) -> Tensor:
    """The dense (n_b, n) fp32 B of (n,) bucket ids: ``B[a[i], i]`` is
    ``weight[i]``, by default 1/|bucket|."""
    assign = assignment.long()
    n = assign.shape[0]
    if weight is None:
        weight = _weights(assign, n_buckets)
    b = torch.zeros((n_buckets, n), dtype=torch.float32, device=assign.device)
    b[assign, torch.arange(n, device=assign.device)] = weight
    return b


def _from_matrix(bmat: Tensor, n: int) -> tuple[Tensor, Tensor, int]:
    """(assignment, per-worker weight, n_b) of a one-non-zero-per-column B."""
    if bmat.dim() != 2 or bmat.shape[1] != n:
        raise ValueError(f"bmat must be (n_b, {n}), got {tuple(bmat.shape)}")
    nz = bmat != 0
    if not bool((nz.sum(dim=0) == 1).all()):
        raise ValueError("bmat must hold exactly one non-zero per column "
                         "(a bucket-assignment matrix)")
    assign = nz.to(torch.int8).argmax(dim=0)
    weight = bmat.float()[assign, torch.arange(n, device=bmat.device)]
    return assign, weight, bmat.shape[0]


def _resolve(x: Tensor, assignment: Tensor, n_buckets: Optional[int],
             weight: Optional[Tensor]) -> tuple[Tensor, Tensor, int]:
    n = x.shape[0]
    assign = torch.as_tensor(assignment).to(device=x.device, dtype=torch.int64)
    if assign.shape != (n,):
        raise ValueError(f"assignment must have shape ({n},), got "
                         f"{tuple(assign.shape)}")
    top = int(assign.max())
    if n_buckets is None:
        n_buckets = top + 1
    if top >= n_buckets or int(assign.min()) < 0:
        raise ValueError(f"bucket ids must lie in [0, {n_buckets})")
    if weight is None:
        weight = _weights(assign, n_buckets)
    return assign, weight.to(device=x.device, dtype=torch.float32), n_buckets


def _blocks(x: Tensor, d: int, n_buckets: int) -> int:
    """Column blocks per lane.  Threads: one per four columns; above
    REG_NB buckets one per (bucket, four columns), with a (D,) scratch
    noting non-finite columns.  The lane form takes the same count, so
    that its register Gram folds the same partials."""
    units = -(-d // 4) * (1 if n_buckets <= REG_NB else n_buckets)
    return max(1, min(-(-units // _THREADS),
                      _BLOCKS_PER_SM * _build.sm_count(x.device)))


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def bucketgram(x: Tensor, assignment: Tensor, n_buckets: Optional[int] = None,
               *, weight: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """K6: (n, D) fp32 / bf16 stack and (n,) bucket ids -> (means (n_b, D)
    in X's dtype, fp32 (n_b, n_b) Gram of the fp32 means).  ``weight``
    (per worker) defaults to 1/|bucket|."""
    assign, weight, nb = _resolve(x, assignment, n_buckets, weight)
    if x.device.type == "cpu":
        return bucket_means_gram_ref(x, assignment_matrix(assign, nb, weight))
    check_stack(x, "bucketgram")
    y, g = _launch(x[None], assign[None], weight[None], nb, with_gram=True,
                   fold=lambda ym: _gram_op(ym[0])[None])
    bucketgram.launches += 1
    return y[0], g[0]


def bucketmeans(x: Tensor, assignment: Tensor, n_buckets: Optional[int] = None,
                *, weight: Optional[Tensor] = None) -> Tensor:
    """K7: the means of :func:`bucketgram` without the Gram."""
    assign, weight, nb = _resolve(x, assignment, n_buckets, weight)
    if x.device.type == "cpu":
        return bucket_means_gram_ref(x, assignment_matrix(assign, nb, weight),
                                     with_gram=False)[0]
    check_stack(x, "bucketgram")
    y, _ = _launch(x[None], assign[None], weight[None], nb, with_gram=False)
    bucketmeans.launches += 1
    return y[0]


bucketgram.launches = 0
bucketmeans.launches = 0


def bucket_means_gram(x: Tensor, bmat: Optional[Tensor] = None, *,
                      assignment: Optional[Tensor] = None,
                      n_buckets: Optional[int] = None,
                      with_gram: bool = True
                      ) -> tuple[Tensor, Optional[Tensor]]:
    """Bucket means (and with ``with_gram`` their fp32 Gram) of a (n, D)
    stack, from the dense (n_b, n) assignment matrix ``bmat`` or from the
    (n,) bucket ids ``assignment`` (weights 1/|bucket|).  Returns
    ``(means (n_b, D) in x.dtype, gram (n_b, n_b) fp32 | None)``."""
    if (bmat is None) == (assignment is None):
        raise ValueError("pass exactly one of bmat and assignment")
    weight = None
    if bmat is not None:
        assignment, weight, n_buckets = _from_matrix(bmat, x.shape[0])
    if with_gram:
        return bucketgram(x, assignment, n_buckets, weight=weight)
    return bucketmeans(x, assignment, n_buckets, weight=weight), None


# ---------------------------------------------------------------------------
# The lane forms: a (B, n, D) stack, each lane with its own bucket ids.
# ---------------------------------------------------------------------------

def _resolve_lanes(x: Tensor, assignments: Tensor, n_buckets: int
                   ) -> tuple[Tensor, Tensor]:
    """(assignments (B, n) int64, weights (B, n) fp32 1/|bucket|)."""
    b, n = x.shape[:2]
    assign = torch.as_tensor(assignments).to(device=x.device,
                                              dtype=torch.int64)
    if assign.shape != (b, n):
        raise ValueError(f"assignments must have shape ({b}, {n}), got "
                         f"{tuple(assign.shape)}")
    if int(assign.max()) >= n_buckets or int(assign.min()) < 0:
        raise ValueError(f"bucket ids must lie in [0, {n_buckets})")
    counts = torch.zeros((b, n_buckets), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, assign, torch.ones_like(assign))
    return assign, (1.0 / counts.float()).gather(1, assign)


def bucket_means_gram_lanes_ref(x: Tensor, assignments: Tensor,
                                n_buckets: int, *, with_gram: bool = True
                                ) -> tuple[Tensor, Optional[Tensor]]:
    """Plain version of the lane forms: :func:`bucket_means_gram_ref` (the
    dense fp32 ``B @ X`` and the Gram of the fp32 means) on each lane with
    its own assignment matrix; returns (means (B, n_b, D) in X's dtype,
    (B, n_b, n_b) fp32 Gram | None)."""
    assign, weight = _resolve_lanes(x, assignments, n_buckets)
    outs = [bucket_means_gram_ref(
        x[k], assignment_matrix(assign[k], n_buckets, weight[k]),
        with_gram=with_gram) for k in range(x.shape[0])]
    y = torch.stack([o[0] for o in outs])
    return y, (torch.stack([o[1] for o in outs]) if with_gram else None)


def _launch(x: Tensor, assign: Tensor, weight: Tensor, n_buckets: int,
            with_gram: bool, fold=_gram_batched_op
            ) -> tuple[Tensor, Optional[Tensor]]:
    """K6 / K7 on a (L, n, D) stack, each lane with its (L, n) bucket ids
    and weights; a single stack is lane 0 of L = 1.  Above REG_NB buckets
    the Gram is ``fold`` of the (L, n_b, D) fp32 means (K5, or K1 on one
    lane)."""
    lanes, n, d = x.shape
    # Each lane's workers sorted by bucket (stable), its bucket offsets and
    # each position's weight, as the single-lane launch forms them.
    order = torch.argsort(assign, dim=1, stable=True)
    start = torch.searchsorted(
        assign.gather(1, order),
        torch.arange(n_buckets + 1, device=x.device).expand(lanes, -1)
        .contiguous()).to(torch.int32)
    w = weight.gather(1, order).contiguous()
    order = order.to(torch.int32).contiguous()
    lib = _build.library()
    blocks = _blocks(x, d, n_buckets)
    y = torch.empty((lanes, n_buckets, d), dtype=x.dtype, device=x.device)
    bad = None if n_buckets <= REG_NB else torch.empty(
        (lanes, d), dtype=torch.int32, device=x.device)
    yf = partial = g = None
    if with_gram:
        if n_buckets <= REG_NB:
            partial = torch.empty(lanes * blocks * lib.repro_bucketgram_npair(),
                                  dtype=torch.float32, device=x.device)
            g = torch.empty((lanes, n_buckets, n_buckets),
                            dtype=torch.float32, device=x.device)
        elif x.dtype != torch.float32:
            yf = torch.empty((lanes, n_buckets, d), dtype=torch.float32,
                             device=x.device)
    with device_guard(x):
        rc = lib.repro_bucketgram(
            x.data_ptr(), _build.dtype_code(x.dtype), lanes, n, d,
            order.data_ptr(), start.data_ptr(), w.data_ptr(), n_buckets,
            y.data_ptr(), _ptr(yf), _ptr(partial), _ptr(g), _ptr(bad),
            blocks, stream_of(x))
    _build.check(rc, "bucketgram kernel")
    if with_gram and g is None:
        g = fold(y if yf is None else yf)
    return y, g


def bucketgram_lanes(x: Tensor, assignments: Tensor, n_buckets: int
                     ) -> tuple[Tensor, Tensor]:
    """K6 lanes: (B, n, D) fp32 / bf16 stack and (B, n) bucket ids ->
    (means (B, n_b, D) in X's dtype, fp32 (B, n_b, n_b) Gram of the fp32
    means), weights 1/|bucket| per lane."""
    assign, weight = _resolve_lanes(x, assignments, n_buckets)
    if x.device.type == "cpu":
        return bucket_means_gram_lanes_ref(x, assign, n_buckets)
    check_lanes(x, "bucketgram_lanes")
    out = _launch(x, assign, weight, n_buckets, with_gram=True)
    bucketgram_lanes.launches += 1
    return out


def bucketmeans_lanes(x: Tensor, assignments: Tensor, n_buckets: int
                      ) -> Tensor:
    """K7 lanes: the means of :func:`bucketgram_lanes` without the Gram."""
    assign, weight = _resolve_lanes(x, assignments, n_buckets)
    if x.device.type == "cpu":
        return bucket_means_gram_lanes_ref(x, assign, n_buckets,
                                           with_gram=False)[0]
    check_lanes(x, "bucketgram_lanes")
    y, _ = _launch(x, assign, weight, n_buckets, with_gram=False)
    bucketmeans_lanes.launches += 1
    return y


bucketgram_lanes.launches = 0
bucketmeans_lanes.launches = 0
