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

The TPU layout padding (n_b to 8, n to ``block_n``, D to ``block_d``) is
not carried over: the kernels mask nothing and pad nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check_stack, stream_of
from repro_torch.kernels.gram import gram as _gram_op
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


def _launch(x: Tensor, assign: Tensor, weight: Tensor, n_buckets: int,
            with_gram: bool) -> tuple[Tensor, Optional[Tensor]]:
    check_stack(x, "bucketgram")
    n, d = x.shape
    # Workers sorted by bucket (stable: worker order inside a bucket), the
    # bucket offsets, and each position's weight.
    order = torch.argsort(assign, stable=True)
    start = torch.searchsorted(
        assign[order], torch.arange(n_buckets + 1, device=x.device)
    ).to(torch.int32)
    w = weight[order].contiguous()
    order = order.to(torch.int32)
    lib = _build.library()
    # Threads: one per four columns; above REG_NB buckets one per (bucket,
    # four columns), with a (D,) scratch noting non-finite columns.
    units = -(-d // 4) * (1 if n_buckets <= REG_NB else n_buckets)
    blocks = max(1, min(-(-units // _THREADS),
                        _BLOCKS_PER_SM * _build.sm_count(x.device)))
    y = torch.empty((n_buckets, d), dtype=x.dtype, device=x.device)
    bad = None if n_buckets <= REG_NB else torch.empty(
        (d,), dtype=torch.int32, device=x.device)
    yf = partial = g = None
    if with_gram:
        if n_buckets <= REG_NB:
            partial = torch.empty(blocks * lib.repro_bucketgram_npair(),
                                  dtype=torch.float32, device=x.device)
            g = torch.empty((n_buckets, n_buckets), dtype=torch.float32,
                            device=x.device)
        elif x.dtype != torch.float32:
            yf = torch.empty((n_buckets, d), dtype=torch.float32,
                             device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        rc = lib.repro_bucketgram(
            x.data_ptr(), _build.dtype_code(x.dtype), n, d, order.data_ptr(),
            start.data_ptr(), w.data_ptr(), n_buckets, y.data_ptr(), ptr(yf),
            ptr(partial), ptr(g), ptr(bad), blocks, stream_of(x))
    _build.check(rc, "bucketgram kernel")
    if with_gram and g is None:
        g = _gram_op(y if yf is None else yf)
    return y, g


def bucketgram(x: Tensor, assignment: Tensor, n_buckets: Optional[int] = None,
               *, weight: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """K6: (n, D) fp32 / bf16 stack and (n,) bucket ids -> (means (n_b, D)
    in X's dtype, fp32 (n_b, n_b) Gram of the fp32 means).  ``weight``
    (per worker) defaults to 1/|bucket|."""
    assign, weight, nb = _resolve(x, assignment, n_buckets, weight)
    if x.device.type == "cpu":
        return bucket_means_gram_ref(x, assignment_matrix(assign, nb, weight))
    out = _launch(x, assign, weight, nb, with_gram=True)
    bucketgram.launches += 1
    return out


def bucketmeans(x: Tensor, assignment: Tensor, n_buckets: Optional[int] = None,
                *, weight: Optional[Tensor] = None) -> Tensor:
    """K7: the means of :func:`bucketgram` without the Gram."""
    assign, weight, nb = _resolve(x, assignment, n_buckets, weight)
    if x.device.type == "cpu":
        return bucket_means_gram_ref(x, assignment_matrix(assign, nb, weight),
                                     with_gram=False)[0]
    y, _ = _launch(x, assign, weight, nb, with_gram=False)
    bucketmeans.launches += 1
    return y


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
