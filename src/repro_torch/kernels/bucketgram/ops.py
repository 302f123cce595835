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
* :func:`bucketgram_lanes_perms` / :func:`bucketmeans_lanes_perms` are the
  fleet's route to the same lane forms (and counters): each lane's
  permutation and the bucket size s, as the hierarchical lanes hold them
  (bucket k: the workers at permutation positions [k s, k s + s)).  The
  register path builds each lane's plan in each block (``stage_plan``,
  whose plain version is :func:`perm_plan_ref`), so the call reads
  nothing back from the card and makes no torch op but its outputs'
  allocations; above PERM_MAX_S, or off the register path, the route runs
  :func:`perm_plan_ref` itself (torch ops on the card, nothing read
  back).  The ids of the public forms take :func:`plan_arrays`, after
  their checks.

A launch's shape-dependent arguments go in a :class:`Plan`, filled once
per shape (cached) and passed by address; its scratch (the plan arrays,
the Gram partials) is one allocation.

The TPU layout padding (n_b to 8, n to ``block_n``, D to ``block_d``) is
not carried over: the kernels mask nothing and pad nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_lanes, check_stack, device_guard, launch_geometry, stream_of,
)
from repro_torch.kernels.gram import gram as _gram_op
from repro_torch.kernels.gram import gram_batched as _gram_batched_op
from repro_torch.kernels.gram import gram_ref

_THREADS = 256
_BLOCKS_PER_SM = 16
#: Largest bucket count whose Gram K6 folds in registers
#: (csrc/bucketgram.cu NB).
REG_NB = 8
#: Largest bucket count whose means alone take the register path
#: (csrc/bucketgram.cu MEANS_NB); above it, a thread per (bucket, columns).
MEANS_NB = 16
#: Largest worker count of the register path (csrc/bucketgram.cu
#: REG_MAX_N: its plan sits in shared memory).
REG_MAX_N = 4096
#: Largest bucket size whose permutation route the kernel plans itself (a
#: worker's rank in its bucket costs s reads); above it, or off the
#: register path, the plan is :func:`perm_plan_ref` on the device, handed
#: over as the id route's.
PERM_MAX_S = 64
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


def load_width(x_off: int, y_off: int, yf_off: Optional[int], d: int,
               itemsize: int) -> int:
    """Elements a thread of the register path loads from a row at once:
    the widest of 8 (bf16 only: 16 bytes), 4, 2 and 1 that divides D and
    to which the stack's, the means' and the fp32 means' base offsets
    (within 16 bytes) are aligned, so every row and lane start is too."""
    for vec in ((8, 4, 2) if itemsize == 2 else (4, 2)):
        if d % vec == 0 and x_off % (vec * itemsize) == 0 \
                and y_off % (vec * itemsize) == 0 \
                and (yf_off is None or yf_off % min(vec * 4, 16) == 0):
            return vec
    return 1


class Plan(ctypes.Structure):
    """``ReproBucketPlan`` of csrc/bucketgram.cu: what a launch at one
    shape passes besides its pointers and stream."""
    _fields_ = [("d", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("lanes", ctypes.c_int), ("n", ctypes.c_int),
                ("nb", ctypes.c_int), ("s", ctypes.c_int),
                ("reg", ctypes.c_int), ("gram", ctypes.c_int),
                ("vec", ctypes.c_int), ("threads", ctypes.c_int),
                ("blocks", ctypes.c_int)]


def register_path(n: int, nb: int, gram: bool) -> bool:
    """Whether a launch takes the register path: its plan fits shared
    memory (n <= REG_MAX_N) and every bucket's means fit its registers
    (n_b <= REG_NB with the register Gram, <= MEANS_NB without)."""
    return n <= REG_MAX_N and nb <= (REG_NB if gram else MEANS_NB)


def plan_geometry(d: int, n: int, nb: int, gram: bool, vec: int, sms: int
                  ) -> tuple[bool, int, int]:
    """(register path, threads, column blocks per lane).  The register path
    (:func:`register_path`) takes
    :func:`~repro_torch.kernels._common.launch_geometry`, with blocks of up
    to 128 threads with the Gram (its registers hold every bucket's means);
    else a thread per (bucket, four columns), 256 a block, at most 16
    blocks an SM.  The lane count does not enter, so the register Gram of
    a lane folds the partials of its single-lane launch."""
    if register_path(n, nb, gram):
        return (True, *launch_geometry(d, vec, sms, 128 if gram else 256))
    units = -(-d // 4) * nb
    return False, _THREADS, max(1, min(-(-units // _THREADS),
                                       _BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=256)
def _plan(d: int, x_off: int, y_off: int, yf_off: Optional[int],
          dtype: torch.dtype, lanes: int, n: int, nb: int, s: int, gram: bool,
          device: int) -> tuple[Plan, int, int]:
    """(plan, its address, scratch words) of a launch at one shape, with
    the register Gram (``gram``) or not and ``s`` > 0 for the permutation
    route; the cache holds the structure alive."""
    vec = load_width(x_off, y_off, yf_off, d, dtype.itemsize)
    reg, threads, blocks = plan_geometry(d, n, nb, gram, vec,
                                         _build.sm_count(device))
    plan = Plan(d, _build.dtype_code(dtype), lanes, n, nb, s, int(reg),
                int(gram), vec, threads, blocks)
    addr = ctypes.addressof(plan)
    return plan, addr, _build.library().repro_bucketgram_scratch(addr)


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
    y, g = _launch_ids(x[None], assign[None], weight[None], nb,
                       with_gram=True, fold=lambda ym: _gram_op(ym[0])[None])
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
    y, _ = _launch_ids(x[None], assign[None], weight[None], nb,
                       with_gram=False)
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


def plan_arrays(assign: Tensor, weight: Tensor, n_buckets: int
                ) -> tuple[Tensor, Tensor, Tensor]:
    """The kernel's plan of (L, n) bucket ids and weights: each lane's
    workers sorted by bucket (stable: each bucket's members in worker
    order) as int32, its (L, n_b + 1) int32 bucket offsets and each
    position's fp32 weight."""
    lanes = assign.shape[0]
    order = torch.argsort(assign, dim=1, stable=True)
    start = torch.searchsorted(
        assign.gather(1, order),
        torch.arange(n_buckets + 1, device=assign.device).expand(lanes, -1)
        .contiguous()).to(torch.int32)
    w = weight.gather(1, order).contiguous()
    return order.to(torch.int32).contiguous(), start, w


def perm_plan_ref(perms: Tensor, s: int) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of ``stage_plan``: the plan of (L, n) permutations in
    buckets of s (bucket k: the workers at positions [k s, k s + s) of a
    lane's permutation, in worker order, weight 1 / their count, the
    ragged tail's included), as :func:`plan_arrays` gives it for the ids
    :func:`perm_assignment` makes."""
    lanes, n = perms.shape
    nb = -(-n // s)
    p = perms.long()
    if nb * s > n:                      # pads sort after every worker
        p = torch.cat([p, p.new_full((lanes, nb * s - n), n)], 1)
    order = torch.sort(p.reshape(lanes, nb, s), dim=2).values
    order = order.reshape(lanes, nb * s)[:, :n].to(torch.int32).contiguous()
    sizes = torch.clamp(n - torch.arange(nb, device=perms.device) * s, max=s)
    weight = (1.0 / sizes.float())[
        torch.div(torch.arange(n, device=perms.device), s,
                  rounding_mode="floor")]
    start = torch.clamp(torch.arange(nb + 1, device=perms.device) * s, max=n)
    return (order, start.to(torch.int32).expand(lanes, -1).contiguous(),
            weight.expand(lanes, -1).contiguous())


def perm_assignment(perms: Tensor, s: int) -> Tensor:
    """(L, n) int64 bucket ids of each lane's permutation in buckets of s:
    worker i goes to bucket argsort(perms[b])[i] // s
    (``bucketing.bucket_assignment`` on each lane)."""
    return torch.div(torch.argsort(perms, dim=1), s, rounding_mode="floor")


def _run(x: Tensor, n_buckets: int, s: int, perms: Optional[Tensor],
         fill: Optional[Callable[[Tensor], None]], with_gram: bool,
         fold) -> tuple[Tensor, Optional[Tensor]]:
    """K6 / K7 on a (L, n, D) stack; a single stack is lane 0 of L = 1.
    The plan comes from ``perms`` (L, n) int64 in buckets of ``s`` (built
    by the register path up to PERM_MAX_S), or ``fill`` writes it at the
    head of the scratch.  Up to REG_NB buckets (and REG_MAX_N workers) K6 folds
    the Gram itself; above, the Gram is ``fold`` of the (L, n_b, D) fp32
    means (K5, or K1 on one lane)."""
    lanes, n, d = x.shape
    gram = with_gram and n_buckets <= REG_NB and n <= REG_MAX_N
    if perms is not None and (s > PERM_MAX_S
                              or not register_path(n, n_buckets, gram)):
        perms, s, fill = None, 0, _writer(*perm_plan_ref(perms, s))
    y = torch.empty((lanes, n_buckets, d), dtype=x.dtype, device=x.device)
    yf = g = None
    if gram:
        g = torch.empty((lanes, n_buckets, n_buckets), dtype=torch.float32,
                        device=x.device)
    elif with_gram and x.dtype != torch.float32:
        yf = torch.empty((lanes, n_buckets, d), dtype=torch.float32,
                         device=x.device)
    x_ptr, y_ptr = x.data_ptr(), y.data_ptr()
    yf_ptr = _ptr(yf)
    _, plan, words = _plan(d, x_ptr & 15, y_ptr & 15,
                           None if yf_ptr is None else yf_ptr & 15, x.dtype,
                           lanes, n, n_buckets, s, gram, x.get_device())
    scratch = None
    if words:
        scratch = torch.empty((words,), dtype=torch.int32, device=x.device)
        if fill is not None:
            fill(scratch)
    lib = _build.library()
    with device_guard(x):
        rc = lib.repro_bucketgram(x_ptr, _ptr(perms), _ptr(scratch), y_ptr,
                                  yf_ptr, _ptr(g), plan, stream_of(x))
    if rc:
        _build.check(rc, "bucketgram kernel")
    if with_gram and g is None:
        g = fold(y if yf is None else yf)
    return y, g


def _launch_ids(x: Tensor, assign: Tensor, weight: Tensor, n_buckets: int,
                with_gram: bool, fold=_gram_batched_op
                ) -> tuple[Tensor, Optional[Tensor]]:
    """K6 / K7 on a (L, n, D) stack, each lane with its (L, n) bucket ids
    and weights: the plan built by :func:`plan_arrays` and written into
    the scratch."""
    fill = _writer(*plan_arrays(assign, weight, n_buckets))
    return _run(x, n_buckets, 0, None, fill, with_gram, fold)


def _writer(order: Tensor, start: Tensor, weight: Tensor
            ) -> Callable[[Tensor], None]:
    """Writes a plan's arrays at the head of a launch's int32 scratch, where
    the kernel reads them: order, start, then the weights' fp32 words."""
    def fill(scratch: Tensor) -> None:
        o, st = order.numel(), start.numel()
        scratch[:o].copy_(order.reshape(-1))
        scratch[o:o + st].copy_(start.reshape(-1))
        scratch[o + st:2 * o + st].copy_(weight.reshape(-1).view(torch.int32))
    return fill


def bucketgram_lanes(x: Tensor, assignments: Tensor, n_buckets: int
                     ) -> tuple[Tensor, Tensor]:
    """K6 lanes: (B, n, D) fp32 / bf16 stack and (B, n) bucket ids ->
    (means (B, n_b, D) in X's dtype, fp32 (B, n_b, n_b) Gram of the fp32
    means), weights 1/|bucket| per lane."""
    assign, weight = _resolve_lanes(x, assignments, n_buckets)
    if x.device.type == "cpu":
        return bucket_means_gram_lanes_ref(x, assign, n_buckets)
    check_lanes(x, "bucketgram_lanes")
    out = _launch_ids(x, assign, weight, n_buckets, with_gram=True)
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
    y, _ = _launch_ids(x, assign, weight, n_buckets, with_gram=False)
    bucketmeans_lanes.launches += 1
    return y


bucketgram_lanes.launches = 0
bucketmeans_lanes.launches = 0


def _check_perms(x: Tensor, perms: Tensor, bucket_size: int,
                 what: str) -> int:
    """The permutation route's operands (no value read: a check of the
    values would wait for the card), in one test on the fleet's path and
    with a message for what fails.  Returns the bucket count."""
    check_lanes(x, what)
    shape = x.shape
    n = shape[1]
    if perms.shape != shape[:2] or perms.dtype != torch.int64 \
            or perms.get_device() != x.get_device() \
            or not perms.is_contiguous() or not 1 <= bucket_size <= n:
        if perms.shape != shape[:2]:
            raise ValueError(f"{what}: perms must have shape "
                             f"{tuple(shape[:2])}, got {tuple(perms.shape)}")
        if not 1 <= bucket_size <= n:
            raise ValueError(f"{what}: need 1 <= bucket_size <= {n}, got "
                             f"{bucket_size}")
        raise ValueError(f"{what}: perms must be a contiguous int64 tensor "
                         f"on {x.device}, got {perms.dtype} on "
                         f"{perms.device}")
    return -(-n // bucket_size)


def bucketgram_lanes_perms(x: Tensor, perms: Tensor, bucket_size: int
                           ) -> tuple[Tensor, Tensor]:
    """K6 lanes from each lane's permutation: (B, n, D) fp32 / bf16 stack
    and (B, n) int64 permutations of range(n) on its card, buckets of
    ``bucket_size`` in permutation order -> (means (B, n_b, D) in X's
    dtype, fp32 (B, n_b, n_b) Gram), equal bit for bit to
    :func:`bucketgram_lanes` on :func:`perm_assignment`'s ids.  The
    permutations are not checked (that would read them back): a value
    outside range(n) is clamped to a row.  Counted in
    ``bucketgram_lanes.launches``."""
    if x.is_cpu:
        nb = -(-x.shape[1] // bucket_size)
        return bucket_means_gram_lanes_ref(
            x, perm_assignment(perms, bucket_size), nb)
    nb = _check_perms(x, perms, bucket_size, "bucketgram_lanes")
    out = _run(x, nb, bucket_size, perms, None, True, _gram_batched_op)
    bucketgram_lanes.launches += 1
    return out


def bucketmeans_lanes_perms(x: Tensor, perms: Tensor, bucket_size: int
                            ) -> Tensor:
    """K7 lanes from each lane's permutation: the means of
    :func:`bucketgram_lanes_perms` without the Gram.  Counted in
    ``bucketmeans_lanes.launches``."""
    if x.is_cpu:
        nb = -(-x.shape[1] // bucket_size)
        return bucket_means_gram_lanes_ref(
            x, perm_assignment(perms, bucket_size), nb, with_gram=False)[0]
    nb = _check_perms(x, perms, bucket_size, "bucketgram_lanes")
    y, _ = _run(x, nb, bucket_size, perms, None, False, None)
    bucketmeans_lanes.launches += 1
    return y
