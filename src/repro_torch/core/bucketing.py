"""Bucketing (Karimireddy et al. 2022): the paper's randomized baseline and
the pre-reduction stage of hierarchical aggregation.

Counterpart of ``repro.core.bucketing``.  The n inputs are permuted, cut
into consecutive groups of size s, and the ceil(n/s) group means go to the
downstream rule with an adjusted Byzantine count.

Randomness: the reference draws its permutation with
``jax.random.permutation(key, n)``, which torch cannot replay.  Every
function here that needs a permutation takes either a ``torch.Generator``
(drawn with ``torch.randperm(n, generator=g)``) or an explicit ``perm``
tensor; a parity test passes the reference's permutation as ``perm``.
Both give the same grouping: worker i sits at position ``argsort(perm)[i]``
of the permuted stack ``x[perm]``, so its bucket is that position // s.

Two forms share :func:`bucket_assignment` / :func:`bucket_counts`:

* the **gather form** (:func:`bucketing`): permute, reshape, mean;
* the **matrix form** (:func:`bucket_matrix`): the (ceil(n/s), n)
  row-normalized assignment B with ``B[b, i] = 1/|bucket b|`` iff worker i
  landed in bucket b, so the means are ``B @ X``.  The bucketgram kernels
  (``repro_torch.kernels.bucketgram``) compute this contraction.

The two differ on non-finite rows: the dense contraction multiplies every
row by B's exact zeros, and 0 * inf = NaN, so one inf row turns every
OTHER bucket's mean NaN in that column; the gather form leaves only the
bucket holding that row non-finite.  The port keeps each semantics on its
own path, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def default_bucket_size(n: int, f: int) -> int:
    """Paper / [26] choice: s = floor(n / 2f) (>= 1)."""
    if f <= 0:
        return 1
    return max(1, n // (2 * f))


def clamp_bucket_size(n: int, s: Optional[int], f: int) -> int:
    """Resolve + clamp a bucket size to [1, n] (shared by every path)."""
    s = s if s is not None else default_bucket_size(n, f)
    return max(1, min(int(s), n))


def num_buckets(n: int, s: int) -> int:
    """ceil(n / s)."""
    return -(-n // s)


def bucket_counts(n: int, s: int, device=None) -> Tensor:
    """True occupancy of each of the ceil(n/s) buckets, fp32.

    All buckets hold s workers except a possibly ragged tail bucket
    (paper: n=17, s=2 -> 9 buckets, one singleton)."""
    nb = num_buckets(n, s)
    full = torch.full((nb,), s, dtype=torch.int64, device=device)
    left = n - torch.arange(nb, device=device) * s
    return torch.minimum(full, left).float()


def draw_perm(n: int, *, generator: Optional[torch.Generator] = None,
              perm: Optional[Tensor] = None, device=None) -> Tensor:
    """The permutation of n workers: ``perm`` as given (int64, on
    ``device``), else one drawn from ``generator``."""
    if perm is None:
        if generator is None:
            raise ValueError("bucketing needs a torch.Generator or an "
                             "explicit perm")
        perm = torch.randperm(n, generator=generator, device=generator.device)
    perm = torch.as_tensor(perm).to(device=device, dtype=torch.int64)
    if perm.shape != (n,):
        raise ValueError(f"perm must have shape ({n},), got {tuple(perm.shape)}")
    return perm


def bucket_assignment(n: int, s: int, *,
                      generator: Optional[torch.Generator] = None,
                      perm: Optional[Tensor] = None, device=None) -> Tensor:
    """(n,) int32 bucket id of every worker under the permutation: worker
    i goes to bucket ``argsort(perm)[i] // s``, the grouping
    :func:`bucketing` produces with the same permutation."""
    p = draw_perm(n, generator=generator, perm=perm, device=device)
    inv = torch.argsort(p)
    return torch.div(inv, s, rounding_mode="floor").to(torch.int32)


def bucket_matrix(n: int, s: int, *,
                  generator: Optional[torch.Generator] = None,
                  perm: Optional[Tensor] = None,
                  assignment: Optional[Tensor] = None,
                  dtype: torch.dtype = torch.float32, device=None) -> Tensor:
    """Row-normalized (ceil(n/s), n) bucket-assignment matrix B:
    ``B @ X`` is the bucket means of X (ragged tail renormalized by its
    true occupancy).  ``assignment`` skips drawing a permutation."""
    nb = num_buckets(n, s)
    if assignment is None:
        assignment = bucket_assignment(n, s, generator=generator, perm=perm,
                                       device=device)
    assign = assignment.to(device=device, dtype=torch.int64)
    onehot = torch.nn.functional.one_hot(assign, nb).float()     # (n, n_b)
    b = onehot.T / bucket_counts(n, s, device=assign.device)[:, None]
    return b.to(dtype)


def adjusted_f(f: int, n_buckets: int) -> int:
    """Downstream Byzantine budget after bucketing (static form): each
    Byzantine input contaminates at most one bucket, so f carries over,
    capped so the downstream rule keeps f' < n_buckets / 2."""
    return min(f, max(0, (n_buckets - 1) // 2)) if f else 0


def adjusted_f_dyn(f, n_buckets: int) -> Tensor:
    """:func:`adjusted_f` for an int-tensor f (fleet lanes, any shape):
    f capped at (n_buckets - 1) // 2, as an int32 tensor."""
    cap = max(0, (n_buckets - 1) // 2)
    return torch.clamp_max(torch.as_tensor(f).to(torch.int32), cap)


def bucketing(x: Tensor, f: int, *, generator: Optional[torch.Generator] = None,
              perm: Optional[Tensor] = None,
              bucket_size: Optional[int] = None) -> tuple[Tensor, int]:
    """Returns (bucket means (ceil(n/s), d), adjusted f).

    Dtype-preserving: the means accumulate in (at least) fp32 and are
    cast back to ``x.dtype``."""
    n = x.shape[0]
    s = clamp_bucket_size(n, bucket_size, f)
    p = draw_perm(n, generator=generator, perm=perm, device=x.device)
    acc = torch.promote_types(x.dtype, torch.float32)
    nb = num_buckets(n, s)
    xp = x[p].to(acc)
    pad = nb * s - n
    if pad:
        # Ragged tail bucket: pad with zeros and renormalize by true count.
        xp = torch.cat([xp, xp.new_zeros((pad,) + tuple(x.shape[1:]))])
    sums = xp.reshape((nb, s) + tuple(x.shape[1:])).sum(dim=1)
    counts = bucket_counts(n, s, device=x.device).to(acc)
    means = sums / counts.reshape((nb,) + (1,) * (x.dim() - 1))
    return means.to(x.dtype), adjusted_f(f, nb)


def bucketing_means(x: Tensor, f: int, *,
                    generator: Optional[torch.Generator] = None,
                    perm: Optional[Tensor] = None,
                    bucket_size: Optional[int] = None) -> Tensor:
    return bucketing(x, f, generator=generator, perm=perm,
                     bucket_size=bucket_size)[0]
