"""K1 · Gram matrix G = X X^T of a (n, D) worker stack, and K5 · the
lane-batched Gram of a (B, n, D) stack.

:func:`gram` and :func:`gram_batched` are the wrappers: for a CUDA stack
they launch the split-K kernels that replace the TPU kernels
``repro/kernels/gram/kernel.py::gram_pallas`` and ``gram_batched_pallas``,
routed by the worker count n (``csrc/gram.cu``'s note says why):

* n <= 8 (K1 only, the main path): ``csrc/gram.cu``'s one-tile kernel;
* n <= 32: the staged kernel of ``csrc/gram_batched.cu``, which reads each
  row once (K1 as one lane);
* n > 32: ``csrc/gram.cu``'s register-tiled product over upper-triangle
  tile pairs, TM x TM output tiles with TM from
  ``repro_gram_tiled_tm(n)``; K5 takes it with a lane grid axis.

For a CPU stack they run :func:`gram_ref` / :func:`gram_batched_ref`, the
plain versions.  ``gram.launches`` and ``gram_batched.launches`` count
kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_lanes, check_stack, device_guard, stream_of,
)

#: Threads per block of gram_rows (csrc/gram.cu, n <= 8).
_THREADS = 256
#: gram_rows blocks per SM: enough in flight to cover memory latency; each
#: block then streams one contiguous D-chunk.
_BLOCKS_PER_SM = 8


#: Column chunk of the plain version.  One fp32 BLAS contraction over a
#: D of 10^8 accumulates each entry nearly sequentially: on an H100 at
#: D = 361,821,120 a single ``x @ x.T`` was off by 3e-4 of max|G| from an
#: fp64 Gram (PERF.md).  Partial Grams over at most this many columns,
#: summed by ``torch.sum``, keep the plain version fp32-tight at any D.
PLAIN_CHUNK = 1 << 16


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: X X^T with fp32 products and sums (bf16 widens to
    fp32 exactly, so this is the reference's preferred_element_type=f32
    contraction), in column chunks of :data:`PLAIN_CHUNK`."""
    d = x.shape[1]
    if d <= PLAIN_CHUNK:
        xf = x.float()
        return xf @ xf.T
    parts = []
    for c in range(0, d, PLAIN_CHUNK):
        xf = x[:, c:c + PLAIN_CHUNK].float()
        parts.append(xf @ xf.T)
    return torch.stack(parts).sum(dim=0)


def gram_batched_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: :func:`gram_ref`, K1's plain version, on each
    lane of a (B, n, D) stack."""
    return torch.stack([gram_ref(x[k]) for k in range(x.shape[0])])


def _launch_rows(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    lib = _build.library()
    units = d // 4 if d % 4 == 0 else d
    chunks = max(1, min(-(-units // _THREADS),
                        _BLOCKS_PER_SM * _build.sm_count(x.device)))
    partial = torch.empty(chunks * 64, dtype=torch.float32, device=x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    with device_guard(x):
        rc = lib.repro_gram(x.data_ptr(), _build.dtype_code(x.dtype), n, d,
                            partial.data_ptr(), chunks, out.data_ptr(),
                            stream_of(x))
    _build.check(rc, "gram kernel")
    return out


def _launch_tiled(x: torch.Tensor, lanes: int, n: int, d: int,
                  tm: Optional[int] = None) -> torch.Tensor:
    """The tiled kernel on a (lanes, n, d) stack; ``tm`` overrides the tile
    height (32, 64 or 128) that ``repro_gram_tiled_tm(n)`` picks, so that
    the crossover can be measured."""
    lib = _build.library()
    if tm is None:
        tm = lib.repro_gram_tiled_tm(n)
    chunks = lib.repro_gram_tiled_chunks(lanes, n, d, tm,
                                         _build.sm_count(x.device))
    partial = torch.empty(lib.repro_gram_tiled_scratch(lanes, n, tm, chunks),
                          dtype=torch.float32, device=x.device)
    out = torch.empty((lanes, n, n), dtype=torch.float32, device=x.device)
    with device_guard(x):
        rc = lib.repro_gram_tiled(x.data_ptr(), _build.dtype_code(x.dtype),
                                  lanes, n, d, tm, partial.data_ptr(), chunks,
                                  out.data_ptr(), stream_of(x))
    _build.check(rc, "gram kernel (tiled)")
    return out


def gram(x: torch.Tensor) -> torch.Tensor:
    """(n, D) fp32 / bf16 -> (n, n) fp32 Gram matrix."""
    if x.device.type == "cpu":
        return gram_ref(x)
    check_stack(x, "gram")
    n, d = x.shape
    lib = _build.library()
    if n <= lib.repro_gram_rows_max_n():
        out = _launch_rows(x, n, d)
    elif n <= lib.repro_gram_staged_max_n():
        out = _launch_staged(x[None], 1, n, d)[0]
    else:
        out = _launch_tiled(x[None], 1, n, d)[0]
    gram.launches += 1
    return out


def _launch_staged(x: torch.Tensor, lanes: int, n: int, d: int
                   ) -> torch.Tensor:
    lib = _build.library()
    chunks = lib.repro_gram_batched_chunks(lanes, n, d,
                                           _build.sm_count(x.device))
    partial = torch.empty(lanes * chunks * lib.repro_gram_batched_slots(n),
                          dtype=torch.float32, device=x.device)
    out = torch.empty((lanes, n, n), dtype=torch.float32, device=x.device)
    with device_guard(x):
        rc = lib.repro_gram_batched(x.data_ptr(), _build.dtype_code(x.dtype),
                                    lanes, n, d, partial.data_ptr(), chunks,
                                    out.data_ptr(), stream_of(x))
    _build.check(rc, "gram_batched kernel")
    return out


def gram_batched(x: torch.Tensor) -> torch.Tensor:
    """(B, n, D) fp32 / bf16 -> (B, n, n) fp32: every lane's Gram in one
    launch pair (K5)."""
    if x.device.type == "cpu":
        return gram_batched_ref(x)
    check_lanes(x, "gram_batched")
    lanes, n, d = x.shape
    if n <= _build.library().repro_gram_staged_max_n():
        out = _launch_staged(x, lanes, n, d)
    else:
        out = _launch_tiled(x, lanes, n, d)
    gram_batched.launches += 1
    return out


gram.launches = 0
gram_batched.launches = 0
