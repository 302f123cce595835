"""K1 · Gram matrix G = X X^T of a (n, D) worker stack, and K5 · the
lane-batched Gram of a (B, n, D) stack.

:func:`gram` and :func:`gram_batched` are the wrappers: for a CUDA stack
they launch the split-K kernels of ``csrc/gram.cu`` (the counterparts of
the TPU kernels ``repro/kernels/gram/kernel.py::gram_pallas`` and
``gram_batched_pallas``); K5 at n <= 32 workers launches the staged kernel
of ``csrc/gram_batched.cu``, which reads each lane's stack once, and above
that K1's kernels with a lane grid axis.  For a CPU stack they run
:func:`gram_ref` / :func:`gram_batched_ref`, the plain versions.
``gram.launches`` and ``gram_batched.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check_lanes, check_stack, stream_of

#: Threads per block of gram_partial (csrc/gram.cu).
_THREADS = 256
#: Partial-Gram blocks per SM and tile pair: enough in flight to cover
#: memory latency; each block then streams one contiguous D-chunk.
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


def _launch(x: torch.Tensor, lanes: int, n: int, d: int) -> torch.Tensor:
    lib = _build.library()
    pairs = lib.repro_gram_pairs(n)
    units = d // 4 if d % 4 == 0 else d
    chunks = max(1, min(-(-units // _THREADS),
                        _BLOCKS_PER_SM * _build.sm_count(x.device)
                        // (pairs * lanes)))
    partial = torch.empty(lanes * chunks * pairs * 64, dtype=torch.float32,
                          device=x.device)
    out = torch.empty((lanes, n, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.repro_gram(x.data_ptr(), _build.dtype_code(x.dtype), lanes,
                            n, d, partial.data_ptr(), chunks, out.data_ptr(),
                            stream_of(x))
    _build.check(rc, "gram kernel")
    return out


def gram(x: torch.Tensor) -> torch.Tensor:
    """(n, D) fp32 / bf16 -> (n, n) fp32 Gram matrix."""
    if x.device.type == "cpu":
        return gram_ref(x)
    check_stack(x, "gram")
    n, d = x.shape
    out = _launch(x, 1, n, d)[0]
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
    with torch.cuda.device(x.device):
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
        out = _launch(x, lanes, n, d)
    gram_batched.launches += 1
    return out


gram.launches = 0
gram_batched.launches = 0
