"""K1 · Gram matrix G = X X^T of a (n, D) worker stack.

:func:`gram` is the wrapper: for a CUDA stack it launches the split-K
kernel of ``csrc/gram.cu`` (the counterpart of the TPU kernel
``repro/kernels/gram/kernel.py::gram_pallas``); for a CPU stack it runs
:func:`gram_ref`, the plain version.  ``gram.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check_stack, stream_of

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


def gram(x: torch.Tensor) -> torch.Tensor:
    """(n, D) fp32 / bf16 -> (n, n) fp32 Gram matrix."""
    if x.device.type == "cpu":
        return gram_ref(x)
    check_stack(x, "gram")
    lib = _build.library()
    n, d = x.shape
    pairs = lib.repro_gram_pairs(n)
    units = d // 4 if d % 4 == 0 else d
    chunks = max(1, min(-(-units // _THREADS),
                        _BLOCKS_PER_SM * _build.sm_count(x.device) // pairs))
    partial = torch.empty(chunks * pairs * 64, dtype=torch.float32,
                          device=x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.repro_gram(x.data_ptr(), _build.dtype_code(x.dtype), n, d,
                            partial.data_ptr(), chunks, out.data_ptr(),
                            stream_of(x))
    _build.check(rc, "gram kernel")
    gram.launches += 1
    return out


gram.launches = 0
