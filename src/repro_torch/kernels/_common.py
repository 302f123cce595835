"""Argument checks and the launch helpers shared by the kernel wrappers,
and the NaN-last sort of the plain versions.

A wrapper's host path runs once per launch, and the fleet's launches are
launch-sized (a (5, 17, 2842) stack is read in a few microseconds), so
these helpers build no tensor view, no ``torch.cuda.Stream`` and no device
context that a launch does not need."""
from __future__ import annotations

import contextlib

import torch


def check_stack(x: torch.Tensor, what: str) -> None:
    """A kernel input stack: 2-D, contiguous, fp32 or bf16, on CUDA."""
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{what}: expected a (n, D) stack, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: expected float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the stack must be contiguous")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{what}: empty stack {tuple(x.shape)}")


#: Largest lane count of a lane-batched launch (the CUDA grid's y / z).
MAX_LANES = 65535


def check_lanes(x: torch.Tensor, what: str) -> None:
    """A lane-batched kernel input: a (B, n, D) stack, each lane a valid
    :func:`check_stack` input, B <= :data:`MAX_LANES`.  The checks and
    messages are :func:`check_stack`'s on lane 0, read off ``x`` itself
    (a contiguous stack has contiguous lanes)."""
    shape = x.shape
    if len(shape) != 3:
        raise ValueError(f"{what}: expected a (B, n, D) stack, got "
                         f"{tuple(shape)}")
    if not 1 <= shape[0] <= MAX_LANES:
        raise ValueError(f"{what}: need 1 <= B <= {MAX_LANES} lanes, got "
                         f"{shape[0]}")
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: expected float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the stack must be contiguous")
    if shape[1] < 1 or shape[2] < 1:
        raise ValueError(f"{what}: empty stack {tuple(shape[1:])}")


def check_small(t: torch.Tensor, shape: tuple, x: torch.Tensor,
                what: str) -> None:
    """A small fp32 operand (coefficients, mixing matrix) beside ``x``, a
    CUDA tensor (so ``get_device`` tells the devices apart)."""
    if t.shape != shape:
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
    if t.dtype != torch.float32 or t.get_device() != x.get_device() \
            or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous float32 tensor on "
                         f"{x.device}, got {t.dtype} on {t.device}")


def stream_of(x: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``x``'s card: the
    ``cuda_stream`` of ``torch.cuda.current_stream(x.device)``, read
    without building the ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


_MAX_THREADS = 256
_MIN_THREADS = 32
_BLOCKS_PER_SM = 16


def launch_geometry(d: int, vec: int, sms: int,
                    max_threads: int = _MAX_THREADS) -> tuple[int, int]:
    """(threads per block, column blocks per lane) on lanes of D columns,
    ``vec`` a thread, on a card of ``sms`` SMs: K3's, K6 / K7's register
    path's (``max_threads`` 256) and the n <= 64 mixtrim body's (128).

    A lane has ceil(D / vec) units (a thread's ``vec`` columns).  The
    block is the largest of ``max_threads``, its halves and 32 threads that
    still gives a lane at least one block per SM, and 32 below that; the
    blocks cover the units once, capped at 16 per SM, the grid striding
    over the rest.  So the grid's (5, 17, 2842) fp32 lanes (vec = 2) run 45
    blocks of 32 threads a lane, one unit a thread, and a large D keeps the
    largest block and 16 blocks an SM a lane.  Neither the lane count nor
    n enters: a lane's geometry is the same whatever B, and in each of
    these kernels a column is one thread's work whatever the geometry."""
    units = -(-d // vec)
    threads = max_threads
    while threads > _MIN_THREADS and -(-units // threads) < sms:
        threads //= 2
    blocks = max(1, min(-(-units // threads), _BLOCKS_PER_SM * sms))
    return threads, blocks


_NO_GUARD = contextlib.nullcontext()


def device_guard(x: torch.Tensor):
    """The context a launch on ``x`` runs in: ``torch.cuda.device(x's
    card)`` when that card is not the current device, else nothing.

    The CUDA runtime refuses a launch into a stream of another card than
    the current one, and :func:`stream_of` hands the C entry the current
    stream of ``x``'s card.  When ``x`` lies on the current card (one
    card: always), entering ``torch.cuda.device`` would set the device it
    already has and set it back, so the launch goes without it.  When
    ``x`` lies on a second card, the guard makes that card current for
    the launch and restores the caller's device after it.  Which card is
    current is read from the runtime at each launch, so a caller's
    ``torch.cuda.set_device`` or guard of its own is seen."""
    if x.get_device() == torch._C._cuda_getDevice():
        return _NO_GUARD
    return torch.cuda.device(x.device)


def sort_nan_last(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.sort(x, dim).values`` with every NaN ranked last, the order
    of ``jnp.sort`` and of the kernels' keys.  ``torch.sort`` gives that
    order on the CPU, but on the card it ranks a NaN with its sign bit set
    (a negated NaN row, or NaNs made by x86 arithmetic) first; NaNs are
    made positive before the sort."""
    return torch.sort(x.masked_fill(torch.isnan(x), float("nan")), dim=dim).values
