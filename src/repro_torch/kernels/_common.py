"""Argument checks shared by the kernel wrappers, and the NaN-last sort of
the plain versions."""
from __future__ import annotations

import torch


def check_stack(x: torch.Tensor, what: str) -> None:
    """A kernel input stack: 2-D, contiguous, fp32 or bf16, on CUDA."""
    if x.device.type != "cuda":
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
    :func:`check_stack` input, B <= :data:`MAX_LANES`."""
    if x.dim() != 3:
        raise ValueError(f"{what}: expected a (B, n, D) stack, got "
                         f"{tuple(x.shape)}")
    if not 1 <= x.shape[0] <= MAX_LANES:
        raise ValueError(f"{what}: need 1 <= B <= {MAX_LANES} lanes, got "
                         f"{x.shape[0]}")
    check_stack(x[0], what)
    if not x.is_contiguous():
        raise ValueError(f"{what}: the stack must be contiguous")


def check_small(t: torch.Tensor, shape: tuple, x: torch.Tensor,
                what: str) -> None:
    """A small fp32 operand (coefficients, mixing matrix) beside ``x``."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
    if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous float32 tensor on "
                         f"{x.device}, got {t.dtype} on {t.device}")


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def sort_nan_last(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.sort(x, dim).values`` with every NaN ranked last, the order
    of ``jnp.sort`` and of the kernels' keys.  ``torch.sort`` gives that
    order on the CPU, but on the card it ranks a NaN with its sign bit set
    (a negated NaN row, or NaNs made by x86 arithmetic) first; NaNs are
    made positive before the sort."""
    return torch.sort(x.masked_fill(torch.isnan(x), float("nan")), dim=dim).values
