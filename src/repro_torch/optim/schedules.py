"""Learning-rate schedules (counterpart of ``repro.optim.schedules``).

Each returns ``fn(step) -> float``, evaluated in float32 arithmetic as the
reference's jnp forms are, so both packages step with the same lr.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(lr: float):
    return lambda step: float(_F(lr))


def step_decay(lr0: float, every: int, factor: float = 0.5):
    """Paper's MNIST schedule: gamma_t = lr0 / (1 + floor(t/every))."""
    def fn(step):
        return float(_F(lr0) / (_F(1.0) + _F(step // every)))
    return fn


def piecewise(lr0: float, boundaries: tuple[int, ...], values: tuple[float, ...]):
    """Paper's CIFAR schedule: lr0 until boundary, then values[i]."""
    def fn(step):
        lr = _F(lr0)
        for b, v in zip(boundaries, values):
            if step >= b:
                lr = _F(v)
        return float(lr)
    return fn


def cosine(lr0: float, total_steps: int, warmup: int = 0, floor: float = 0.0):
    def fn(step):
        s = _F(step)
        warm = min(_F(1.0), s / _F(max(1, warmup))) if warmup else _F(1.0)
        frac = np.clip((s - _F(warmup)) / _F(max(1, total_steps - warmup)),
                       _F(0.0), _F(1.0))
        cos = _F(floor) + _F(1 - floor) * _F(0.5) * (_F(1) + np.cos(_F(np.pi) * frac))
        return float(_F(lr0) * warm * cos)
    return fn
