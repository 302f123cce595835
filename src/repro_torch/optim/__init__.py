"""Server-side optimizers and schedules (counterpart of repro.optim)."""
from repro_torch.optim.optimizers import (
    Optimizer, OptState, adam, clip_by_global_norm, global_norm, sgd,
)
from repro_torch.optim.schedules import constant, cosine, piecewise, step_decay

__all__ = ["adam", "clip_by_global_norm", "global_norm", "sgd", "OptState",
           "Optimizer", "constant", "cosine", "piecewise", "step_decay"]
