"""Data-poisoning threat models: corruption through the batch, not the
gradient (counterpart of ``repro.fed.poison``).

The adversary controls only its clients' training data and then computes
honestly, so its update stays a realisable gradient (Farhadkhani et al.,
PAPERS.md).  Poisoning hits the LAST ``m_byz`` cohort rows (honest rows
first) inside the round, on the batch's device; label flipping maps
``l -> n_classes - 1 - l``, so a ``rate=1.0`` label-flip run equals the
scheduled ``"lf"`` attack bit for bit (``tests/test_torch_guard_poison.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

POISON_KINDS = ("labelflip", "feature")


@dataclasses.dataclass(frozen=True)
class PoisonConfig:
    """Static description of a data-poisoning threat model.

    ``kind`` "labelflip" (labels ``l -> n_classes-1-l`` on poisoned
    samples) or "feature" (additive Gaussian noise of scale ``strength``
    on poisoned samples' features); ``rate`` the fraction of each
    Byzantine client's samples poisoned per batch; ``labels_key`` /
    ``features_key`` the batch keys it targets; ``n_classes`` the
    label-flip alphabet."""

    kind: str = "labelflip"
    rate: float = 1.0
    strength: float = 1.0
    labels_key: str = "y"
    features_key: str = "x"
    n_classes: int = 10

    def __post_init__(self):
        if self.kind not in POISON_KINDS:
            raise ValueError(f"unknown poison kind {self.kind!r}; known: "
                             f"{POISON_KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")

    def static_signature(self) -> tuple:
        """The fields that change the round's code path (fleet bucket-key
        material in the reference)."""
        return (self.kind, self.labels_key, self.features_key,
                self.n_classes)


def static_signature(cfg: Optional[PoisonConfig]) -> Optional[tuple]:
    """:meth:`PoisonConfig.static_signature`, None without poisoning."""
    return None if cfg is None else cfg.static_signature()


def poison_batch(batch: dict, cfg: PoisonConfig, m_byz: int, *,
                 rate: float, strength: float,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Tensor] = None) -> dict:
    """Corrupt the last ``m_byz`` cohort rows of a (m, L, B, ...) batch of
    tensors; returns a new dict (``batch`` is left as it is).

    The first floor(rate * B) positions of each slice are poisoned (the
    threshold formed in fp32, as the reference forms it), which keeps the
    count exact without consuming randomness.  "feature" noise is
    standard normal of the features' shape, drawn from ``generator`` (a
    CPU generator, so a CPU and a CUDA run draw alike) unless ``noise``
    gives it (e.g. the reference's draw); it is scaled by ``strength`` in
    fp32."""
    y = batch[cfg.labels_key]
    m, _, b = y.shape[:3]
    dev = y.device
    thr = float(np.float32(rate) * np.float32(b))
    byz_row = torch.arange(m, device=dev) >= m - m_byz
    sample_sel = torch.arange(b, device=dev).float() < thr
    mask = byz_row[:, None, None] & sample_sel[None, None, :]

    out = dict(batch)
    if cfg.kind == "labelflip":
        flipped = ((cfg.n_classes - 1) - y).to(y.dtype)
        out[cfg.labels_key] = torch.where(mask, flipped, y)
        return out
    x = batch[cfg.features_key]
    if noise is None:
        if generator is None:
            raise ValueError("feature poisoning needs a torch.Generator or "
                             "an explicit noise tensor")
        noise = torch.randn(tuple(x.shape), generator=generator,
                            dtype=torch.float32)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(dev) \
        * float(np.float32(strength))
    fmask = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 3))
    xf = x.float()
    out[cfg.features_key] = torch.where(fmask, xf + noise, xf).to(x.dtype)
    return out
