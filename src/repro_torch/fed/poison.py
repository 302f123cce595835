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

    :func:`poison_batch_lanes` on one lane.  "feature" noise is standard
    normal of the features' shape, drawn from ``generator`` (a CPU
    generator, so a CPU and a CUDA run draw alike) unless ``noise`` gives
    it (e.g. the reference's draw)."""
    keys = [cfg.labels_key]
    if cfg.kind == "feature":
        keys.append(cfg.features_key)
        x = batch[cfg.features_key]
        if noise is None:
            if generator is None:
                raise ValueError("feature poisoning needs a torch.Generator "
                                 "or an explicit noise tensor")
            noise = torch.randn(tuple(x.shape), generator=generator,
                                dtype=torch.float32)
        noise = torch.as_tensor(noise, dtype=torch.float32)[None]
    dev = batch[cfg.labels_key].device
    # Filled on the device: no host copy (and no stream sync) per round.
    lane = poison_batch_lanes(
        {k: batch[k][None] for k in keys}, cfg,
        torch.full((1,), m_byz, dtype=torch.int64, device=dev),
        rate=torch.full((1,), rate, dtype=torch.float32, device=dev),
        strength=torch.full((1,), strength, dtype=torch.float32, device=dev),
        noise=noise)
    out = dict(batch)
    for k in keys:
        out[k] = lane[k][0]
    return out


def poison_batch_lanes(batch: dict, cfg: PoisonConfig, m_byz: Tensor, *,
                       rate: Tensor, strength: Tensor,
                       noise: Optional[Tensor] = None) -> dict:
    """Data poisoning on a lane axis: batch leaves (B, m, L, bs, ...) and
    ``m_byz`` / ``rate`` / ``strength`` (B,) tensors, one value a lane
    (the fleet's lane operands; the poison KIND is the bucket's).  Lane k
    poisons its last ``m_byz[k]`` cohort rows; returns a new dict.

    The first floor(rate * bs) positions of each slice are poisoned (the
    threshold formed in fp32, as the reference forms it), which keeps the
    count exact without consuming randomness; ``rate=0`` leaves a lane
    clean.  "feature" takes its (B, m, L, bs, ...) standard normal
    ``noise`` from the caller (the fleet's host plan draws it from each
    lane's CPU generator), scaled by the lane's ``strength`` in fp32."""
    y = batch[cfg.labels_key]
    nl, m, _, b = y.shape[:4]
    dev = y.device
    thr = rate.to(device=dev, dtype=torch.float32) * np.float32(b)
    byz_row = torch.arange(m, device=dev)[None] >= \
        (m - m_byz.to(dev))[:, None]
    sample_sel = torch.arange(b, device=dev).float()[None] < thr[:, None]
    mask = byz_row[:, :, None, None] & sample_sel[:, None, None, :]

    out = dict(batch)
    if cfg.kind == "labelflip":
        flipped = ((cfg.n_classes - 1) - y).to(y.dtype)
        out[cfg.labels_key] = torch.where(mask, flipped, y)
        return out
    if noise is None:
        raise ValueError("feature poisoning on lanes needs the lanes' noise")
    x = batch[cfg.features_key]
    scale = strength.to(device=dev, dtype=torch.float32)
    noise = noise.to(device=dev, dtype=torch.float32) \
        * scale.reshape((nl,) + (1,) * (x.dim() - 1))
    fmask = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 4))
    xf = x.float()
    out[cfg.features_key] = torch.where(fmask, xf + noise, xf).to(x.dtype)
    return out
