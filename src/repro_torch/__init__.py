"""PyTorch + CUDA port of the robust-aggregation system (package ``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and names so each counterpart is found at once.  It imports
``torch`` and never ``jax``, and nothing from ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit CPU request they raise
(:func:`repro_torch.device.resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
