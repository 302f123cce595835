"""npz checkpoints of parameter trees (counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.npz import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
