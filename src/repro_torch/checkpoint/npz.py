"""npz checkpointing of pytrees of tensors (counterpart of
``repro.checkpoint.npz``; single process).

Leaves are stored under jax-style key-path names (``['params']['w']``,
``[0]``) in the port's leaf order; a load restores into the structure of
a ``like`` tree, each leaf on the device and in the dtype of its ``like``
leaf.

Two kinds of leaf have no numpy form and are stored with their kind
recorded beside them (where the reference records typed PRNG keys'
impls):

- ``torch.bfloat16`` tensors (smollm-360m's parameters): their bits as a
  ``uint16`` array, viewed back on load, so the round trip is bit-exact;
- Python numbers (the trainer's ``step`` feeds the lr schedule as an
  ``int``): 0-d arrays that come back as the same Python type.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.obs import runtime as obs_runtime
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

PyTree = Any
_SEP = "::"
_KIND = f"{_SEP}kind{_SEP}"   # companion entry prefix: a leaf's kind
_STEP = f"{_SEP}step"


def tree_paths(tree: PyTree) -> list[str]:
    """jax ``keystr`` names of the leaves, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [f"[{k!r}]{p}" for k in sorted(tree)
                for p in tree_paths(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [f"[{i}]{p}" for i, v in enumerate(tree)
                for p in tree_paths(v)]
    return [""]


def encode_leaf(leaf: Any) -> tuple[np.ndarray, Optional[str]]:
    """Host array for ``leaf`` plus its kind (None when numpy holds it as
    it is): ``"bfloat16"``, ``"int"``, ``"float"`` or ``"bool"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        return t.cpu().numpy(), None
    for kind in (bool, int, float):          # bool first: it is an int
        if isinstance(leaf, kind):
            return np.asarray(leaf), kind.__name__
    return np.asarray(leaf), None


def decode_leaf(arr: np.ndarray, like_leaf: Any, kind: Optional[str]) -> Any:
    """Inverse of :func:`encode_leaf`: a tensor on ``like_leaf``'s device
    and in its dtype, or a Python number of ``like_leaf``'s type."""
    arr = np.asarray(arr)
    if isinstance(like_leaf, (bool, int, float)):
        return type(like_leaf)(arr)
    if not isinstance(like_leaf, torch.Tensor):
        raise TypeError(f"cannot restore into a {type(like_leaf).__name__} "
                        "leaf (tensors and Python numbers only)")
    if tuple(arr.shape) != tuple(like_leaf.shape):
        raise ValueError(f"stored shape {tuple(arr.shape)} does not match "
                         f"the like leaf's {tuple(like_leaf.shape)}")
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    if kind == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like_leaf.device, dtype=like_leaf.dtype)


def fsync_replace(tmp: str, path: str) -> None:
    """``os.replace`` that survives power loss: fsync file, rename, fsync
    dir."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def save_checkpoint(path: str, tree: PyTree,
                    step: Optional[int] = None) -> None:
    leaves, names = tree_leaves(tree), tree_paths(tree)
    with obs_runtime.span("checkpoint.save", path=path, leaves=len(leaves),
                          step=step):
        data = {}
        for name, leaf in zip(names, leaves):
            arr, kind = encode_leaf(leaf)
            data[name] = arr
            if kind is not None:
                data[_KIND + name] = np.asarray(kind)
        if step is not None:
            data[_STEP] = np.asarray(step)
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "wb") as fh:
            np.savez(fh, **data)
            fh.flush()
            os.fsync(fh.fileno())
        fsync_replace(tmp, path)


def load_checkpoint(path: str, like: PyTree) -> tuple[PyTree, Optional[int]]:
    """Restore into the structure (devices, dtypes) of ``like``.

    The saved key set must match ``like`` exactly; a mismatch raises one
    ``ValueError`` listing every missing / extra key."""
    with obs_runtime.span("checkpoint.load", path=path), np.load(path) as data:
        want = tree_paths(like)
        have = {k for k in data.files
                if not k.startswith(_KIND) and k != _STEP}
        missing = [k for k in want if k not in have]
        extra = sorted(have - set(want))
        if missing or extra:
            raise ValueError(
                f"checkpoint {path!r} does not match the `like` structure: "
                f"missing keys {missing!r}, extra keys {extra!r}")
        leaves = []
        for name, leaf in zip(want, tree_leaves(like)):
            kind = str(data[_KIND + name]) if _KIND + name in data.files \
                else None
            leaves.append(decode_leaf(data[name], leaf, kind))
        step = int(data[_STEP]) if _STEP in data.files else None
    return tree_unflatten(tree_structure(like), leaves), step
