"""The weights bridge between the reference's numpy view and the port.

``params_from_numpy`` turns the JAX package's parameters, given as a tree
of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), into the
port's dict of tensors; ``params_to_numpy`` goes back.  The same helpers
carry the trainer state: the reference's momentum is a list of (n, ...)
leaves in parameter order, the port's one flat (n, D) fp32 buffer.  The
fed server's state has the same layout (its population momentum is one
flat (n_clients, D) buffer), so :func:`state_from_numpy` /
:func:`state_to_numpy` carry it too.  Under selective robustness
(``TrainerConfig.fsdp_keys``) the reference's momentum lists the robust
leaves only, and so does the port's flat buffer: pass the same
``fsdp_keys`` to both helpers.  A MoE tree needs nothing more: its fp32
router inside a bf16 model and its (L, E, d, ff) expert stacks carry
across leaf by leaf, each in its own dtype.

The fleet's lane state carries across too (:func:`lane_state_from_numpy`
/ :func:`lane_state_to_numpy`): params, opt_state, the momentum list and
the step, every leaf stacked over lanes.  The reference's per-lane PRNG
``key`` has no counterpart (the port's lanes draw from ``torch``
generators seeded with the job's seed) and is dropped.
:func:`mlp_params_from_numpy` carries the fleet MLP's init across, e.g.
``_mlp_init(jax.random.PRNGKey(seed), 48)`` as numpy.

On a model mesh (``models.common.model_mesh``) :func:`params_to_shards`
cuts the reference's padded parameters, as numpy, into this rank's shards
(``models.common.shard_slice`` of each leaf's desc) and
:func:`params_from_shards` gathers them back over the model axis (a
collective: every rank calls it).  The sharded trainer's momentum is a
block of its model shard's columns, not the reference's layout; the
state forms below carry single-device states (``fsdp_keys=`` as there).

A decode cache carries across too (:func:`cache_from_numpy` /
:func:`cache_to_numpy`): the reference's ``init_cache`` / ``decode_step``
tree, one of the layouts in :data:`CACHE_KEYS`, leaf for leaf in jax's
sorted-key order.  On a model mesh :func:`cache_to_shards` cuts it into
this rank's shards by the model's ``cache_descs`` (the batch over the
data axes, heads over the model axis, a long span's sequence over either
or both) and :func:`cache_from_shards` gathers them back over every axis
of each leaf's spec (a collective).

bf16 arrays arrive as ``ml_dtypes.bfloat16`` numpy arrays (JAX's numpy
bf16); they are reinterpreted bit for bit.  On the way back bf16 tensors
become fp32 arrays (exact), so this module needs no ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.training.trainer import split_params
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def tensor_from_numpy(a, device: Optional[torch.device] = None
                      ) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t if device is None else t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree: PyTree, device: Optional[torch.device] = None
                      ) -> PyTree:
    """A tree of numpy arrays -> the same tree of tensors on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: PyTree) -> PyTree:
    """A tree of tensors -> the same tree of numpy arrays."""
    return tree_map(tensor_to_numpy, tree)


def params_to_shards(tree: PyTree, descs: PyTree, axes, mesh,
                     device: Optional[torch.device] = None) -> PyTree:
    """The reference's (padded) parameters as numpy -> this rank's shard of
    each leaf, on ``device``."""
    from repro_torch.models.common import shard_slice
    return tree_map(lambda a, d: tensor_from_numpy(
        np.asarray(a)[shard_slice(d, axes, mesh)], device), tree, descs)


def params_from_shards(tree: PyTree, descs: PyTree, axes, mesh) -> PyTree:
    """Every rank's shards -> the whole parameters as numpy (bf16 as fp32),
    all-gathered over the model axis leaf by leaf (a collective)."""
    from repro_torch.models.common import leaf_spec

    def whole(t, d):
        spec = leaf_spec(d, axes)
        if axes.model not in spec or mesh.size(axes.model) == 1:
            return tensor_to_numpy(t)
        dim = spec.index(axes.model)
        rows = t.detach().float().movedim(dim, 0).contiguous()
        full = mesh.all_gather(rows, axes.model)
        return tensor_to_numpy(full.movedim(0, dim))
    return tree_map(whole, tree, descs)


def momentum_from_numpy(leaves: list, device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """The reference's momentum list of (n, ...) leaves -> the port's flat
    (n, D) fp32 buffer (leaves in parameter order)."""
    n = np.asarray(leaves[0]).shape[0]
    flat = np.concatenate([np.asarray(l, np.float32).reshape(n, -1)
                           for l in leaves], axis=1)
    return tensor_from_numpy(flat, device)


def momentum_to_numpy(flat: torch.Tensor, params) -> list:
    """The port's flat (n, D) momentum -> a list of (n, ...) leaves shaped
    like ``params``' leaves (a tree, or the list of robust leaves), in the
    reference's order."""
    out, off = [], 0
    arr = tensor_to_numpy(flat)
    n = arr.shape[0]
    for p in tree_leaves(params):
        size = int(np.prod(p.shape))
        out.append(arr[:, off:off + size].reshape((n,) + tuple(p.shape)))
        off += size
    return out


def state_from_numpy(state: dict, device: Optional[torch.device] = None,
                     fsdp_keys: tuple = ()) -> dict:
    """The reference's TrainState (as numpy) -> the port's TrainState;
    ``fsdp_keys`` as the state's ``TrainerConfig`` has them."""
    out = dict(params=params_from_numpy(state["params"], device),
               opt_state=params_from_numpy(state["opt_state"], device),
               step=int(np.asarray(state["step"])))
    if "momentum" in state:
        want = [tuple(np.shape(p)) for p in
                split_params(state["params"], fsdp_keys)[0]]
        got = [tuple(np.shape(m)[1:]) for m in state["momentum"]]
        if got != want:
            raise ValueError("the momentum's leaves do not match the robust "
                             f"leaves for fsdp_keys={fsdp_keys!r}")
        out["momentum"] = momentum_from_numpy(state["momentum"], device)
    return out


def state_to_numpy(state: dict, fsdp_keys: tuple = ()) -> dict:
    """The port's TrainState -> the reference's layout, as numpy."""
    out = dict(params=params_to_numpy(state["params"]),
               opt_state=params_to_numpy(state["opt_state"]),
               step=np.int32(state["step"]))
    if "momentum" in state:
        out["momentum"] = momentum_to_numpy(
            state["momentum"], split_params(state["params"], fsdp_keys)[0])
    return out


#: The fleet MLP's parameter names (``repro_torch.fed.scenarios``).
MLP_KEYS = ("b1", "b2", "w1", "w2")


def mlp_params_from_numpy(tree: dict, device: Optional[torch.device] = None
                          ) -> dict:
    """The reference's MLP init (numpy dict w1, b1, w2, b2) -> the port's
    fp32 params, checked for names and shapes."""
    if tuple(sorted(tree)) != MLP_KEYS:
        raise ValueError(f"expected MLP params {MLP_KEYS}, got {sorted(tree)}")
    w1, w2 = np.asarray(tree["w1"]), np.asarray(tree["w2"])
    if (np.shape(tree["b1"]) != (w1.shape[1],)
            or w2.shape[0] != w1.shape[1]
            or np.shape(tree["b2"]) != (w2.shape[1],)):
        raise ValueError("MLP params have inconsistent shapes")
    return {k: tensor_from_numpy(np.asarray(v, np.float32), device)
            for k, v in tree.items()}


def lane_state_from_numpy(state: dict, device: Optional[torch.device] = None
                          ) -> dict:
    """A fleet bucket's stacked lane state from the reference (as numpy:
    params / opt_state leaves (B, ...), momentum a list of (B, n_clients,
    ...) leaves, step (B,)) -> the port's; the PRNG ``key`` is dropped."""
    out = dict(params=params_from_numpy(state["params"], device),
               opt_state=params_from_numpy(state["opt_state"], device),
               step=tensor_from_numpy(np.asarray(state["step"], np.int32),
                                      device))
    if "momentum" in state:
        out["momentum"] = [tensor_from_numpy(np.asarray(m, np.float32), device)
                           for m in state["momentum"]]
    return out


def lane_state_to_numpy(state: dict) -> dict:
    """The port's stacked lane state -> the reference's layout, as numpy
    (without ``key``)."""
    out = dict(params=params_to_numpy(state["params"]),
               opt_state=params_to_numpy(state["opt_state"]),
               step=tensor_to_numpy(state["step"]).astype(np.int32))
    if "momentum" in state:
        out["momentum"] = [tensor_to_numpy(m) for m in state["momentum"]]
    return out


#: The decode caches' layouts, as sorted key paths: the encoder-decoder's,
#: the KV cache (dense / moe / vlm), rwkv's, and the hybrid's.
CACHE_KEYS = (
    ("cross_k", "cross_v", "k", "v"),
    ("k", "v"),
    ("cshift", "state", "tshift"),
    ("attn/k", "attn/v", "ssm/conv", "ssm/state"),
)


def _cache_keys(tree: dict) -> tuple:
    keys = []
    for k, v in tree.items():
        keys += [f"{k}/{j}" for j in v] if isinstance(v, dict) else [k]
    return tuple(sorted(keys))


def _check_cache(tree: dict) -> None:
    if not isinstance(tree, dict) or _cache_keys(tree) not in CACHE_KEYS:
        got = _cache_keys(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"not a decode cache: {got}; expected one of "
                         f"{CACHE_KEYS}")


def cache_from_numpy(tree: dict, device: Optional[torch.device] = None
                     ) -> dict:
    """The reference's decode cache (as numpy) -> the port's, each leaf in
    its own dtype (bf16 bit for bit)."""
    _check_cache(tree)
    return params_from_numpy(tree, device)


def cache_to_numpy(tree: dict) -> dict:
    """The port's decode cache -> the reference's layout, as numpy (bf16
    as fp32, exact)."""
    _check_cache(tree)
    return params_to_numpy(tree)


def cache_to_shards(tree: dict, descs: dict, axes, mesh,
                    device: Optional[torch.device] = None) -> dict:
    """The reference's decode cache (as numpy) -> this rank's shard of
    each leaf (``models.common.shard_slice`` of its cache desc), on
    ``device``."""
    _check_cache(tree)
    return params_to_shards(tree, descs, axes, mesh, device)


def cache_from_shards(tree: dict, descs: dict, axes, mesh) -> dict:
    """Every rank's cache shards -> the whole cache as numpy (bf16 as
    fp32), each leaf all-gathered over every mesh axis its spec names,
    the data axes included (a collective)."""
    from repro_torch.models.common import gather_dim, leaf_spec
    _check_cache(tree)

    def whole(t, d):
        for dim, part in enumerate(leaf_spec(d, axes)):
            t = gather_dim(t.detach(), dim, part, mesh)
        return tensor_to_numpy(t)
    return tree_map(whole, tree, descs)
