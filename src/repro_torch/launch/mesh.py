"""Named meshes over a ``torch.distributed`` world: the aggregation meshes
of the multi-device backends and the model-parallel mesh (counterpart of
``repro.launch.mesh``: ``use_mesh`` / ``aggregation_mesh`` /
``hier_aggregation_mesh``, ``make_production_mesh`` / ``mesh_axes_for`` /
``n_workers``).

A :class:`Mesh` lays the world's ranks out on a grid with named axes
(``make_mesh((2, 2), ("workers", "model"))``: rank ``r`` at
``divmod(r, 2)``) and holds one process group per axis: the ranks that
share this rank's coordinates on every other axis.  Building a mesh is a collective: every
rank of the world builds the same meshes in the same order.  "Device
count" in the reference's rules means the world size here.

Transport (:class:`Transport`): the world's backend, never picked
silently — ``nccl`` for ranks that each own a card, ``gloo`` for CPU
ranks and for ranks that share one card (NCCL refuses two ranks on one
GPU).  Gloo takes every collective of the mesh on the tensors as they
are and stages CUDA tensors through the host itself
(``scripts/torch_gloo_probe.py`` checks which collectives gloo runs on
CUDA tensors and times them against explicit host copies); NCCL moves
card tensors only, so under it a host operand is refused with the op and
the axis named.  A rank's device (:func:`rank_device`, ``Mesh.device``):
its own card under nccl, the shared ``cuda:0`` or the CPU under gloo.

The model-parallel layers (``repro_torch.models.common``: column- and
row-parallel products, the split vocabulary, the sequence blocks of
``seq_par``) run their all-reduces, all-gathers and reduce-scatters on
the ``"model"`` axis's group of the active mesh; expert FSDP's gathers
and reduce-scatters run on the data axes'.  A collective over a tuple of
axes (the multi-pod trainer's ``("pod", "data")``: an all-reduce, an
all-gather, an all-to-all) runs as one along each axis in turn, over
their row-major product (:meth:`Mesh.index_of`).

:func:`fake_world` makes this process one rank of a world of any shape
over torch's fake process group (``launch.dryrun``: nothing moves, every
collective is logged as on a real world); :func:`fake_tools` is the one
import of the private torch modules that stands on.

Every collective is counted and timed (host clock around the call, after
a synchronize of a CUDA operand) in :func:`collective_log`, emitted as a
``mesh.<op>`` span of ``repro_torch.obs.runtime``, and recorded as a
decision on the open dispatch record with its transport.

:func:`spawn_world` runs a function on ``world`` processes (the tests'
gloo CPU worlds, ``chip_smoke.py``'s worlds over gloo or, one card a
rank, over nccl; each rank joins through :func:`join_world`): every
process group has an explicit ``timeout``, the parent joins under an
overall time limit and kills the children on a timeout or on the first
rank that raises or dies (NCCL's watchdog ends a rank whose collective
hangs), so a failing rank fails the run instead of hanging the others in
a collective.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import inspect
import math
import os
import queue as queue_lib
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

#: Seconds a collective may wait for its peers before it raises.
GROUP_TIMEOUT = 120.0

#: The reference's production geometry (a TPU pod's): the defaults of
#: :func:`make_production_mesh` and :func:`mesh_axes_for`, nothing more.
MODEL_PAR = 16
DATA_PAR = 16
PODS = 2


# ---------------------------------------------------------------------------
# Collectives, their transport and their log.
# ---------------------------------------------------------------------------

_LOG: list = []


def collective_log() -> list:
    """Every collective since :func:`reset_collective_log`: dicts with
    ``op``, ``axis``, ``transport``, ``bytes`` and ``seconds``."""
    return list(_LOG)


def reset_collective_log() -> None:
    _LOG.clear()


class Transport:
    """How a world moves tensors: its backend, ``"nccl"`` or ``"gloo"``
    (see the module docstring), or ``"fake"`` (:func:`fake_world`: every
    collective returns at once and moves nothing; the log still records
    its bytes)."""

    def __init__(self, backend: str):
        if backend not in ("nccl", "gloo", "fake"):
            raise ValueError(f"unknown process-group backend {backend!r}")
        self.backend = backend

    def _operand(self, t: torch.Tensor, op: str, axis: str) -> None:
        """Refuse a host operand under nccl, before any collective starts:
        NCCL moves card tensors only, and a silent copy to the card would
        hide the caller's wrong device."""
        if self.backend == "nccl" and t.device.type != "cuda":
            raise ValueError(
                f"{op} over axis {axis!r}: the nccl transport moves card "
                f"tensors only, and this operand lies on {t.device}; make "
                f"it on the mesh's device (Mesh.device)")

    @contextlib.contextmanager
    def _timed(self, op: str, axis: str, t: torch.Tensor,
               record: bool = True):
        from repro_torch.kernels import dispatch as kdispatch
        from repro_torch.obs import runtime as obs_runtime
        nbytes = t.numel() * t.element_size()
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        with obs_runtime.span(f"mesh.{op}", axis=axis,
                              transport=self.backend, bytes=nbytes):
            yield
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        dt = time.perf_counter() - t0
        _LOG.append({"op": op, "axis": axis, "transport": self.backend,
                     "bytes": nbytes, "seconds": dt})
        if record:
            kdispatch.record_decision(f"collective:{op}", "mesh",
                                      self.backend,
                                      f"axis {axis!r}, {nbytes} bytes")

    def all_reduce(self, t: torch.Tensor, group, axis: str,
                   op: str = "sum", record: bool = True) -> torch.Tensor:
        """In-place all-reduce of ``t`` over ``group`` (``op``: sum / min /
        max); returns ``t``.  ``record``: a decision on the open dispatch
        record (the aggregation's collectives; the trainer's own pass
        none)."""
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        self._operand(t, "all_reduce", axis)
        with self._timed("all_reduce", axis, t, record):
            dist.all_reduce(t, op=red, group=group)
        return t

    def all_gather(self, t: torch.Tensor, group, axis: str, size: int,
                   record: bool = True) -> torch.Tensor:
        """(size * t.shape[0], ...) concatenation of every rank's equally
        shaped ``t`` along dim 0, in the group's rank order."""
        self._operand(t, "all_gather", axis)
        with self._timed("all_gather", axis, t, record):
            src = t.contiguous()
            out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=group)
        return out

    def reduce_scatter(self, t: torch.Tensor, group, axis: str, size: int,
                       record: bool = True) -> torch.Tensor:
        """Sum of every rank's equally shaped ``t``, cut along dim 0 into
        ``size`` equal blocks: the group's j-th rank gets block j."""
        self._operand(t, "reduce_scatter", axis)
        with self._timed("reduce_scatter", axis, t, record):
            src = t.contiguous()
            out = src.new_empty((src.shape[0] // size,)
                                + tuple(src.shape[1:]))
            dist.reduce_scatter_tensor(out, src, group=group)
        return out

    def all_to_all(self, t: torch.Tensor, group, axis: str,
                   out_rows: int, record: bool = True) -> torch.Tensor:
        """All-to-all of equal chunks along dim 0: chunk j of ``t`` goes to
        the group's j-th rank; returns the (out_rows, ...) chunks received,
        in rank order."""
        self._operand(t, "all_to_all", axis)
        with self._timed("all_to_all", axis, t, record):
            src = t.contiguous()
            out = src.new_empty((out_rows,) + tuple(src.shape[1:]))
            dist.all_to_all_single(out, src, group=group)
        return out


# ---------------------------------------------------------------------------
# The mesh.
# ---------------------------------------------------------------------------

def world_size() -> int:
    """Ranks of the initialized world (1 without one): the port's device
    count."""
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


@dataclasses.dataclass(eq=False)
class Mesh:
    """A named grid of the world's ranks and one process group per axis
    (see the module docstring).  Build it on every rank, in the same
    order: :func:`make_mesh`."""
    axis_names: tuple
    shape: tuple
    rank: int           # the world's ranks lie on the grid row-major
    groups: dict
    transport: Transport
    device: torch.device    # this rank's (world_device)

    def size(self, axis) -> int:
        """Ranks along ``axis`` (a name, or a tuple of names: the product)."""
        if isinstance(axis, tuple):
            return math.prod(self.size(a) for a in axis)
        return dict(zip(self.axis_names, self.shape))[axis]

    def index_of(self, rank: int, axis) -> int:
        """``rank``'s coordinate along ``axis`` (a tuple of names: the
        row-major coordinate over them, the first the slowest)."""
        if isinstance(axis, tuple):
            idx = 0
            for a in axis:
                idx = idx * self.size(a) + self.index_of(rank, a)
            return idx
        a = self.axis_names.index(axis)
        return (rank // math.prod(self.shape[a + 1:])) % self.shape[a]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.index_of(self.rank, axis)

    @property
    def devices(self) -> int:
        return math.prod(self.shape)

    def signature(self) -> tuple:
        return (world_size(), tuple(self.axis_names), tuple(self.shape))

    def all_reduce(self, t: torch.Tensor, axis, op: str = "sum",
                   record: bool = True) -> torch.Tensor:
        """In-place all-reduce along ``axis`` (a tuple of names: along
        each in turn)."""
        if isinstance(axis, tuple):
            for a in axis:
                self.all_reduce(t, a, op, record)
            return t
        if self.size(axis) == 1:
            return t
        return self.transport.all_reduce(t, self.groups[axis], axis, op,
                                         record)

    def all_to_all(self, t: torch.Tensor, axis, out_rows: int
                   ) -> torch.Tensor:
        """:meth:`Transport.all_to_all` along ``axis`` (chunk j of ``t``
        to the axis's j-th rank), recorded in the log only.  A tuple of
        names exchanges over their product, chunk j going to the rank of
        row-major coordinate j over them (:meth:`index_of`): one
        all-to-all along each axis in turn, each moving the chunks to
        their coordinate on that axis."""
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        if isinstance(axis, tuple):
            ks = [self.size(a) for a in axis]
            if out_rows != t.shape[0] or t.shape[0] % math.prod(ks):
                raise ValueError(f"all_to_all over {axis}: {t.shape[0]} rows "
                                 f"in, {out_rows} out, {math.prod(ks)} ranks")
            rest = tuple(t.shape[1:])
            x = t.reshape(tuple(ks) + (-1,) + rest)
            for i, a in enumerate(axis):
                # Dimension i: the destination's coordinate along a, then
                # (after the exchange) the source's.
                y = x.movedim(i, 0).reshape((-1,) + rest)
                y = self.all_to_all(y, a, y.shape[0])
                x = y.reshape(tuple(ks[i:i + 1]) + tuple(
                    k for j, k in enumerate(ks) if j != i) + (-1,) + rest
                ).movedim(0, i)
            return x.reshape(t.shape)
        if self.size(axis) == 1:
            return t[:out_rows].clone()
        return self.transport.all_to_all(t, self.groups[axis], axis,
                                         out_rows, record=False)

    def all_gather(self, t: torch.Tensor, axis,
                   record: bool = True) -> torch.Tensor:
        """Every rank's equally shaped ``t`` along ``axis``, concatenated
        on dim 0 in rank order; over a tuple of names in row-major order
        (gathered along the fastest axis first)."""
        if isinstance(axis, tuple):
            for a in reversed(axis):
                t = self.all_gather(t, a, record)
            return t
        if self.size(axis) == 1:
            return t
        return self.transport.all_gather(t, self.groups[axis], axis,
                                         self.size(axis), record)

    def reduce_scatter(self, t: torch.Tensor, axis: str,
                       record: bool = True) -> torch.Tensor:
        """:meth:`Transport.reduce_scatter` along ``axis``: dim 0 of ``t``
        (a multiple of the axis's size) summed over the axis, this rank's
        block of it kept."""
        k = self.size(axis)
        if t.shape[0] % k:
            raise ValueError(f"reduce_scatter: {t.shape[0]} rows do not "
                             f"split over the {k} ranks of {axis!r}")
        if k == 1:
            return t
        return self.transport.reduce_scatter(t, self.groups[axis], axis, k,
                                             record)

    def all_to_all_world(self, t: torch.Tensor, out_rows: int
                         ) -> torch.Tensor:
        """:meth:`all_to_all` over every rank of the world (chunk j of
        ``t`` to rank j), recorded in the log only."""
        return self.transport.all_to_all(t, None, "world", out_rows,
                                         record=False)

    def all_reduce_world(self, t: torch.Tensor, op: str = "sum"
                         ) -> torch.Tensor:
        """All-reduce over every rank of the mesh (every axis in turn),
        recorded in the log only."""
        for axis in self.axis_names:
            self.all_reduce(t, axis, op, record=False)
        return t


_MESHES: dict = {}


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              backend: Optional[str] = None) -> Mesh:
    """The mesh ``shape`` x ``axis_names`` over the initialized world
    (a collective: every rank calls it alike; cached per layout).  Its
    size must equal the world size.  ``backend``: its groups' transport,
    the world's by default (a gloo mesh in an nccl world runs the same
    program over the other transport on the same cards)."""
    shape, names = tuple(int(k) for k in shape), tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axes {names} do not match")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialized torch.distributed "
                           "world (spawn_world or init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} holds "
                         f"{math.prod(shape)} ranks; the world has {world}")
    backend = backend or dist.get_backend()
    key = (world, names, shape, backend)
    if key in _MESHES:
        return _MESHES[key]
    rank = dist.get_rank()
    groups = {}
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT)
    own = None if backend == dist.get_backend() else backend
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    for a, name in enumerate(names):
        # Every line of ranks along axis a, in a fixed order on every rank.
        lines = []
        for base in range(world):
            coords = [(base // strides[i]) % shape[i] for i in range(len(shape))]
            if coords[a] != 0:
                continue
            lines.append([base + j * strides[a] for j in range(shape[a])])
        for line in lines:
            g = dist.new_group(line, timeout=timeout, backend=own) \
                if shape[a] > 1 else None
            if rank in line:
                groups[name] = g
    mesh = Mesh(names, shape, rank, groups, Transport(backend),
                world_device(rank, backend))
    _MESHES[key] = mesh
    return mesh


_ACTIVE_MESH: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the active aggregation mesh inside the scope."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost active :func:`use_mesh` scope (or None)."""
    return _ACTIVE_MESH


#: Mesh axes the sharded aggregation backend prefers to shard the
#: flattened (n, D) feature dim over, in order (the reference's).
AGG_AXIS_PREFERENCE = ("model", "shard")


def aggregation_axis(mesh: Mesh) -> Optional[str]:
    """The axis the aggregation stage shards D over, or None: the first of
    :data:`AGG_AXIS_PREFERENCE` with more than one rank, else the largest
    axis; None when every axis has one rank."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    for name in AGG_AXIS_PREFERENCE:
        if sizes.get(name, 1) > 1:
            return name
    if not sizes:
        return None
    name = max(sizes, key=lambda a: sizes[a])
    return name if sizes[name] > 1 else None


def aggregation_mesh() -> Optional[tuple[Mesh, str]]:
    """(mesh, axis) the ``cuda_sharded`` backend runs over, or None.  The
    active :func:`use_mesh` scope wins; without one, a world of more than
    one rank gets an ad-hoc 1-D ``"shard"`` mesh over all of them.  None
    means "no multi-rank mesh": the dispatcher records the degrade."""
    mesh = current_mesh()
    if mesh is not None:
        ax = aggregation_axis(mesh)
        return (mesh, ax) if ax is not None else None
    if world_size() > 1:
        return make_mesh((world_size(),), ("shard",)), "shard"
    return None


#: Mesh axes the hierarchical backend prefers to shard the worker dim
#: over, in order (the reference's).
AGG_WORKER_AXIS_PREFERENCE = ("workers", "data", "pod")


def aggregation_worker_axis(mesh: Mesh, model_axis: Optional[str]
                            ) -> Optional[str]:
    """The axis hierarchical aggregation shards the worker dim over, or
    None (1-D hier): the first of :data:`AGG_WORKER_AXIS_PREFERENCE` with
    more than one rank other than the D axis, else the largest remaining
    axis."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    for name in AGG_WORKER_AXIS_PREFERENCE:
        if name != model_axis and sizes.get(name, 1) > 1:
            return name
    rest = {a: k for a, k in sizes.items() if a != model_axis and k > 1}
    if not rest:
        return None
    return max(rest, key=lambda a: rest[a])


def hier_aggregation_mesh() -> Optional[tuple[Mesh, Optional[str], str]]:
    """(mesh, worker_axis | None, model_axis) for ``cuda_hier``, or None.
    The active scope wins (D along :func:`aggregation_axis`, workers along
    :func:`aggregation_worker_axis`); without one, a world of 4 or more
    ranks (an even count) gets an ad-hoc 2-D (2, k/2) ``("workers",
    "shard")`` mesh and 2-3 ranks the 1-D ``"shard"`` mesh."""
    mesh = current_mesh()
    if mesh is not None:
        model_ax = aggregation_axis(mesh)
        if model_ax is None:
            return None
        return mesh, aggregation_worker_axis(mesh, model_ax), model_ax
    k = world_size()
    if k >= 4 and k % 2 == 0:
        return make_mesh((2, k // 2), ("workers", "shard")), "workers", \
            "shard"
    if k > 1:
        return make_mesh((k,), ("shard",)), None, "shard"
    return None


def mesh_signature() -> tuple:
    """Hashable fingerprint of the mesh the aggregation would shard over:
    (world size, axis names, shape) under an active mesh, else (world
    size,)."""
    mesh = current_mesh()
    if mesh is not None:
        return mesh.signature()
    return (world_size(),)


def make_hier_mesh(workers: int, model: int) -> Mesh:
    """The 2-D mesh of hierarchical aggregation: the stack sharded along
    both axes (worker rows x D columns)."""
    return make_mesh((workers, model), ("workers", "model"))


def make_debug_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A small ("data", "model") mesh for tests."""
    return make_mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: ("data", "model") of DATA_PAR x
    MODEL_PAR ranks (("pod", "data", "model") with PODS pods).  Raises,
    naming the size, when the world holds another rank count."""
    shape = (PODS, DATA_PAR, MODEL_PAR) if multi_pod \
        else (DATA_PAR, MODEL_PAR)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(names, shape))} "
                         f"needs {math.prod(shape)} ranks; the world has "
                         f"{world_size()}")
    return make_mesh(shape, names)


def mesh_axes_for(cfg, *, multi_pod: bool = False, model_par: int = MODEL_PAR,
                  data_axes: Optional[tuple] = None, pad_kv: bool = False):
    """The per-arch sharding switches for a mesh geometry (the reference's
    resolution): ``shard_kv`` from ``models.common.pad_heads``,
    ``shard_expert`` when the experts divide over ``model_par``."""
    from repro_torch.models.common import MeshAxes, pad_heads
    if data_axes is None:
        data_axes = ("pod", "data") if multi_pod else ("data",)
    _, _, _, shard_kv = pad_heads(cfg.num_heads, cfg.num_kv_heads, model_par,
                                  pad_kv=pad_kv)
    shard_expert = cfg.num_experts > 0 and cfg.num_experts % model_par == 0
    return MeshAxes(data=tuple(data_axes), model="model", model_par=model_par,
                    shard_kv=shard_kv, shard_expert=shard_expert,
                    pad_kv_to_mesh=pad_kv)


def n_workers(*, multi_pod: bool = False) -> int:
    """Workers of the production mesh: one per data rank."""
    return DATA_PAR * (PODS if multi_pod else 1)


# ---------------------------------------------------------------------------
# Worlds of processes.
# ---------------------------------------------------------------------------

def fake_tools() -> tuple:
    """(FakeStore, MemTracker): the two private torch modules the dry run
    (``launch.dryrun``) stands on, imported here and nowhere else.  Raises
    ``ImportError`` naming them when this torch lacks them."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise ImportError(
            "the dry run needs torch's private fake process group "
            "(torch.testing._internal.distributed.fake_pg) and memory "
            "tracker (torch.distributed._tools.mem_tracker); this torch "
            f"({torch.__version__}) has not got them: {e}") from e
    return FakeStore, MemTracker


@contextlib.contextmanager
def fake_world(shape: Sequence[int], axis_names: Sequence[str],
               rank: int = 0):
    """This process as rank ``rank`` of a world of ``prod(shape)`` ranks
    over torch's fake process group (nothing moves; ``Transport`` logs
    every collective's bytes as for a real world); yields
    :func:`make_mesh` of ``shape`` x ``axis_names``.  The world and its
    meshes are torn down on exit."""
    fake_store, _ = fake_tools()
    if dist.is_initialized():
        raise RuntimeError("fake_world: a torch.distributed world is "
                           "already initialized in this process")
    world = math.prod(int(k) for k in shape)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not a rank of a world of {world}")
    dist.init_process_group("fake", store=fake_store(), rank=rank,
                            world_size=world)
    try:
        yield make_mesh(shape, axis_names)
    finally:
        _MESHES.clear()
        dist.destroy_process_group()


def rank_device(rank: int, backend: str) -> torch.device:
    """The device rank ``rank`` of a one-host world over ``backend``
    computes on: under ``"nccl"`` its own card, ``cuda:rank`` (NCCL
    refuses two ranks on one card); under ``"gloo"`` ``cuda:0`` where the
    host has a card (the ranks share it) and the CPU where it has none
    (the tests' CPU worlds); the CPU under ``"fake"`` (the dry run's
    world)."""
    if backend not in ("nccl", "gloo", "fake"):
        raise ValueError(f"unknown process-group backend {backend!r}")
    if backend == "nccl":
        return torch.device("cuda", rank)
    if backend == "gloo" and torch.cuda.is_available():
        return torch.device("cuda", 0)
    return torch.device("cpu")


#: The device :func:`join_world` gave this process's rank (None: the
#: process joined its world otherwise).
_RANK_DEVICE: Optional[torch.device] = None


def world_device(rank: int, backend: str) -> torch.device:
    """This process's device as rank ``rank`` of its world: the one
    :func:`join_world` bound, else the current card under nccl (the
    caller made it current before joining), else :func:`rank_device`."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return rank_device(rank, backend)


def check_cards(world: int, backend: str) -> None:
    """Raise, before anything is spawned, where a one-host world of
    ``world`` nccl ranks does not find a card for each."""
    rank_device(0, backend)             # an unknown backend raises here
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and world > cards:
        raise ValueError(
            f"a world of {world} nccl ranks needs {world} cards, one a "
            f"rank; this host has {cards} (NCCL refuses two ranks on one "
            f"card: share one over backend='gloo')")


def join_world(rank: int, world: int, port: int, timeout: float,
               backend: str = "gloo") -> torch.device:
    """Join this process to a one-host world as rank ``rank`` over
    ``tcp://127.0.0.1:port``; returns its device (:func:`rank_device`).
    An nccl rank makes its card current before anything touches CUDA,
    binds the world to it (``device_id``) and keeps NCCL's bootstrap on
    the loopback interface (the world lies on one host)."""
    global _RANK_DEVICE
    dev = rank_device(rank, backend)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout), **kw)
    _RANK_DEVICE = dev
    return dev


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, timeout: float,
               fn: Callable, args: tuple, results, backend: str) -> None:
    try:
        join_world(rank, world, port, timeout, backend)
        out = fn(rank, world, *args)
        results.put(("ok", rank, out))
    except BaseException:                        # noqa: BLE001 - reported
        results.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:                    # noqa: BLE001 - exiting
                pass


def spawn_world(fn: Callable, world: int, args: tuple = (), *,
                limit: float = 600.0,
                group_timeout: float = GROUP_TIMEOUT,
                backend: str = "gloo") -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned processes joined
    in one world over ``tcp://127.0.0.1`` (:func:`join_world`); returns
    the ranks' results in rank order.  ``backend``: ``"gloo"`` (CPU ranks,
    or ranks sharing ``cuda:0``) or ``"nccl"`` (rank r on ``cuda:r``,
    made current before anything touches CUDA); a world of more nccl
    ranks than cards raises before anything is spawned, and nothing falls
    back to gloo.

    ``fn`` and its results must pickle (a module-level function).  The
    world's groups wait ``group_timeout`` seconds for a peer; the parent
    waits at most ``limit`` seconds in all.  The first rank that raises
    or dies, or the limit, kills every child and raises ``RuntimeError``
    with the rank's traceback (``TimeoutError`` for the limit)."""
    import torch.multiprocessing as mp
    check_cards(world, backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, group_timeout, fn,
                               tuple(args), results, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + limit
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_world: {world - len(out)} of {world} ranks did "
                    f"not finish within {limit:.0f} s")
            try:
                status, rank, value = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"spawn_world: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before reporting")
                continue
            if status == "error":
                raise RuntimeError(f"spawn_world: rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=5.0)
        results.close()
    return [out[r] for r in range(world)]
