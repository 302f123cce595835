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
GPU).  Both take every collective of the mesh on the tensors as they
are: gloo stages CUDA tensors through the host itself
(``scripts/torch_gloo_probe.py`` checks which collectives gloo runs on
CUDA tensors and times them against explicit host copies).

The model-parallel layers (``repro_torch.models.common``: column- and
row-parallel products, the split vocabulary, the sequence blocks of
``seq_par``) run their all-reduces, all-gathers and reduce-scatters on
the ``"model"`` axis's group of the active mesh; expert FSDP's gathers
and reduce-scatters run on the data axes'.

:func:`fake_world` makes this process one rank of a world of any shape
over torch's fake process group (``launch.dryrun``: nothing moves, every
collective is logged as on a real world); :func:`fake_tools` is the one
import of the private torch modules that stands on.

Every collective is counted and timed (host clock around the call, after
a synchronize of a CUDA operand) in :func:`collective_log`, emitted as a
``mesh.<op>`` span of ``repro_torch.obs.runtime``, and recorded as a
decision on the open dispatch record with its transport.

:func:`spawn_world` runs a function on ``world`` processes (the tests'
gloo CPU worlds and ``chip_smoke.py`` phase 21): every process group has
an explicit ``timeout``, the parent joins under an overall time limit and
kills the children on a timeout or on the first rank that raises, so a
failing rank fails the run instead of hanging the others in a collective.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
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
        with self._timed("all_reduce", axis, t, record):
            dist.all_reduce(t, op=red, group=group)
        return t

    def all_gather(self, t: torch.Tensor, group, axis: str, size: int,
                   record: bool = True) -> torch.Tensor:
        """(size * t.shape[0], ...) concatenation of every rank's equally
        shaped ``t`` along dim 0, in the group's rank order."""
        with self._timed("all_gather", axis, t, record):
            src = t.contiguous()
            out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=group)
        return out

    def reduce_scatter(self, t: torch.Tensor, group, axis: str, size: int,
                       record: bool = True) -> torch.Tensor:
        """Sum of every rank's equally shaped ``t``, cut along dim 0 into
        ``size`` equal blocks: the group's j-th rank gets block j."""
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

    def all_to_all(self, t: torch.Tensor, axis: str, out_rows: int
                   ) -> torch.Tensor:
        """:meth:`Transport.all_to_all` along ``axis`` (chunk j of ``t``
        to the axis's j-th rank), recorded in the log only."""
        if self.size(axis) == 1:
            return t[:out_rows].clone()
        return self.transport.all_to_all(t, self.groups[axis], axis,
                                         out_rows, record=False)

    def all_gather(self, t: torch.Tensor, axis: str,
                   record: bool = True) -> torch.Tensor:
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


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The mesh ``shape`` x ``axis_names`` over the initialized world
    (a collective: every rank calls it alike; cached per layout).  Its
    size must equal the world size."""
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
    key = (world, names, shape)
    if key in _MESHES:
        return _MESHES[key]
    rank = dist.get_rank()
    groups = {}
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT)
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
            g = dist.new_group(line, timeout=timeout) if shape[a] > 1 else None
            if rank in line:
                groups[name] = g
    mesh = Mesh(names, shape, rank, groups, Transport(dist.get_backend()))
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


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, timeout: float,
               fn: Callable, args: tuple, results) -> None:
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
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
                group_timeout: float = GROUP_TIMEOUT) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned processes joined
    in one gloo world over ``tcp://127.0.0.1`` (ranks that each own a card
    call ``init_process_group("nccl", ...)`` and :func:`make_mesh`
    themselves); returns the ranks' results in rank order.

    ``fn`` and its results must pickle (a module-level function).  The
    world's groups wait ``group_timeout`` seconds for a peer; the parent
    waits at most ``limit`` seconds in all.  The first rank that raises,
    or the limit, kills every child and raises ``RuntimeError`` with the
    rank's traceback (``TimeoutError`` for the limit)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, group_timeout, fn,
                               tuple(args), results))
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
