"""A dry run of one rank of the production mesh (counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles every (arch x input shape x mesh)
against 512 fake XLA devices and reads XLA's memory, cost and collective
analyses.  The port runs the program itself: this process stands for one
rank (``--rank``) of the production mesh (``launch.mesh.
make_production_mesh``: 16 x 16, or 2 x 16 x 16 with ``--multi-pod``)
over torch's fake process group (``launch.mesh.fake_world``: collectives
return at once and move nothing; ``Transport`` logs their bytes), with
every tensor under ``FakeTensorMode`` (nothing is allocated).  That rank
runs the full config at full depth through the trainer's
``build_train_step`` (train shapes), the model's ``forward`` (prefill) or
``decode_step`` (decode).  There are no probe depths: the reference
extrapolates from two shallow compiles because XLA counts a loop body
once; the port counts every op it runs.

Each record holds, for that rank:

* ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count
  (matrix products and attention; elementwise work is not counted);
* ``cost.bytes accessed``: operand plus result bytes of every aten op
  but views and allocations, as XLA's "bytes accessed" counts per HLO
  op: an upper bound on HBM traffic, since a fused kernel does not
  reread its intermediates;
* ``collectives``: per ``"op@axis"``, calls and the bytes handed to the
  collective (its input), from ``launch.mesh.collective_log``;
* ``memory``: the peak of live tensors on the rank's device
  (``torch.distributed._tools.mem_tracker.MemTracker``; ``meta``
  tensors, which hold nothing, are not counted), the step's inputs
  (``argument_bytes``) and the rest of the peak (``temp_bytes``);
* ``roofline``: ``launch.roofline.RooflineTerms`` with an H100 SXM's
  data-sheet peaks (700 W) and, for the collective term, each axis's
  link from data sheets (:data:`NVLINK_BW` within an 8-GPU node,
  :data:`NET_BW` across nodes; :func:`axis_link`): reckonings, not
  measurements;
* ``model_flops_per_device`` (6 N D over the ranks) and
  ``useful_flops_ratio``.

The kernel wrappers see CPU tensors, so the counts are their plain
versions' (the Gram as a product, the trimmed mean as a sort).  Records
carry the keys ``benchmarks/bench_roofline.py`` reads.  As in the
reference, ``seq_par`` defaults on for the FSDP giants in training
(``launch_config.wants_fsdp_experts``) and ``expert_fsdp`` follows that
test; ``launch_config.skip_reason`` skips a target.  A read of a value on
the host (``.item()``, ``.tolist()``, ``bool`` of a tensor) raises under
fake tensors; the train step, forward and decode make none (decode takes
its position as a host int), and a target that still fails is recorded
``status: "error"``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k [--multi-pod] [--agg nnm+cwtm] [--out artifacts/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS
from repro_torch.configs.base import SHAPES, InputShape, ModelConfig
from repro_torch.core.types import AggregatorSpec
from repro_torch.launch import launch_config as lc
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as specslib
from repro_torch.models import build_model, common
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.training import ByzantineConfig, TrainerConfig
from repro_torch.training import build_train_step, init_state
from repro_torch.tree import tree_leaves, tree_map

#: GPUs per node: ranks r and q share NVLink when r // 8 == q // 8.
GPUS_PER_NODE = 8
#: NVLink 4 on an H100 SXM: 900 GB/s per GPU both ways together (data
#: sheet), 450e9 B/s each way.
NVLINK_BW = 450e9
#: A DGX H100's network: one 400 Gb/s ConnectX-7 port per GPU (data
#: sheet), 50e9 B/s each way.
NET_BW = 50e9

CPU = torch.device("cpu")


def parse_agg(s: str, transport: Optional[str] = None,
              sketch: int = 0) -> AggregatorSpec:
    """``"nnm+cwtm"`` -> the sharded backend's spec (the trainer's worker
    axes on a model mesh require it)."""
    pre, _, rule = s.rpartition("+")
    return AggregatorSpec(rule=rule or "cwtm", pre=pre or None,
                          backend="cuda_sharded", transport_dtype=transport,
                          sketch_dim=sketch)


def axis_link(mesh, axis: str) -> tuple[str, float]:
    """(name, bytes/s) of the link this rank's group along ``axis`` moves
    over: NVLink when every rank of it lies in this rank's 8-GPU node, else
    the network (the world's ranks fill nodes in order)."""
    node = mesh.rank // GPUS_PER_NODE
    a = mesh.axis_names.index(axis)
    stride = math.prod(mesh.shape[a + 1:])
    base = mesh.rank - mesh.index(axis) * stride
    ranks = [base + j * stride for j in range(mesh.shape[a])]
    if all(r // GPUS_PER_NODE == node for r in ranks):
        return "nvlink", NVLINK_BW
    return "network", NET_BW


def collective_summary(log: list) -> dict:
    """{"op@axis": {"calls", "bytes"}} of a collective log."""
    out: dict = {}
    for c in log:
        row = out.setdefault(f"{c['op']}@{c['axis']}",
                             {"calls": 0, "bytes": 0})
        row["calls"] += 1
        row["bytes"] += int(c["bytes"])
    return out


# ---------------------------------------------------------------------------
# What one rank runs.
# ---------------------------------------------------------------------------

def shard_tensors(descs, axes, mesh, device: torch.device):
    """Zero tensors of this rank's shard shapes (``common.shard_slice``),
    drawing nothing whole (real or fake)."""
    def one(d):
        idx = common.shard_slice(d, axes, mesh)
        shape = tuple(len(range(*s.indices(n))) for s, n in zip(idx, d.shape))
        return torch.zeros(shape, dtype=d.dtype, device=device)
    return tree_map(one, descs)


def train_target(model, axes, n_workers: int, agg: AggregatorSpec,
                 fsdp_keys: tuple, params, *, kappa_hat: bool = True,
                 trainer: Optional[TrainerConfig] = None):
    """(step, state): the reference's dry-run train target (D-GD under
    ``fsdp_keys``, else D-SHB; f = max(1, n / 4), no attack; SGD with clip
    2.0 at lr 1e-3) over the port's trainer with the workers dealt over the
    data axes, or ``trainer`` (its ``param_specs`` and ``worker_axes``
    filled in); run it as ``step(state, batch)``."""
    f = max(1, n_workers // 4)
    tcfg = trainer or TrainerConfig(
        algorithm="dgd" if fsdp_keys else "dshb",
        agg=dataclasses.replace(agg, f=f),
        byz=ByzantineConfig(f=f, attack="none"), track_kappa_hat=kappa_hat,
        fsdp_keys=fsdp_keys)
    tcfg = dataclasses.replace(
        tcfg, worker_axes=axes.data,
        param_specs=common.leaf_specs(model.param_descs()))
    optimizer = sgd(clip=2.0)
    step = build_train_step(model.loss, optimizer, tcfg, constant(1e-3))
    return step, init_state(params, optimizer, n_workers, tcfg)


class _BytesAccessed(TorchDispatchMode):
    """Operand plus result bytes of every aten op but views and
    allocations."""

    _SKIP = ("empty", "empty_strided", "new_empty", "new_empty_strided",
             "empty_like", "detach", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket.__name__ not in self._SKIP:
            self.bytes += sum(
                t.numel() * t.element_size()
                for t in pytree.tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Counters:
    """FLOPs, bytes accessed and the collective log of the enclosed work
    (``with Counters() as c: ...``), on real or fake tensors."""

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._stack = contextlib.ExitStack()
        meshlib.reset_collective_log()
        self._flops = self._stack.enter_context(FlopCounterMode(display=False))
        self._bytes = self._stack.enter_context(_BytesAccessed())
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self.flops = int(self._flops.get_total_flops())
        self.hbm_bytes = int(self._bytes.bytes)
        self.collectives = collective_summary(meshlib.collective_log())
        return False


def _fake_inputs(meta: dict) -> dict:
    return {k: torch.zeros(tuple(v.shape), dtype=v.dtype, device=CPU)
            for k, v in meta.items()}


def _run_rank(cfg: ModelConfig, shape: InputShape, axes, mesh, n_workers,
              agg: AggregatorSpec, fsdp_keys: tuple, kappa_hat: bool,
              trainer: Optional[TrainerConfig]) -> dict:
    """The target on this rank, under the active fake world and fake
    tensor mode: its counts and its memory."""
    _, mem_tracker = meshlib.fake_tools()
    model = build_model(cfg)
    tracker = mem_tracker()
    with tracker:
        params = shard_tensors(model.param_descs(), axes, mesh, CPU)
        if shape.kind == "train":
            meta, _ = specslib.train_input_specs(cfg, shape, axes, n_workers)
            batch = _fake_inputs(meta)
            step, state = train_target(model, axes, n_workers, agg, fsdp_keys,
                                       params, kappa_hat=kappa_hat,
                                       trainer=trainer)
            args = _nbytes((state, batch))
            with Counters() as c:
                out = step(state, batch)
        elif shape.kind == "prefill":
            meta, _ = specslib.prefill_input_specs(cfg, shape, axes)
            lo, hi = common.batch_block(shape.global_batch)
            batch = {k: v[lo:hi] for k, v in _fake_inputs(meta).items()}
            args = _nbytes((params, batch))
            with Counters() as c, torch.no_grad():
                out = model.forward(params, batch)
        else:
            b, s = shape.global_batch, shape.seq_len
            meta, _ = specslib.decode_input_specs(cfg, shape, axes)
            lo, hi = common.batch_block(b)
            tokens = _fake_inputs(meta)["tokens"][lo:hi]
            cache = model.init_cache(b, s, CPU)
            args = _nbytes((params, cache, tokens))
            with Counters() as c:
                out = model.decode_step(params, cache, tokens, s - 1,
                                        batch=b, max_seq=s)
    # The rank's device only: MemTracker also counts ``meta`` tensors (the
    # trainer's stack layout, n x the robust leaves), which hold nothing.
    peak = tracker.get_tracker_snapshot("peak")
    peak_bytes = max((int(stats.get("Total", 0)) for dev, stats in peak.items()
                      if torch.device(dev).type != "meta"), default=0)
    return {"flops": c.flops, "hbm_bytes": c.hbm_bytes,
            "collectives": c.collectives, "argument_bytes": args,
            "output_bytes": _nbytes(out), "peak_bytes": peak_bytes}


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               agg: str = "nnm+cwtm", seq_par: Optional[bool] = None,
               verbose: bool = True, transport: Optional[str] = None,
               sketch: int = 0, pad_kv: bool = False,
               gqa_einsum: bool = False, kappa_hat: bool = True,
               capacity: Optional[float] = None, variant: str = "baseline",
               rank: int = 0, cfg: Optional[ModelConfig] = None,
               shape: Optional[InputShape] = None,
               mesh_shape: Optional[tuple] = None,
               expert_fsdp: Optional[bool] = None,
               fsdp_keys: Optional[tuple] = None,
               n_workers: Optional[int] = None,
               trainer: Optional[TrainerConfig] = None) -> dict:
    """One target's record (module docstring).  ``cfg`` / ``shape`` /
    ``mesh_shape`` replace the launch config, the input shape and the
    production mesh (a ("data", "model") grid, or with three entries a
    ("pod", "data", "model") one; ``multi_pod`` then does not apply),
    ``expert_fsdp`` / ``fsdp_keys`` the choices
    ``launch_config.wants_fsdp_experts`` makes, ``n_workers`` the one
    worker per data rank and ``trainer`` the train target's config
    (:func:`train_target`): a run of another program (a reduced target, a
    chip phase's) on a small fake world, as a real world runs it."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if mesh_shape is not None:
        mesh_name = "x".join(str(k) for k in mesh_shape)
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = lc.skip_reason(arch, shape_name)
    if reason:
        return {**head, "status": "skipped", "reason": reason}
    if gqa_einsum:
        return {**head, "variant": variant, "status": "skipped",
                "reason": "ModelConfig.gqa_einsum has no form in the port: "
                          "its decode contracts the q-head groups against "
                          "the shared kv heads in one form (ROADMAP, 'Not "
                          "carried over')"}
    if cfg is None:
        cfg = lc.launch_config(arch, shape_name)
    if capacity is not None:
        cfg = cfg.replace(capacity_factor=capacity)
    if seq_par is None:
        seq_par = lc.wants_fsdp_experts(cfg)
    shape = shape or SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape = (meshlib.PODS, meshlib.DATA_PAR, meshlib.MODEL_PAR) \
            if multi_pod else (meshlib.DATA_PAR, meshlib.MODEL_PAR)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
    else:
        multi_pod = len(mesh_shape) == 3
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n_workers = n_workers or math.prod(mesh_shape[:-1])
    axes = meshlib.mesh_axes_for(cfg, multi_pod=multi_pod, pad_kv=pad_kv,
                                 model_par=mesh_shape[-1])
    if shape.kind == "train":
        axes = dataclasses.replace(axes, workers_on_data=True,
                                   seq_par=seq_par)
    if expert_fsdp is None:
        expert_fsdp = lc.wants_fsdp_experts(cfg)
    if fsdp_keys is None:
        fsdp_keys = lc.fsdp_keys_for(cfg)
    axes = dataclasses.replace(axes, expert_fsdp=expert_fsdp)
    chips = math.prod(mesh_shape)
    record = {**head, "kind": shape.kind, "agg": agg, "n_workers": n_workers,
              "rank": rank, "variant": variant,
              "options": {"transport": transport, "sketch": sketch,
                          "pad_kv": pad_kv, "seq_par": seq_par,
                          "expert_fsdp": axes.expert_fsdp,
                          "gqa_einsum": gqa_einsum}}
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    with meshlib.fake_world(mesh_shape, names, rank) as mesh, \
            meshlib.use_mesh(mesh), common.mesh_axes_scope(axes), \
            FakeTensorMode():
        got = _run_rank(cfg, shape, axes, mesh, n_workers,
                        parse_agg(agg, transport, sketch), fsdp_keys,
                        kappa_hat, trainer)
        links = {ax: axis_link(mesh, ax) for ax in mesh.axis_names}
    record["run_s"] = round(time.time() - t0, 1)
    record["cost"] = {"flops": float(got["flops"]),
                      "bytes accessed": float(got["hbm_bytes"])}
    record["collectives"] = got["collectives"]
    record["links"] = {ax: name for ax, (name, _) in links.items()}
    record["memory"] = {
        "argument_bytes": got["argument_bytes"],
        "output_bytes": got["output_bytes"],
        "temp_bytes": max(got["peak_bytes"] - got["argument_bytes"], 0),
        "peak_bytes": got["peak_bytes"]}
    cbytes = float(sum(r["bytes"] for r in got["collectives"].values()))
    coll_s = sum(r["bytes"] / links[key.split("@", 1)[1]][1]
                 if key.split("@", 1)[1] in links else r["bytes"] / NET_BW
                 for key, r in got["collectives"].items())
    peak = rl.H100_PEAK_FP32 if cfg.dtype == torch.float32 \
        else rl.H100_PEAK_BF16
    terms = rl.RooflineTerms(got["flops"], got["hbm_bytes"], cbytes, peak,
                             rl.H100_HBM_BW,
                             cbytes / coll_s if coll_s else float("inf"))
    record["roofline"] = terms.as_dict()
    tokens = shape.global_batch * shape.seq_len if shape.kind != "decode" \
        else shape.global_batch
    # model_flops = 6 N D counts forward and backward; inference is forward.
    mult = 1.0 if shape.kind == "train" else 1.0 / 3.0
    mf = rl.model_flops(cfg, tokens) * mult
    record["model_flops_global"] = mf
    record["model_flops_per_device"] = mf / chips
    record["useful_flops_ratio"] = (record["model_flops_per_device"]
                                    / got["flops"] if got["flops"] else None)
    record["status"] = "ok"
    if verbose:
        r = record["roofline"]
        print(f"{arch:16s} {shape_name:12s} {record['mesh']:8s} "
              f"run={record['run_s']:6.1f}s compute={r['compute_s']:.3e}s "
              f"memory={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
              f"dom={r['dominant']} peak="
              f"{record['memory']['peak_bytes'] / 2**30:.2f}GiB")
    return record


def error_record(arch: str, shape_name: str, mesh: str,
                 exc: BaseException) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": mesh,
            "status": "error", "error": f"{type(exc).__name__}: {exc}",
            "traceback": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--agg", default="nnm+cwtm")
    ap.add_argument("--no-seq-par", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape_name}_{'mp' if mp else 'sp'}"
                try:
                    rec = dryrun_one(arch, shape_name, multi_pod=mp,
                                     agg=args.agg, rank=args.rank,
                                     seq_par=False if args.no_seq_par
                                     else None)
                except Exception as e:                 # noqa: BLE001
                    rec = error_record(arch, shape_name,
                                       "2x16x16" if mp else "16x16", e)
                    print(f"{arch} {shape_name} FAILED: {rec['error'][:200]}")
                with open(os.path.join(args.out, tag + ".json"), "w") as fh:
                    json.dump(rec, fh, indent=1)


if __name__ == "__main__":
    main()
