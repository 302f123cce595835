"""End-to-end training entry point (counterpart of ``repro.launch.train``).

Trains an assigned arch with the full robust pipeline: Dirichlet-
heterogeneous synthetic LM data, D-SHB + NNM + rule, Byzantine attack
simulation and kappa-hat tracking.  Runs on CUDA unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --full --steps 3 --workers 8 --byz 2 --attack alie --agg nnm+cwtm
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5 \\
      --checkpoint params.npz    # the final params, for load_checkpoint
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3 \\
      --attack alie_opt --sketch-dim 512   # eta search; sketch Gram
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --device cpu --steps 2   # or zamba2-2.7b, whisper-base

``--arch`` takes every registered arch (dense, MoE, VLM, rwkv6-3b,
zamba2-2.7b, whisper-base); a VLM's batch carries zero patches and ``seq
- num_patches`` text tokens, an encoder-decoder's zero frames of
``encoder_seq``, as the reference's.  The SSM and hybrid families need
``--seq`` a multiple of ``ssm_chunk`` (16 reduced, 64 full).  The CLI, like the reference's, builds no
selective-robustness step: ``TrainerConfig.fsdp_keys`` is a library
option (``repro_torch.launch.launch_config.fsdp_keys_for``).
``--attack`` takes every name of ``repro_torch.core.types.ATTACKS``
(``alie_opt`` / ``foe_opt`` run 13 aggregates a step); ``--sketch-dim``
sets ``AggregatorSpec.sketch_dim``, its signs drawn from the run's
generator.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core.types import ATTACKS, AggregatorSpec
from repro_torch.data import build_heterogeneous, make_lm_corpus, worker_batches
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.optim.schedules import cosine
from repro_torch.training import ByzantineConfig, TrainerConfig, build_train_step, init_state
from repro_torch.training.trainer import to_device
from repro_torch.tree import tree_leaves


def parse_agg(s: str) -> AggregatorSpec:
    pre, _, rule = s.rpartition("+")
    return AggregatorSpec(rule=rule or "cwtm", pre=pre or None)


def lm_batch(seq: np.ndarray, cfg, seq_len: int) -> dict:
    """Worker-stacked (n, b, seq_len + 1) token rows -> the model's batch:
    next-token tokens / labels; a VLM's adds zero patches (n, b,
    num_patches, vision_dim) and keeps ``seq_len - num_patches`` text
    positions; an encoder-decoder's adds zero frames (n, b, encoder_seq,
    d_model), the stubbed audio frontend's output."""
    batch = {"tokens": seq[..., :-1], "labels": seq[..., 1:]}
    w, pb = seq.shape[:2]
    if cfg.family == "vlm":
        batch["patches"] = np.zeros((w, pb, cfg.num_patches, cfg.vision_dim),
                                    np.float32)
        text = seq_len - cfg.num_patches
        batch["tokens"] = batch["tokens"][..., :text]
        batch["labels"] = batch["labels"][..., :text]
    if cfg.family == "encdec":
        batch["frames"] = np.zeros((w, pb, cfg.encoder_seq, cfg.d_model),
                                   np.float32)
    return batch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="use the full-scale (published) config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--byz", type=int, default=2)
    ap.add_argument("--attack", default="alie", choices=ATTACKS)
    ap.add_argument("--agg", default="nnm+cwtm")
    ap.add_argument("--sketch-dim", type=int, default=0,
                    help="the sketch Gram's width (0: the exact Gram)")
    ap.add_argument("--algorithm", default="dshb", choices=["dshb", "dgd"])
    ap.add_argument("--beta", type=float, default=0.9)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=4, help="per-worker batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--alpha", type=float, default=0.1,
                    help="Dirichlet heterogeneity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="save the final params to this .npz path")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[list] = None, *, capture_first_stack: bool = False
         ) -> dict:
    """Run the training loop; returns {"state", "history", "dispatch", "launches",
    "peak_bytes"} and, with ``capture_first_stack``, step 1's attacked flat
    stack and its layout (``"attacked"``, ``"layout"``), with its sketch
    signs and its eta search's ``"eta"`` / ``"damages"`` when it drew or
    ran them.  Under ``alie_opt`` / ``foe_opt`` the history's ``"eta"``
    holds each step's chosen eta."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    model = build_model(cfg)
    agg = parse_agg(args.agg)
    tcfg = TrainerConfig(
        algorithm=args.algorithm, beta=args.beta,
        agg=AggregatorSpec(rule=agg.rule, f=args.byz, pre=agg.pre,
                           sketch_dim=args.sketch_dim),
        byz=ByzantineConfig(f=args.byz, attack=args.attack))

    if device.type == "cuda":
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.library()
        print(f"kernels ready in {time.perf_counter() - t0:.1f}s "
              f"(nvcc {_build.BUILD_SECONDS:.1f}s)")
        torch.cuda.reset_peak_memory_stats(device)

    params = model.init(args.seed, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M workers={args.workers} "
          f"f={args.byz} attack={args.attack} agg={args.agg} device={device}")

    seqs, topics = make_lm_corpus(n_tokens=400_000, vocab=cfg.vocab_size,
                                  seq_len=args.seq + 1, seed=args.seed)
    ds = build_heterogeneous({"seq": seqs, "y": topics}, "y", args.workers,
                             alpha=args.alpha, seed=args.seed)
    raw = worker_batches(ds, args.batch, seed=args.seed)

    optimizer = sgd(clip=2.0)
    schedule = cosine(args.lr, args.steps, warmup=min(20, args.steps // 10))
    step_fn = build_train_step(model.loss, optimizer, tcfg, schedule)
    state = init_state(params, optimizer, args.workers, tcfg)
    # Draws the bucket permutations of --agg bucketing+<rule> and the
    # signs of --sketch-dim.
    generator = torch.Generator().manual_seed(args.seed)

    history: dict[str, list] = {"loss": [], "direction_norm": [],
                                "kappa_hat": [], "lr": [], "ms": [], "eta": []}
    out: dict = {}
    searches = args.attack.endswith("_opt")
    for t in range(args.steps):
        batch = to_device(lm_batch(next(raw)["seq"], cfg, args.seq), device)
        capture = capture_first_stack and t == 0
        internals = {} if capture or searches else None
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, internals,
                                 generator=generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = 1e3 * (time.perf_counter() - t0)
        if capture:
            out.update(internals)
        for k in ("loss", "direction_norm", "kappa_hat", "lr"):
            history[k].append(float(metrics[k]))
        if searches:
            history["eta"].append(float(internals["eta"]))
        history["ms"].append(ms)
        del internals
        if (t + 1) % args.log_every == 0 or t == 0:
            eta = f" eta={history['eta'][-1]:g}" if searches else ""
            print(f"step {t + 1:5d} loss={history['loss'][-1]:.4f} "
                  f"|R|={history['direction_norm'][-1]:.3f} "
                  f"kappa_hat={history['kappa_hat'][-1]:.3f} "
                  f"lr={history['lr'][-1]:.4f}{eta} ({ms:.1f} ms/step)")

    rec = kdispatch.last_dispatch()
    launches = kdispatch.launch_counts()
    print("dispatch:", rec.describe() if rec else None)
    print("kernel launches:", launches)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        print(f"peak device memory: {peak / 2**30:.2f} GiB")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state["params"], step=state["step"])
        print(f"checkpoint saved to {args.checkpoint}")
    out.update(state=state, history=history, dispatch=rec, launches=launches,
               peak_bytes=peak)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
