"""Batched greedy decode from the command line (counterpart of
``examples/serve_decode.py``): one arch, seeded random weights, seeded
prompts, through :class:`repro_torch.serving.ServeEngine`.  Runs on CUDA
unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --device cpu          # reduced config: 2 layers, fp32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --full \\
      --batch 8 --prompt 256 --max-new 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \\
      --full --layers 1     # a depth cut for an arch one card cannot hold

``--arch`` takes every registered arch.  ``--full`` is the published
config (bf16), else the reduced one; ``--layers`` cuts the depth (a
hybrid's to a multiple of its ``attn_every``) and is printed.  An
encoder-decoder (whisper-base) serves seeded normal frames through
``prefill_cache``.  Prints the tokens' first row, the prefill ms and the
ms per decoded token (:func:`clocked_generate`: the host clock around
each step of ``generate``, ending in a synchronize on CUDA; the median
over the steps after the first).
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def clocked_generate(eng: ServeEngine, prompts, max_new: int, cache=None,
                     *, keep_logits: bool = False) -> dict:
    """:meth:`ServeEngine.generate` with a host clock around its prefill and
    around each decode step after it, each ending in a synchronize on CUDA
    (the engine's ``prefill`` and its model's ``decode_step`` are wrapped
    for the call).  Returns {"tokens": generate's (B, max_new) int32,
    "prefill_ms", "step_ms" (max_new - 1 of them)} and, with
    ``keep_logits``, "logits": the prefill's last logits and each step's,
    (B, max_new, V) fp32.  On a model mesh it runs on each rank as it
    stands: the synchronize is the rank's device's, the logits are this
    data rank's rows (the vocabulary whole), the tokens the whole
    batch's."""
    dev, model = eng.device, eng.model
    out: dict = {"step_ms": []}
    kept: list = []
    decode, prefill = model.decode_step, eng.prefill

    def timed_prefill(c, p):
        _sync(dev)
        t0 = time.perf_counter()
        c, logits, n = prefill(c, p)
        _sync(dev)
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        kept.append(logits)
        model.decode_step = timed_step
        return c, logits, n

    def timed_step(params, c, tokens, pos, **kw):
        t0 = time.perf_counter()
        logits, c = decode(params, c, tokens, pos, **kw)
        _sync(dev)
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        kept.append(logits)
        return logits, c

    eng.prefill = timed_prefill
    try:
        out["tokens"] = eng.generate(prompts, max_new=max_new, cache=cache)
    finally:
        del eng.prefill
        model.__dict__.pop("decode_step", None)
    if keep_logits:
        out["logits"] = torch.cat(kept, dim=1)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="use the full-scale (published) config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[list] = None) -> dict[str, Any]:
    """Serve one batch; returns {"tokens", "prefill_ms", "step_ms",
    "ms_per_token", "cfg"}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    if args.layers and args.layers != cfg.num_layers:
        print(f"depth cut: {args.layers} of {cfg.num_layers} layers")
        cfg = cfg.replace(num_layers=args.layers)
    model = build_model(cfg)
    params = model.init(args.seed, device)
    rng = np.random.default_rng(args.seed + 1)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt))
    max_seq = args.prompt + args.max_new
    eng = ServeEngine(model, params, batch_size=args.batch, max_seq=max_seq)
    cache = None
    if cfg.family == "encdec":
        gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        frames = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=device)
        cache = model.prefill_cache(params, frames, args.batch, max_seq)
    out = clocked_generate(eng, prompts, args.max_new, cache)
    steps = out["step_ms"][1:]
    out["ms_per_token"] = statistics.median(steps) if steps else float("nan")
    out["cfg"] = cfg
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"batch={args.batch} prompt={args.prompt} max_new={args.max_new} "
          f"device={device}")
    print(f"tokens {out['tokens'].shape}, first row: "
          f"{out['tokens'][0].tolist()}")
    print(f"prefill {out['prefill_ms']:.1f} ms; {out['ms_per_token']:.3f} ms "
          f"per decoded token (median of {len(steps)} steps after the first)")
    return out


if __name__ == "__main__":
    main()
