"""The reference's hill-climbing pairs (counterpart of
``repro.launch.perf``): for each of three (arch x shape) pairs, the
paper-faithful baseline and the candidate changes, each a hypothesis and
its dry-run record (``launch.dryrun``: one rank of the production mesh
over the fake process group, reckoned for an H100 SXM from data-sheet
peaks, not measured), written to ``artifacts/perf/<pair>.json`` with each
variant's change in the three roofline terms printed.

``PAIRS`` is the reference's, variants and hypotheses as written there;
the hypotheses' predictions were made for the reference's TPU mesh.  The
``gqa_einsum`` variants have no form in the port (ROADMAP, "Not carried
over") and are recorded ``status: "skipped"`` with that reason.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.perf --pair qwen2_train
    PYTHONPATH=src python -m repro_torch.launch.perf --all
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import dryrun_one, error_record

#: (arch, shape, variants).  Each variant: (name, hypothesis, kwargs).
PAIRS = {
    # Most representative of the paper's technique: full robust D-SHB on a
    # dense 7B; collective term is dominated by the two worker-axis
    # all-gather passes of the fp32 momentum stack (gram pass + mix pass).
    "qwen2_train": ("qwen2-7b", "train_4k", [
        ("sampled_kappa",
         "the kappa-hat diagnostic re-gathers the fp32 stack every step "
         "independently of the aggregation passes; computing it on a "
         "sampled schedule (off in the steady-state step) removes one "
         "full-stack gather (predicted collective ~ -30%)",
         dict(kappa_hat=False)),
        ("bf16_transport",
         "all-gathers move n*|theta| fp32 twice; bf16 transport halves "
         "collective bytes (predicted ~2x on the aggregation share); "
         "composed with sampled kappa-hat so the fp32 diagnostic gather "
         "does not mask it",
         dict(transport="bf16", kappa_hat=False)),
        ("sketch512",
         "neighbor selection only needs distance RANKS; a 512-dim "
         "structured sketch computed worker-locally removes the gram "
         "all-gather pass entirely (predicted: collective ~ -40%)",
         dict(sketch=512, kappa_hat=False)),
        ("bf16+sketch512",
         "compose both: one bf16 pass instead of two fp32 passes "
         "(predicted ~4x lower aggregation collective bytes)",
         dict(transport="bf16", sketch=512, kappa_hat=False)),
        ("no_seq_par",
         "ablation: sequence-parallel residual stream off; expected HIGHER "
         "memory term -- measured LOWER (-10%): SP reshard copies cost "
         "more than the activation savings at 7B scale. REFUTED for "
         "non-giants; seq_par now defaults off below the FSDP threshold",
         dict(seq_par=False)),
    ]),
    # Most collective-bound: giant MoE with FSDP experts + selective
    # robustness; collectives = expert all-gathers + aggregation passes.
    "arctic_train": ("arctic-480b", "train_4k", [
        ("bf16_transport",
         "aggregation share of collectives halves with bf16 transport",
         dict(transport="bf16", kappa_hat=False)),
        ("bf16+sketch512",
         "drop the gram pass (sketch) + bf16 the mix pass",
         dict(transport="bf16", sketch=512, kappa_hat=False)),
        ("capacity1.0",
         "expert dispatch buffers / all-to-all bytes scale with the "
         "capacity factor; 1.25 -> 1.0 trims 20% of the MoE path at the "
         "cost of more token dropping (predicted collective ~ -10%)",
         dict(capacity=1.0, kappa_hat=False)),
    ]),
    # Worst memory-term decode: replicated kv heads force the model axis to
    # shard the cache SEQ dim; the ring-slot scatter then triggers XLA's
    # involuntary full rematerialization (a full cache copy per token).
    "minitron_decode": ("minitron-8b", "decode_32k", [
        ("gqa_einsum",
         "the decode kv-repeat materializes a (B,S,Hq,hd) copy of the "
         "cache per layer (4x the kv bytes for kv=8->hq=32); grouped "
         "einsum contracts q-head groups against shared kv directly - "
         "predicted memory term ~ -50%",
         dict(gqa_einsum=True)),
        ("gqa_einsum+pad_kv",
         "compose: grouped einsum + kv sharding over the mesh (kills the "
         "seq-shard scatter rematerialization as well)",
         dict(gqa_einsum=True, pad_kv=True)),
        ("pad_kv16",
         "pad kv heads 8->16 so the cache shards over kv instead of seq: "
         "scatter becomes shard-local; predicted memory term ~ -60% "
         "(kills the 17GB/token cache rematerialization) at 2x kv-param "
         "padding cost",
         dict(pad_kv=True)),
    ]),
}


def _dryrun(arch: str, shape: str, variant: str, **kw) -> dict:
    try:
        return dryrun_one(arch, shape, variant=variant, **kw)
    except Exception as e:                             # noqa: BLE001
        return {**error_record(arch, shape, "16x16", e), "variant": variant}


def run_pair(name: str, out_dir: str = "artifacts/perf") -> list:
    arch, shape, variants = PAIRS[name]
    os.makedirs(out_dir, exist_ok=True)
    records = [{"variant": "baseline", "hypothesis":
                "paper-faithful NNM+CWTM pipeline",
                **_dryrun(arch, shape, "baseline")}]
    for vname, hypothesis, kw in variants:
        rec = {"variant": vname, "hypothesis": hypothesis,
               **_dryrun(arch, shape, vname, **kw)}
        records.append(rec)
        _compare(records[0], rec)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
        json.dump(records, fh, indent=1)
    return records


def _compare(base: dict, rec: dict) -> None:
    if rec.get("status") != "ok" or base.get("status") != "ok":
        print(f"  {rec['variant']:16s} {rec.get('status')}: "
              f"{rec.get('reason') or rec.get('error', '')}"[:160])
        return
    b, r = base["roofline"], rec["roofline"]
    for term in ("compute_s", "memory_s", "collective_s"):
        delta = (r[term] - b[term]) / max(b[term], 1e-30)
        print(f"  {rec['variant']:16s} {term:13s} {b[term]:.3e} -> "
              f"{r[term]:.3e}  ({delta:+.1%})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", choices=list(PAIRS), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/perf")
    args = ap.parse_args(argv)
    names = list(PAIRS) if args.all or not args.pair else [args.pair]
    for n in names:
        print(f"=== {n} ===")
        run_pair(n, args.out)


if __name__ == "__main__":
    main()
