#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py --18d    # the build and phase 18d alone
    python3 chip_smoke.py --22     # the build and phase 22 alone
    python3 chip_smoke.py --23     # the build and phase 23 alone

Phases, each fatal on failure:
  1. environment: torch / CUDA / nvcc versions, the card, TF32 off;
  2. build: the CUDA kernels of src/repro_torch/kernels/csrc, compiled
     from the checkout by nvcc (one process per source, in parallel);
  3. each kernel (K1 gram, K2 mixtrim, K3 combine) against its plain
     PyTorch version on the card at the main path's shape (n = 8 workers,
     D = 361,821,120: full-width smollm-360m), and at n = 17, f = 8 on a
     ragged smaller D; times by CUDA events (median of 7, after a warm-up)
     beside the least time the card could take (bound) and, where one
     PyTorch call computes the same function, that call's time; K2's dense
     trim with the mix (fp32 and bf16) beside the previous design's time;
     K2 on the wide heights of its n <= 64 body (n in {33, 48, 64},
     D = 2^24, fp32 and bf16, trim with the mix); then K1 at
     n in {17, 40, 64, 256, 640, 1024}, D = 2^20 (the staged kernel to 32
     workers, the tiled product above, each tile height the wrapper picks
     beside the other heights) against its plain version and
     torch.mm(x, x.T);
  4. K6 (bucketgram) and K7 (bucketmeans) against their plain versions at
     the hierarchical trainer's shape (n = 16 workers in 8 buckets,
     D = 361,821,120, fp32 and bf16, then with inf / NaN rows), and at the
     reference's scale shapes (n in {256, 1024, 4096, 10240},
     d = clamp(2^19 / n, 64, 2048), buckets of 16);
  5. K2 above 64 workers (n in {65, 256, 640, 1024, 10240}, trim and
     median, with and without the mix, and with NaN / inf rows) against its
     plain version; up to n = 1024 the tiled mix and rank selection, whose
     times at n = 256, 640 and 1024 are printed beside the previous
     design's;
  6. the reference's hierarchical scale case, n = 10240 workers in buckets
     of 16 (640 means): robust_aggregate(hier) with NNM + CWTM (K6, K1 on
     the means, K2 with the mix) and with CWTM (K7, K2 without it), the
     kernel backend against the torch backend at D = 64 and D = 2^19, then
     each twice at D = 2^20 (a 42.9 GB fp32 stack: launches and an empty
     fallback log asserted, host-clock time, peak memory), and each of
     their kernels timed at the aggregates' own inputs: K1 on the 640 means
     (the tiled product) must be bitwise repeatable, exactly symmetric and
     faster than torch.mm(y, y.T), its time printed beside the previous
     design's;
  7. the main path: ``repro_torch.launch.train.main`` for 3 D-SHB steps of
     full-width smollm-360m, n = 8, f = 2, ALIE, NNM + CWTM; asserts finite
     loss / kappa_hat, one K1 and one K2 launch per step and no recorded
     fallback; then step 1's attacked stack through robust_aggregate on
     the kernel backend against the leaf-streamed torch backend;
  8. the gram-rule path: 2 steps with NNM + GM, asserting K3 ran;
  9. the hierarchical trainer at full width (4 of 32 layers), n = 16, f
     = 3, ALIE, through train_loop: hier + NNM + CWTM (3 steps; K6 = 1, K2 = 1, K1 = 0 per
     step), hier + CWTM (2 steps; K7 and K2), hier + NNM + GM (2 steps; K6
     and K3); then --agg bucketing+cwtm through launch.train.main (2 steps;
     K2 only);
 10. ptxas's registers / stack / spills of the n <= 64 body K2 and K4
     share, of K5's, K2's 64 < n <= 1024 and K1's tiled instances (the
     shared body's fp32 n <= 32, K2's fp32 mix instance for n = 640 and
     K1's fp32 cp.async instance for n = 640, TM = 128, must keep no stack
     frame and no spill); K4's sort on every 0-1 column at n = 17 (every
     f, trim and median) and K2's at n = 8 and 17 (its slice at every f,
     and the median) exactly equal to their plain versions; K5 (gram_batched) against its plain version (the
     batch and each lane) and torch.bmm at (B = 8, n = 17, D = 2^24) and
     the reference bench's (8, 16, 8192), bitwise repeatable, its time at
     (8, 17, 2^24) beside the previous design's and the bound, and above
     32 workers (the tiled product) at (2, 640, 2^20), each lane also held
     to K1 on that lane; K4 (mixtrim_dyn)
     lane-batched at (8, 17, 2^24) with per-lane f = 0..7 and per-lane M,
     with and without the mix, and with an inf row and a NaN row; both at
     the fleet grid's own shapes, (B = 5, n = 17, D = 2842) and the
     bucketing lanes' (5, 9, 2842), f = 4 per lane through adjusted_f_dyn
     (the lane forms of K2's median and K3 at the grid's shape: phase 18);
 11. the fleet: ``repro_torch.launch.grid --full`` in process (61 jobs,
     13 buckets, GRID_ROUNDS = 30 rounds), asserting K4, K5 and the lane forms of K2's
     median and K3 launched, no single-lane K2 / K3 and no fallback, printing the accuracy table, ms per bucket-round and peak
     memory; then the cwtm | nnm and cwtm | bucketing buckets again on the
     torch backend, per-round losses within rtol 1e-4 of the kernel run;
 12. the federated engine (``repro_torch.fed``): (a) the registry's
     iid_baseline, labelskew_alie_partial, mimic_rotating,
     dirichlet_localsgd, poison_labelflip, poison_feature and
     faulty_nan_quarantine through ``run_scenario``, 20 rounds each in
     segments of 5, asserting the launches of every round (cwtm | nnm K1
     + K2; gm, autogm and average K1 + K3), no kernel fallback, finite
     metrics and, under the guard, m_byz rows quarantined every round;
     printing accuracy, ms per round by the host clock around each
     segment and peak memory; labelskew_alie_partial again on the torch
     backend (losses within rtol 1e-4) and on the loop engine (1e-6);
     (b) K1 and K2 at the full-width cohort stack (n = 6) against their
     plain versions, then ``FedServer`` + ``run_rounds`` with full-width
     smollm-360m: 8 clients, cohorts of 6, f = 2, ALIE eta 8, NNM + CWTM,
     D-SHB, 2 rounds in segments of 1 (one K1 and one K2 a round, finite
     loss and kappa_hat, peak memory below 70 GiB beside the reckoned
     peak);
 13. resumable runs (``repro_torch.resilience``): (a) full-width
     smollm-360m at 4 of 32 layers, n = 8, f = 2, ALIE 8, NNM + CWTM, 4
     D-SHB steps through
     train_loop's scan engine (segments of 2) and its loop engine: final
     params, best params, momentum and every metric equal bit for bit, 1
     host metric transfer against 4, 4 K1 and 4 K2 launches each, ms per
     step of both; (b) the same run killed after its step-2 snapshot
     (FaultPlan(kill_at=0), keep=1, a temporary directory; the free disk
     checked against two reckoned snapshots first) and resumed from it,
     equal to (a)'s scan run bit for bit; each snapshot's bytes and
     seconds, the load's seconds, the resumed ms per step and peak
     memory; (c) labelskew_alie_partial, 20 rounds in segments of 5,
     killed (kill_at=1) and torn (torn_at=1), each resumed: history
     (pack() arrays, cohorts) and state equal the uninterrupted run, K1 +
     K2 once a round; (d) the grid's cwtm | nnm bucket (5 lanes), 16
     rounds in segments of 2, killed after its first snapshot and
     resumed: every FleetResult equal, K4 + K5 once a bucket-round;
 14. the continuous fleet service (``repro_torch.serving``): (a) the
     paper's grid (61 jobs, 13 buckets, 18 rounds in segments of at most
     10, cut at the evals) submitted up front to ``FleetService`` and run
     by ``FleetRunner``, in turns: every FleetResult equal bit for bit, 13
     round programs each, the K2-K5 launches equal (K4 / K5 and the
     lane forms of K2's median / K3 once a bucket-round, none once a
     lane), no fallback, ms per bucket-round
     of both; (b) churn on the cwtm | nnm and gm | nnm buckets (3 lanes,
     segments of 3): late submits, a running and a queued cancel, two
     deadlines; admission latencies and order asserted, each finished
     lane equal bit for bit to its job alone in a 3-slot bucket and
     within rtol 1e-5 of its 1-lane solo run (GM's direction_norm 1e-4;
     bitwise or not printed), K4 / K5 once a bucket-round, seconds per
     step boundary, peak memory;
     (c) ``launch.service --seeds 2 --rounds 12``: every registered
     scenario as lanes, poisoned and guarded ones included (finite
     histories, the quarantine event), the poisoned and guarded buckets
     again on the torch backend (loss within rtol 1e-4); (d) ``launch.
     service --kill-at 2``: spec-named and raw jobs, a mid-run submit, a
     cancel, deadlines; every surviving handle bit for bit equal to the
     uninterrupted run, snapshot bytes / seconds and the restore's
     seconds;
 15. the rest of the core: (a) ``launch.train`` at full width, n = 8,
     f = 2: alie_opt with NNM + CWTM (3 steps, 13 K1 + 13 K2 a step, the
     eta a step, the peak within phase 7's + 4 D fp32) and foe_opt with
     NNM + GM (2 steps, 13 K1 + 13 K3); step 1's eta search again on the
     kernel and torch backends (damages within 1e-5 of the largest, the
     same eta unless a near-tie); one hier + NNM + CWTM alie_opt step at n = 16
     (13 K6 + 13 K2), its generator then where an alie step leaves it;
     (b) NNM + CWTM with sketch_dim = 512 (2 steps, K2 once a step, no
     K1, the record names the sketch), step 1's stack aggregated with its
     signs on both backends, the sketch fold timed beside K1; (c)
     FedServer under foe_opt at full width (2 rounds, 13 K1 + 13 K2 a
     round) and labelskew_alie_partial with alie_opt (20 rounds: scan ==
     loop bit for bit, torch backend within 1e-4); (d) the breakdown
     sweep at examples/breakdown_frontier.py's defaults (85 lanes, 20
     rounds) on both backends: equal frontiers, losses within 1e-4, K3 /
     K4 / K5 launches asserted, the frontier table printed;
 16. the in-round health taps and the runtime's exporters: (a)
     train_loop at full width (4 of 32 layers), n = 8, f = 2, ALIE, NNM +
     CWTM, 3 steps
     tapped and untapped (params, loss, kappa_hat, direction_norm bit for
     bit, 1 K1 + 1 K2 a step, one metric transfer each, the tap columns'
     semantics, ms/step and peaks), step 1's stack through the kernel
     and torch backends' taps (neighbor_count and mix_mass equal,
     trim_frac within 1e-6, dist / cos within 1e-5), NNM + GM tapped (2
     steps, K1 + K3, no trim taps); (b) FedServer at 12b's width tapped
     against untapped (2 rounds, bitwise) and faulty_nan_quarantine
     tapped (20 rounds, the quarantine taps on the Byzantine mask); (c)
     the grid's cwtm|nnm and gm|nnm buckets, 30 rounds tapped against
     untapped (bitwise, equal K3 / K4 / K5 launches) and against the
     torch backend's taps (1e-4); (d) two tapped lanes through
     FleetService, restored from a mid-run snapshot, bit for bit; (e)
     ``launch.health`` on the card: both exports, the JSONL round trip,
     a monotone Chrome trace, the switch round visible in the taps;
 17. the attention-family zoo at full width (depth and n cut), each
     through build_train_step from seeded weights with ALIE, NNM + CWTM,
     D-SHB on the kernel backend: (a) mixtral-8x22b, 1 layer, n = 8, f =
     2, batch 4 x 128, 3 steps, fsdp_keys from the FULL config
     (fsdp_keys_for: the experts take the mean gradient); (b) qwen2-7b,
     1 layer, n = 4, f = 1, 2 steps (QKV bias, untied 152064 vocab: a
     1.32e9-wide stack); (c) internvl2-2b, 4 layers, n = 8, f = 2, seq
     384 (256 seeded normal patches + 128 text), 2 steps.  Each asserts finite
     loss / kappa_hat / direction_norm, exactly one K1 and one K2 a step
     and no other launch, no recorded fallback, every leaf but the norm
     gains (robust and expert) moved by step 1, and step 1's attacked stack through
     robust_aggregate on the kernel backend against the torch backend
     (leaf-streamed over column chunks of 2^25) within 1e-5 of the
     largest magnitude; prints ms per step, peak memory, D, the expert
     parameter count and the card line;
 18. hierarchical fleet lanes and the lane forms of K2's median, K3, K6
     and K7: (a) at the fleet's kernel shape (B = 8, n = 17, D = 2^24):
     K6 lanes at s = 3 (6 means, the register Gram) and K7 lanes at s = 2
     (9 means, ragged tail; with the Gram, K7 + K5), fp32 and bf16, on
     the fleet's route (each lane's permutation; the kernel builds the
     buckets) and bit for bit the id route (bucket ids), K3
     lanes and K2's median lanes with and without the mix, each against
     its plain version (RTOL; bf16 means one ulp), each lane against the
     single-lane kernel on that lane bit for bit (at 9 means the Gram,
     which K5 folds and the single-lane K6 folds with K1, each within
     RTOL of the plain version), a rerun bit for bit,
     timed beside the bound and torch.bmm(B, X) (K7; in bf16 with the
     weights rounded to bf16), torch.bmm(c, x)
     (K3), torch.median (the median without the mix); inf / NaN rows at a
     ragged D (the NaN spread stays in its lane) and the grid's shapes;
     (b) FleetRunner at the grid's widths, NNM + CWTM / cwmed / GM x 5
     attacks, hierarchical with buckets of 2 and 3, and CWTM x 5 without
     NNM with buckets of 2 (7 buckets of 5 lanes, 10 rounds): launches exact per bucket-round (one K6 lane form, K5
     again at 9 means, one K4, median or K3 lane launch, none per lane),
     each lane within rtol 1e-5 of its 1-lane solo run (GM's
     direction_norm 1e-4), the torch backend within 1e-4; one bucket of 8
     lanes of a quadratic job at D = 2^24 (17 clients, f = 4, hier s = 3,
     NNM + CWTM, 3 rounds): launches, solo runs, two lanes on the torch
     backend, peak memory; (c) four hierarchical lanes through
     FleetService, restored after a mid-run snapshot, bit for bit; (d)
     every kernel the grid and the fed rounds launch, at their shapes,
     each first held to its plain version: K3 lanes at the grid's (5, 17
     / 9, 2842) and at (8, 17, 2^24) against torch.bmm(c[:, None], x),
     K3 and K1 at the fed cohorts (10 / 12 / 17, 2842) against c @ x and
     torch.mm(x, x.T), K5 at the grid's shapes against
     torch.bmm(x, x.mT), K4 (f = 4, with and without the mix), the
     median lanes with and without the mix against torch.median, K6 /
     K7 / K7 + K5 lanes on the fleet's route at (5, 17, 2842), fp32 and
     bf16 (K7 against torch.bmm(bm, x)), and every fleet-route call of
     the median lanes, K4 and K6 / K7 there once under
     torch.cuda.set_sync_debug_mode("error") (none may wait for the
     card); in
     turns, the median of 7 with the min-max of three numbers per call:
     the turn (CUDA events around 200 back-to-back calls: the larger of
     the host's and the device's cost), the host's (its clock around 200
     enqueues queued behind a busy launch) and the device's (CUDA events
     around those 200 launches, run back to back);
 19. the attention-free and encoder-decoder families at their published
     widths, as phase 17 (ALIE, NNM + CWTM, D-SHB, batch 4, seeded
     weights, each step exactly one K1 and one K2 and no fallback, finite
     losses, step 1's attacked stack on the kernel and torch backends
     within 1e-5 of the largest magnitude, ms per step and peak memory):
     (a) rwkv6-3b, 4 of 32 layers, n = 8, f = 2, seq 256 (four chunks of
     64), 3 steps; (b) zamba2-2.7b, 12 of 54 layers (two groups of six,
     the shared block twice), n = 6 (at 8 the torch backend's mix does
     not fit beside the step's stacks), f = 2, seq 256, 2 steps; (c)
     whisper-base at full depth (6 + 6 layers), n = 8, f = 2, 1500 zero
     frames and 128 tokens, 3 steps; (d) gla_chunked against gla_naive
     (plain torch, fp32, within 1e-5 of max |naive|) at rwkv6-3b's (H 40,
     K = V = 64, with u) and zamba2-2.7b's (H 80, K = V = 64, a per-head
     decay) widths, batch 4 x seq 256, each timed;
 20. cached decode and greedy serving (``repro_torch.serving.
     ServeEngine``) at published widths from seeded bf16 weights:
     qwen2-7b (batch 8, prompt 256, 64 new) and whisper-base (1500 seeded
     frames through ``prefill_cache``) at full depth; smollm-360m 8 of 32
     layers, minitron-8b 8 of 32, internvl2-2b (text decode) 6 of 24,
     rwkv6-3b 8 of 32, zamba2-2.7b 12 of 54, mixtral-8x22b 2 of 56 and
     arctic-480b 1 of 35; batch 4,
     prompt 64, 32 new (rwkv6 / zamba2 64) unless named.  Each run generates greedily through
     ``launch.serve.clocked_generate`` (prefill ms, ms per decoded token as
     the median step after the first, tokens per second, peak memory, the
     bound per decoded token from ``launch.roofline``, MoE reading the
     experts its batch picked); each step's logits are held to the port's
     forward of the same tokens (SERVE_REL; rwkv6 and zamba2
     SERVE_REL_RECURRENT;
     MoE forward at a capacity factor where no token drops (8, arctic's
     E / k), replaying decode's expert picks
     (a bf16 rounding tips router near-ties; the flips are counted); the
     VLM's as a dense config); no kernel launch and no
     fallback; then in fp32 (TF32 off) smollm-360m and rwkv6-3b at 8 of
     32 layers, zamba2-2.7b at 12 of 54 and mixtral-8x22b at 1 layer,
     within 1e-4 of max |forward|;
 21. the multi-device aggregation backends (``launch.mesh``,
     ``kernels/shard.py``) in worlds of processes that share the card over
     gloo (``world_run``: kept worlds of 2 and of 4 ranks, one alive at a
     time, shared by phases 21-23; (b) runs first; NCCL refuses two ranks
     on one GPU), each case under a time limit that kills its world, any rank's
     failure failing the phase, every rank's fallback log empty: (a)
     "cuda_sharded" at the dense shape (n = 8, f = 2, D = 361,821,120
     fp32) over 2 ranks, each regenerating its column block from a seed
     per chunk (``seeded_block``) and aggregating it through
     ``robust_aggregate_block``: NNM + CWTM, CWTM and NNM + GM against the
     single-device kernel path run first (its outputs on the disk, the
     card freed) — the coordinate rules bit for bit where the NNM matrix
     is equal, NNM + GM within 1e-5, the all-reduced Gram within 1e-5 of
     max |G| (the summation-order bound of tests/test_torch_cuda.py is
     vacuous at this D: D u = 21.6 > 1) — each rank's K1 /
     K2 / K3 launches asserted, its peak below the 11.58 GB of the whole
     stack, each collective timed; then the lane forms at (8, 17, 2^24)
     through ``batched_robust_aggregate`` (K5 + K4, K5 + K3 lanes); (b)
     "cuda_hier" on a 2 x 2 ("workers", "model") mesh at phase 6's scale
     case (n = 10240, s = 16, f = 320, D = 2^20; phase 6's stack is
     ``seeded_block``'s, so each rank regenerates its (5120, 2^19) tile):
     K7 per tile, the partial means all-reduced over "workers", K1 on the
     means, K2; hier + NNM + CWTM held to phase 6's aggregate under its
     near-tie rule, hier + CWTM within 1e-5; (c) the trainer: full-width
     smollm-360m D-SHB, ALIE, through ``train_loop`` with ``worker_axes``
     on 2 ranks, NNM + CWTM on "cuda_sharded" (n = 8, f = 2, 2 of 32
     layers, 2 steps) and hier + NNM + CWTM on 1-D "cuda_hier" (n = 16, f
     = 3, 8 buckets of 2, 2 of 32 layers, 2 steps), each against the
     single-device run from
     the same seeded weights, run first: parameters within 1e-5 of the
     tree's largest magnitude, the loss within 1e-5, both ranks' copies
     equal bit for bit; ms per step and each rank's peak;
 22. the model-parallel mesh (``models.common``'s ``MeshAxes`` and
     padded heads; ranks of a ("data", "model") world sharing the card
     over gloo, each holding its shard of the heads, the ff, the
     vocabulary or the experts, the layers' all-reduces on the model
     axis, D-SHB aggregating each rank's model-shard columns with K1 / K2,
     K6 / K7 on the hierarchical form); every case first on one device
     (the padded model whole under ``mesh_axes_scope``), then over the
     world: (a) full-width smollm-360m at 4 of 32 layers, bf16, heads
     15 -> 16 and kv 5 -> 8, n = 8, f = 2, ALIE, NNM + CWTM, 2 steps on
     (data 2, model 2), the loss within 1e-3 and the parameters within
     5e-3 (the reference's own sharded-vs-single bounds); (b) fp32 at 2
     of 32 layers on (1, 2) and (2, 2), NNM + CWTM and hier + NNM + CWTM
     (s = 2): the loss within 1e-5 relative, the parameters within 1e-5 x
     their largest magnitude, each step's stack Gram within 1e-5 of max
     |G|; (c) mixtral-8x22b at 1 of 56 layers, bf16, the experts split 4
     a rank and under ``fsdp_keys``, n = 4, f = 1 on (1, 2), bounds as
     (a), the ranks' summed peak under 72 GB; (d) (b)'s run through
     ``train_loop`` under ``options.checkpoint`` on (2, 2), killed after
     step 1's snapshot and resumed: every rank's shards and momentum bit
     for bit; (e-j) every other family at its published widths, depth
     cut, in bf16 (one step: the reference's sharded-vs-single contract)
     and in fp32 with the Gram (2 steps), and smollm's sketch route
     (``MODEL_RUNS``).  ms per step on one device and over the world, each
     rank's peak, launches, collectives and model-axis all-reduces a step;
     asserts K1 and K2 on every rank and empty fallback logs.  Then
     cached decode and ``ServeEngine`` on the same worlds
     (``MODEL_DECODE_RUNS``), each case first on one device, seeded
     weights and prompts: (k) qwen2-7b, 4 of 28 layers, bf16, batch 8
     on (2, 2) (kv 4 -> 2 a rank, QKV biases); (l) mixtral-8x22b, 2 of 56,
     the experts 4 a rank and the ring cache, on (1, 2); (m) internvl2-2b,
     6 of 24, text decode, (1, 2); (n) rwkv6-3b, 8 of 32, (2, 2); (o)
     zamba2-2.7b, 12 of 54 (two groups), (1, 2); (p) whisper-base, 2 + 2,
     1500 seeded frames through ``prefill_cache``, (2, 2); batch 4,
     prompt 64, 32 new unless named; (q) the tight set in fp32 (TF32
     off) on (1, 2): smollm-360m (4 layers), mixtral-8x22b (1),
     rwkv6-3b (2), zamba2-2.7b (6), whisper-base (6 + 6), prompt 16, 16
     new.  The world is fed the one device's tokens (teacher-forced: each
     step's logits within SERVE_REL of max |logits|, rwkv6 / zamba2
     SERVE_REL_RECURRENT, (q) 1e-5 and every cache leaf 1e-5 of its
     max), then its own greedy run through ``launch.serve.
     clocked_generate`` must give the one device's tokens until the
     row's first difference, which must lie at a near-tie (the one
     device's top two logits within the case's bound) or after a routing
     flip; MoE routing flips only at router near-ties.  (r)
     the KV cache's sequence split: qwen2-7b at 2 layers, fp32, kv heads
     unsplit, max_seq 16384, batch 2 on (1, 2) ("seq_model") and batch 1
     on (2, 2) ("seq_both"), 8 seeded steps from position 12000 of a
     seeded cache and 4 from position 100 (every rank but the first
     masked), logits and cache within 1e-5 of one device.  Prefill ms
     and ms per decoded token on one device and over the world, the
     bound per token (``launch.roofline``), collectives a token a rank,
     peaks; no kernel launch and empty fallback logs on every rank;
 23. sequence parallelism and expert FSDP on the model mesh
     (``MeshAxes.seq_par``: the residual stream as each rank's sequence
     block, every split sub-block entered by an all-gather and left by a
     reduce-scatter; ``expert_fsdp``: the expert tables over the data
     axis too, all-gathered for each use and their gradients
     reduce-scattered), a (data 2, model 2) world sharing the card over
     gloo, each case first on one device: (a) 22a's smollm-360m (4 of 32
     layers, bf16, n = 8, f = 2, ALIE, NNM + CWTM, 2 steps) with
     ``seq_par``, the loss within 1e-3 and the parameters within 5e-3;
     (b) the same at 2 layers in fp32, 1e-5 of the largest magnitude and
     the stack Gram; (c) mixtral-8x22b at 1 of 56 layers, bf16, under
     ``seq_par`` + ``expert_fsdp`` and ``fsdp_keys``, n = 4, f = 1: a rank
     holds half of ``ff_inner`` of 4 of the 8 experts (0.60 B of the
     layer's 2.42 B expert parameters); one step (the reference's
     sharded-vs-single contract: the step's loss and the parameters
     after it), bounds as (a); (d) ``launch.dryrun`` of (a) and (c) on a
     fake (2, 2) world in a CPU subprocess: its rank-0 collectives (op,
     axis, calls, bytes) a step must equal (a)'s / (c)'s measured ones,
     its FLOPs printed beside the measured step.  Per rank: ms per step,
     peak and collectives a step (beside 22a's without ``seq_par`` when
     phase 22 ran); asserts K1 and K2 on every rank and empty fallback
     logs;
 24. summary: the K1-K7 table (K2 above 64 workers and K1 on the 640
     means on rows of their own, their launches those of phase 6; the
     lane forms of K2's median, K3, K6 and K7 on rows of their own), the
     fed phase's launches, phase 13's to 19's and 21's to 23's launches,
     the kernels JSON line (K1, K2, K4 and K5 launches include phase
     13's; K2-K5 phase 14's; K1-K6 phase 15's; K1-K5 phase 16's; K1 and
     K2 phase 17's and 19's; the lane forms and K4 / K5 phase 18's; K1-K7
     phase 21's and K1 / K2 / K6 / K7 phase 22's and K1 / K2 phase 23's,
     summed over their ranks), the card line, and last the {"ok": true,
     ...} line.

Phase 3 also holds K4 at the dense trainer's shape (n = 8, f = 2 as a
device tensor, with the NNM mix) against its plain version and against K2
at the same f, which it must equal bit for bit (one body).

Cuts for time (the script must end within its 1200 s limit on a slow
chip host too, whose speed varies 1.5-2x between calls: it aims at half
the limit; PERF.md says which comparison each cut gives up): 13a / 13b
at 4 of 32 layers (13b's full-depth snapshot of 13 GB took ~90 s of
disk); phase 9 and 16a / 16b at 4 of 32 (8 before); phase 20's smollm,
minitron, internvl2 and rwkv6 runs at a quarter of their depth, zamba2
at 12 of 54 and mixtral at 2 of 56 (bf16 and fp32); 21c's trainer at 2
and 2 of 32 layers, 2 steps each (32 and 16, then 4 and 2 before); 22a
at 4 of 32, 22h / 22i whisper at 2 + 2 of 6 + 6, 22b / 22j (and so 22d)
at 2 layers (4 before); 22e-22h's bf16 runs one step (2 before; their
fp32 runs 22i keep 2) and 22e at 1 layer; 22k at 4 of 28 layers, 22l at
2 of 56, 22m at 6 of 24, 22n at 8 of 32, 22p at 2 + 2 (14, 4, 24, 32,
6 + 6 before); the grid at 30 rounds (100, then 50 before), 14a at 18
(30 before), 18b at 10 (20 before).  22f and 22o keep 12 layers: two
shared-block groups, so the shared block's gradient is summed over
groups on the model mesh and decode keeps a cache per group.  The
worlds of phases 21-23 start three times, not seven (``world_run``).

It needs one CUDA card and imports nothing of JAX or of the reference
package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN, F_MAIN = 8, 2
D_MAIN = 361_821_120            # smollm-360m parameter count (tied, padded vocab)
N_SENT, F_SENT, D_SENT = 17, 8, (1 << 24) + 3
N_HIER, F_HIER = 16, 3          # hierarchical runs: s = 2, 8 buckets, f' = 3
HIER_TRAIN_LAYERS = 4           # phase 9's depth, cut for time (of 32; 8 before)
SCALE_NS = (256, 1024, 4096, 10240)   # the reference's scale cases, s = 16
HIER_N, HIER_S = 10240, 16      # the scale case of the hierarchical variant
HIER_D = 1 << 20                # ... at a real width: a 42.9 GB fp32 stack
HIER_D_PARITY = 1 << 19         # widest D where the torch backend's gather fits
HIER_TIE_ROWS = 20              # most NNM near-tie rows allowed there (of 640)
#: K2 on the wide heights of its n <= 64 body (48- and 64-high instances).
K2_WIDE_NS, K2_WIDE_D = (33, 48, 64), 1 << 24
#: K2 above 64 workers: (n, D); n = 640 is the scale case's bucket count.
K2_LARGE = ((65, (1 << 20) + 3), (256, 1 << 20), (640, 1 << 20),
            (1024, 1 << 20), (10240, 64))
PLAIN_CHUNK = 1 << 25           # plain mixtrim runs in D-chunks (sort indices)
PLAIN_ELEMS = 1 << 28           # ... of at most this many elements above n = 64
#: K1's sweep over worker counts at D = 2^20 (phase 3).
GRAM_SWEEP = (17, 40, 64, 256, 640, 1024)
GRAM_SWEEP_D = 1 << 20
#: The fleet's lane-batched kernel shapes: (B, n, D).
FLEET_BIG = (8, 17, 1 << 24)
FLEET_BENCH = (8, 16, 8192)     # the reference bench's gram_batched shape
FLEET_WIDE = (2, 640, 1 << 20)  # K5 above 32 workers: the tiled product
FLEET_GRID = (5, 17, 2842)      # a grid bucket: 5 lanes, the 48-48-10 MLP
FLEET_GRID_BKT = (5, 9, 2842)   # a bucketing bucket: 17 workers, 9 means (s = 2)
F_GRID = 4                      # the grid's f (n = 17)
GRID_ROUNDS = 30                # phase 11's rounds (100, then 50 before), cut for time
REPS = 7
RTOL = 1e-5                     # of the largest finite |plain| (fp32 contract)
FP32_TFLOPS = 67e12             # H100 SXM fp32 outside the tensor cores

#: Memory rate by card name (NVIDIA data sheets); the SXM part otherwise.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}


def log(*a):
    print(*a, flush=True)


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    return 3.35e12


def time_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _chunks(got, want, step: int = 1 << 26):
    got, want = got.reshape(-1), want.reshape(-1)
    for c in range(0, want.numel(), step):
        yield got[c:c + step].float(), want[c:c + step].float()


def max_err(got, want, ulp: bool = False) -> tuple[float, float]:
    """(max |got - want| over finite entries, tolerance), in chunks so
    that (n_b, D) outputs need no full-size temporaries; NaN / inf
    positions must agree exactly.  The tolerance is 1e-5 of the largest
    finite |want|; with ``ulp`` each entry may also differ by one bf16
    ulp (2^-7 of its value), and the returned error is the worst excess
    over that per-entry allowance (0 when every entry is within it)."""
    import torch
    scale, any_fin = 0.0, False
    for g, w in _chunks(got, want):
        nan_w = torch.isnan(w)
        if not torch.equal(torch.isnan(g), nan_w):
            raise AssertionError("NaN positions differ")
        fin = torch.isfinite(w)
        inf = ~fin & ~nan_w
        if not torch.equal(g[inf], w[inf]):
            raise AssertionError("infinities differ")
        if bool(fin.any()):
            any_fin = True
            scale = max(scale, float(torch.where(fin, w.abs(), 0).max()))
    if not any_fin:
        return 0.0, 0.0
    err = 0.0
    for g, w in _chunks(got, want):
        fin = torch.isfinite(w)
        d = (g - w).abs()
        if ulp:
            d = d - 2.0 ** -7 * w.abs()
        err = max(err, float(torch.where(fin, d, 0).max()))
    return max(err, 0.0), RTOL * scale


def bound(bytes_moved: float, flops: float, rate: float) -> tuple[float, str]:
    tb, to = 1e3 * bytes_moved / rate, 1e3 * flops / FP32_TFLOPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(name, got, want, ms, plain_ms, bnd, library_ms=None):
    err, tol = max_err(got, want)
    ok = err <= tol
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} {'OK' if ok else 'FAIL'}"
        f" | kernel {ms:.3f} ms, bound {bnd[0]:.4g} ms ({bnd[1]}), plain "
        f"{plain_ms:.3f} ms, library "
        f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def agree(name, got, want) -> None:
    """A correctness-only comparison (no timing)."""
    err, tol = max_err(got, want)
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} "
        f"{'OK' if err <= tol else 'FAIL'}")
    if err > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")


def check_ulp(name, got, want, ms, plain_ms, bnd, library_ms=None):
    """bf16 means: rounded from fp32 sums taken in another order, so an
    entry at a rounding boundary may land one bf16 step away; each entry
    is held to one bf16 ulp (2^-7 of its value) on top of the fp32
    tolerance."""
    err, tol = max_err(got, want, ulp=True)
    ok = err <= tol
    log(f"  {name}: excess over one bf16 ulp={err:.3e} tol={tol:.3e} "
        f"{'OK' if ok else 'FAIL'} | kernel {ms:.3f} ms, bound {bnd[0]:.3f} ms "
        f"({bnd[1]}), plain {plain_ms:.3f} ms, library "
        f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def chunked(fn, d: int, n: int = 0):
    """The plain mixtrim over D-chunks, concatenated."""
    import torch
    step = PLAIN_CHUNK if n <= 64 else max(1, PLAIN_ELEMS // n)
    return lambda: torch.cat([fn(slice(c, min(c + step, d)))
                              for c in range(0, d, step)])


#: Times of the previous designs on an H100 80GB HBM3 at 700 W (PERF.md's
#: kernel table), printed beside this run's: at (8, 17,
#: 2^24) K4 on K2's bitonic body with f on the device, with / without the
#: mix, and K5 as K1's tile-pair kernels with a lane axis; K2 at the dense
#: shape (trim, the NNM mix, f = 2) on its bitonic body; K2 above 64
#: workers (trim, f = n / 32, D = 2^20) on mixtrim_big's shared-memory sort;
#: K1 on the 640 means of phase 6 (D = 2^20) on its 8-row tile pairs.
PREV_MS = {"K4 mix": 19.512, "K4 no-mix": 10.458, "K5": 9.858,
           "K2 dense mix fp32": 6.233, "K2 dense mix bf16": 6.303,
           "K2 n=256 mix": 29.861, "K2 n=256 no-mix": 5.119,
           "K2 n=640 mix": 116.665, "K2 n=640 no-mix": 27.265,
           "K2 n=1024 mix": 258.404, "K2 n=1024 no-mix": 28.289,
           "K1 n=640": 40.639}
_PTXAS_KERNELS = {
    # The n <= 64 body K2 and K4 share ("K4" below) and K5's staged body:
    # (dtype, height, flag).
    "K4": re.compile(r"mixtrim_dyn_smallI(f|13__nv_bfloat16)Li(\d+)ELb([01])E"),
    "K5": re.compile(r"gram_stagedI(f|13__nv_bfloat16)Li(\d+)ELb([01])E"),
    # K2 / K4 for 64 < n <= 1024: the mix kernel by its padded rows
    # (thread-rows x rows a thread), and the no-mix kernel (height 0).
    "K2sel": re.compile(r"mix_selectI(f|13__nv_bfloat16)NS_3CfgILi(\d+)ELi(\d+)"
                        r"ELi(\d+)E"),
    "K2sel-nomix": re.compile(r"select_nomixI(f|13__nv_bfloat16)E"),
    # K1 / K5 above 32 workers: the tiled product by its tile height.
    "K1": re.compile(r"gram_tiledI(f|13__nv_bfloat16)Li(\d+)ELb([01])E"),
}


def ptxas_report(log: str) -> dict:
    """{(kernel, dtype, height, flag): (registers, stack, spill stores,
    spill loads)} of K4's, K5's, K2's n <= 1024 and K1's tiled instances
    from ``nvcc -Xptxas -v`` output (flag: K4 and K2 the mix, K5 and K1
    cp.async staging; height: K4 the compiled n, K5 row blocks of 4, K2 the
    padded rows, K1 the tile height TM)."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = None
            for k, pat in _PTXAS_KERNELS.items():
                g = pat.search(m.group(1))
                if g:
                    dt = "fp32" if g.group(1) == "f" else "bf16"
                    if k == "K2sel":      # threads, thread-rows, rows a thread
                        key = ("K2", dt, int(g.group(3)) * int(g.group(4)), True)
                    elif k == "K2sel-nomix":
                        key = ("K2", dt, 0, False)
                    else:
                        key = (k, dt, int(g.group(2)), g.group(3) == "1")
                    out[key] = [0, 0, 0, 0]
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[key][1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def phase_kernels(dev, rate: float) -> dict:
    import torch
    from repro_torch.core import gram as gramlib
    from repro_torch.kernels import (combine, combine_ref, gram, gram_ref,
                                     mixtrim, mixtrim_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}

    def stack(n, d, dtype=torch.float32):
        return torch.randn((n, d), generator=gen, device=dev).to(dtype)

    for n, f, d in ((N_MAIN, F_MAIN, D_MAIN), (N_SENT, F_SENT, D_SENT)):
        main = d == D_MAIN
        log(f"-- n={n} f={f} D={d} ({'main path shape' if main else 'sentinel case'})")
        x = stack(n, d)
        g = gram(x)
        gp = gram_ref(x)
        bnd = bound(4.0 * n * d + 4 * n * n, n * (n + 1) * d, rate)
        lib = time_ms(lambda: torch.mm(x, x.T)) if main else None
        ms, pms = time_ms(lambda: gram(x)), time_ms(lambda: gram_ref(x))
        err = check("K1 gram fp32", g, gp, ms, pms, bnd, lib)
        if main:
            rows["gram"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                bound=bnd, library_ms=lib)
            # Which fp32 sum is accurate at this D: against fp64.
            g64 = sum((xc := x[:, s:s + PLAIN_CHUNK].double()) @ xc.T
                      for s in range(0, d, PLAIN_CHUNK))
            scale = float(g64.abs().max())
            for what, val in (("kernel", g), ("plain (chunked)", gp),
                              ("one torch.mm", torch.mm(x, x.T))):
                log(f"    K1 {what} vs fp64: "
                    f"{float((val.double() - g64).abs().max()) / scale:.2e} of max|G|")
        # The main path's operands: the NNM matrix and the GM coefficients.
        m = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(gp), f)
        c = (gramlib.gm_coeff(gramlib.mixed_gram(gp, m), f) @ m).contiguous()
        for mode in ("trim", "med"):
            for mm in (m, None):
                k = 0 if mode == "med" else f
                out = mixtrim(x, mm, k, mode)
                plain = chunked(lambda s: mixtrim_ref(x[:, s], mm, k, mode), d)
                flops = (2 * n * n * d if mm is not None else 0) + n * d
                bnd = bound(4.0 * n * d + 4 * d + (4 * n * n if mm is not None else 0),
                            flops, rate)
                ms, pms = time_ms(lambda: mixtrim(x, mm, k, mode)), time_ms(plain)
                name = f"K2 mixtrim {mode} {'mix' if mm is not None else 'no-mix'} fp32"
                err = check(name, out, plain(), ms, pms, bnd)
                if main and mode == "trim" and mm is not None:
                    rows["mixtrim"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                           bound=bnd, library_ms=None)
                    beside_previous("K2 dense mix fp32", ms, bnd, (n, d))
        if main:
            phase_k4_dense(x, m, f, d, rate)
        del out
        for dtype in (torch.float32, torch.bfloat16):
            xx = x if dtype == torch.float32 else x.to(dtype)
            el = xx.element_size()
            bnd = bound(1.0 * el * n * d + 4 * d + 4 * n, 2 * n * d, rate)
            lib = time_ms(lambda: c.to(dtype) @ xx) if main else None
            ms, pms = time_ms(lambda: combine(xx, c)), time_ms(lambda: combine_ref(xx, c))
            err = check(f"K3 combine {str(dtype)[6:]}", combine(xx, c),
                        combine_ref(xx, c), ms, pms, bnd, lib)
            if main and dtype == torch.float32:
                rows["combine"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       bound=bnd, library_ms=lib)
            if dtype == torch.bfloat16:
                bnd = bound(1.0 * el * n * d + 4 * n * n, n * (n + 1) * d, rate)
                check("K1 gram bf16", gram(xx), gram_ref(xx),
                      time_ms(lambda: gram(xx)), time_ms(lambda: gram_ref(xx)), bnd)
                mb = m.to(dtype)
                plain = chunked(lambda s: mixtrim_ref(xx[:, s], mb, f, "trim"), d)
                bnd = bound(1.0 * el * n * d + 4 * d, 2 * n * n * d, rate)
                ms = time_ms(lambda: mixtrim(xx, mb, f, "trim"))
                check("K2 mixtrim trim mix bf16", mixtrim(xx, mb, f, "trim"), plain(),
                      ms, time_ms(plain), bnd)
                if main:
                    beside_previous("K2 dense mix bf16", ms, bnd, (n, d))
            del xx
        del x, g, gp
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return rows


def phase_k2_wide(dev, rate: float) -> None:
    """K2 on the 48- and 64-high instances of its n <= 64 body (n read at
    run time): trim with a softmax mix, f = n // 4, D = 2^24, fp32 and
    bf16, against the plain version."""
    import torch
    from repro_torch.kernels import mixtrim, mixtrim_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    d = K2_WIDE_D
    for n in K2_WIDE_NS:
        f = n // 4
        x32 = torch.randn((n, d), generator=gen, device=dev)
        m = torch.softmax(torch.randn((n, n), generator=gen, device=dev), -1)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            mm = m.to(dtype)
            plain = chunked(lambda s: mixtrim_ref(x[:, s], mm, f), d)
            bnd = bound(1.0 * x.element_size() * n * d + 4 * d + 4 * n * n,
                        2.0 * n * n * d + n * d, rate)
            check(f"K2 mixtrim trim mix {str(dtype)[6:]} n={n} D={d} f={f}",
                  mixtrim(x, mm, f), plain(), time_ms(lambda: mixtrim(x, mm, f)),
                  time_ms(plain), bnd)
            del x
        del x32, m
        torch.cuda.empty_cache()


def phase_gram_sweep(dev, rate: float) -> None:
    """K1 at n in GRAM_SWEEP, D = 2^20, fp32: the route the wrapper takes
    against its plain version and torch.mm(x, x.T); above 32 workers also
    the tiled product at each tile height (32, 64, 128), each held to the
    plain version, so the wrapper's choice is seen beside the others."""
    import torch
    from repro_torch.kernels import gram, gram_ref
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram.ops import _launch_tiled
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    d = GRAM_SWEEP_D
    for n in GRAM_SWEEP:
        x = torch.randn((n, d), generator=gen, device=dev)
        want = gram_ref(x)
        bnd = bound(4.0 * n * d + 4 * n * n, n * (n + 1) * d, rate)
        lib = time_ms(lambda: torch.mm(x, x.T))
        check(f"K1 gram fp32 n={n} D={d}", gram(x), want,
              time_ms(lambda: gram(x)), time_ms(lambda: gram_ref(x)), bnd, lib)
        if n > _build.library().repro_gram_staged_max_n():
            pick = _build.library().repro_gram_tiled_tm(n)
            alt = []
            for tm in (32, 64, 128):
                run = lambda: _launch_tiled(x[None], 1, n, d, tm)[0]
                err, tol = max_err(run(), want)
                if err > tol:
                    raise AssertionError(f"K1 tiled TM={tm} n={n}: {err} > {tol}")
                alt.append(f"TM={tm}{' (picked)' if tm == pick else ''} "
                           f"{time_ms(run):.3f} ms")
            log(f"    tile heights at n={n}: " + ", ".join(alt))
        del x, want
        torch.cuda.empty_cache()


def phase_k4_dense(x, m, f: int, d: int, rate: float) -> None:
    """K4 at the dense trainer's shape: f as a device tensor, the NNM mix;
    against its plain version and against K2 at the same f, bit for bit:
    one body, the same sort and the same sum over ranks [f, n - f) on
    finite data, the mask's zeros adding exact zeros."""
    import torch
    from repro_torch.kernels import mixtrim, mixtrim_dyn, mixtrim_dyn_ref
    n = x.shape[0]
    ft = torch.tensor(f, dtype=torch.int32, device=x.device)
    out = mixtrim_dyn(x, m, ft)
    plain = chunked(lambda s: mixtrim_dyn_ref(x[:, s], m, ft), d)
    bnd = bound(4.0 * n * d + 4 * d + 4 * n * n, 2 * n * n * d + n * d, rate)
    ms, pms = time_ms(lambda: mixtrim_dyn(x, m, ft)), time_ms(plain)
    check("K4 mixtrim_dyn trim mix fp32, f=2 on the device", out, plain(), ms,
          pms, bnd)
    k2 = mixtrim(x, m, f, "trim")
    same = torch.equal(out, k2)
    log(f"  K4 vs K2 at f={f}: {'equal bit for bit OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("K4 differs from K2 at equal f")
    del out, k2


def lanes_chunked(fn, d: int, step: int = 1 << 22):
    """A lane-batched plain version over column chunks, concatenated."""
    import torch
    return lambda: torch.cat([fn(slice(c, min(c + step, d)))
                              for c in range(0, d, step)], dim=1)


def phase_fleet_kernels(dev, rate: float) -> dict:
    """K5 and K4 on (B, n, D) lane-batched stacks."""
    import torch
    from repro_torch.core.bucketing import adjusted_f_dyn
    from repro_torch.kernels import (gram, gram_batched, gram_batched_ref,
                                     mixtrim_dyn, mixtrim_dyn_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    rows = {}
    for b, n, d in (FLEET_BIG, FLEET_BENCH, FLEET_WIDE, FLEET_GRID, FLEET_GRID_BKT):
        big = (b, n, d) == FLEET_BIG
        log(f"-- K5 gram_batched B={b} n={n} D={d}")
        x = torch.randn((b, n, d), generator=gen, device=dev)
        g = gram_batched(x)
        want = gram_batched_ref(x)
        bnd = bound(4.0 * b * n * d + 4 * b * n * n, b * n * (n + 1) * d, rate)
        ms = time_ms(lambda: gram_batched(x))
        pms = time_ms(lambda: gram_batched_ref(x))
        lib = time_ms(lambda: torch.bmm(x, x.mT))
        err = check("K5 gram_batched fp32", g, want, ms, pms, bnd, lib)
        for k in range(b):      # each lane to its own scale, not the batch's
            agree(f"K5 lane {k} vs plain", g[k], want[k])
        if not torch.equal(g, gram_batched(x)):
            raise AssertionError("K5 is not bitwise repeatable")
        log("  K5: bitwise equal over two runs")
        if big:
            rows["gram_batched"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                        bound=bnd, library_ms=lib)
            beside_previous("K5", ms, bnd)
        if (b, n, d) == FLEET_WIDE:
            for k in range(b):
                agree(f"K5 lane {k} vs K1 on that lane", g[k], gram(x[k]))
        if (b, n, d) in (FLEET_BENCH, FLEET_WIDE):
            del x, g, want
            torch.cuda.empty_cache()
            continue
        if d == FLEET_GRID[2]:
            # The grid's own f, capped per lane as the bucketing lanes cap it.
            fs = adjusted_f_dyn(torch.full((b,), F_GRID, device=dev), n)
        else:
            fs = torch.arange(b, dtype=torch.int32, device=dev) % (n // 2 + 2)
        m = torch.softmax(torch.randn((b, n, n), generator=gen, device=dev), -1)
        for mm in (m, None):
            tag = "mix" if mm is not None else "no-mix"
            log(f"-- K4 mixtrim_dyn B={b} n={n} D={d} {tag}, f={fs.tolist()}")
            plain = lanes_chunked(
                lambda s: mixtrim_dyn_ref(x[:, :, s].contiguous(), mm, fs), d)
            flops = (2.0 * b * n * n * d if mm is not None else 0) + b * n * d
            bnd = bound(4.0 * b * n * d + 4 * b * d
                        + (4 * b * n * n if mm is not None else 0), flops, rate)
            ms, pms = time_ms(lambda: mixtrim_dyn(x, mm, fs)), time_ms(plain)
            err = check(f"K4 mixtrim_dyn trim {tag} fp32",
                        mixtrim_dyn(x, mm, fs), plain(), ms, pms, bnd)
            if big and mm is not None:
                rows["mixtrim_dyn"] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=pms, bound=bnd,
                                           library_ms=None)
            if big:
                beside_previous(f"K4 {tag}", ms, bnd)
            agree(f"K4 mixtrim_dyn med {tag}", mixtrim_dyn(x, mm, fs, "med"),
                  plain_med(x, mm, fs, d))
        if big:
            # An inf row and a NaN row: the rank mask keeps inf * 0 = NaN.
            xs = x[:, :, :(1 << 20) + 3].clone()
            xs[1, n - 1, 100:5000] = float("inf")
            xs[2, 3, 2000:9000] = float("nan")
            xs[3, 0, 7:11] = -float("inf")
            for mm in (m, None):
                got = mixtrim_dyn(xs, mm, fs)
                want = mixtrim_dyn_ref(xs, mm, fs)
                agree(f"K4 inf / nan rows {'mix' if mm is not None else 'no-mix'} "
                      f"({int(torch.isnan(want).sum())} NaN outputs)", got, want)
            del xs
        del x, g, want
        torch.cuda.empty_cache()
    return rows


def beside_previous(what: str, ms: float, bnd, shape=FLEET_BIG) -> None:
    log(f"  {what} at {shape}: {ms:.3f} ms, previous design "
        f"{PREV_MS[what]:.3f} ms, "
        f"bound {bnd[0]:.3f} ms ({bnd[1]}): {100 * bnd[0] / ms:.0f} % of "
        f"bound, {PREV_MS[what] / ms:.2f}x the previous design")


def phase_ptxas() -> None:
    """ptxas's registers, stack frame and spills for the n <= 64 body K2
    and K4 share (one set of instances, "K2/K4"), K5's staged body, K2's
    64 < n <= 1024 body and K1's tiled product; the shared body's fp32
    instances up to n = 32, K2's fp32 mix instance for n = 640 and K1's
    fp32 cp.async instance for n = 640 (TM = 128) must keep no stack frame
    and no spill."""
    from repro_torch.kernels import _build
    rep = ptxas_report(_build.BUILD_LOG)
    if not rep:
        raise AssertionError("no ptxas report of K4 / K5 in the build log")
    for kern, flag in (("K4", "mix"), ("K5", "cp.async"), ("K2", "mix"),
                       ("K1", "cp.async")):
        for dt in ("fp32", "bf16"):
            for on in (True, False):
                row = [(h, v) for (k, d, h, f), v in sorted(rep.items())
                       if k == kern and d == dt and f == on]
                label = "K2/K4" if kern == "K4" else kern
                log(f"  ptxas {label} {dt} {'' if on else 'no '}{flag} "
                    "(height: registers/stack/spill stores/spill loads): "
                    + ", ".join(f"{h}: {'/'.join(map(str, v))}" for h, v in row))
    bad = {k: v for k, v in rep.items()
           if k[0] == "K4" and k[1] == "fp32" and k[2] <= 32 and any(v[1:])}
    if bad:
        raise AssertionError(f"K2/K4 fp32 n <= 32 instances with a stack "
                             f"frame or spills: {bad}")
    log("  K2/K4 fp32 n <= 32: no stack frame, no spill OK")
    k2 = rep.get(("K2", "fp32", 640, True))
    if k2 is None or any(k2[1:]):
        raise AssertionError(f"K2's fp32 mix instance for n = 640: {k2} "
                             "(registers/stack/spill stores/spill loads)")
    log(f"  K2 fp32 mix, 640 rows: {k2[0]} registers, no stack frame, no "
        "spill OK")
    tm = _build.library().repro_gram_tiled_tm(640)
    k1 = rep.get(("K1", "fp32", tm, True))
    if k1 is None or any(k1[1:]):
        raise AssertionError(f"K1's fp32 tiled instance for n = 640 (TM = {tm}): "
                             f"{k1} (registers/stack/spill stores/spill loads)")
    log(f"  K1 fp32 tiled, n = 640 (TM = {tm}): {k1[0]} registers, no stack "
        "frame, no spill OK")


def zero_one(n: int, dev):
    """The (n, 2^n) stack holding every 0-1 column once."""
    import torch
    cols = torch.arange(1 << n, device=dev)
    return ((cols[None, :] >> torch.arange(n, device=dev)[:, None]) & 1).float()


def phase_sort_01(dev, n: int = FLEET_BIG[1]) -> None:
    """The 0-1 principle: on a stack holding every 0-1 column, K4's trim at
    every f and its median (n = 17), and K2's trim (its slice of ranks
    [f, n - f)) at every f and its median (n = 8 and 17), equal their
    plain versions exactly.  K2's plain version runs on the CPU, whose
    mean divides the exact sum once, as the kernel does."""
    import torch
    from repro_torch.kernels import mixtrim, mixtrim_dyn, mixtrim_dyn_ref, mixtrim_ref
    for k in (N_MAIN, n):
        x = zero_one(k, dev).contiguous()
        xc = x.cpu()
        for f in range((k - 1) // 2 + 1):
            if not torch.equal(mixtrim(x, None, f, "trim").cpu(),
                               mixtrim_ref(xc, None, f, "trim")):
                raise AssertionError(f"K2 0-1 check: trim at n={k}, f={f} differs")
        if not torch.equal(mixtrim(x, None, 0, "med").cpu(),
                           mixtrim_ref(xc, None, 0, "med")):
            raise AssertionError(f"K2 0-1 check: median at n={k} differs")
        log(f"  K2 sort on all {1 << k} 0-1 columns at n={k}, f=0..{(k - 1) // 2}, "
            "trim (the slice) and median: equal to the plain version OK")
    x = zero_one(n, dev)[None].contiguous()
    for f in range(n // 2 + 2):
        ft = torch.tensor([f], dtype=torch.int32, device=dev)
        for mode in ("trim", "med"):
            if not torch.equal(mixtrim_dyn(x, None, ft, mode),
                               mixtrim_dyn_ref(x, None, ft, mode)):
                raise AssertionError(f"K4 0-1 check: {mode} at f={f} differs")
    log(f"  K4 sort on all {1 << n} 0-1 columns at n={n}, f=0..{n // 2 + 1}, "
        "trim and median: equal to the plain version OK")


def plain_med(x, m, fs, d: int):
    from repro_torch.kernels import mixtrim_dyn_ref
    return lanes_chunked(
        lambda s: mixtrim_dyn_ref(x[:, :, s].contiguous(), m, fs, "med"), d)()


def phase_grid(dev, rounds: int) -> dict:
    """The fleet grid through its entry point; returns the launch counts."""
    import torch
    from repro_torch.fleet import FleetRunner
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import grid
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = grid.main(["--full", "--device", dev.type, "--rounds", str(rounds)])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = kdispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    fallbacks = kdispatch.fallback_log()
    runner = out["runner"]
    log(f"  grid: {len(out['results'])} jobs, {runner.n_buckets} buckets, "
        f"{rounds} rounds, {wall:.1f} s, launches {counts}, "
        f"peak {peak / 2**30:.3f} GiB")
    if fallbacks:
        raise AssertionError(f"grid dispatch fell back: {fallbacks[:3]}")
    for k in ("gram_batched", "mixtrim_dyn", "mixtrim_lanes",
              "combine_lanes"):
        if counts[k] == 0:
            raise AssertionError(f"grid: kernel {k} was never launched")
    if counts["mixtrim"] or counts["combine"]:
        raise AssertionError(f"grid: a kernel launched once a lane: {counts}")
    if runner.n_buckets != 13 or len(out["results"]) != 61:
        raise AssertionError("grid: expected 61 jobs in 13 buckets")
    for r in out["results"]:
        h = r.history
        if h.rounds != rounds or not all(math.isfinite(v) for v in
                                         h.direction_norm):
            raise AssertionError(f"{r.label}: bad history")
    base = out["table"]["baseline"]
    if not base > 0.8:
        raise AssertionError(f"baseline accuracy {base} <= 0.8")
    per = {}
    for bi, lanes, nr, sec in runner.segment_log:
        per.setdefault(bi, []).append(1e3 * sec / nr)
    meds = {bi: statistics.median(v) for bi, v in per.items()}
    labels = {bi: b.jobs[0].label.rsplit("|", 1)[0] if len(b.jobs) > 1
              else b.jobs[0].label for bi, b in enumerate(runner.buckets)}
    log("  ms per bucket-round (median over segments): " + ", ".join(
        f"{labels[bi]} {ms:.2f}" for bi, ms in meds.items()))
    log(f"  median over buckets: {statistics.median(meds.values()):.3f} ms "
        f"per bucket-round")
    # The cwtm | nnm and cwtm | bucketing buckets again, torch backend, on
    # the card.  Bucketing permutations come from the host plan (a per-lane
    # generator seeded with the job's seed), so both runs see the same ones.
    rerun = ("cwtm|nnm|", "cwtm|bucketing|")
    jobs = [j for j in grid.build_jobs(full=True, alpha=0.1, steps=rounds,
                                       backend="torch")
            if j.label.startswith(rerun)]
    before = kdispatch.launch_counts()
    again = FleetRunner(jobs, device=dev).run()
    if kdispatch.launch_counts() != before:
        raise AssertionError("the torch backend launched a kernel")
    kern = {r.label: r for r in out["results"]}
    for pre in rerun:
        worst = 0.0
        for r in (r for r in again if r.label.startswith(pre)):
            a = [float(v) for v in kern[r.label].history.loss]
            b = [float(v) for v in r.history.loss]
            if len(a) != rounds or len(b) != rounds:
                raise AssertionError(f"{r.label}: missing rounds")
            for x, y in zip(a, b):
                rel = abs(x - y) / max(abs(y), 1e-30)
                worst = max(worst, rel)
                if abs(x - y) > 1e-4 * abs(y):
                    raise AssertionError(
                        f"{r.label}: cuda vs torch loss {x} vs {y}")
        log(f"  {pre[:-1]} bucket, cuda vs torch backend: per-round loss max "
            f"rel diff {worst:.3e} (tol 1e-4) OK")
    return counts


def run_train(agg: str, steps: int, capture: bool, n: int = N_MAIN,
              f: int = F_MAIN, attack: str = "alie", extra: tuple = (),
              allow: tuple = ()):
    """``launch.train.main`` at full width; fails on a non-finite metric
    or on any recorded fallback but those named in ``allow`` (the sketch
    Gram's torch decision, ``"sketch_gram"``)."""
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import train
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    out = train.main(["--arch", "smollm-360m", "--full", "--steps", str(steps),
                      "--workers", str(n), "--byz", str(f),
                      "--attack", attack, "--agg", agg, "--device", "cuda",
                      *extra], capture_first_stack=capture)
    counts = kdispatch.launch_counts()
    hist = out["history"]
    for k in ("loss", "kappa_hat", "direction_norm"):
        if not all(math.isfinite(v) for v in hist[k]):
            raise AssertionError(f"{agg}: non-finite {k}: {hist[k]}")
    rec = out["dispatch"]
    bad = [d for d in kdispatch.fallback_log() if d.primitive not in allow]
    if rec is None or rec.backend != "cuda" or bad:
        raise AssertionError(f"{agg}: dispatch did not stay on the kernels:\n"
                             f"{rec.describe() if rec else None}")
    eta = f", eta {hist['eta']}" if hist["eta"] else ""
    log(f"  {agg} {attack}: ms/step {[round(v, 1) for v in hist['ms']]}{eta}, "
        f"launches {counts}, peak {out['peak_bytes'] / 2**30:.2f} GiB")
    return out, counts


def phase_backends(out) -> None:
    """Step 1's attacked stack: kernel backend against the torch backend."""
    import torch
    from repro_torch.core.robust import robust_aggregate
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.tree import tree_leaves
    stack = kdispatch.stack_views(out["attacked"], out["layout"])
    got, want = (robust_aggregate(stack, AggregatorSpec(rule="cwtm", f=F_MAIN,
                                                        pre="nnm", backend=b))
                 for b in ("cuda", "torch"))
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        err, tol = max_err(a.reshape(-1), b.reshape(-1))
        if err > tol:
            raise AssertionError(f"backends disagree: {err} > {tol}")
        worst = max(worst, err)
    log(f"  robust_aggregate cuda vs torch on step 1's attacked stack: "
        f"max_abs_err={worst:.3e} (tol {RTOL} x max|leaf|) OK")
    del got, want, stack
    torch.cuda.empty_cache()


def bucket_plan(n: int, s: int, dev, seed: int):
    """A bucket assignment of n workers into ceil(n/s) buckets from a
    seeded permutation, and its dense matrix B."""
    import torch
    from repro_torch.core import bucketing
    gen = torch.Generator().manual_seed(seed)
    assign = bucketing.bucket_assignment(n, s, generator=gen, device=dev)
    nb = bucketing.num_buckets(n, s)
    bmat = bucketing.bucket_matrix(n, s, assignment=assign, device=dev)
    return assign, nb, bmat


def bucket_bound(n, nb, d, el, rate, gram: bool):
    """Bytes: X read once, the means written once in X's dtype (and the
    Gram); operations: the sparse means (2 per read element) and the
    Gram's nb(nb+1)/2 multiply-adds per column."""
    flops = 2.0 * n * d + (nb * (nb + 1) * d if gram else 0)
    return bound(1.0 * el * n * d + el * nb * d + (4 * nb * nb if gram else 0),
                 flops, rate)


def phase_bucketgram(dev, rate: float) -> dict:
    import torch
    from repro_torch.kernels import (bucket_means_gram_ref, bucketgram,
                                     bucketmeans)
    rows = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n, s, d = N_HIER, 2, D_MAIN
    assign, nb, bmat = bucket_plan(n, s, dev, seed=0)
    log(f"-- trainer shape: n={n} s={s} n_b={nb} D={d}")
    x = torch.randn((n, d), generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        xx = x if dtype == torch.float32 else x.to(dtype)
        el = xx.element_size()
        tag = str(dtype)[6:]
        y, g = bucketgram(xx, assign, nb)
        py, pg = bucket_means_gram_ref(xx, bmat)
        ms = time_ms(lambda: bucketgram(xx, assign, nb))
        pms = time_ms(lambda: bucket_means_gram_ref(xx, bmat))
        bnd = bucket_bound(n, nb, d, el, rate, gram=True)
        if dtype == torch.float32:
            e_y = check("K6 bucketgram means fp32", y, py, ms, pms, bnd)
        else:
            e_y = check_ulp("K6 bucketgram means bf16", y, py, ms, pms, bnd)
        e_g = check(f"K6 bucketgram Gram {tag}", g, pg, ms, pms, bnd)
        del y, g, py, pg
        r1, r2 = bucketgram(xx, assign, nb), bucketgram(xx, assign, nb)
        if not torch.equal(r1[1], r2[1]):
            raise AssertionError("K6 Gram is not bitwise repeatable")
        del r1, r2
        log(f"  K6 Gram {tag}: bitwise equal over two runs")
        if dtype == torch.float32:
            rows["bucketgram"] = dict(max_abs_err=max(e_y, e_g), ms=ms,
                                      plain_ms=pms, bound=bnd, library_ms=None)
        y = bucketmeans(xx, assign, nb)
        py = bucket_means_gram_ref(xx, bmat, with_gram=False)[0]
        b_x = bmat.to(dtype)
        ms = time_ms(lambda: bucketmeans(xx, assign, nb))
        pms = time_ms(lambda: bucket_means_gram_ref(xx, bmat, with_gram=False))
        lib = time_ms(lambda: torch.mm(b_x, xx))
        bnd = bucket_bound(n, nb, d, el, rate, gram=False)
        if dtype == torch.float32:
            err = check("K7 bucketmeans fp32", y, py, ms, pms, bnd, lib)
            rows["bucketmeans"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       bound=bnd, library_ms=lib)
        else:
            check_ulp("K7 bucketmeans bf16", y, py, ms, pms, bnd, lib)
        del y, py, xx
        torch.cuda.empty_cache()
    # Non-finite rows: the dense contraction's 0 * inf = NaN spreads NaN to
    # every bucket other than the bad row's; the kernels must match it.
    x[3, 1000:2000] = float("inf")
    x[9, 1500:4000] = float("nan")
    x[12, 7:9] = -float("inf")
    y, g = bucketgram(x, assign, nb)
    py, pg = bucket_means_gram_ref(x, bmat)
    nan_cols = int(torch.isnan(py).any(dim=0).sum())
    agree("K6 means, inf / nan rows", y, py)
    agree("K6 Gram, inf / nan rows", g, pg)
    agree("K7 means, inf / nan rows", bucketmeans(x, assign, nb), py)
    log(f"  (NaN in {nan_cols} columns of the plain means, as in the kernels')")
    del x, y, g, py, pg
    torch.cuda.empty_cache()

    for n in SCALE_NS:
        d = min(2048, max(64, (1 << 19) // n))
        assign, nb, bmat = bucket_plan(n, 16, dev, seed=n)
        log(f"-- scale shape: n={n} s=16 n_b={nb} d={d}")
        x = torch.randn((n, d), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xx = x.to(dtype)
            el = xx.element_size()
            tag = str(dtype)[6:]
            y, g = bucketgram(xx, assign, nb)
            py, pg = bucket_means_gram_ref(xx, bmat)
            ms = time_ms(lambda: bucketgram(xx, assign, nb))
            pms = time_ms(lambda: bucket_means_gram_ref(xx, bmat))
            bnd = bucket_bound(n, nb, d, el, rate, gram=True)
            (check if dtype == torch.float32 else check_ulp)(
                f"K6 bucketgram means {tag}", y, py, ms, pms, bnd)
            check(f"K6 bucketgram Gram {tag} (K1 on the fp32 means)", g, pg,
                  ms, pms, bnd)
            ms = time_ms(lambda: bucketmeans(xx, assign, nb))
            pms = time_ms(lambda: bucket_means_gram_ref(xx, bmat, with_gram=False))
            (check if dtype == torch.float32 else check_ulp)(
                f"K7 bucketmeans {tag}", bucketmeans(xx, assign, nb), py, ms,
                pms, bucket_bound(n, nb, d, el, rate, gram=False))
    return rows


def phase_mixtrim_large(dev, rate: float) -> None:
    """K2 above 64 workers: the tiled mix and rank selection up to
    n = 1024 (times at n = 256, 640 and 1024 printed beside the previous
    design's), the shared-memory sort above."""
    import torch
    from repro_torch.kernels import mixtrim, mixtrim_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for n, d in K2_LARGE:
        f = (n - 1) // 2 if n == 65 else n // 32
        x = torch.randn((n, d), generator=gen, device=dev)
        m = torch.softmax(torch.randn((n, n), generator=gen, device=dev), -1)
        log(f"-- K2 n={n} f={f} D={d}")
        for mode in ("trim", "med"):
            for mm in (m, None):
                k = 0 if mode == "med" else f
                plain = chunked(lambda s: mixtrim_ref(x[:, s], mm, k, mode), d, n)
                flops = (2.0 * n * n * d if mm is not None else 0) + n * d
                bnd = bound(4.0 * n * d + 4 * d + (4 * n * n if mm is not None else 0),
                            flops, rate)
                reps = 3 if mode == "trim" else 1
                ms = time_ms(lambda: mixtrim(x, mm, k, mode), reps)
                pms = time_ms(plain, 1)
                tag = "mix" if mm is not None else "no-mix"
                check(f"K2 mixtrim {mode} {tag} n={n}", mixtrim(x, mm, k, mode),
                      plain(), ms, pms, bnd)
                if mode == "trim" and f"K2 n={n} {tag}" in PREV_MS:
                    beside_previous(f"K2 n={n} {tag}", ms, bnd, (n, d))
        # NaN and inf rows (the nan / inf attacks): ranked last, trimmed.
        xs = x[:, :min(d, 4099)].clone()
        xs[n - 3:] = float("nan")
        xs[n - 6:n - 3] = float("inf")
        xs[0, :7] = -float("inf")
        for mode, k in (("trim", max(f, 6)), ("med", 0)):
            for mm in (m, None):
                agree(f"K2 mixtrim {mode} {'mix' if mm is not None else 'no-mix'} "
                      f"n={n}, nan / inf rows", mixtrim(xs, mm, k, mode),
                      mixtrim_ref(xs, mm, k, mode))
        del x, xs, m
        torch.cuda.empty_cache()


def _hier_specs(f: int) -> dict:
    """The two hierarchical aggregates of the scale case (s = 16) and the
    launches each makes on the kernel backend at n = 10240 (640 means)."""
    common = dict(rule="cwtm", f=f, hier=True, bucket_size=HIER_S)
    zero = dict(gram=0, mixtrim=0, combine=0, bucketgram=0, bucketmeans=0)
    return {
        "hier+nnm+cwtm": (dict(common, pre="nnm"),
                          dict(zero, bucketgram=1, gram=1, mixtrim=1)),
        "hier+cwtm": (dict(common, pre=None),
                      dict(zero, bucketmeans=1, mixtrim=1)),
    }


def _nnm_near_ties(g_k, g_t, m_k, m_t, keep: int) -> int:
    """The rows where the kernel path's NNM matrix m_k (from its Gram g_k)
    differs from the torch backend's m_t (from g_t); returns their count.
    g_k must agree with g_t within the fp32 contract (RTOL of max|G|), at
    most HIER_TIE_ROWS rows may differ, and each must be a near-tie: with
    e = max|g_k - g_t|, every distance d_ij = G_ii + G_jj - 2 G_ij moves by
    at most 4 e between the Grams, so the kernel's keep nearest, measured
    by g_t's distances, lie within 8 e of g_t's keep-th smallest distance
    b (those it keeps at most b + 8 e, those it drops at least b - 8 e).
    A kernel Gram off by more than rounding picks neighbours outside that
    band or fails the Gram bound."""
    import torch
    from repro_torch.core import gram as gramlib
    e = float((g_k - g_t).abs().max())
    gtol = RTOL * float(g_t.abs().max())
    if e > gtol:
        raise AssertionError(f"kernel path's Gram of the means off by {e} > "
                             f"{gtol} from the torch backend's")
    rows = torch.nonzero((m_k != m_t).any(dim=1)).flatten().tolist()
    if len(rows) > HIER_TIE_ROWS:
        raise AssertionError(f"NNM rows that differ between backends: "
                             f"{len(rows)} > {HIER_TIE_ROWS}")
    d_t = gramlib.pdist_sq_from_gram(g_t)
    for i in rows:
        b = float(torch.sort(d_t[i]).values[keep - 1])
        kept = m_k[i] != 0
        if int(kept.sum()) != keep:
            raise AssertionError(f"NNM row {i} keeps {int(kept.sum())} != {keep}")
        hi, lo = float(d_t[i][kept].max()), float(d_t[i][~kept].min())
        if hi > b + 8 * e or lo < b - 8 * e:
            raise AssertionError(
                f"NNM row {i}: the kernel path's neighbours are no near-tie "
                f"of the torch backend's (kept up to {hi}, dropped from {lo}, "
                f"boundary {b}, band {8 * e})")
    return len(rows)


def _hier_parity(dev, d: int, seed: int, ties: bool) -> None:
    """Both hierarchical aggregates at n = 10240 and width d: the kernel
    backend against the torch backend (the gather form), the same
    permutation, within the fp32 contract.  NNM's choice of neighbours is
    not continuous in the Gram: where two distances of a row are equal to
    within the rounding of fp32 Grams summed in other orders, the backends
    may pick different neighbours.  Without ``ties`` (D = 64) the two NNM
    matrices (each from its own backend's Gram) must be equal.  With
    ``ties`` a few rows may differ, each a near-tie (_nnm_near_ties), and
    then the kernel backend is held to the torch pipeline (gather means,
    mix, sort) run with the kernel path's M."""
    import torch
    from repro_torch.core import bucketing as bucketlib
    from repro_torch.core import gram as gramlib
    from repro_torch.core.robust import (_tree_bucket, _tree_coordinate_rule,
                                         robust_aggregate, tree_gram, tree_mix)
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import bucketgram
    n, f = HIER_N, HIER_N // 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree = {"x": torch.randn((n, d), generator=gen, device=dev)}
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(7))
    for name, (spec, _) in _hier_specs(f).items():
        torch.cuda.reset_peak_memory_stats(dev)
        got = robust_aggregate(tree, AggregatorSpec(backend="cuda", **spec),
                               perm=perm)["x"]
        want = robust_aggregate(tree, AggregatorSpec(backend="torch", **spec),
                                perm=perm)["x"]
        note = ""
        if spec["pre"] == "nnm":
            nb = bucketlib.num_buckets(n, HIER_S)
            fb = bucketlib.adjusted_f(f, nb)
            assign = bucketlib.bucket_assignment(n, HIER_S, perm=perm, device=dev)
            g_k = bucketgram(tree["x"], assign, nb)[1]
            means, _ = _tree_bucket(tree, f, perm.to(dev), HIER_S)
            g_t = tree_gram(means)
            m_k = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g_k), fb)
            m_t = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g_t), fb)
            if ties:
                rows = _nnm_near_ties(g_k, g_t, m_k, m_t, nb - fb)
            else:
                rows = int((m_k != m_t).any(dim=1).sum())
                if rows:
                    raise AssertionError(f"{name} d={d}: NNM rows that differ "
                                         f"between backends: {rows}")
            note = f", NNM rows that differ between backends: {rows}"
            if rows:
                want = _tree_coordinate_rule(tree_mix(means, m_k), "cwtm", fb)["x"]
                note += (" (each a near-tie; held to the torch pipeline with "
                         "the kernel path's M)")
            del means
        err, tol = max_err(got, want)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"  {name} n={n} d={d} f={f}: cuda vs torch backend "
            f"max_abs_err={err:.3e} tol={tol:.3e} "
            f"{'OK' if err <= tol else 'FAIL'}{note} (peak {peak:.2f} GiB)")
        if err > tol:
            raise AssertionError(f"{name}: backends disagree {err} > {tol}")
        del got, want
    del tree
    torch.cuda.empty_cache()


def phase_hier_aggregate(dev, rate: float, ref_dir: str) -> dict:
    """robust_aggregate(hier, s = 16) at the reference's scale case,
    n = 10240 workers (640 bucket means): hier + NNM + CWTM (K6 with K1 on
    the means, then K2 with the mix at n = 640) and hier + CWTM (K7, then
    K2 without the mix).  The kernel backend against the torch backend at
    D = 64 (equal NNM choices) and at HIER_D_PARITY; at D = HIER_D (a
    42.9 GB fp32 stack) each aggregate twice, asserting its launches and
    an empty fallback log, timed by the host clock around a synchronize,
    with its peak memory; then each kernel of the two at the aggregate's
    own inputs, held to its plain version and timed by CUDA events.
    Returns K2's rows (the n = 640 mix and no mix) and K1's on the means,
    and each one's launches in the aggregates.  The D = HIER_D stack is
    ``seeded_block``'s (seed 3), so phase 21b's ranks regenerate their
    tiles of it; its aggregates, the permutation, the Gram of the means
    and the NNM matrix go to ``ref_dir`` for 21b."""
    import torch
    from repro_torch.core import bucketing as bucketlib
    from repro_torch.core import gram as gramlib
    from repro_torch.core.robust import robust_aggregate
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import (bucket_means_gram_ref, bucketgram,
                                     bucketmeans, gram, gram_ref, mixtrim,
                                     mixtrim_ref)
    from repro_torch.kernels import dispatch as kdispatch
    _hier_parity(dev, 64, HIER_N, ties=False)
    _hier_parity(dev, HIER_D_PARITY, 2, ties=True)

    n, d, f = HIER_N, HIER_D, HIER_N // 32
    tree = {"x": seeded_block(3, (0, n), (0, d), dev, HIER_SEED_ROWS)}
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(7))
    _save(ref_dir, "perm", perm)
    log(f"-- n={n} D={d} fp32 stack: {4 * n * d / 1e9:.1f} GB")
    launches, gram_launches = {}, 0
    for name, (spec, expect) in _hier_specs(f).items():
        launches[name] = 0
        for run in range(2):
            kdispatch.reset_launch_counts()
            kdispatch.reset_fallbacks()
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = robust_aggregate(tree, AggregatorSpec(backend="cuda", **spec),
                                   perm=perm)["x"]
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            counts = kdispatch.launch_counts()
            got = {k: counts[k] for k in expect}
            rec = kdispatch.last_dispatch()
            if got != expect or rec.fallbacks or kdispatch.fallback_log():
                raise AssertionError(f"{name}: launches {counts}, expected "
                                     f"{expect}:\n{rec.describe()}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name}: non-finite aggregate")
            if run == 0:
                log(rec.describe())
                _save(ref_dir, name, out)
            launches[name] += counts["mixtrim"]
            if spec["pre"] == "nnm":
                gram_launches += counts["gram"]
            log(f"  {name} run {run}: {ms:.1f} ms (host clock), launches "
                f"{got}, no fallback, peak "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
            del out
    # Each kernel at the aggregates' own inputs, against its plain version.
    x = tree["x"]
    s = bucketlib.clamp_bucket_size(n, HIER_S, f)
    nb = bucketlib.num_buckets(n, s)
    fb = bucketlib.adjusted_f(f, nb)
    assign = bucketlib.bucket_assignment(n, s, perm=perm, device=dev)
    bmat = bucketlib.bucket_matrix(n, s, assignment=assign, device=dev)
    log(f"-- kernels of the aggregates: n={n} -> {nb} means, f'={fb}")
    y, g = bucketgram(x, assign, nb)
    py, pg = bucket_means_gram_ref(x, bmat)
    ms = time_ms(lambda: bucketgram(x, assign, nb), 3)
    pms = time_ms(lambda: bucket_means_gram_ref(x, bmat), 1)
    bnd = bucket_bound(n, nb, d, 4, rate, gram=True)
    check("K6 bucketgram means fp32", y, py, ms, pms, bnd)
    check("K6 bucketgram Gram fp32 (K1 on the fp32 means)", g, pg, ms, pms, bnd)
    del pg
    ym = bucketmeans(x, assign, nb)
    ms = time_ms(lambda: bucketmeans(x, assign, nb), 3)
    pms = time_ms(lambda: bucket_means_gram_ref(x, bmat, with_gram=False), 1)
    lib = time_ms(lambda: torch.mm(bmat, x), 1)
    check("K7 bucketmeans fp32", ym, py, ms, pms,
          bucket_bound(n, nb, d, 4, rate, gram=False), lib)
    del tree, x, ym, py, bmat
    torch.cuda.empty_cache()
    bnd = bound(4.0 * nb * d + 4 * nb * nb, nb * (nb + 1) * d, rate)
    g1 = gram(y)
    ms, pms = time_ms(lambda: gram(y), 3), time_ms(lambda: gram_ref(y), 1)
    lib = time_ms(lambda: torch.mm(y, y.T), 3)
    err = check(f"K1 gram of the {nb} means", g1, gram_ref(y), ms, pms, bnd, lib)
    rows = {"gram_tiled": dict(max_abs_err=err, ms=ms, plain_ms=pms, bound=bnd,
                               library_ms=lib)}
    if not (torch.equal(g1, gram(y)) and torch.equal(g1, g1.T)):
        raise AssertionError("K1 on the means is not bitwise repeatable and "
                             "exactly symmetric")
    log("  K1 on the means: bitwise equal over two runs, exactly symmetric")
    beside_previous(f"K1 n={nb}", ms, bnd, (nb, d))
    if not ms < lib:
        raise AssertionError(f"K1 on the {nb} means ({ms:.3f} ms) is slower "
                             f"than torch.mm(y, y.T) ({lib:.3f} ms)")
    log(f"  K1 on the means: {lib / ms:.2f}x faster than torch.mm(y, y.T) OK")
    del g1
    m = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g), fb)
    _save(ref_dir, "gram", g)
    _save(ref_dir, "m", m)
    for mm in (m, None):
        tag = "mix" if mm is not None else "no-mix"
        plain = chunked(lambda s_: mixtrim_ref(y[:, s_], mm, fb, "trim"), d, nb)
        flops = (2.0 * nb * nb * d if mm is not None else 0) + nb * d
        bnd = bound(4.0 * nb * d + 4 * d + (4 * nb * nb if mm is not None else 0),
                    flops, rate)
        ms, pms = time_ms(lambda: mixtrim(y, mm, fb, "trim"), 3), time_ms(plain, 1)
        err = check(f"K2 mixtrim trim {tag} n={nb} f={fb}"
                    f"{' (NNM M)' if mm is not None else ''}", mixtrim(y, mm, fb),
                    plain(), ms, pms, bnd)
        key = "mixtrim_select" if mm is not None else "mixtrim_select_nomix"
        rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound=bnd,
                         library_ms=None)
    del y, g, m
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": {"mixtrim_select": launches["hier+nnm+cwtm"],
                                       "mixtrim_select_nomix": launches["hier+cwtm"],
                                       "gram_tiled": gram_launches}}


def lm_batches(n: int, seed: int = 0):
    """The launcher's data: Dirichlet-heterogeneous synthetic LM batches."""
    from repro_torch.configs import get_config
    from repro_torch.data import build_heterogeneous, make_lm_corpus, worker_batches
    cfg = get_config("smollm-360m")
    seqs, topics = make_lm_corpus(n_tokens=400_000, vocab=cfg.vocab_size,
                                  seq_len=129, seed=seed)
    ds = build_heterogeneous({"seq": seqs, "y": topics}, "y", n, alpha=0.1,
                             seed=seed)
    for b in worker_batches(ds, 4, seed=seed):
        yield {"tokens": b["seq"][..., :-1], "labels": b["seq"][..., 1:]}


def run_loop(dev, name: str, spec_kw: dict, steps: int, expect: dict) -> dict:
    """Full-width smollm-360m (HIER_TRAIN_LAYERS deep) D-SHB through
    train_loop (the scan engine, segments of one step, so ms per step is
    each segment's time) with a hierarchical spec, n = 16, f = 3, ALIE;
    asserts finite metrics, no fallback and the exact launches per
    step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine
    from repro_torch.training import ByzantineConfig, TrainerConfig, train_loop
    model = build_model(get_config("smollm-360m").replace(
        num_layers=HIER_TRAIN_LAYERS))
    params = model.init(0, dev)
    cfg = TrainerConfig(agg=AggregatorSpec(f=F_HIER, hier=True, **spec_kw),
                        byz=ByzantineConfig(f=F_HIER, attack="alie"))
    torch.cuda.reset_peak_memory_stats(dev)
    kdispatch.reset_launch_counts()
    _, out = train_loop(model.loss, params, lm_batches(N_HIER), sgd(clip=2.0),
                        cfg, cosine(0.05, steps, warmup=0), steps, seed=0,
                        track_best=False, chunk=1)
    counts = kdispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    hist = out["history"]
    for k in ("loss", "kappa_hat", "direction_norm"):
        if not all(math.isfinite(v) for v in hist[k]):
            raise AssertionError(f"{name}: non-finite {k}: {hist[k]}")
    rec = kdispatch.last_dispatch()
    if rec is None or rec.backend != "cuda" or rec.fallbacks or not rec.hier:
        raise AssertionError(f"{name}: dispatch did not stay on the kernels:\n"
                             f"{rec.describe() if rec else None}")
    want = {k: v * steps for k, v in expect.items()}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    log(rec.describe())
    ms = [1e3 * sec for _, _, sec in out["scan_report"]["segments"]]
    log(f"  {name}: ms/step {[round(v, 1) for v in ms]}, loss "
        f"{[round(v, 4) for v in hist['loss']]}, kappa_hat "
        f"{[round(v, 4) for v in hist['kappa_hat']]}, launches {counts}, "
        f"peak {peak / 2**30:.2f} GiB")
    del out, params
    torch.cuda.empty_cache()
    return counts

#: Phase 12a: the registry scenarios driven on the card, 20 rounds each in
#: segments of 5, and the kernel launches ONE round of each must make.
FED_SCENARIOS = ("iid_baseline", "labelskew_alie_partial", "mimic_rotating",
                 "dirichlet_localsgd", "poison_labelflip", "poison_feature",
                 "faulty_nan_quarantine")
FED_ROUNDS, FED_CHUNK = 20, 5
#: Phase 12b: the federated server at full width: 8 clients, cohorts of 6,
#: f = 2 (m_byz = ceil(2 * 6 / 8) = 2, the cohort's breakdown point).
FED_CLIENTS, FED_COHORT, FED_F, FED_FULL_ROUNDS = 8, 6, 2, 2
_FED_KERNELS = ("gram", "mixtrim", "combine", "mixtrim_dyn", "gram_batched",
                "bucketgram", "bucketmeans", "bucketgram_lanes",
                "bucketmeans_lanes", "combine_lanes", "mixtrim_lanes")


def fed_expected(rule: str, pre) -> dict:
    """Launches of one round by (rule, pre): cwtm | nnm K1 + K2; the gram
    rules (average too: the reference's kernel path also routes it
    through the Gram and the combine) K1 + K3; nothing else."""
    want = dict.fromkeys(_FED_KERNELS, 0)
    if rule == "cwtm" and pre == "nnm":
        want.update(gram=1, mixtrim=1)
    elif rule in ("average", "gm", "autogm"):
        want.update(gram=1, combine=1)
    else:
        raise ValueError(f"no launch plan for {rule} | {pre}")
    return want


def no_fallback(what: str, autogm: bool = False) -> None:
    """No kernel fell back.  The one torch op the dispatch record notes for
    a kernel backend is AutoGM's (m, m) weight solve, which has no kernel
    form in the reference either (ROADMAP queue 2)."""
    from repro_torch.kernels import dispatch as kdispatch
    bad = [d for d in kdispatch.fallback_log()
           if not (autogm and d.primitive == "autogm_coeff")]
    if bad:
        raise AssertionError(f"{what}: dispatch fell back: {bad[:3]}")


def seg_ms(report: dict) -> list:
    return [1e3 * sec / (end - start) for start, end, sec in report["segments"]]


def phase_fed_scenarios(dev, rate: float) -> dict:
    """12a: registry scenarios through run_scenario on the card; returns
    {scenario: launch counts}."""
    import torch
    from repro_torch.core import gram as gramlib
    from repro_torch.fed import get_scenario, run_scenario
    from repro_torch.kernels import (combine, combine_ref, gram, gram_ref,
                                     mixtrim, mixtrim_ref)
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.rounds import RoundOptions
    # K1, K2 and K3 at the cohort stacks these scenarios give them, each
    # timed (CUDA events) beside its bound, its plain version and a
    # scenario's ms per round below.  K1 runs gram.cu's gram_rows at
    # n <= 8 and gram_batched.cu's staged kernel as one lane above.
    gen = torch.Generator(device=dev).manual_seed(12)
    d = 2842
    for n, f in ((10, 2), (12, 3), (17, 4)):
        x = torch.randn((n, d), device=dev, generator=gen)
        g = gram(x)
        check(f"K1 gram n={n} D={d}", g, gram_ref(x), time_ms(lambda: gram(x)),
              time_ms(lambda: gram_ref(x)),
              bound(4.0 * n * d + 4 * n * n, n * (n + 1) * d, rate),
              time_ms(lambda: torch.mm(x, x.T)))
        m = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g), f)
        check(f"K2 mixtrim trim mix n={n} f={f}", mixtrim(x, m, f, "trim"),
              mixtrim_ref(x, m, f, "trim"),
              time_ms(lambda: mixtrim(x, m, f, "trim")),
              time_ms(lambda: mixtrim_ref(x, m, f, "trim")),
              bound(4.0 * n * d + 4 * d + 4 * n * n, 2 * n * n * d + n * d, rate))
        c = (gramlib.gm_coeff(gramlib.mixed_gram(g, m), f) @ m).contiguous()
        check(f"K3 combine n={n}", combine(x, c), combine_ref(x, c),
              time_ms(lambda: combine(x, c)), time_ms(lambda: combine_ref(x, c)),
              bound(4.0 * n * d + 4 * d + 4 * n, 2 * n * d, rate),
              time_ms(lambda: c @ x))
    opts = RoundOptions(chunk=FED_CHUNK)
    counts_by, runs = {}, {}
    for name in FED_SCENARIOS:
        sc = get_scenario(name)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        out = run_scenario(name, rounds=FED_ROUNDS, seed=0, device=dev,
                           options=opts)
        counts = kdispatch.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) - held
        want = {k: v * FED_ROUNDS for k, v in fed_expected(sc.rule, sc.pre).items()}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        no_fallback(f"fed {sc.name}", autogm=sc.rule == "autogm")
        hist, rep = out["history"], out["server"].last_scan_report
        for k in ("loss", "direction_norm", "kappa_hat"):
            if not all(math.isfinite(v) for v in getattr(hist, k)):
                raise AssertionError(f"{name}: non-finite {k}")
        if sc.guard is not None:
            m_byz = hist.m_byz[0]
            if m_byz == 0 or rep["quarantined_count"] != [m_byz] * FED_ROUNDS:
                raise AssertionError(f"{name}: quarantined "
                                     f"{rep['quarantined_count']}, expected "
                                     f"{m_byz} every round")
        ms = seg_ms(rep)
        log(f"  {name} ({sc.rule}|{sc.pre}, m={sc.clients_per_round}, "
            f"m_byz={hist.m_byz[0]}): acc {out['accuracy']:.4f}, final loss "
            f"{hist.loss[-1]:.4f}, ms/round per segment "
            f"{[round(v, 3) for v in ms]} (median {statistics.median(ms):.3f}), "
            f"launches {got}, peak {peak / 2**20:.2f} MiB above the "
            f"{held / 2**20:.1f} MiB held before the run")
        counts_by[name] = got
        runs[name] = out
    # labelskew_alie_partial again: the torch backend, then the loop engine.
    name = "labelskew_alie_partial"
    base = runs[name]["history"].loss
    before = kdispatch.launch_counts()
    again = run_scenario(name, rounds=FED_ROUNDS, seed=0, device=dev,
                         options=RoundOptions(chunk=FED_CHUNK, backend="torch"))
    if kdispatch.launch_counts() != before:
        raise AssertionError("the torch backend launched a kernel")
    loop = run_scenario(name, rounds=FED_ROUNDS, seed=0, device=dev,
                        options=RoundOptions(engine="loop"))
    for what, other, rtol in (("torch backend", again, 1e-4),
                              ("loop engine", loop, 1e-6)):
        b = other["history"].loss
        worst = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(b, base))
        if len(b) != FED_ROUNDS or worst > rtol:
            raise AssertionError(f"{name}: {what} loss max rel diff {worst} "
                                 f"> {rtol}")
        log(f"  {name}, {what} vs the kernel scan run: per-round loss max rel "
            f"diff {worst:.3e} (tol {rtol:g}) OK")
    return counts_by


def fed_lm_batch_fn(n_clients: int, seed: int = 0):
    """The launcher's Dirichlet LM data as a fed ``batch_fn``: (m, 1, 4,
    128) tokens and labels for the cohort."""
    from repro_torch.configs import get_config
    from repro_torch.data import build_heterogeneous, make_lm_corpus
    from repro_torch.fed import cohort_batch_fn
    cfg = get_config("smollm-360m")
    seqs, topics = make_lm_corpus(n_tokens=400_000, vocab=cfg.vocab_size,
                                  seq_len=129, seed=seed)
    ds = build_heterogeneous({"seq": seqs, "y": topics}, "y", n_clients,
                             alpha=0.1, seed=seed)
    base = cohort_batch_fn(ds, 4, 0)

    def batch_fn(cohort, n_flip, rng):
        seq = base(cohort, n_flip, rng)["seq"]
        return {"tokens": seq[..., :-1], "labels": seq[..., 1:]}
    return batch_fn


def fed_grad_forms(dev, model, params, rounds: int = 3) -> None:
    """12b's row-by-row client pass on one cohort (FED_COHORT rows at full
    width, local_steps = 0) with both gradient forms ``client_send`` takes:
    plain autograd (the route's) and ``torch.func`` (what
    ``client_updates`` vmaps).  Row 0's loss and sends are printed beside
    an fp32 reference (autograd at the params cast to fp32); then each
    form runs the cohort in turns for a warm-up and ``rounds`` rounds, the
    order alternating, timed by the host clock with a synchronize at each
    end (the pass is host-bound), peak above what was held.  Fails on
    unequal losses or a non-finite send."""
    import numpy as np
    import torch
    from repro_torch.fed.clients import (ClientConfig, autograd_grad_and_value,
                                         client_send)
    from repro_torch.tree import tree_map
    batch = fed_lm_batch_fn(FED_CLIENTS)(np.arange(FED_COHORT, dtype=np.int32),
                                         0, np.random.default_rng(0))
    batch = tree_map(lambda a: torch.as_tensor(a).to(dev), batch)
    ccfg = ClientConfig(local_steps=0)
    forms = {"autograd": {"grad_and_value": autograd_grad_and_value},
             "func": {}}

    def send(form, i, p=params):
        return client_send(model.loss, p, tree_map(lambda b: b[i], batch),
                           ccfg, **forms[form])

    def rel_l2(xs, ys):
        num = sum(float(((x.float() - y) ** 2).sum()) for x, y in zip(xs, ys))
        return (num / sum(float((y ** 2).sum()) for y in ys)) ** 0.5

    l32, g32 = send("autograd", 0, tree_map(lambda p: p.float(), params))
    (la, a), (lb, b) = send("autograd", 0), send("func", 0)
    log(f"  row route, row 0: loss fp32 {float(l32):.6f}, autograd "
        f"{float(la):.6f}, func {float(lb):.6f}; sends' relative L2 error vs "
        f"fp32: autograd {rel_l2(a, g32):.3e}, func {rel_l2(b, g32):.3e}; "
        f"autograd vs func {rel_l2(a, [y.float() for y in b]):.3e}")
    if float(la) != float(lb) or not all(
            bool(torch.isfinite(x).all()) for x in a + b):
        raise AssertionError("fed full width: the two gradient forms disagree")
    del a, b, g32
    torch.cuda.empty_cache()
    for r in range(rounds + 1):
        for form in (("autograd", "func") if r % 2 == 0 else ("func", "autograd")):
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            for i in range(FED_COHORT):
                loss, sends = send(form, i)
                del sends
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            extra = (torch.cuda.max_memory_allocated(dev) - held) / 2**30
            log(f"  row route, {'warm-up' if r == 0 else f'round {r}'} {form}: "
                f"{FED_COHORT} rows {ms:.1f} ms, peak {extra:.2f} GiB above "
                f"the {held / 2**30:.2f} GiB held")


def phase_fed_full(dev, rate: float) -> dict:
    """12b: FedServer + run_rounds at full width; returns launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.fed import (ClientConfig, FedConfig, FedServer,
                                 constant_attack, run_rounds)
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.kernels import gram, gram_ref, mixtrim, mixtrim_ref
    from repro_torch.core import gram as gramlib
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import constant
    from repro_torch.tree import tree_leaves
    # K1 and K2 at the shape this path gives them: the cohort stack.
    n, d = FED_COHORT, D_MAIN
    x = torch.randn((n, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    g = gram(x)
    check(f"K1 gram n={n} D={d}", g, gram_ref(x), time_ms(lambda: gram(x)),
          time_ms(lambda: gram_ref(x)),
          bound(4.0 * n * d + 4 * n * n, n * (n + 1) * d, rate),
          time_ms(lambda: torch.mm(x, x.T)))
    m = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g), FED_F)
    plain = chunked(lambda s: mixtrim_ref(x[:, s], m, FED_F, "trim"), d)
    check(f"K2 mixtrim trim mix n={n} f={FED_F}", mixtrim(x, m, FED_F, "trim"),
          plain(), time_ms(lambda: mixtrim(x, m, FED_F, "trim")),
          time_ms(plain),
          bound(4.0 * n * d + 4 * d + 4 * n * n, 2 * n * n * d + n * d, rate))
    del x, g
    torch.cuda.empty_cache()

    model = build_model(get_config("smollm-360m"))
    params = model.init(0, dev)
    d = sum(p.numel() for p in tree_leaves(params))
    cfg = FedConfig(n_clients=FED_CLIENTS, clients_per_round=FED_COHORT,
                    f=FED_F, agg=AggregatorSpec(rule="cwtm", f=FED_F, pre="nnm"),
                    client=ClientConfig(local_steps=0, algorithm="dshb",
                                        beta=0.9))
    # Reckoned peak: the population momentum (n_clients, D) and the cohort
    # stack (m, D) in fp32, bf16 params / new params / one gradient, the
    # fp32 aggregate and its clipped copy, ~3 GiB of activations.
    reckoned = 4 * d * (FED_CLIENTS + FED_COHORT) + 2 * d * 3 + 4 * d * 2 \
        + 3 * 2**30
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    server = FedServer(model.loss, sgd(clip=2.0), cfg, constant(0.05),
                       device=dev)
    state = server.init_state(params)
    t0 = time.perf_counter()
    state, hist = run_rounds(server, state, fed_lm_batch_fn(FED_CLIENTS),
                             FED_FULL_ROUNDS,
                             schedule=constant_attack("alie", 8.0), seed=0,
                             chunk=1)
    wall = time.perf_counter() - t0
    counts = kdispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: v * FED_FULL_ROUNDS for k, v in fed_expected("cwtm", "nnm").items()}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"fed full width: launches {got}, expected {want}")
    no_fallback("fed full width")
    rec = kdispatch.last_dispatch()
    if rec is None or rec.backend != "cuda":
        raise AssertionError("fed full width: the aggregation left the kernels")
    for k in ("loss", "kappa_hat", "direction_norm"):
        if not all(math.isfinite(v) for v in getattr(hist, k)):
            raise AssertionError(f"fed full width: non-finite {k}")
    if hist.m_byz != [2] * FED_FULL_ROUNDS:
        raise AssertionError(f"fed full width: m_byz {hist.m_byz}")
    if peak >= 70 * 2**30:
        raise AssertionError(f"fed full width: peak {peak / 2**30:.2f} GiB")
    log(rec.describe())
    log(f"  smollm-360m D={d}, {FED_CLIENTS} clients, cohorts of "
        f"{FED_COHORT}, m_byz {hist.m_byz[0]}: ms/round "
        f"{[round(v, 1) for v in seg_ms(server.last_scan_report)]} "
        f"({wall:.1f} s in all), loss {[round(v, 4) for v in hist.loss]}, "
        f"kappa_hat {[round(v, 4) for v in hist.kappa_hat]}, launches {got}, "
        f"peak {peak / 2**30:.2f} GiB (reckoned {reckoned / 2**30:.2f} GiB)")
    fed_grad_forms(dev, model, state["params"])
    del state, params, server
    torch.cuda.empty_cache()
    return got


#: Phase 13: resumable runs.  13a / 13b: full-width smollm-360m at
#: RESUME_LAYERS of its 32 layers, n = 8, f = 2, ALIE 8, NNM + CWTM, 4
#: D-SHB steps in segments of 2; 13c: the
#: registry's labelskew_alie_partial, 20 rounds in segments of 5; 13d: the
#: grid's cwtm | nnm bucket (5 lanes, n = 17, f = 4), 16 rounds in segments
#: of 2 (evals every 2 rounds).
RESUME_STEPS, RESUME_CHUNK, RESUME_ETA = 4, 2, 8.0
#: The depth of 13a / 13b, cut for time: a 3.1 GB snapshot, where the full
#: depth's 13 GB took ~90 s of disk.
RESUME_LAYERS = 4
FLEET_RESUME_ROUNDS, FLEET_RESUME_CHUNK = 16, 2


def same_tree(what: str, a, b) -> None:
    """Bitwise equality of two pytrees (tensors, numbers, arrays)."""
    import numpy as np
    import torch
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{what}: {len(la)} leaves vs {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            ok = x.dtype == y.dtype and torch.equal(x, y)
        elif isinstance(x, np.ndarray):
            ok = x.dtype == y.dtype and np.array_equal(x, y)
        else:
            ok = type(x) is type(y) and x == y
        if not ok:
            raise AssertionError(f"{what}: leaf {i} differs")


def same_fed_history(what: str, a, b) -> None:
    """FedHistory.pack() arrays (cohorts included) and meta, bit for bit."""
    import numpy as np
    (x, xm), (y, ym) = a.pack(), b.pack()
    if sorted(x) != sorted(y) or xm != ym:
        raise AssertionError(f"{what}: history columns or attacks differ")
    for k in y:
        if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k],
                                                          equal_nan=True):
            raise AssertionError(f"{what}: history column {k} differs")


def snapshot_spans(since: int) -> list:
    """(bytes, seconds) of the snapshots written after event ``since``."""
    from repro_torch.obs import runtime as obs_runtime
    return [(e["args"].get("bytes"), e["dur"])
            for e in obs_runtime.history(name="resilience.snapshot")
            if e["seq"] > since]


def last_seq() -> int:
    from repro_torch.obs import runtime as obs_runtime
    evs = obs_runtime.history(limit=1)
    return evs[-1]["seq"] if evs else 0


def phase_resume_trainer(dev) -> dict:
    """13a / 13b: train_loop's scan engine at full width (RESUME_LAYERS
    deep) against its loop engine, then a kill after the step-2 snapshot
    and a resume from it; returns the launches of the four runs summed."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.models import build_model
    from repro_torch.obs import runtime as obs_runtime
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine
    from repro_torch.resilience import (CheckpointConfig, FaultPlan,
                                        SimulatedPreemption)
    from repro_torch.rounds import RoundOptions
    from repro_torch.training import ByzantineConfig, TrainerConfig, train_loop
    from repro_torch.tree import tree_leaves
    model = build_model(get_config("smollm-360m").replace(
        num_layers=RESUME_LAYERS))
    params = model.init(0, dev)
    d = sum(p.numel() for p in tree_leaves(params))
    cfg = TrainerConfig(agg=AggregatorSpec(rule="cwtm", f=F_MAIN, pre="nnm"),
                        byz=ByzantineConfig(f=F_MAIN, attack="alie",
                                            eta=RESUME_ETA))
    total: dict = {}
    last: dict = {}

    def run(engine, checkpoint=None):
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        before = obs_runtime.counters().get("rounds.transfers", 0)
        try:
            _, out = train_loop(
                model.loss, params, lm_batches(N_MAIN), sgd(clip=2.0), cfg,
                cosine(0.05, RESUME_STEPS, warmup=0), RESUME_STEPS, seed=0,
                engine=engine, chunk=RESUME_CHUNK,
                options=RoundOptions(checkpoint=checkpoint))
        finally:
            counts = last["counts"] = kdispatch.launch_counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        transfers = int(obs_runtime.counters()["rounds.transfers"] - before)
        if kdispatch.fallback_log():
            raise AssertionError(f"13 {engine}: the aggregation fell back")
        return out, counts, transfers

    def expect_launches(what, counts, steps):
        got = {k: counts[k] for k in ("gram", "mixtrim")}
        if got != {"gram": steps, "mixtrim": steps}:
            raise AssertionError(f"{what}: launches {counts}, expected "
                                 f"{steps} K1 and {steps} K2")

    def same_run(what, a, b):
        for k in ("loss", "direction_norm", "kappa_hat", "lr"):
            if a["history"][k] != b["history"][k]:
                raise AssertionError(f"{what}: {k} {a['history'][k]} vs "
                                     f"{b['history'][k]}")
        if a["best"]["norm"] != b["best"]["norm"]:
            raise AssertionError(f"{what}: best norm differs")
        same_tree(f"{what}: final params", a["state"]["params"],
                  b["state"]["params"])
        same_tree(f"{what}: best params", a["best"]["params"],
                  b["best"]["params"])
        same_tree(f"{what}: momentum", a["state"]["momentum"],
                  b["state"]["momentum"])
        if a["state"]["step"] != b["state"]["step"]:
            raise AssertionError(f"{what}: step differs")

    log(f"-- 13a. train_loop's scan engine (chunk {RESUME_CHUNK}) against "
        f"its loop engine: {RESUME_STEPS} steps, n={N_MAIN} f={F_MAIN}, "
        f"ALIE eta {RESUME_ETA:g}, NNM + CWTM, D={d}")
    scan, c_scan, t_scan = run("scan")
    loop, c_loop, t_loop = run("loop")
    for what, hist, counts in (("13a scan", scan["history"], c_scan),
                               ("13a loop", loop["history"], c_loop)):
        expect_launches(what, counts, RESUME_STEPS)
        if not all(math.isfinite(v) for v in hist["loss"]):
            raise AssertionError(f"{what}: non-finite loss")
    same_run("13a scan vs loop", scan, loop)
    if (t_scan, t_loop) != (1, RESUME_STEPS):
        raise AssertionError(f"13a: host metric transfers {t_scan} / "
                             f"{t_loop}, expected 1 / {RESUME_STEPS}")
    scan_ms = [1e3 * sec / (e - s) for s, e, sec in
               scan["scan_report"]["segments"]]
    log(f"  scan == loop bit for bit (final params, best params, momentum, "
        f"loss, direction_norm, kappa_hat, lr); ms/step scan (per segment) "
        f"{[round(v, 1) for v in scan_ms]}, loop "
        f"{[round(v, 1) for v in loop['history']['ms']]}; host metric "
        f"transfers {t_scan} vs {t_loop}; launches per run K1 "
        f"{c_scan['gram']} / {c_loop['gram']}, K2 {c_scan['mixtrim']} / "
        f"{c_loop['mixtrim']}; loss {[round(v, 4) for v in scan['history']['loss']]}")
    del loop
    torch.cuda.empty_cache()

    # 13b.  Reckon the carry before asking for disk.
    momentum_b = N_MAIN * d * 4
    params_b = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    carry_b = momentum_b + 2 * params_b
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"-- 13b. kill after the step-{RESUME_CHUNK} snapshot, resume: "
            f"carry momentum {momentum_b / 1e9:.2f} GB + params "
            f"{params_b / 1e9:.2f} GB + best params {params_b / 1e9:.2f} GB "
            f"= {carry_b / 1e9:.2f} GB a snapshot, up to "
            f"{2 * carry_b / 1e9:.2f} GB on disk while one replaces the "
            f"other; free on the disk of {tmp}: {free / 1e9:.2f} GB")
        if free < 2 * carry_b + 2**30:
            raise AssertionError(
                f"13b needs {(2 * carry_b + 2**30) / 1e9:.1f} GB free under "
                f"{tmp} for two full-width snapshots; it has "
                f"{free / 1e9:.1f} GB")
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        seq = last_seq()
        t0 = time.perf_counter()
        try:
            run("scan", CheckpointConfig(dir=tmp, keep=1,
                                         fault_plan=FaultPlan(kill_at=0)))
        except SimulatedPreemption as exc:
            if exc.round != RESUME_CHUNK:
                raise AssertionError(f"13b: killed at round {exc.round}")
        else:
            raise AssertionError("13b: the kill drill did not fire")
        kill_wall = time.perf_counter() - t0
        expect_launches("13b kill", last["counts"], RESUME_CHUNK)
        peak_kill = torch.cuda.max_memory_allocated(dev) - held
        snaps = snapshot_spans(seq)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        seq = last_seq()
        t0 = time.perf_counter()
        resumed, c_res, t_res = run("scan", CheckpointConfig(dir=tmp, keep=1))
        res_wall = time.perf_counter() - t0
        peak_res = torch.cuda.max_memory_allocated(dev) - held
        snaps += snapshot_spans(seq)
        loads = [e["dur"] for e in
                 obs_runtime.history(name="resilience.load")
                 if e["seq"] > seq]
        on_disk = sorted(os.listdir(tmp))
    rep = resumed["scan_report"]
    if rep["resumed_from"] != RESUME_CHUNK or rep["snapshots"] != 1:
        raise AssertionError(f"13b: resumed from {rep['resumed_from']}, "
                             f"{rep['snapshots']} snapshots")
    expect_launches("13b resume", c_res, RESUME_STEPS - RESUME_CHUNK)
    same_run("13b resumed vs 13a scan", resumed, scan)
    if on_disk != ["MANIFEST.json", f"snapshot-{RESUME_STEPS:08d}.npz"]:
        raise AssertionError(f"13b: files left {on_disk}")
    res_ms = [1e3 * sec / (e - s) for s, e, sec in rep["segments"]]
    log(f"  killed after the step-{RESUME_CHUNK} snapshot ({kill_wall:.1f} s "
        f"for the run, {RESUME_CHUNK} K1 + {RESUME_CHUNK} K2); resumed "
        f"from step {rep['resumed_from']} ({res_wall:.1f} s, snapshot load "
        f"{[round(v, 2) for v in loads]} s): final params, best params, "
        f"momentum and every metric column equal 13a's scan run bit for bit")
    for i, (nbytes, sec) in enumerate(snaps):
        log(f"  snapshot {i}: {nbytes} B ({nbytes / 1e9:.3f} GB) in "
            f"{sec:.2f} s (resilience.snapshot span: D2H copy, np.savez, "
            f"fsync, rename, manifest)")
    log(f"  ms/step resumed segment {[round(v, 1) for v in res_ms]} beside "
        f"13a's scan {[round(v, 1) for v in scan_ms]}; peak device memory "
        f"above the {held / 2**30:.2f} GiB held: kill run "
        f"{peak_kill / 2**30:.2f} GiB, resumed run {peak_res / 2**30:.2f} GiB")
    del scan, resumed, params
    torch.cuda.empty_cache()
    return total


def phase_resume_fed(dev) -> dict:
    """13c: labelskew_alie_partial, 20 rounds in segments of 5, killed
    (kill_at=1) and torn (torn_at=1), each resumed; returns launches."""
    import tempfile
    from repro_torch.fed import build_scenario, get_scenario, run_rounds
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.resilience import (CheckpointConfig, FaultPlan,
                                        SimulatedPreemption)
    from repro_torch.rounds import RoundOptions
    sc = get_scenario("labelskew_alie_partial")
    total: dict = {}

    def run(checkpoint=None):
        server, state, batch_fn, _ = build_scenario(sc, seed=0, device=dev)
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        try:
            state, hist = run_rounds(
                server, state, batch_fn, FED_ROUNDS, schedule=sc.attack,
                byz_identity=sc.byz_identity(), seed=0, engine="scan",
                chunk=FED_CHUNK, options=RoundOptions(checkpoint=checkpoint))
        finally:
            counts = kdispatch.launch_counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        no_fallback(f"fed {sc.name}", autogm=sc.rule == "autogm")
        want = {k: v * (FED_ROUNDS - (server.last_scan_report or {}).get(
                    "resumed_from", 0))
                for k, v in fed_expected(sc.rule, sc.pre).items()}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"13c: launches {counts}, expected {want}")
        return server, state, hist

    _, ref_state, ref_hist = run()
    for plan, resumed_at in ((FaultPlan(kill_at=1), 2 * FED_CHUNK),
                             (FaultPlan(torn_at=1), FED_CHUNK)):
        with tempfile.TemporaryDirectory() as tmp:
            seq = last_seq()
            try:
                run(CheckpointConfig(dir=tmp, fault_plan=plan))
            except SimulatedPreemption:
                pass
            else:
                raise AssertionError(f"13c: {plan} did not fire")
            server, state, hist = run(CheckpointConfig(dir=tmp))
            snaps = snapshot_spans(seq)
        rep = server.last_scan_report
        if rep["resumed_from"] != resumed_at:
            raise AssertionError(f"13c {plan}: resumed from "
                                 f"{rep['resumed_from']}")
        same_fed_history(f"13c {plan}", hist, ref_hist)
        same_tree(f"13c {plan}: state", state, ref_state)
        log(f"  {sc.name} {plan}: resumed from round {rep['resumed_from']}, "
            f"history (pack() arrays, cohorts) and state equal the "
            f"uninterrupted run bit for bit; K1 + K2 once a round; "
            f"snapshots (B, s) {[(b, round(t, 4)) for b, t in snaps]}")
    return total


def phase_resume_fleet(dev) -> dict:
    """13d: the grid's cwtm | nnm bucket, killed after its first snapshot
    and resumed; returns launches."""
    import tempfile
    from repro_torch.fleet import FleetRunner
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import grid
    from repro_torch.resilience import (CheckpointConfig, FaultPlan,
                                        SimulatedPreemption)
    from repro_torch.rounds import RoundOptions
    total: dict = {}

    def run(checkpoint=None):
        jobs = [j for j in grid.build_jobs(full=True, alpha=0.1,
                                           steps=FLEET_RESUME_ROUNDS)
                if j.label.startswith("cwtm|nnm|")]
        runner = FleetRunner(jobs, device=dev, options=RoundOptions(
            chunk=FLEET_RESUME_CHUNK, checkpoint=checkpoint))
        if len(jobs) != 5 or runner.n_buckets != 1:
            raise AssertionError("13d: expected one bucket of 5 lanes")
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        try:
            return runner.run()
        finally:
            counts = kdispatch.launch_counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            if kdispatch.fallback_log():
                raise AssertionError("13d: the aggregation fell back")

    ref = run()
    with tempfile.TemporaryDirectory() as tmp:
        seq = last_seq()
        try:
            run(CheckpointConfig(dir=tmp, fault_plan=FaultPlan(kill_at=0)))
        except SimulatedPreemption as exc:
            killed_at = exc.round
        else:
            raise AssertionError("13d: the kill drill did not fire")
        res = run(CheckpointConfig(dir=tmp))
        snaps = snapshot_spans(seq)
    for a, b in zip(res, ref):
        same_fed_history(f"13d {a.label}", a.history, b.history)
        if a.evals != b.evals or a.best_eval != b.best_eval:
            raise AssertionError(f"13d {a.label}: evals differ")
        same_tree(f"13d {a.label}: state", a.state, b.state)
    want = {"mixtrim_dyn": 2 * FLEET_RESUME_ROUNDS,
            "gram_batched": 2 * FLEET_RESUME_ROUNDS}
    got = {k: total[k] for k in want}
    if got != want:
        raise AssertionError(f"13d: K4 / K5 launches {got} over the "
                             f"uninterrupted, killed and resumed runs, "
                             f"expected {want}")
    log(f"  cwtm|nnm bucket (5 lanes, n=17, f={F_GRID}), "
        f"{FLEET_RESUME_ROUNDS} rounds in segments of {FLEET_RESUME_CHUNK}: "
        f"killed after round {killed_at}, resumed; every FleetResult "
        f"(history, evals, state) equals the uninterrupted run bit for bit; "
        f"K4 {got['mixtrim_dyn']} and K5 {got['gram_batched']} launches over "
        f"the three runs (once a bucket-round); snapshots (B, s) "
        f"{[(b, round(t, 4)) for b, t in snaps]}")
    return total


# ---------------------------------------------------------------------------
# Phase 14: the continuous fleet service (repro_torch.serving).
# ---------------------------------------------------------------------------

SERVICE_ROUNDS, SERVICE_CHUNK = 18, 10      # 14a: the grid through both (30 rounds before)
CHURN_ROUNDS, CHURN_CHUNK = 12, 3           # 14b
#: The lane buckets' kernels: K5, K4, K2's median and K3's lane forms, and
#: the single-lane K2 / K3, which a lane bucket no longer launches.
_LANE_KERNELS = ("gram_batched", "mixtrim_dyn", "mixtrim_lanes",
                 "combine_lanes", "mixtrim", "combine")
_GRAM_RULES = ("average", "gm", "autogm", "krum", "multikrum")


def service_launches(keys: tuple = _LANE_KERNELS) -> dict:
    from repro_torch.kernels import dispatch as kdispatch
    counts = kdispatch.launch_counts()
    return {k: counts[k] for k in keys}


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def lane_expected(rule: str, pre, rounds: int, lanes: int) -> dict:
    """A lane bucket's launches over ``rounds`` bucket-rounds, whatever
    its ``lanes``: K5 (the Gram), and K4 (the cwtm trim), K2's median lane
    form (cwmed) or K3's (the gram rules' combine), once a bucket-round
    each; nothing once a lane."""
    gram = pre == "nnm" or rule in _GRAM_RULES
    return {"gram_batched": rounds if gram else 0,
            "mixtrim_dyn": rounds if rule == "cwtm" else 0,
            "mixtrim_lanes": rounds if rule == "cwmed" else 0,
            "combine_lanes": rounds if rule in _GRAM_RULES else 0,
            "mixtrim": 0, "combine": 0}


def add_counts(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def ms_per_bucket_round(entries) -> dict:
    """{bucket: median ms per bucket-round} over (bucket, rounds, s)."""
    per: dict = {}
    for key, nr, sec in entries:
        per.setdefault(key, []).append(1e3 * sec / nr)
    return {k: statistics.median(v) for k, v in per.items()}


def phase_service_grid(dev) -> dict:
    """14a: the paper's grid (61 jobs, 13 buckets) submitted up front to
    the service and run by the batch runner: every result equal bit for
    bit, launches equal; returns the service's launches."""
    import torch
    from repro_torch.fleet import FleetRunner
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import grid
    from repro_torch.serving import FleetService
    jobs = grid.build_jobs(full=True, alpha=0.1, steps=SERVICE_ROUNDS)
    runs, walls = {}, {"runner": [], "service": []}
    # In turns (runner, service, service, runner): the first run of a
    # process pays its warm-up; the first run of each is checked.
    for name in ("runner", "service", "service", "runner"):
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if name == "runner":
            fleet = FleetRunner(jobs, chunk=SERVICE_CHUNK, device=dev)
            results = fleet.run()
        else:
            fleet = FleetService(chunk=SERVICE_CHUNK, device=dev)
            handles = [fleet.submit(j) for j in jobs]
            fleet.run_until_idle()
            results = [h.result() for h in handles]
        torch.cuda.synchronize(dev)
        walls[name].append(time.perf_counter() - t0)
        no_fallback(f"14a {name}")
        runs.setdefault(name, (fleet, results, service_launches()))
    runner, ref, counts_r = runs["runner"]
    svc, got, counts_s = runs["service"]
    if runner.n_buckets != 13 or len(got) != 61:
        raise AssertionError("14a: expected 61 jobs in 13 buckets")
    if svc.trace_count != 13 or runner.trace_count != 13:
        raise AssertionError(f"14a: round programs {svc.trace_count} "
                             f"(service) / {runner.trace_count} (runner)")
    for a, b in zip(got, ref):
        same_fed_history(f"14a {a.label}", a.history, b.history)
        if a.evals != b.evals or a.best_eval != b.best_eval:
            raise AssertionError(f"14a {a.label}: evals differ")
        same_tree(f"14a {a.label}: state", a.state, b.state)
    want: dict = {}
    for b in runner.buckets:
        spec = b.jobs[0].cfg.agg
        add_counts(want, lane_expected(spec.rule, spec.pre, SERVICE_ROUNDS,
                                       len(b.jobs)))
    check_launches("14a runner", counts_r, want)
    check_launches("14a service", counts_s, want)
    ms_r = ms_per_bucket_round((bi, nr, sec) for bi, _, nr, sec
                               in runner.segment_log)
    ms_s = ms_per_bucket_round((key, nr, sec) for key, _, nr, sec
                               in svc.step_log)
    log(f"  61 jobs, 13 buckets, {SERVICE_ROUNDS} rounds in segments of at "
        f"most {SERVICE_CHUNK}, cut at the evals (every "
        f"{jobs[0].eval_every}): every FleetResult (history, evals, state) of the "
        f"service equals the batch runner's bit for bit; 13 round programs "
        f"each; launches equal {counts_s} (K4 / K5 and K2's median / K3's "
        f"lane forms once a bucket-round, none once a lane); no fallback")
    log(f"  ms per bucket-round (median over buckets of each bucket's "
        f"median): service {statistics.median(ms_s.values()):.3f} "
        f"[{min(ms_s.values()):.3f}-{max(ms_s.values()):.3f}], runner "
        f"{statistics.median(ms_r.values()):.3f} "
        f"[{min(ms_r.values()):.3f}-{max(ms_r.values()):.3f}]; wall in "
        f"turns (runner, service, service, runner; planning included): "
        f"{walls['runner'][0]:.2f}, {walls['service'][0]:.2f}, "
        f"{walls['service'][1]:.2f}, {walls['runner'][1]:.2f} s")
    return counts_s


def phase_service_churn(dev) -> dict:
    """14b: cwtm | nnm and gm | nnm buckets of 3 lanes under churn: late
    submits, a running and a queued cancel, deadlines; each finished lane
    against its solo run within rtol 1e-5; returns launches."""
    import dataclasses
    import torch
    from repro_torch.fleet import FleetRunner
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import grid
    from repro_torch.serving import FleetService
    cells = {j.label: j for j in grid.build_jobs(full=True, alpha=0.1,
                                                 steps=CHURN_ROUNDS)}

    def job(label, rounds):
        # Evals every 3 rounds: the segments are cut at the chunk.
        return dataclasses.replace(cells[label], rounds=rounds,
                                   eval_every=CHURN_CHUNK)

    plan = {"A1": ("cwtm|nnm|alie", 12), "A2": ("cwtm|nnm|foe", 6),
            "A3": ("cwtm|nnm|sf", 9), "A4": ("cwtm|nnm|mimic", 6),
            "A5": ("cwtm|nnm|lf", 6), "G1": ("gm|nnm|alie", 12),
            "G2": ("gm|nnm|sf", 9), "G3": ("gm|nnm|mimic", 6)}
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    svc = FleetService(max_lanes=3, chunk=CHURN_CHUNK, device=dev)
    h = {n: svc.submit(job(*plan[n])) for n in ("A1", "A2", "G1", "G2")}
    done_at: dict = {}
    step_s: list = []

    def step():
        t0 = time.perf_counter()
        more = svc.step()
        step_s.append(time.perf_counter() - t0)
        for n, hh in h.items():
            if hh.status() == "done" and n not in done_at:
                done_at[n] = svc.steps
        return more

    step()
    h["A3"] = svc.submit(job(*plan["A3"]))      # the free cwtm slot
    h["G3"] = svc.submit(job(*plan["G3"]))
    if not h["G3"].cancel() or h["G3"].status() != "cancelled":
        raise AssertionError("14b: the queued cancel failed")
    if not h["G2"].cancel() or h["G2"].partial_result.history.rounds \
            != CHURN_CHUNK:
        raise AssertionError("14b: the running cancel failed")
    step()                                      # A2 finishes here
    h["A5"] = svc.submit(job(*plan["A5"]), deadline=2.0)    # waits
    h["A4"] = svc.submit(job(*plan["A4"]), deadline=1.0)    # A2's slot
    while step():
        pass
    torch.cuda.synchronize(dev)
    counts = service_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    no_fallback("14b")
    finished = [n for n in plan if h[n].status() == "done"]
    if sorted(finished) != ["A1", "A2", "A3", "A4", "A5", "G1"]:
        raise AssertionError(f"14b: finished {finished}")
    lat = {n: h[n].admit_step - h[n].submit_step for n in ("A3", "A4", "A5")}
    if lat["A3"] > 1 or lat["A4"] > 1:
        raise AssertionError(f"14b: admission latencies {lat}")
    if not h["A4"].admit_ts < h["A5"].admit_ts:
        raise AssertionError("14b: admission did not follow the deadlines")
    # A5 takes the first cwtm slot that frees after A4's admission.
    freed = min(done_at[n] for n in ("A1", "A2", "A3", "A4")
                if done_at[n] > h["A4"].admit_step)
    if h["A5"].admit_step != freed:
        raise AssertionError(f"14b: A5 admitted at {h['A5'].admit_step}, "
                             f"a slot freed at {freed}")
    rounds = {}
    for key, _, nr, _ in svc.step_log:
        rounds[key] = rounds.get(key, 0) + nr
    want: dict = {}
    for key, nr in rounds.items():
        b = next(hh for hh in h.values() if hh.key == key).job.cfg.agg
        add_counts(want, lane_expected(b.rule, b.pre, nr, 3))
    check_launches("14b", counts, want)
    # Churn is invisible at a fixed bucket shape: each finished lane
    # equals, bit for bit, its job run alone in a bucket of 3 slots.
    # Against its 1-lane solo run (another shape: the card's reductions
    # and products pick other configurations) it is held within rtol
    # 1e-5, GM's direction_norm within 1e-4 (the reference's fleet
    # tolerance): Weiszfeld's fp32 iterations amplify the ~1e-8 per-round
    # difference to ~2e-5 over 12 rounds.
    worst = {"loss": 0.0, "direction_norm": 0.0}
    solo_bitwise = True
    for n in finished:
        alone = FleetService(max_lanes=3, chunk=CHURN_CHUNK, device=dev)
        same = alone.submit(job(*plan[n])).result()
        same_fed_history(f"14b {n} (alone, 3 slots)", h[n].result().history,
                         same.history)
        same_tree(f"14b {n} (alone, 3 slots): state", h[n].result().state,
                  same.state)
        solo = FleetRunner([job(*plan[n])], chunk=CHURN_CHUNK,
                           device=dev).run()[0]
        got = h[n].result()
        for col in ("loss", "direction_norm"):
            a = getattr(got.history, col)
            b = getattr(solo.history, col)
            if len(a) != len(b):
                raise AssertionError(f"14b {n}: {len(a)} rounds vs {len(b)}")
            solo_bitwise &= a == b
            tol = 1e-4 if col == "direction_norm" \
                and got.job.cfg.agg.rule == "gm" else 1e-5
            for x, y in zip(a, b):
                rel = abs(x - y) / max(abs(y), 1e-30)
                worst[col] = max(worst[col], rel)
                if rel > tol:
                    raise AssertionError(f"14b {n} {col}: {x} vs solo {y} "
                                         f"(tol {tol})")
    log(f"  8 jobs through 2 buckets of 3 lanes (segments of "
        f"{CHURN_CHUNK}): late admissions {lat} boundaries (A5 at the "
        f"first freed slot after A4, deadline 1.0 before 2.0), one running "
        f"and one queued cancel; each of the 6 finished lanes equals its "
        f"job alone in a 3-slot bucket bit for bit; against its 1-lane solo "
        f"run: max rel diff loss {worst['loss']:.3e} (tol 1e-5), "
        f"direction_norm {worst['direction_norm']:.3e} (tol 1e-5, gm 1e-4), "
        f"bitwise {'equal' if solo_bitwise else 'not equal'}; launches "
        f"{counts} (K4 / K5 once a bucket-round over "
        f"{sum(rounds.values())} bucket-rounds); s per step boundary "
        f"(admit, segments, evict, backfill) {min(step_s):.4f}-"
        f"{max(step_s):.4f}; peak {peak / 2**30:.3f} GiB")
    return counts


def phase_service_registry(dev) -> dict:
    """14c: every registered scenario x 2 seeds through launch.service
    (poisoned and guarded lanes included); the poisoned and guarded
    buckets again on the torch backend; returns launches."""
    import torch
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import service
    from repro_torch.obs import runtime as obs_runtime
    from repro_torch.rounds import RoundOptions
    from repro_torch.serving import FleetService
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    seq = last_seq()
    out = service.main(["--seeds", "2", "--rounds", "12",
                        "--device", dev.type])
    torch.cuda.synchronize(dev)
    counts = service_launches()
    no_fallback("14c", autogm=True)
    for label, r in out["results"].items():
        h = r.history
        if h.rounds != 12 or not all(math.isfinite(v) for v in
                                     h.loss + h.direction_norm):
            raise AssertionError(f"14c {label}: bad history")
    quar = [e["args"] for e in obs_runtime.history(
        name="robustness.quarantine") if e["seq"] > seq]
    if not quar or any(e["surface"] != "fleet.service" for e in quar):
        raise AssertionError(f"14c: quarantine events {quar}")
    names = ("poison_labelflip", "poison_feature", "faulty_nan_quarantine")
    again = FleetService(device=dev, options=RoundOptions(backend="torch"))
    from repro_torch.fleet import ScenarioSpec
    handles = [again.submit(ScenarioSpec(n, seed=s, rounds=12))
               for n in names for s in range(2)]
    before = kdispatch.launch_counts()
    again.run_until_idle()
    if kdispatch.launch_counts() != before:
        raise AssertionError("14c: the torch backend launched a kernel")
    worst = 0.0
    for hh in handles:
        a = out["results"][hh.job.label].history.loss
        b = hh.result().history.loss
        for x, y in zip(a, b):
            rel = abs(x - y) / max(abs(y), 1e-30)
            worst = max(worst, rel)
            if rel > 1e-4:
                raise AssertionError(f"14c {hh.job.label}: cuda vs torch "
                                     f"loss {x} vs {y}")
    log(f"  {len(out['results'])} jobs, {out['service'].trace_count} round "
        f"programs, {out['wall']:.2f} s; histories finite; quarantine "
        f"events {[(e['total'], e['rounds']) for e in quar]}; launches "
        f"{counts}; poisoned and guarded buckets cuda vs torch backend: "
        f"per-round loss max rel diff {worst:.3e} (tol 1e-4) OK")
    return counts


def phase_service_drill(dev) -> dict:
    """14d: the preemption drill through launch.service: spec-named and
    raw jobs, a mid-run submit, a cancel, a deadline; returns launches."""
    import torch
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import service
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    out = service.main(["--kill-at", "2", "--seeds", "2", "--rounds", "12",
                        "--device", dev.type])
    torch.cuda.synchronize(dev)
    counts = service_launches()
    no_fallback("14d")
    if not out["survivors"] or not out["snapshots"]:
        raise AssertionError("14d: nothing survived the kill")
    sizes = [b for b, _ in out["snapshots"]]
    secs = [t for _, t in out["snapshots"]]
    log(f"  {len(out['survivors'])} surviving handles equal the "
        f"uninterrupted run bit for bit; {len(sizes)} snapshots of "
        f"{min(sizes)}-{max(sizes)} B in {min(secs):.4f}-{max(secs):.4f} s; "
        f"restore {out['restore_s']:.4f} s; launches {counts}")
    return counts



#: Phase 15: the optimized attacks (the deployed aggregate and 12
#: candidates a step or round), the sketch Gram and the breakdown sweep.
OPT_AGGS = 13
SKETCH_DIM = 512
OPT_RTOL = 1e-5                  # the damages, kernel vs torch backend
K1_DENSE = (3.986, 3.456)        # K1 ms and bound at the dense shape (PERF.md)
BD_ROUNDS, BD_RTOL = 20, 1e-4    # examples/breakdown_frontier.py's rounds


def opt_check(what: str, counts: dict, per_agg: dict, times: int) -> dict:
    """Exactly ``per_agg`` launches per aggregate, 13 aggregates a step or
    round, ``times`` steps or rounds; the other kernels none."""
    want = {k: per_agg.get(k, 0) * OPT_AGGS * times for k in _FED_KERNELS}
    got = {k: counts[k] for k in _FED_KERNELS}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return got


def opt_search_backends(out, spec_kw: dict, attack: str) -> None:
    """15a: the eta search again on step 1's captured stack, through the
    kernel backend and the torch backend, in place on that one buffer:
    each damage within 1e-5 of the largest (the script's fp32 contract,
    RTOL), and each damage above that within 1e-5 of itself (etas whose
    aggregate IS the honest mean up to rounding give damages ~1e-14 of the
    largest, whose relative difference is noise), the same eta unless the top two damages lie within that tolerance (a
    near-tie, printed)."""
    import torch
    from repro_torch.core.attacks import attack_flat_
    from repro_torch.core.robust import robust_aggregate
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    flat, layout = out["attacked"], out["layout"]
    segs = [(off, size) for off, size, _ in layout.segments]
    found = {}
    for backend in ("cuda", "torch"):
        spec = AggregatorSpec(f=F_MAIN, backend=backend, **spec_kw)
        internals = {}
        t0 = time.perf_counter()
        attack_flat_(attack, flat, F_MAIN, segments=segs, internals=internals,
                     agg_closure=lambda fl: robust_aggregate(
                         kdispatch.stack_views(fl, layout), spec))
        torch.cuda.synchronize()
        found[backend] = (float(internals["eta"]),
                          internals["damages"].double().cpu().tolist(),
                          time.perf_counter() - t0)
    (ek, dk, sk), (et, dt, st) = found["cuda"], found["torch"]
    same_step = dk == out["damages"].double().cpu().tolist()
    scale = max(abs(v) for v in dt)
    worst = max(abs(a - b) for a, b in zip(dk, dt)) / scale
    rel = max(abs(a - b) / abs(b) for a, b in zip(dk, dt)
              if abs(b) > OPT_RTOL * scale)
    top = sorted(dt, reverse=True)[:2]
    tie = top[0] - top[1] <= OPT_RTOL * abs(top[0])
    log(f"  {attack} search on step 1's stack: kernel eta {ek:g} ({sk:.2f} s, "
        f"damages bitwise step 1's: {same_step}), torch eta {et:g} "
        f"({st:.2f} s); damages max diff {worst:.3e} of the largest (tol "
        f"{OPT_RTOL:g}), max rel diff {rel:.3e} over those above the tol"
        f"{'; NEAR-TIE of the top two' if tie else ''}")
    log(f"    damages (kernel): {[f'{v:.6e}' for v in dk]}")
    if worst > OPT_RTOL or rel > OPT_RTOL or (ek != et and not tie):
        raise AssertionError(f"{attack}: backends disagree: eta {ek} vs {et}, "
                             f"damages {worst} of the largest, rel {rel}")


def phase_opt_trainer(dev, peak7: int) -> dict:
    """15a: alie_opt NNM + CWTM (3 steps) and foe_opt NNM + GM (2 steps)
    through launch.train at full width; the hierarchical alie_opt step."""
    import torch
    total = {}
    out, counts = run_train("nnm+cwtm", 3, capture=True, attack="alie_opt")
    add_counts(total, opt_check("nnm+cwtm alie_opt", counts,
                                {"gram": 1, "mixtrim": 1}, 3))
    extra = out["peak_bytes"] - peak7
    log(f"  peak {out['peak_bytes'] / 2**30:.2f} GiB against phase 7's "
        f"{peak7 / 2**30:.2f} GiB: {extra / 2**30:+.2f} GiB (limit +"
        f"{16 * D_MAIN / 2**30:.2f})")
    if extra > 16 * D_MAIN:
        raise AssertionError("alie_opt: the search held a second stack")
    del out["state"]
    torch.cuda.empty_cache()
    opt_search_backends(out, dict(rule="cwtm", pre="nnm"), "alie_opt")
    del out
    torch.cuda.empty_cache()
    out, counts = run_train("nnm+gm", 2, capture=False, attack="foe_opt")
    add_counts(total, opt_check("nnm+gm foe_opt", counts,
                                {"gram": 1, "combine": 1}, 2))
    del out
    torch.cuda.empty_cache()
    add_counts(total, phase_opt_hier(dev))
    return total


def phase_opt_hier(dev) -> dict:
    """15a: one hier + NNM + CWTM step under alie_opt (n = 16, f = 3, 8
    buckets of 2): 13 K6 + 13 K2; its generator then stands where an
    alie step leaves it (one permutation draw for all 13 aggregates)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine
    from repro_torch.training import (ByzantineConfig, TrainerConfig,
                                      build_train_step, init_state)
    from repro_torch.training.trainer import to_device
    model = build_model(get_config("smollm-360m"))
    params = model.init(0, dev)
    batch = to_device(next(lm_batches(N_HIER)), dev)
    gens, got = {}, None
    for attack in ("alie_opt", "alie"):
        cfg = TrainerConfig(agg=AggregatorSpec(f=F_HIER, hier=True, pre="nnm",
                                               rule="cwtm"),
                            byz=ByzantineConfig(f=F_HIER, attack=attack))
        step = build_train_step(model.loss, sgd(clip=2.0), cfg,
                                cosine(0.05, 1, warmup=0))
        state = init_state(params, sgd(clip=2.0), N_HIER, cfg)
        gens[attack] = torch.Generator().manual_seed(0)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        internals = {}
        t0 = time.perf_counter()
        state, metrics = step(state, batch, internals, generator=gens[attack])
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        counts = kdispatch.launch_counts()
        no_fallback(f"hier {attack}")
        if not all(math.isfinite(float(metrics[k]))
                   for k in ("loss", "kappa_hat", "direction_norm")):
            raise AssertionError(f"hier {attack}: non-finite metrics")
        eta = f", eta {float(internals['eta']):g}" if "eta" in internals else ""
        log(f"  hier+nnm+cwtm {attack}, n={N_HIER} f={F_HIER}: {ms:.1f} ms"
            f"{eta}, launches {counts}, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        if attack == "alie_opt":
            got = opt_check("hier+nnm+cwtm alie_opt", counts,
                            {"bucketgram": 1, "mixtrim": 1}, 1)
        del state, internals, metrics
        torch.cuda.empty_cache()
    if not torch.equal(gens["alie_opt"].get_state(), gens["alie"].get_state()):
        raise AssertionError("hier alie_opt drew its permutation more than once")
    log("  the generator after the alie_opt step equals its state after an "
        "alie step: one permutation draw a step")
    del params, batch
    torch.cuda.empty_cache()
    return got


def phase_sketch(dev, rate: float) -> dict:
    """15b: NNM + CWTM with sketch_dim = 512 through launch.train, 2 steps
    (K2 once a step, no K1; the record names the sketch); step 1's stack
    aggregated with its signs on both backends; the sketch fold timed
    beside K1 on that stack."""
    import torch
    from repro_torch.core.robust import robust_aggregate
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.kernels import gram
    from repro_torch.tree import tree_leaves
    out, counts = run_train("nnm+cwtm", 2, capture=True,
                            extra=("--sketch-dim", str(SKETCH_DIM)),
                            allow=("sketch_gram",))
    want = dict.fromkeys(_FED_KERNELS, 0)
    want["mixtrim"] = 2
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"sketch: launches {counts}, expected {want}")
    prims = [d.primitive for d in out["dispatch"].decisions]
    if "sketch_gram" not in prims or "gram" in prims:
        raise AssertionError(f"sketch: the record does not name the sketch: "
                             f"{prims}")
    log(out["dispatch"].describe())
    del out["state"]
    torch.cuda.empty_cache()
    flat, layout, signs = out["attacked"], out["layout"], out["signs"]
    stack = kdispatch.stack_views(flat, layout)
    got, want = (robust_aggregate(stack, AggregatorSpec(
        rule="cwtm", f=F_MAIN, pre="nnm", sketch_dim=SKETCH_DIM, backend=b),
        signs=signs) for b in ("cuda", "torch"))
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        err, tol = max_err(a.reshape(-1), b.reshape(-1))
        if err > tol:
            raise AssertionError(f"sketch: backends disagree: {err} > {tol}")
        worst = max(worst, err)
    log(f"  sketch robust_aggregate cuda vs torch on step 1's stack, same "
        f"signs: max_abs_err={worst:.3e} (tol {RTOL} x max|leaf|) OK")
    del got, want
    torch.cuda.empty_cache()
    n, d = flat.shape
    segs = [(off, size) for off, size, _ in layout.segments]
    fold_ms = time_ms(lambda: kdispatch.dispatch_sketch_gram(
        flat, segs, SKETCH_DIM, signs, backend="cuda"))
    k1_ms = time_ms(lambda: gram(flat))
    fbnd = bound(4.0 * n * d + 4 * n * SKETCH_DIM + 4 * n * n,
                 2.0 * n * d + 2 * n * n * SKETCH_DIM, rate)
    kbnd = bound(4.0 * n * d + 4 * n * n, n * (n + 1) * d, rate)
    log(f"  sketch fold + Gram (n={n}, D={d}, {len(segs)} segments, "
        f"s={SKETCH_DIM}): {fold_ms:.3f} ms, bound {fbnd[0]:.3f} ms "
        f"({fbnd[1]}); K1 on the same stack {k1_ms:.3f} ms, bound "
        f"{kbnd[0]:.3f} ms (PERF.md's kernel table: {K1_DENSE[0]} / "
        f"{K1_DENSE[1]})")
    del out, flat, stack
    torch.cuda.empty_cache()
    return {k: counts[k] for k in _FED_KERNELS}


def phase_opt_fed(dev) -> dict:
    """15c: full-width FedServer under foe_opt (cohorts of 6 of 8, f = 2,
    NNM + CWTM, 2 rounds: 13 K1 + 13 K2 a round); then
    labelskew_alie_partial with its attack made alie_opt, 20 rounds: the
    scan engine equals the loop engine bit for bit, the torch backend
    within 1e-4 per round's loss."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.fed import (ClientConfig, FedConfig, FedServer,
                                 constant_attack, get_scenario, run_rounds,
                                 run_scenario)
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import constant
    from repro_torch.rounds import RoundOptions
    total = {}
    model = build_model(get_config("smollm-360m"))
    params = model.init(0, dev)
    cfg = FedConfig(n_clients=FED_CLIENTS, clients_per_round=FED_COHORT,
                    f=FED_F, agg=AggregatorSpec(rule="cwtm", f=FED_F, pre="nnm"),
                    client=ClientConfig(local_steps=0, algorithm="dshb",
                                        beta=0.9))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    server = FedServer(model.loss, sgd(clip=2.0), cfg, constant(0.05),
                       device=dev)
    state = server.init_state(params)
    state, hist = run_rounds(server, state, fed_lm_batch_fn(FED_CLIENTS),
                             FED_FULL_ROUNDS,
                             schedule=constant_attack("foe_opt"), seed=0,
                             chunk=1)
    add_counts(total, opt_check("fed full width foe_opt",
                                kdispatch.launch_counts(),
                                {"gram": 1, "mixtrim": 1}, FED_FULL_ROUNDS))
    no_fallback("fed full width foe_opt")
    for k in ("loss", "kappa_hat", "direction_norm"):
        if not all(math.isfinite(v) for v in getattr(hist, k)):
            raise AssertionError(f"fed foe_opt: non-finite {k}")
    log(f"  FedServer foe_opt, smollm-360m, cohorts of {FED_COHORT}: ms/round "
        f"{[round(v, 1) for v in seg_ms(server.last_scan_report)]}, loss "
        f"{[round(v, 4) for v in hist.loss]}, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del state, params, server
    torch.cuda.empty_cache()

    sc = dataclasses.replace(get_scenario("labelskew_alie_partial"),
                             attack=constant_attack("alie_opt"))
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    scan = run_scenario(sc, rounds=FED_ROUNDS, seed=0, device=dev,
                        options=RoundOptions(chunk=FED_CHUNK))
    per = fed_expected(sc.rule, sc.pre)
    add_counts(total, opt_check("labelskew alie_opt scan",
                                kdispatch.launch_counts(),
                                {k: v for k, v in per.items() if v},
                                FED_ROUNDS))
    no_fallback("labelskew alie_opt")
    loop = run_scenario(sc, rounds=FED_ROUNDS, seed=0, device=dev,
                        options=RoundOptions(engine="loop"))
    same_fed_history("alie_opt scan vs loop", scan["history"], loop["history"])
    same_tree("alie_opt scan vs loop state", scan["state"], loop["state"])
    before = kdispatch.launch_counts()
    plain = run_scenario(sc, rounds=FED_ROUNDS, seed=0, device=dev,
                         options=RoundOptions(chunk=FED_CHUNK,
                                              backend="torch"))
    if kdispatch.launch_counts() != before:
        raise AssertionError("the torch backend launched a kernel")
    base, other = scan["history"].loss, plain["history"].loss
    worst = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(other, base))
    if len(other) != FED_ROUNDS or worst > BD_RTOL:
        raise AssertionError(f"alie_opt torch backend: loss rel {worst}")
    ms = seg_ms(scan["server"].last_scan_report)
    log(f"  labelskew_alie_partial with alie_opt, {FED_ROUNDS} rounds: acc "
        f"{scan['accuracy']:.4f}, ms/round per segment "
        f"{[round(v, 3) for v in ms]}; scan == loop bit for bit; torch "
        f"backend per-round loss max rel diff {worst:.3e} (tol {BD_RTOL:g})")
    return total


def phase_breakdown(dev) -> dict:
    """15d: examples/breakdown_frontier.py's sweep (n = 10, 20 rounds, 5
    rules x 4 attacks x f = 1-4 + clean lanes: 85 lanes) on the kernel and
    the torch backends: equal frontiers, window losses within 1e-4
    (a collapse flag may differ only within that of its threshold)."""
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.robustness import (DEFAULT_ATTACKS, DEFAULT_RULES,
                                        frontier_table, run_breakdown)
    from repro_torch.rounds import RoundOptions
    reps = {}
    for backend in ("cuda", "torch"):
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        t0 = time.perf_counter()
        rep = run_breakdown(rounds=BD_ROUNDS, device=dev,
                            options=RoundOptions(backend=backend))
        secs = time.perf_counter() - t0
        counts = kdispatch.launch_counts()
        reps[backend] = rep
        no_fallback(f"breakdown {backend}", autogm=True)
        lanes = len(DEFAULT_RULES) * (1 + len(DEFAULT_ATTACKS) * len(rep["fs"]))
        log(f"  breakdown on the {backend} backend: {lanes} lanes, "
            f"{rep['n_buckets']} buckets, {rep['trace_count']} round programs, "
            f"{secs:.2f} s; K3 lanes {counts['combine_lanes']}, K4 "
            f"{counts['mixtrim_dyn']}, "
            f"K5 {counts['gram_batched']} launches")
        if backend == "cuda":
            # Every bucket takes K5; cwtm's two buckets K4, the gram
            # rules' buckets K3's lane form, once a bucket-round each.
            want = dict.fromkeys(_FED_KERNELS, 0)
            want.update(gram_batched=rep["n_buckets"] * BD_ROUNDS,
                        mixtrim_dyn=2 * BD_ROUNDS,
                        combine_lanes=(rep["n_buckets"] - 2) * BD_ROUNDS)
            got = {k: counts[k] for k in _FED_KERNELS}
            if lanes != 85 or rep["n_buckets"] != 10 or got != want:
                raise AssertionError(f"breakdown: {lanes} lanes, "
                                     f"{rep['n_buckets']} buckets, launches "
                                     f"{got}, expected {want}")
            kernel_counts = got
        elif any(counts.values()):
            raise AssertionError(f"breakdown torch backend launched {counts}")
    k, t = reps["cuda"], reps["torch"]
    worst, flips = 0.0, []
    for key, cell in t["cells"].items():
        threshold = t["collapse_factor"] * t["baseline_loss"][key.split("|")[0]]
        for f, loss in cell["losses"].items():
            mine = k["cells"][key]["losses"][f]
            if math.isfinite(loss) or math.isfinite(mine):
                rel = abs(mine - loss) / max(abs(loss), 1e-30)
                worst = max(worst, rel)
                if rel > BD_RTOL:
                    raise AssertionError(f"breakdown {key} f={f}: {mine} vs {loss}")
            if k["cells"][key]["collapsed"][f] != cell["collapsed"][f]:
                near = abs(loss - threshold) <= BD_RTOL * abs(threshold)
                flips.append((key, f, near))
                if not near:
                    raise AssertionError(f"breakdown {key} f={f}: collapse "
                                         "flags differ away from the threshold")
        if k["frontier"][key] != t["frontier"][key] and not any(
                near for kk, _, near in flips if kk == key):
            raise AssertionError(f"breakdown {key}: frontier "
                                 f"{k['frontier'][key]} vs {t['frontier'][key]}")
    log(f"  kernel vs torch backend: window losses max rel diff {worst:.3e} "
        f"(tol {BD_RTOL:g}); collapse flags that differ (near the threshold): "
        f"{flips or 'none'}; frontiers equal: {k['frontier'] == t['frontier']}")
    for line in frontier_table(k).splitlines():
        log("    " + line)
    held = {key: (k["frontier"][key], k["predicted"][key.split("|")[0]])
            for key in k["frontier"] if key.startswith("nnm-")}
    log(f"  NNM rows at the theory frontier (the paper's claim, measured): "
        f"{sum(e == p for e, p in held.values())} of {len(held)} cells")
    return kernel_counts


# ---------------------------------------------------------------------------
# Phase 16: the in-round health taps and the runtime's exporters.
# ---------------------------------------------------------------------------

TAPS_STEPS, TAPS_GM_STEPS = 3, 2            # 16a
TAPS_FED_ROUNDS, TAPS_NAN_ROUNDS = 2, 20    # 16b
TAPS_FLEET_ROUNDS, TAPS_FLEET_CHUNK = 30, 10    # 16c
TAPS_SVC_ROUNDS, TAPS_SVC_CHUNK = 12, 3     # 16d
TAPS_LAYERS = 4         # 16a / 16b's depth, cut for time (of 32; 8 before)
TAPS_REL = 1e-5         # dist / cos, kernel vs torch backend taps
TAPS_TRIM_ABS = 1e-6    # trim_frac, kernel vs torch backend taps
TAPS_FLEET_RTOL = 1e-4  # the fleet's kernel vs torch backend tolerance


def fleet_taps_close(what: str, got, want, worst: dict) -> None:
    """A lane's tap columns on the kernel backend (``got``) against the
    torch backend's (``want``, FedHistory each): equal fields and NaN
    positions, and each difference within TAPS_FLEET_RTOL of the field's
    scale.  The scale of ``dist_honest`` = ||R - mbar|| is ||R|| + ||mbar||
    <= 2 ||R|| + dist (the round's direction_norm and its dist): the
    fleet's tolerance holds R and mbar, and their difference carries
    their error, not its own size's.  The cosine and the shares lie in
    [-1, 1]: scale 1.  Neighbour counts must be equal.  ``worst`` keeps
    each field's largest difference over its scale."""
    import numpy as np
    g, w = got.tap_columns(), want.tap_columns()
    if sorted(g) != sorted(w):
        raise AssertionError(f"{what}: tap fields {sorted(g)} vs {sorted(w)}")
    dn = np.asarray(want.direction_norm, np.float64)
    for k in w:
        a = np.asarray(g[k], np.float64)
        b = np.asarray(w[k], np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"{what}: {k} NaN positions differ")
        scale = 2 * dn + np.abs(b) if k == "dist_honest" else np.ones_like(b)
        ok = ~np.isnan(b)
        ratio = np.abs(a - b)[ok] / scale[ok]
        worst[k] = max(worst.get(k, 0.0), float(ratio.max(initial=0.0)))
        limit = 0.0 if k == "neighbor_count" else TAPS_FLEET_RTOL
        if (ratio > limit).any():
            raise AssertionError(f"{what}: {k} differs by {ratio.max():.3e} "
                                 f"of its scale (limit {limit:g})")


def taps_train(dev, model, params, spec_kw: dict, steps: int, taps: bool):
    """train_loop (scan engine, segments of one step) at full width, n = 8,
    f = 2, ALIE; returns (params, out, launches, peak bytes)."""
    import torch
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine
    from repro_torch.training import ByzantineConfig, TrainerConfig, train_loop
    cfg = TrainerConfig(agg=AggregatorSpec(f=F_MAIN, **spec_kw),
                        byz=ByzantineConfig(f=F_MAIN, attack="alie"),
                        taps=taps)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    p, out = train_loop(model.loss, params, lm_batches(N_MAIN), sgd(clip=2.0),
                        cfg, cosine(0.05, steps, warmup=0), steps, seed=0,
                        track_best=False, chunk=1)
    torch.cuda.synchronize(dev)
    counts = kdispatch.launch_counts()
    no_fallback(f"16a taps={taps}")
    for k in ("loss", "kappa_hat", "direction_norm"):
        if not all(math.isfinite(v) for v in out["history"][k]):
            raise AssertionError(f"16a: non-finite {k}")
    del out["state"]
    return p, out, counts, torch.cuda.max_memory_allocated(dev)


def taps_backends(dev, model, params) -> None:
    """16a: step 1's attacked stack through the kernel backend's taps
    (the NNM matrix stashed, the trim taps' mix and sort redone in
    chunks) and the torch backend's (the mixed and sorted stacks
    stashed); the kernel backend's taps call timed alone."""
    import torch
    from repro_torch.core.robust import robust_aggregate
    from repro_torch.core.theory import tree_kappa_hat
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.obs.taps import health_taps
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine
    from repro_torch.rounds import round_generator, round_seeds
    from repro_torch.training import (ByzantineConfig, TrainerConfig,
                                      build_train_step, init_state)
    from repro_torch.training.trainer import to_device
    cfg = TrainerConfig(agg=AggregatorSpec(rule="cwtm", f=F_MAIN, pre="nnm"),
                        byz=ByzantineConfig(f=F_MAIN, attack="alie"))
    opt = sgd(clip=2.0)
    step = build_train_step(model.loss, opt, cfg, cosine(0.05, 1, warmup=0))
    state = init_state(params, opt, N_MAIN, cfg)
    internals: dict = {}
    step(state, to_device(next(lm_batches(N_MAIN)), dev), internals,
         generator=round_generator(round_seeds(0, 1)[0]))
    del state
    torch.cuda.empty_cache()
    stack = kdispatch.stack_views(internals["attacked"], internals["layout"])
    got, secs = {}, {}
    for backend in ("cuda", "torch"):
        spec = AggregatorSpec(rule="cwtm", f=F_MAIN, pre="nnm", backend=backend)
        stash: dict = {}
        agg = robust_aggregate(stack, spec, internals=stash)
        tree_kappa_hat(agg, stack, N_MAIN - F_MAIN, stash)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        taps = health_taps(stack, agg, n_honest=N_MAIN - F_MAIN, f=F_MAIN,
                           rule="cwtm", pre="nnm", internals=stash)
        torch.cuda.synchronize(dev)
        secs[backend] = time.perf_counter() - t0
        got[backend] = {k: v.double().cpu().numpy()
                        for k, v in taps.to_dict().items()}
        del agg, stash, taps
        torch.cuda.empty_cache()
    k, t = got["cuda"], got["torch"]
    import numpy as np
    for f in ("neighbor_count", "mix_mass", "byz_mix_mass", "honest_mix_mass"):
        if not np.array_equal(k[f], t[f]):
            raise AssertionError(f"16a: {f} differs between the backends")
    trim = float(np.abs(k["trim_frac"] - t["trim_frac"]).max())
    rel = {f: float(abs(k[f] - t[f]) / abs(t[f]))
           for f in ("dist_honest", "cos_honest")}
    if trim > TAPS_TRIM_ABS or max(rel.values()) > TAPS_REL:
        raise AssertionError(f"16a: backends' taps: trim {trim}, {rel}")
    log(f"  step 1's stack, kernel vs torch backend taps: neighbor_count, "
        f"mix_mass equal; trim_frac max abs diff {trim:.3e} (tol "
        f"{TAPS_TRIM_ABS:g}); dist_honest / cos_honest rel diff "
        f"{rel['dist_honest']:.3e} / {rel['cos_honest']:.3e} (tol "
        f"{TAPS_REL:g}); health_taps alone: kernel backend (trim recomputed "
        f"in chunks) {1e3 * secs['cuda']:.1f} ms, torch backend (stashed) "
        f"{1e3 * secs['torch']:.1f} ms")
    log(f"    neighbor_count {k['neighbor_count'].tolist()}, byz_mix_mass "
        f"{float(k['byz_mix_mass']):.4f}, trim_frac "
        f"{[round(v, 4) for v in k['trim_frac'].tolist()]}")


def phase_taps_trainer(dev, model, params, peak7: int) -> dict:
    """16a: the main path tapped against untapped, then the backends'
    taps on step 1's stack, then NNM + GM tapped; returns launches."""
    import numpy as np
    import torch
    total: dict = {}
    runs = {}
    for taps in (False, True):
        p, out, counts, peak = taps_train(dev, model, params,
                                          dict(rule="cwtm", pre="nnm"),
                                          TAPS_STEPS, taps)
        check_launches(f"16a taps={taps}",
                       {k: counts[k] for k in ("gram", "mixtrim")},
                       {"gram": TAPS_STEPS, "mixtrim": TAPS_STEPS})
        add_counts(total, counts)
        runs[taps] = (p, out, peak)
    (p0, off, peak0), (p1, on, peak1) = runs[False], runs[True]
    same_tree("16a tapped vs untapped params", p1, p0)
    for k in ("loss", "kappa_hat", "direction_norm", "lr"):
        if on["history"][k] != off["history"][k]:
            raise AssertionError(f"16a: {k} differs tapped vs untapped")
    transfers = (off["scan_report"]["transfers"], on["scan_report"]["transfers"])
    if transfers != (1, 1):
        raise AssertionError(f"16a: metric transfers {transfers}")
    cols = on["history"]["taps"]
    mass = cols["byz_mix_mass"].astype(np.float64) + cols["honest_mix_mass"]
    tf = cols["trim_frac"]
    if (np.abs(mass - 1.0).max() > 1e-6 or (tf < 0).any() or (tf > 1).any()
            or (tf.sum(axis=1) > 2 * F_MAIN + 1e-5).any()):
        raise AssertionError(f"16a: tap semantics: mass {mass}, trim {tf}")
    ms = {t: [round(1e3 * s, 1) for _, _, s in runs[t][1]["scan_report"]
              ["segments"]] for t in (False, True)}
    log(f"  nnm+cwtm, {TAPS_STEPS} steps: tapped == untapped bit for bit "
        f"(params, loss, kappa_hat, direction_norm), 1 K1 + 1 K2 a step, "
        f"1 metric transfer each; ms/step untapped {ms[False]}, tapped "
        f"{ms[True]}; peak untapped {peak0 / 2**30:.2f} GiB, tapped "
        f"{peak1 / 2**30:.2f} GiB (phase 7: {peak7 / 2**30:.2f} GiB)")
    log(f"    dist_honest {[round(float(v), 5) for v in cols['dist_honest']]}, "
        f"cos_honest {[round(float(v), 5) for v in cols['cos_honest']]}, "
        f"byz_mix_mass {[round(float(v), 4) for v in cols['byz_mix_mass']]}, "
        f"trim_frac rows sum {[round(float(v), 4) for v in tf.sum(axis=1)]}")
    del runs, p0, p1, off, on
    torch.cuda.empty_cache()
    taps_backends(dev, model, params)
    p, out, counts, peak = taps_train(dev, model, params,
                                      dict(rule="gm", pre="nnm"),
                                      TAPS_GM_STEPS, True)
    check_launches("16a nnm+gm", {k: counts[k] for k in ("gram", "combine",
                                                          "mixtrim")},
                   {"gram": TAPS_GM_STEPS, "combine": TAPS_GM_STEPS,
                    "mixtrim": 0})
    if "trim_frac" in out["history"]["taps"]:
        raise AssertionError("16a: GM has no trim taps")
    add_counts(total, counts)
    log(f"  nnm+gm tapped, {TAPS_GM_STEPS} steps: 1 K1 + 1 K3 a step, taps "
        f"{sorted(out['history']['taps'])}; ms/step "
        f"{[round(1e3 * s, 1) for _, _, s in out['scan_report']['segments']]}, "
        f"peak {peak / 2**30:.2f} GiB")
    del p, out
    torch.cuda.empty_cache()
    return total


def phase_taps_fed(dev, model, params) -> dict:
    """16b: FedServer at 12b's full width, tapped against untapped, then
    faulty_nan_quarantine tapped against untapped; returns launches."""
    import numpy as np
    import torch
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.fed import (ClientConfig, FedConfig, FedServer,
                                 constant_attack, run_rounds, run_scenario)
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import constant
    from repro_torch.rounds import RoundOptions
    total: dict = {}
    runs = {}
    for taps in (False, True):
        cfg = FedConfig(n_clients=FED_CLIENTS, clients_per_round=FED_COHORT,
                        f=FED_F, agg=AggregatorSpec(rule="cwtm", f=FED_F,
                                                    pre="nnm"),
                        client=ClientConfig(local_steps=0, algorithm="dshb",
                                            beta=0.9), taps=taps)
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        server = FedServer(model.loss, sgd(clip=2.0), cfg, constant(0.05),
                           device=dev)
        state, hist = run_rounds(server, server.init_state(params),
                                 fed_lm_batch_fn(FED_CLIENTS), TAPS_FED_ROUNDS,
                                 schedule=constant_attack("alie", 8.0), seed=0,
                                 chunk=1)
        counts = kdispatch.launch_counts()
        no_fallback(f"16b taps={taps}")
        add_counts(total, counts)
        runs[taps] = (state["params"], hist, counts,
                      seg_ms(server.last_scan_report))
        del state, server
        torch.cuda.empty_cache()
    (p0, h0, c0, ms0), (p1, h1, c1, ms1) = runs[False], runs[True]
    same_tree("16b tapped vs untapped params", p1, p0)
    if (h0.loss, h0.kappa_hat, h0.direction_norm) != \
            (h1.loss, h1.kappa_hat, h1.direction_norm) or c0 != c1:
        raise AssertionError("16b: the tapped fed run differs")
    cols = h1.tap_columns()
    log(f"  FedServer full width, {TAPS_FED_ROUNDS} rounds: tapped == "
        f"untapped bit for bit, launches {({k: c1[k] for k in ('gram', 'mixtrim')})} "
        f"each; ms/round untapped {[round(v, 1) for v in ms0]}, tapped "
        f"{[round(v, 1) for v in ms1]}; taps {sorted(cols)}")
    del runs, p0, p1
    torch.cuda.empty_cache()
    name = "faulty_nan_quarantine"
    outs = {}
    for taps in (False, True):
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        outs[taps] = run_scenario(name, rounds=TAPS_NAN_ROUNDS, seed=0,
                                  device=dev, options=RoundOptions(
                                      chunk=FED_CHUNK, taps=taps))
        no_fallback(f"16b {name}")
        add_counts(total, kdispatch.launch_counts())
    h0, h1 = outs[False]["history"], outs[True]["history"]
    q = outs[False]["server"].last_scan_report["quarantined_count"]
    cols = h1.tap_columns()
    m_byz = h1.m_byz[0]
    if h0.loss != h1.loss or h0.kappa_hat != h1.kappa_hat:
        raise AssertionError(f"16b {name}: tapped vs untapped differ")
    if (cols["quarantined_count"].tolist() != [float(v) for v in q]
            or q != [m_byz] * TAPS_NAN_ROUNDS
            or not np.array_equal(cols["quarantine_mask_byz"].sum(axis=1),
                                  cols["quarantined_count"])
            or cols["quarantine_mask_honest"].any()):
        raise AssertionError(f"16b {name}: quarantine taps {cols} vs {q}")
    log(f"  {name}, {TAPS_NAN_ROUNDS} rounds tapped == untapped bit for "
        f"bit; quarantined_count tap {int(cols['quarantined_count'][0])} "
        f"every round (the untapped run's metric too), all on the Byzantine "
        f"rows' mask; ms/round tapped "
        f"{statistics.median(seg_ms(outs[True]['server'].last_scan_report)):.2f}"
        f", untapped "
        f"{statistics.median(seg_ms(outs[False]['server'].last_scan_report)):.2f}"
        f" (medians)")
    return total


def phase_taps_fleet(dev) -> dict:
    """16c: the grid's cwtm|nnm and gm|nnm buckets on FleetRunner, tapped
    against untapped (bitwise, equal launches) and the kernel backend's
    tap columns against the torch backend's; returns launches."""
    from repro_torch.fleet import FleetRunner
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import grid
    from repro_torch.rounds import RoundOptions
    jobs = [j for j in grid.build_jobs(full=True, alpha=0.1,
                                       steps=TAPS_FLEET_ROUNDS)
            if j.label.startswith(("cwtm|nnm|", "gm|nnm|"))]
    total: dict = {}
    res, counts, ms = {}, {}, {}
    for name, opts in (("untapped", RoundOptions(chunk=TAPS_FLEET_CHUNK)),
                       ("tapped", RoundOptions(chunk=TAPS_FLEET_CHUNK,
                                               taps=True)),
                       ("torch", RoundOptions(chunk=TAPS_FLEET_CHUNK,
                                              taps=True, backend="torch"))):
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        runner = FleetRunner(jobs, device=dev, options=opts)
        if runner.n_buckets != 2:
            raise AssertionError(f"16c: {runner.n_buckets} buckets")
        res[name] = runner.run()
        counts[name] = service_launches()
        if name != "torch":
            no_fallback(f"16c {name}")
            add_counts(total, counts[name])
        ms[name] = ms_per_bucket_round((b, n, s) for b, _, n, s
                                       in runner.segment_log)
    want = add_counts(lane_expected("cwtm", "nnm", TAPS_FLEET_ROUNDS, 5),
                      lane_expected("gm", "nnm", TAPS_FLEET_ROUNDS, 5))
    check_launches("16c untapped", counts["untapped"], want)
    check_launches("16c tapped", counts["tapped"], want)
    if any(counts["torch"].values()):
        raise AssertionError("16c: the torch backend launched a kernel")
    worst: dict = {}
    for a, b, t in zip(res["tapped"], res["untapped"], res["torch"]):
        for col in ("loss", "direction_norm", "kappa_hat"):
            if getattr(a.history, col) != getattr(b.history, col):
                raise AssertionError(f"16c {a.label}: {col} differs")
        same_tree(f"16c {a.label}: state", a.state, b.state)
        if b.history.tap_columns():
            raise AssertionError(f"16c {b.label}: untapped run has taps")
        fleet_taps_close(f"16c {a.label}", a.history, t.history, worst)
    log(f"  cwtm|nnm and gm|nnm (5 lanes each, n=17, f={F_GRID}), "
        f"{TAPS_FLEET_ROUNDS} rounds: tapped == untapped bit for bit, "
        f"launches {counts['tapped']} each; ms per bucket-round untapped "
        f"{ {k: round(v, 3) for k, v in ms['untapped'].items()} }, tapped "
        f"{ {k: round(v, 3) for k, v in ms['tapped'].items()} }; kernel vs "
        f"torch backend tap columns, largest difference over each field's "
        f"scale (limit {TAPS_FLEET_RTOL:g}, neighbor_count 0): "
        f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }")
    return total


def phase_taps_service(dev) -> dict:
    """16d: two tapped jobs through FleetService, a snapshot mid-run, a
    restore; the tap columns equal the uninterrupted run's bit for bit;
    returns launches."""
    import dataclasses
    import tempfile
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import grid
    from repro_torch.resilience import CheckpointConfig
    from repro_torch.rounds import RoundOptions
    from repro_torch.serving import FleetService
    cells = {j.label: j for j in grid.build_jobs(full=True, alpha=0.1,
                                                 steps=TAPS_SVC_ROUNDS)}

    def jobs():
        return [dataclasses.replace(cells[label], eval_every=TAPS_SVC_CHUNK)
                for label in ("cwtm|nnm|alie", "cwtm|nnm|sf")]

    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    ref = FleetService(chunk=TAPS_SVC_CHUNK, options=RoundOptions(taps=True),
                       device=dev)
    handles = [ref.submit(j) for j in jobs()]
    want = [h.result() for h in handles]
    with tempfile.TemporaryDirectory() as tmp:
        opts = RoundOptions(taps=True, checkpoint=CheckpointConfig(
            dir=tmp, sync=True))
        svc = FleetService(chunk=TAPS_SVC_CHUNK, options=opts, device=dev)
        ids = [svc.submit(j).job_id for j in jobs()]
        svc.step()
        svc.step()
        del svc
        restored = FleetService.restore(opts.checkpoint,
                                        jobs=dict(zip(ids, jobs())),
                                        device=dev)
        got = [restored.handle_of(i).result() for i in ids]
    no_fallback("16d")
    for a, b in zip(got, want):
        cols = b.history.tap_columns()
        if not cols or "trim_frac" not in cols:
            raise AssertionError(f"16d {b.label}: no tap columns")
        same_fed_history(f"16d {b.label}", a.history, b.history)
        same_tree(f"16d {b.label}: state", a.state, b.state)
    counts = service_launches()
    log(f"  2 tapped lanes (cwtm|nnm), {TAPS_SVC_ROUNDS} rounds in segments "
        f"of {TAPS_SVC_CHUNK}: restored after the step-2 snapshot, every "
        f"history (tap columns included) and state equals the uninterrupted "
        f"run bit for bit; launches {counts}")
    return counts


def phase_health(dev) -> dict:
    """16e: python -m repro_torch.launch.health on the card: both files,
    the JSONL round trip equal to snapshot(), a monotone Chrome trace, and
    the attack switch visible in the taps; returns launches."""
    import json as _json
    import tempfile
    import numpy as np
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import health
    from repro_torch.obs import runtime as obs_runtime
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = health.main(["--device", dev.type, "--export-dir", tmp])
        wall = time.perf_counter() - t0
        sizes = [os.path.getsize(out[k]) for k in ("jsonl", "chrome")]
        lines = obs_runtime.import_jsonl(out["jsonl"])
        with open(out["chrome"]) as fh:
            rows = _json.load(fh)["traceEvents"]
    counts = kdispatch.launch_counts()
    no_fallback("16e")
    events = [line for line in lines if line["kind"] != "counter"]
    names = {e["name"] for e in events}
    ts = [r["ts"] for r in rows]
    if (min(sizes) == 0 or events != obs_runtime.snapshot()
            or ts != sorted(ts) or not {"rounds.segment",
                                        "kernels.dispatch"} <= names):
        raise AssertionError(f"16e: export sizes {sizes}, names {names}")
    cols, sw = out["columns"], out["switch"]
    moved = {k: (float(np.mean(cols[k][:sw])), float(np.mean(cols[k][sw:])))
             for k in ("byz_mix_mass", "dist_honest")}
    if any(a == b for a, b in moved.values()):
        raise AssertionError(f"16e: the switch does not show: {moved}")
    log(f"  launch.health: {len(cols['dist_honest'])} rounds in {wall:.2f} s, "
        f"switch at round {sw}: byz_mix_mass {moved['byz_mix_mass'][0]:.4f} "
        f"-> {moved['byz_mix_mass'][1]:.4f}, dist_honest "
        f"{moved['dist_honest'][0]:.4f} -> {moved['dist_honest'][1]:.4f}; "
        f"JSONL {sizes[0]} B ({len(lines)} lines, round trip == snapshot()), "
        f"Chrome trace {sizes[1]} B ({len(rows)} rows, ts nondecreasing); "
        f"launches K1 {counts['gram']}, K2 {counts['mixtrim']}")
    return {k: counts[k] for k in ("gram", "mixtrim")}


def phase_taps(dev, peak7: int) -> dict:
    """Phase 16; returns its launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(get_config("smollm-360m").replace(
        num_layers=TAPS_LAYERS))
    params = model.init(0, dev)
    log(f"-- 16a. the main path tapped, full-width smollm-360m at "
        f"{TAPS_LAYERS} of 32 layers, n=8 f=2 ALIE")
    total = phase_taps_trainer(dev, model, params, peak7)
    secs = {"16a": time.perf_counter() - t0}
    log("-- 16b. FedServer tapped at full width; faulty_nan_quarantine")
    add_counts(total, phase_taps_fed(dev, model, params))
    del params
    torch.cuda.empty_cache()
    secs["16b"] = time.perf_counter() - t0 - sum(secs.values())
    log("-- 16c. tapped fleet lanes: the grid's cwtm|nnm and gm|nnm buckets")
    add_counts(total, phase_taps_fleet(dev))
    secs["16c"] = time.perf_counter() - t0 - sum(secs.values())
    log("-- 16d. tapped lanes through FleetService, snapshot and restore")
    add_counts(total, phase_taps_service(dev))
    secs["16d"] = time.perf_counter() - t0 - sum(secs.values())
    log("-- 16e. python -m repro_torch.launch.health on the card")
    add_counts(total, phase_health(dev))
    secs["16e"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  seconds: { {k: round(v, 1) for k, v in secs.items()} }")
    return total


#: Phase 17: the attention-family zoo at its published widths, depth and
#: worker count cut: (label, arch, layers, n, f, per-worker batch, seq,
#: steps).  seq counts a VLM's patches.
ZOO_RUNS = (("17a", "mixtral-8x22b", 1, 8, 2, 4, 128, 3),
            ("17b", "qwen2-7b", 1, 4, 1, 4, 128, 2),
            ("17c", "internvl2-2b", 4, 8, 2, 4, 384, 2))
ZOO_CHUNK = 1 << 25             # torch-backend columns per leaf chunk (17)


def zoo_backends(label: str, attacked, n: int, f: int) -> None:
    """Step 1's attacked (n, D) stack through robust_aggregate on the
    kernel and torch backends, both over one layout of column chunks of
    at most ZOO_CHUNK (the kernel path still sees one flat stack; the
    torch path's per-leaf sort then fits beside two stacks)."""
    import torch
    from repro_torch.core.robust import robust_aggregate
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    n_rows, d = attacked.shape
    segs = tuple((c0, min(ZOO_CHUNK, d - c0), (min(ZOO_CHUNK, d - c0),))
                 for c0 in range(0, d, ZOO_CHUNK))
    layout = kdispatch.StackLayout([None] * len(segs), segs, n_rows, d)
    stack = kdispatch.stack_views(attacked, layout)
    got, want = (robust_aggregate(stack, AggregatorSpec(rule="cwtm", f=f,
                                                        pre="nnm", backend=b))
                 for b in ("cuda", "torch"))
    worst, tol = 0.0, 0.0
    for a, b in zip(got, want):
        err, t = max_err(a, b)
        worst, tol = max(worst, err), max(tol, t)
    if worst > tol:
        raise AssertionError(f"{label}: backends disagree: {worst} > {tol}")
    log(f"  {label} robust_aggregate cuda vs torch on step 1's attacked "
        f"stack ({len(segs)} chunks): max_abs_err={worst:.3e} (tol {tol:.3e} "
        f"= {RTOL} x max|torch|) OK")
    del got, want, stack
    torch.cuda.empty_cache()


def phase_zoo_run(dev, card: str, label: str, arch: str, layers: int, n: int,
                  f: int, batch: int, seq: int, steps: int) -> dict:
    """One phase-17 or phase-19 run; returns its launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.data import build_heterogeneous, make_lm_corpus, worker_batches
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch.launch_config import fsdp_keys_for
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine
    from repro_torch.training import (
        ByzantineConfig, TrainerConfig, build_train_step, init_state,
        split_params,
    )
    from repro_torch.training.trainer import to_device
    from repro_torch.tree import tree_leaves, tree_paths
    t_run = time.perf_counter()
    full = get_config(arch)
    fsdp_keys = fsdp_keys_for(full)       # of the FULL config, then the cut
    cfg = full.replace(num_layers=layers)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(0, dev)
    robust, fsdp = split_params(params, fsdp_keys)
    width = sum(p.numel() for p in robust)
    experts = sum(p.numel() for p in fsdp)
    seqs, topics = make_lm_corpus(n_tokens=400_000, vocab=cfg.vocab_size,
                                  seq_len=seq + 1, seed=0)
    ds = build_heterogeneous({"seq": seqs, "y": topics}, "y", n, alpha=0.1,
                             seed=0)
    raw = worker_batches(ds, batch, seed=0)
    tcfg = TrainerConfig(agg=AggregatorSpec(rule="cwtm", f=f, pre="nnm"),
                         byz=ByzantineConfig(f=f, attack="alie"),
                         fsdp_keys=fsdp_keys)
    optimizer = sgd(clip=2.0)
    step_fn = build_train_step(model.loss, optimizer, tcfg,
                               cosine(0.05, steps, warmup=0))
    state = init_state(params, optimizer, n, tcfg)
    del params, robust, fsdp
    generator = torch.Generator().manual_seed(0)
    extra = {"ssm": f", {cfg.ssm_heads} rwkv heads of {cfg.ssm_head_dim}",
             "hybrid": f", {cfg.ssm_heads} mamba2 heads of {cfg.ssm_head_dim}"
                       f" (state {cfg.ssm_state}), shared block every "
                       f"{cfg.attn_every}",
             "encdec": f", {cfg.encoder_layers} encoder layers over "
                       f"{cfg.encoder_seq} frames"}.get(cfg.family, "")
    log(f"  {label} {arch}: {layers} layer(s) of {full.num_layers}, d "
        f"{cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}{extra}, n={n} f={f}, batch "
        f"{batch} x {seq}; fsdp_keys {fsdp_keys}; robust D = {width:,}, "
        f"expert params (mean gradient) {experts:,}")
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    counts: dict = {}
    hist = {"loss": [], "kappa_hat": [], "direction_norm": [], "ms": []}
    peak = 0
    for t in range(steps):
        host = lm_batch(next(raw)["seq"], cfg, seq)
        if cfg.family == "vlm":
            # Seeded patches: the CLI's zeros would give the projector no
            # gradient, and it would not move.
            host["patches"] = np.random.default_rng(t).standard_normal(
                host["patches"].shape, dtype=np.float32)
        wb = to_device(host, dev)
        internals = {} if t == 0 else None
        before = state["params"] if t == 0 else None
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, wb, internals, generator=generator)
        torch.cuda.synchronize(dev)
        hist["ms"].append(1e3 * (time.perf_counter() - t0))
        for k in ("loss", "kappa_hat", "direction_norm"):
            hist[k].append(float(metrics[k]))
        if t > 0:
            continue
        # Step 1: every leaf but the norm gains moved (robust and FSDP
        # alike; a bf16 gain of 1.0 keeps its bits under an update below
        # half its ulp, 2^-9), the path's launches and fallbacks, then the
        # backends on its stack (their launches and memory are not the
        # path's).
        paths = tree_paths(before)
        gains = {p for p, d in zip(paths, tree_leaves(model.param_descs()))
                 if d.init == "ones"}
        still = [p for p, a, b in zip(paths, tree_leaves(before),
                                      tree_leaves(state["params"]))
                 if torch.equal(a, b)]
        if set(still) - gains:
            raise AssertionError(f"{label}: leaves {still} did not move")
        log(f"  {label} step 1 moved {len(paths) - len(still)} of "
            f"{len(paths)} leaves (unchanged, norm gains: {still})")
        del before
        counts = dict(kdispatch.launch_counts())
        no_fallback(label)
        peak = torch.cuda.max_memory_allocated(dev)
        zoo_backends(label, internals["attacked"], n, f)
        del internals
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
    counts = add_counts(counts, kdispatch.launch_counts())
    no_fallback(label)
    peak = max(peak, torch.cuda.max_memory_allocated(dev))
    for k in ("loss", "kappa_hat", "direction_norm"):
        if not all(math.isfinite(v) for v in hist[k]):
            raise AssertionError(f"{label}: non-finite {k}: {hist[k]}")
    rec = kdispatch.last_dispatch()
    if rec is None or rec.backend != "cuda" or rec.fallbacks:
        raise AssertionError(f"{label}: dispatch did not stay on the kernels:\n"
                             f"{rec.describe() if rec else None}")
    want = {k: steps if k in ("gram", "mixtrim") else 0
            for k in kdispatch.KERNELS}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    log(f"  {label} {arch}: ms/step {[round(v, 1) for v in hist['ms']]}, loss "
        f"{[round(v, 4) for v in hist['loss']]}, kappa_hat "
        f"{[round(v, 4) for v in hist['kappa_hat']]}, |R| "
        f"{[round(v, 4) for v in hist['direction_norm']]}, launches K1 "
        f"{counts['gram']} K2 {counts['mixtrim']}, peak {peak / 2**30:.2f} "
        f"GiB, D = {width:,}, experts {experts:,}, "
        f"{time.perf_counter() - t_run:.1f} s; card {card}")
    del state
    torch.cuda.empty_cache()
    return counts


def phase_zoo(dev, card: str) -> dict:
    """Phase 17; returns its launches."""
    total: dict = {}
    for run in ZOO_RUNS:
        log(f"-- {run[0]}. {run[1]} at full width, {run[2]} layer(s), "
            f"n={run[3]} f={run[4]}")
        add_counts(total, phase_zoo_run(dev, card, *run))
    return total


# ---------------------------------------------------------------------------
# Phase 18: hierarchical fleet lanes and the lane forms of K2's median, K3,
# K6 and K7.
# ---------------------------------------------------------------------------

HIER_FLEET_ROUNDS = 10          # 18b: the grid's buckets, hierarchical (20 before)
HIER_FLEET_SIZES = (2, 3)       # bucket sizes: 9 means (K5), 6 (K6's fold)
HIER_BIG_ROUNDS, HIER_BIG_S = 3, 3   # 18b: the (8, 17, 2^24) bucket
HIER_SVC_ROUNDS, HIER_SVC_CHUNK = 8, 2   # 18c
#: The lane forms and the single-lane kernels they must not fall back to.
_HIER_KERNELS = ("bucketgram_lanes", "bucketmeans_lanes", "gram_batched",
                 "mixtrim_dyn", "mixtrim_lanes", "combine_lanes", "gram",
                 "mixtrim", "combine", "bucketgram", "bucketmeans")


def same_bits(a, b) -> bool:
    """Bit for bit, NaN payloads included (the raw words compared)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    word = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.contiguous().view(word), b.contiguous().view(word))


def lane_assign(perms, s: int):
    """(B, n) bucket ids of each lane's permutation, buckets of s."""
    import torch
    return torch.div(torch.argsort(perms, dim=1), s, rounding_mode="floor")


def lanes_vs_single(what: str, got, single) -> None:
    """Each lane of a lane-form output equals the single-lane kernel on
    that lane bit for bit (``single(k)``)."""
    for k in range(got.shape[0]):
        if not same_bits(got[k], single(k)):
            raise AssertionError(f"{what}: lane {k} differs from the "
                                 "single-lane kernel")


def phase_lane_kernels(dev, rate: float) -> dict:
    """18a: K6 / K7, K3 and K2's median lane forms at the fleet's kernel
    shape (8, 17, 2^24), each against its plain version, each lane against
    the single-lane kernel on that lane (bit for bit), a rerun (bit for
    bit), timed beside the bound and a library call; then inf / NaN rows
    at a ragged D and the grid's shapes; returns the kernels-line rows."""
    import torch
    from repro_torch.kernels import (
        bucket_means_gram_lanes_ref, bucketgram, bucketgram_lanes,
        bucketgram_lanes_perms, bucketmeans, bucketmeans_lanes,
        bucketmeans_lanes_perms, combine, combine_lanes, combine_lanes_ref,
        combine_ref, gram_batched, mixtrim, mixtrim_lanes, mixtrim_lanes_ref,
        mixtrim_ref,
    )
    from repro_torch.kernels.bucketgram import assignment_matrix
    b, n, d = FLEET_BIG
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    x = torch.randn((b, n, d), generator=gen, device=dev)
    perms = torch.stack([torch.randperm(n, generator=torch.Generator()
                                        .manual_seed(k)) for k in range(b)])
    perms = perms.to(dev)
    rows = {}

    def bmats(assign, nb):
        return torch.stack([assignment_matrix(assign[k], nb)
                            for k in range(b)])

    # K6 lanes, s = 3: 6 means, the register Gram.  Timed on the fleet's
    # route (each lane's permutation; the kernel builds the buckets), held
    # bit for bit to the id route (bucket ids; the plan built on the host).
    a3, nb3 = lane_assign(perms, 3), -(-n // 3)
    a2, nb2 = lane_assign(perms, 2), -(-n // 2)
    for xx, tag in ((x, "fp32"), (x.bfloat16(), "bf16")):
        el = xx.element_size()
        log(f"-- K6 bucketgram_lanes {tag} B={b} n={n} D={d}, s=3 "
            f"({nb3} means)")
        y, g = bucketgram_lanes_perms(xx, perms, 3)
        yi, gi = bucketgram_lanes(xx, a3, nb3)
        if not (same_bits(y, yi) and same_bits(g, gi)):
            raise AssertionError(f"K6 lanes {tag}: the permutation route "
                                 "differs from the id route")
        del yi, gi
        wy, wg = bucket_means_gram_lanes_ref(xx, a3, nb3)
        bnd = bound(1.0 * el * b * n * d + el * b * nb3 * d
                    + 4 * b * nb3 * nb3 + 8 * b * n,
                    2.0 * b * n * d + b * nb3 * (nb3 + 1) * d, rate)
        ms = time_ms(lambda: bucketgram_lanes_perms(xx, perms, 3))
        pms = time_ms(lambda: bucket_means_gram_lanes_ref(xx, a3, nb3))
        fn = check if tag == "fp32" else check_ulp
        err = fn(f"K6 lanes means {tag}", y, wy, ms, pms, bnd)
        for k in range(b):
            agree(f"K6 lanes Gram {tag} lane {k}", g[k], wg[k])
        lanes_vs_single(f"K6 lanes means {tag}", y,
                        lambda k: bucketgram(xx[k], a3[k], nb3)[0])
        lanes_vs_single(f"K6 lanes Gram {tag}", g,
                        lambda k: bucketgram(xx[k], a3[k], nb3)[1])
        y2, g2 = bucketgram_lanes_perms(xx, perms, 3)
        if not (same_bits(y, y2) and same_bits(g, g2)):
            raise AssertionError(f"K6 lanes {tag} is not bitwise repeatable")
        log(f"  K6 lanes {tag}: the permutation and id routes and every "
            f"lane's single-lane K6 agree bit for bit (means and Gram); "
            f"bitwise equal over two runs; {100 * bnd[0] / ms:.0f} % of the "
            f"bound")
        if tag == "fp32":
            rows["bucketgram_lanes"] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=pms, bound=bnd,
                                            library_ms=None)
        del y, g, wy, wg, y2, g2

        log(f"-- K7 bucketmeans_lanes {tag}, s=2 ({nb2} means, ragged "
            f"tail), and K7 + K5")
        y = bucketmeans_lanes_perms(xx, perms, 2)
        if not same_bits(y, bucketmeans_lanes(xx, a2, nb2)):
            raise AssertionError(f"K7 lanes {tag}: the permutation route "
                                 "differs from the id route")
        wy, _ = bucket_means_gram_lanes_ref(xx, a2, nb2, with_gram=False)
        bnd = bound(1.0 * el * b * n * d + el * b * nb2 * d + 8 * b * n,
                    2.0 * b * n * d, rate)
        ms = time_ms(lambda: bucketmeans_lanes_perms(xx, perms, 2))
        pms = time_ms(lambda: bucket_means_gram_lanes_ref(xx, a2, nb2,
                                                          with_gram=False))
        # In bf16 the library's product rounds the 1/|bucket| weights to
        # bf16 too (bmm takes one dtype): the same work, another result.
        bm = bmats(a2, nb2).to(xx.dtype)
        lib = time_ms(lambda: torch.bmm(bm, xx))
        del bm
        err = fn(f"K7 lanes {tag}", y, wy, ms, pms, bnd, lib)
        lanes_vs_single(f"K7 lanes {tag}", y,
                        lambda k: bucketmeans(xx[k], a2[k], nb2))
        if not same_bits(y, bucketmeans_lanes_perms(xx, perms, 2)):
            raise AssertionError(f"K7 lanes {tag} is not bitwise repeatable")
        if tag == "fp32":
            rows["bucketmeans_lanes"] = dict(max_abs_err=err, ms=ms,
                                             plain_ms=pms, bound=bnd,
                                             library_ms=lib)
        del y, wy
        # With the Gram above 8 means: K7 writes the fp32 means, K5 their
        # Gram.  The single-lane form folds it with K1, which splits D
        # otherwise: both Grams are held to the plain version, not to each
        # other bit for bit.
        ms7 = ms
        y, g = bucketgram_lanes_perms(xx, perms, 2)
        _, wg = bucket_means_gram_lanes_ref(xx, a2, nb2)
        ms = time_ms(lambda: bucketgram_lanes_perms(xx, perms, 2))
        for k in range(b):
            agree(f"K7 + K5 lanes Gram {tag} lane {k}", g[k], wg[k])
            y1, g1 = bucketgram(xx[k], a2[k], nb2)
            if not same_bits(y[k], y1):
                raise AssertionError(f"K7 + K5 lanes {tag}: lane {k} means "
                                     "differ from the single-lane K6")
            agree(f"single-lane K6 (K7 + K1) Gram {tag} lane {k}", g1,
                  wg[k])
        if tag == "fp32" and not same_bits(g, gram_batched(y)):
            raise AssertionError("K7 + K5 lanes: the Gram is not K5's on "
                                 "the means")
        log(f"  K7 lanes {tag}: the permutation and id routes and every "
            f"lane's single-lane K7 agree bit for bit, bitwise repeatable, "
            f"{100 * bnd[0] / ms7:.0f} % of the bound; K7 + K5 with the Gram "
            f"{ms:.3f} ms")
        del y, g, wg
        torch.cuda.empty_cache()

    log(f"-- K3 combine_lanes B={b} n={n} D={d}")
    c = torch.softmax(torch.randn((b, n), generator=gen, device=dev), -1)
    r = combine_lanes(x, c)
    bnd = bound(4.0 * b * n * d + 4 * b * d + 4 * b * n, 2.0 * b * n * d,
                rate)
    ms = time_ms(lambda: combine_lanes(x, c))
    pms = time_ms(lambda: combine_lanes_ref(x, c))
    lib = time_ms(lambda: torch.bmm(c[:, None], x))
    err = check("K3 lanes fp32", r, combine_lanes_ref(x, c), ms, pms, bnd,
                lib)
    lanes_vs_single("K3 lanes", r, lambda k: combine(x[k], c[k]))
    if not same_bits(r, combine_lanes(x, c)):
        raise AssertionError("K3 lanes is not bitwise repeatable")
    log(f"  K3 lanes: every lane equals the single-lane K3 bit for bit, "
        f"bitwise repeatable; {100 * bnd[0] / ms:.0f} % of the bound")
    rows["combine_lanes"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                 bound=bnd, library_ms=lib)
    del r

    m = torch.softmax(torch.randn((b, n, n), generator=gen, device=dev), -1)
    for mm in (m, None):
        tag = "mix" if mm is not None else "no-mix"
        log(f"-- K2 median lanes (mixtrim_lanes) B={b} n={n} D={d} {tag}")
        got = mixtrim_lanes(x, mm)
        bnd = bound(4.0 * b * n * d + 4 * b * d
                    + (4 * b * n * n if mm is not None else 0),
                    2.0 * b * n * n * d if mm is not None else 0.0, rate)
        ms = time_ms(lambda: mixtrim_lanes(x, mm))
        pms = time_ms(lambda: mixtrim_lanes_ref(x, mm))
        # n = 17 is odd: torch.median's lower median is the median.
        lib = None if mm is not None else \
            time_ms(lambda: torch.median(x, dim=1).values)
        err = check(f"K2 median lanes {tag}", got, mixtrim_lanes_ref(x, mm),
                    ms, pms, bnd, lib)
        lanes_vs_single(f"K2 median lanes {tag}", got,
                        lambda k: mixtrim(x[k], None if mm is None else mm[k],
                                          0, "med"))
        if not same_bits(got, mixtrim_lanes(x, mm)):
            raise AssertionError(f"K2 median lanes {tag} is not bitwise "
                                 "repeatable")
        log(f"  K2 median lanes {tag}: every lane equals the single-lane K2 "
            f"bit for bit, bitwise repeatable; {100 * bnd[0] / ms:.0f} % of "
            f"the bound")
        if mm is not None:
            rows["mixtrim_lanes"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                         bound=bnd, library_ms=None)
        del got

    # Non-finite rows at a ragged D (the element-wise paths): lane 1 holds
    # +-inf rows, lane 2 a NaN row; lane 0 must stay finite.
    xs = x[:, :, :(1 << 20) + 3].clone()
    xs[1, 4, 100:5000] = float("inf")
    xs[1, 9, 3000:7000] = -float("inf")
    xs[2, 7, 2000:9000] = float("nan")
    outs = {"K6 lanes": (bucketgram_lanes(xs, a3, nb3)[0],
                         bucket_means_gram_lanes_ref(xs, a3, nb3)[0]),
            "K7 lanes": (bucketmeans_lanes(xs, a2, nb2),
                         bucket_means_gram_lanes_ref(xs, a2, nb2)[0]),
            "K3 lanes": (combine_lanes(xs, c), combine_lanes_ref(xs, c)),
            "K2 median lanes": (mixtrim_lanes(xs, m),
                                mixtrim_lanes_ref(xs, m))}
    for what, (got, want) in outs.items():
        agree(f"{what} inf / nan rows ({int(torch.isnan(want).sum())} NaN "
              "outputs)", got, want)
        if bool(torch.isnan(got[0]).any()):
            raise AssertionError(f"{what}: a NaN reached lane 0")
    y6, g6 = bucketgram_lanes_perms(xs, perms, 3)
    y7 = bucketmeans_lanes_perms(xs, perms, 2)
    if not (same_bits(y6, outs["K6 lanes"][0])
            and same_bits(y7, outs["K7 lanes"][0])):
        raise AssertionError("K6 / K7 lanes inf / nan: the permutation route "
                             "differs from the id route")
    for k in range(b):
        y1, g1 = bucketgram(xs[k], a3[k], nb3)
        if not (same_bits(y6[k], y1) and same_bits(g6[k], g1)):
            raise AssertionError(f"K6 lanes inf / nan: lane {k} differs "
                                 "from the single-lane K6")
    log("  inf / NaN rows: the 0 * inf spread stays in its lane; K6 lanes "
        "equal the single-lane K6 bit for bit there, both routes")
    del xs, outs, y6, g6, y7, x
    torch.cuda.empty_cache()

    # The grid's shapes: the lane forms against their plain versions.
    gb, gn, gd = FLEET_GRID
    xg = torch.randn((gb, gn, gd), generator=gen, device=dev)
    pg = torch.stack([torch.randperm(gn, generator=torch.Generator()
                                     .manual_seed(k)) for k in range(gb)])
    pg = pg.to(dev)
    cg = torch.softmax(torch.randn((gb, gn), generator=gen, device=dev), -1)
    mg = torch.softmax(torch.randn((gb, gn, gn), generator=gen, device=dev),
                       -1)
    for s in HIER_FLEET_SIZES:
        ag, nbg = lane_assign(pg, s), -(-gn // s)
        y, g = bucketgram_lanes_perms(xg, pg, s)
        yi, gi = bucketgram_lanes(xg, ag, nbg)
        if not (same_bits(y, yi) and same_bits(g, gi)):
            raise AssertionError(f"K6 lanes grid shape s={s}: the permutation "
                                 "route differs from the id route")
        wy, wg = bucket_means_gram_lanes_ref(xg, ag, nbg)
        agree(f"K6 lanes grid shape s={s} means", y, wy)
        for k in range(gb):
            agree(f"K6 lanes grid shape s={s} Gram lane {k}", g[k], wg[k])
    # K3 and K2's median, lane forms and single-lane kernels, each lane
    # against the plain version and the two forms bit for bit.
    r = combine_lanes(xg, cg)
    agree("K3 lanes grid shape", r, combine_lanes_ref(xg, cg))
    for k in range(gb):
        agree(f"K3 grid shape lane {k}", combine(xg[k], cg[k]),
              combine_ref(xg[k], cg[k]))
    lanes_vs_single("K3 lanes grid shape", r,
                    lambda k: combine(xg[k], cg[k]))
    for mm in (mg, None):
        tag = "mix" if mm is not None else "no-mix"
        med = mixtrim_lanes(xg, mm)
        agree(f"K2 median lanes grid shape {tag}", med,
              mixtrim_lanes_ref(xg, mm))
        single = [mixtrim(xg[k], None if mm is None else mm[k], 0, "med")
                  for k in range(gb)]
        for k in range(gb):
            agree(f"K2 median grid shape {tag} lane {k}", single[k],
                  mixtrim_ref(xg[k], None if mm is None else mm[k], 0,
                              "med"))
        lanes_vs_single(f"K2 median lanes grid shape {tag}", med,
                        lambda k: single[k])
    return rows


def hier_grid_jobs(rounds: int, backend: str = "auto") -> list:
    """The grid's NNM + CWTM, NNM + cwmed and NNM + GM cells (5 attacks
    each), hierarchical at each of HIER_FLEET_SIZES, and its CWTM cells
    without NNM at the first (the means alone, K7): 7 buckets of 5."""
    import dataclasses
    from repro_torch.launch import grid
    out = []
    for s in HIER_FLEET_SIZES:
        cells = ("cwtm|nnm|", "cwmed|nnm|", "gm|nnm|") + (
            ("cwtm|None|",) if s == HIER_FLEET_SIZES[0] else ())
        for j in grid.build_jobs(full=True, alpha=0.1, steps=rounds,
                                 backend=backend):
            if not j.label.startswith(cells):
                continue
            agg = dataclasses.replace(j.cfg.agg, hier=True, bucket_size=s)
            out.append(dataclasses.replace(
                j, label=f"{j.label}|s{s}",
                cfg=dataclasses.replace(j.cfg, agg=agg)))
    return out


def hier_round_expected(rule: str, pre, nb: int, rounds: int) -> dict:
    """One hierarchical bucket's launches over ``rounds``: K6's lane form
    once a bucket-round (K7's without a Gram consumer: CWTM or cwmed
    without NNM), K5 once more where a Gram is needed above 8 means, and
    one launch of the rule's lane kernel; nothing per lane."""
    want = dict.fromkeys(_HIER_KERNELS, 0)
    gram = pre == "nnm" or rule in _GRAM_RULES
    want["bucketgram_lanes" if gram else "bucketmeans_lanes"] = rounds
    want["gram_batched"] = rounds if gram and nb > 8 else 0
    key = {"cwtm": "mixtrim_dyn", "cwmed": "mixtrim_lanes"}.get(
        rule, "combine_lanes")
    want[key] = rounds
    return want


def close_histories(what: str, got, want, rtol: float, worst: dict,
                    norm_rtol: Optional[float] = None) -> None:
    """Per-round loss within ``rtol`` and direction_norm within
    ``norm_rtol`` (default ``rtol``) of ``want``'s; the worst relative
    differences go to ``worst``."""
    for col in ("loss", "direction_norm"):
        tol = rtol if col == "loss" or norm_rtol is None else norm_rtol
        a, b = getattr(got.history, col), getattr(want.history, col)
        if len(a) != len(b):
            raise AssertionError(f"{what}: {len(a)} rounds vs {len(b)}")
        for u, v in zip(a, b):
            rel = abs(u - v) / max(abs(v), 1e-30)
            worst[col] = max(worst.get(col, 0.0), rel)
            if not rel <= tol:
                raise AssertionError(f"{what} {col}: {u} vs {v} (rtol {tol})")


def _quad_loss(p, batch):
    """0.5 |theta|^2 - c_i sum(theta) for client i, c_i = sin(1.3 i + 0.5)
    (gradient theta - c_i in fp32).  The c_i are distinct in every pair,
    so no two pairs of honest rows lie at tied distances.  The sums over
    the 2^24 coordinates accumulate in fp64 (no fp64 copy): as an fp32
    ``theta @ theta`` the 8-lane and the 1-lane products reduced them in
    other orders, 1.6e-4 apart on the card, which hid the aggregate's own
    agreement with the solo run."""
    import torch
    c = torch.sin(1.3 * batch["idx"].double().reshape(-1)[0] + 0.5)
    th = p["theta"]
    sq = (th * th).sum(dtype=torch.float64)
    return (0.5 * sq - c * th.sum(dtype=torch.float64)).float(), {}


def _idx_batch(cohort, n_flip, rng):
    import numpy as np
    return {"idx": np.asarray(cohort)[:, None, None]}


def _quad_big_job(label: str, seed: int, dev, opt, backend: str = "auto"):
    """tests/test_hier.py's quadratic job widened to the fleet's kernel
    shape: 17 clients, all of them each round, f = 4, D = 2^24 seeded
    parameters; client i is pulled towards c_i (:func:`_quad_loss`, so the
    worker rows differ), ALIE, NNM + CWTM, hier with
    buckets of HIER_BIG_S.  The loss, batch function and ``opt`` are
    shared objects: they are bucket-key material."""
    import torch
    from repro_torch.core import AggregatorSpec
    from repro_torch.fed import ClientConfig, FedConfig, constant_attack
    from repro_torch.fleet import FleetJob
    n, d = FLEET_BIG[1], FLEET_BIG[2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(100 + seed)
    cfg = FedConfig(n_clients=n, clients_per_round=n, f=4,
                    agg=AggregatorSpec(rule="cwtm", f=4, pre="nnm",
                                       hier=True, bucket_size=HIER_BIG_S,
                                       backend=backend),
                    client=ClientConfig(local_steps=0, algorithm="dshb",
                                        beta=0.9))
    return FleetJob(
        label=label, cfg=cfg, loss_fn=_quad_loss, optimizer=opt,
        params={"theta": torch.randn((d,), generator=gen, device=dev)},
        batch_fn=_idx_batch,
        rounds=HIER_BIG_ROUNDS, seed=seed,
        schedule=constant_attack("alie", 2.0), lr_fn=lambda r: 0.1)


def phase_hier_fleet(dev) -> dict:
    """18b: hierarchical FleetRunner buckets at the grid's widths and one
    8-lane bucket at the kernel shape; exact launches per bucket-round,
    each lane against its 1-lane solo run, the kernel backend against the
    torch backend; returns launches."""
    import torch
    from repro_torch.fleet import FleetRunner
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.optim import sgd
    total: dict = {}
    jobs = hier_grid_jobs(HIER_FLEET_ROUNDS)
    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    runner = FleetRunner(jobs, device=dev)
    if runner.n_buckets != 7 or len(jobs) != 35:
        raise AssertionError(f"18b: {runner.n_buckets} buckets, "
                             f"{len(jobs)} jobs")
    t0 = time.perf_counter()
    res = runner.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = service_launches(_HIER_KERNELS)
    no_fallback("18b grid")
    want: dict = {}
    for bkt in runner.buckets:
        agg = bkt.jobs[0].cfg.agg
        add_counts(want, hier_round_expected(
            agg.rule, agg.pre, -(-FLEET_GRID[1] // agg.bucket_size),
            HIER_FLEET_ROUNDS))
    check_launches("18b grid buckets", counts, want)
    add_counts(total, counts)
    worst_solo: dict = {}
    for job, r in zip(jobs, res):
        if not all(math.isfinite(v) for v in r.history.loss
                   + r.history.direction_norm):
            raise AssertionError(f"18b {r.label}: non-finite history")
        kdispatch.reset_launch_counts()
        solo = FleetRunner([job], device=dev).run()[0]
        agg = job.cfg.agg
        check_launches(f"18b solo {r.label}", service_launches(_HIER_KERNELS),
                       hier_round_expected(agg.rule, agg.pre,
                                           -(-FLEET_GRID[1]
                                             // agg.bucket_size),
                                           HIER_FLEET_ROUNDS))
        add_counts(total, service_launches(_HIER_KERNELS))
        # As 14b: GM's direction_norm within 1e-4 (Weiszfeld's fp32
        # iterations amplify another batch shape's rounding).
        close_histories(f"18b {r.label} vs solo", r, solo, 1e-5, worst_solo,
                        1e-4 if agg.rule == "gm" else None)
    kdispatch.reset_launch_counts()
    again = FleetRunner(hier_grid_jobs(HIER_FLEET_ROUNDS, backend="torch"),
                        device=dev).run()
    if any(kdispatch.launch_counts().values()):
        raise AssertionError("18b: the torch backend launched a kernel")
    worst_torch: dict = {}
    for a, b in zip(res, again):
        close_histories(f"18b {a.label} cuda vs torch", a, b, 1e-4,
                        worst_torch)
    per: dict = {}
    for bi, _, nr, sec in runner.segment_log:
        per.setdefault(bi, []).append(1e3 * sec / nr)
    meds = {"|".join(runner.buckets[bi].jobs[0].label.split("|")[:2]) + "|s"
            + str(runner.buckets[bi].jobs[0].cfg.agg.bucket_size):
            round(statistics.median(v), 3) for bi, v in per.items()}
    log(f"  35 jobs (cwtm / cwmed / gm | nnm x 5 attacks x s in "
        f"{HIER_FLEET_SIZES}, cwtm | None x 5 at s = "
        f"{HIER_FLEET_SIZES[0]}), 7 buckets of 5 lanes, {HIER_FLEET_ROUNDS} "
        f"rounds, {wall:.2f} s; launches {counts} (one lane-form launch a "
        f"bucket-round, K5 again at 9 means, none per lane); against the "
        f"1-lane solo runs max rel diff "
        f"{ {k: float(f'{v:.3e}') for k, v in worst_solo.items()} } (tol "
        f"1e-5, gm's direction_norm 1e-4); cuda vs torch backend "
        f"{ {k: float(f'{v:.3e}') for k, v in worst_torch.items()} } (tol "
        f"1e-4); ms per bucket-round {meds}")

    # One bucket of 8 lanes at the kernel shape (one optimizer object: it
    # is bucket-key material).
    opt = sgd(clip=1.0)
    big = [_quad_big_job(f"quad{k}", k, dev, opt)
           for k in range(FLEET_BIG[0])]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kdispatch.reset_launch_counts()
    runner = FleetRunner(big, device=dev)
    if runner.n_buckets != 1:
        raise AssertionError(f"18b big: {runner.n_buckets} buckets")
    t0 = time.perf_counter()
    res = runner.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    counts = service_launches(_HIER_KERNELS)
    no_fallback("18b big")
    check_launches("18b big bucket", counts, hier_round_expected(
        "cwtm", "nnm", -(-FLEET_BIG[1] // HIER_BIG_S), HIER_BIG_ROUNDS))
    add_counts(total, counts)
    worst_big: dict = {}
    for job, r in zip(big, res):
        if not all(math.isfinite(v) for v in r.history.loss
                   + r.history.direction_norm):
            raise AssertionError(f"18b {r.label}: non-finite history")
        kdispatch.reset_launch_counts()
        solo = FleetRunner([job], device=dev).run()[0]
        check_launches(f"18b solo {r.label}", service_launches(_HIER_KERNELS),
                       hier_round_expected("cwtm", "nnm", -(-FLEET_BIG[1]
                                                            // HIER_BIG_S),
                                           HIER_BIG_ROUNDS))
        add_counts(total, service_launches(_HIER_KERNELS))
        close_histories(f"18b {r.label} vs solo", r, solo, 1e-5, worst_big)
    torch_jobs = [_quad_big_job(f"quad{k}", k, dev, opt, backend="torch")
                  for k in range(2)]
    before = kdispatch.launch_counts()
    tres = FleetRunner(torch_jobs, device=dev).run()
    if kdispatch.launch_counts() != before:
        raise AssertionError("18b big: the torch backend launched a kernel")
    worst_bt: dict = {}
    for a, b in zip(res[:2], tres):
        close_histories(f"18b {a.label} cuda vs torch", a, b, 1e-4, worst_bt)
    seg = [1e3 * sec / nr for _, _, nr, sec in runner.segment_log]
    log(f"  8 lanes x 17 workers x D = 2^24 (hier s={HIER_BIG_S}, NNM + "
        f"CWTM, ALIE), {HIER_BIG_ROUNDS} rounds, {wall:.2f} s ("
        f"{min(seg):.1f}-{max(seg):.1f} ms a round), peak "
        f"{peak / 2**30:.2f} GiB; launches {counts}; against the solo runs "
        f"{ {k: float(f'{v:.3e}') for k, v in worst_big.items()} } (tol "
        f"1e-5); two lanes cuda vs torch "
        f"{ {k: float(f'{v:.3e}') for k, v in worst_bt.items()} } (tol 1e-4)")
    del big, res, runner
    torch.cuda.empty_cache()
    return total


def phase_hier_service(dev) -> dict:
    """18c: hierarchical jobs through FleetService, a snapshot mid-run, a
    restore; every history and state equals the uninterrupted service's
    bit for bit; returns launches."""
    import dataclasses
    import tempfile
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.resilience import CheckpointConfig
    from repro_torch.rounds import RoundOptions
    from repro_torch.serving import FleetService
    cells = {j.label: j for j in hier_grid_jobs(HIER_SVC_ROUNDS)}

    def jobs():
        return [dataclasses.replace(cells[label], eval_every=HIER_SVC_CHUNK)
                for label in ("cwtm|nnm|alie|s2", "cwtm|nnm|sf|s2",
                              "cwmed|nnm|mimic|s3", "gm|nnm|foe|s3")]

    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    ref = FleetService(chunk=HIER_SVC_CHUNK, device=dev)
    want = [h.result() for h in [ref.submit(j) for j in jobs()]]
    with tempfile.TemporaryDirectory() as tmp:
        opts = RoundOptions(checkpoint=CheckpointConfig(dir=tmp, sync=True))
        svc = FleetService(chunk=HIER_SVC_CHUNK, options=opts, device=dev)
        ids = [svc.submit(j).job_id for j in jobs()]
        svc.step()
        svc.step()
        del svc
        restored = FleetService.restore(opts.checkpoint,
                                        jobs=dict(zip(ids, jobs())),
                                        device=dev)
        got = [restored.handle_of(i).result() for i in ids]
    no_fallback("18c")
    for a, b in zip(got, want):
        same_fed_history(f"18c {b.label}", a.history, b.history)
        same_tree(f"18c {b.label}: state", a.state, b.state)
    counts = service_launches(_HIER_KERNELS)
    log(f"  4 hierarchical lanes in 3 buckets (cwtm|nnm s=2, cwmed|nnm s=3, "
        f"gm|nnm s=3), {HIER_SVC_ROUNDS} rounds in segments of "
        f"{HIER_SVC_CHUNK}: restored after the step-2 snapshot, every "
        f"history and state equals the uninterrupted service bit for bit; "
        f"launches {counts}")
    return counts


def time_samples(fn, calls: int, reps: int = REPS) -> list:
    """``reps`` samples of ms per call, each CUDA events around ``calls``
    launches, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / calls)
    return out


#: 18d: calls a sample queues at a launch-sized shape (at (8, 17, 2^24),
#: 5), and the busy launch ahead of a split sample (torch.cuda._sleep
#: cycles, ~34 ms at 1.98 GHz; quadrupled while it does not outlast the
#: host's enqueues).
LAUNCH_CALLS = 200
BUSY_CYCLES = 1 << 26


def split_sample(fn, calls: int) -> tuple[float, float]:
    """One sample of (host us, device us) per call of ``fn``: ``calls``
    calls queued behind a busy launch, the host clock around the enqueues
    (the host never waits on the device) and CUDA events around the
    launches (they run back to back, so the host's cost is hidden).  The
    busy launch must still run when the host has enqueued the last call."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = BUSY_CYCLES
    for _ in range(4):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        covered = not s.query()
        e.record()
        e.synchronize()
        if covered:
            return 1e6 * host / calls, 1e3 * s.elapsed_time(e) / calls
        cycles *= 4
    raise AssertionError("18d: the busy launch never outlasted the enqueues")


def _spread(v: list, fmt: str = ".4f") -> str:
    return f"{statistics.median(v):{fmt}} ({min(v):{fmt}}-{max(v):{fmt}})"


def launch_pair(label: str, kernel, library, lib_name: Optional[str],
                calls: int, bnd: tuple) -> dict:
    """``kernel`` against ``library`` (None: the kernel alone) in turns,
    REPS rounds (kernel first in even rounds, library first in odd ones):
    each round takes one turn sample (CUDA events around ``calls``
    back-to-back calls: max(host, device) per call) and one split sample
    (:func:`split_sample`) of each.  Logs medians with the min-max and
    whether the kernel wins or loses beyond the turns' spread, beside the
    bound ``bnd`` (ms, what bounds it)."""
    fns = [("kernel", kernel)] + ([("library", library)] if library else [])
    got = {k: {"turn_ms": [], "host_us": [], "device_us": []} for k, _ in fns}
    for i in range(REPS):
        for key, fn in (fns if i % 2 == 0 else fns[::-1]):
            got[key]["turn_ms"] += time_samples(fn, calls, 1)
            host, device = split_sample(fn, calls)
            got[key]["host_us"].append(host)
            got[key]["device_us"].append(device)
    k = got["kernel"]
    line = (f"  18d {label}: turns {_spread(k['turn_ms'])} ms, host "
            f"{_spread(k['host_us'], fmt='.1f')} us, device "
            f"{_spread(k['device_us'], fmt='.1f')} us, bound "
            f"{1e3 * bnd[0]:.3f} us ({bnd[1]})")
    if library:
        lb = got["library"]
        kt, lt = k["turn_ms"], lb["turn_ms"]
        verdict = ("loses beyond the spread" if min(kt) > max(lt)
                   else "wins beyond the spread" if max(kt) < min(lt)
                   else "the spreads overlap")
        line += (f" | {lib_name}: turns {_spread(lt)} ms, host "
                 f"{_spread(lb['host_us'], fmt='.1f')} us, device "
                 f"{_spread(lb['device_us'], fmt='.1f')} us | median "
                 f"{'<=' if statistics.median(kt) <= statistics.median(lt) else '>'}"
                 f" the library's; {verdict}")
    log(line)
    return {"label": label, "library": lib_name, "bound_us": 1e3 * bnd[0],
            "bound_by": bnd[1],
            **{f"{key}_{m}": statistics.median(v) for key, d in got.items()
               for m, v in d.items()}}


def launch_bucket_rows(x, perms, rate: float, out: list) -> None:
    """18d's K6 / K7 lanes at a grid shape on the fleet's route (each
    lane's permutation): K6 at s = 3 (6 means, the register Gram), K7 at
    s = 2 (9 means, ragged tail) against torch.bmm(bm, x) (in bf16 bmm
    rounds the 1/|bucket| weights to bf16 too), and K7 + K5 (the Gram of
    the 9 means), fp32 and bf16; each held to its plain version (bf16
    means within one ulp), printed beside its bound (the stack, the
    permutations and the outputs each moved once)."""
    import torch
    from repro_torch.kernels import (
        bucket_means_gram_lanes_ref, bucketgram_lanes_perms,
        bucketmeans_lanes_perms,
    )
    from repro_torch.kernels.bucketgram import assignment_matrix
    b, n, d = x.shape
    for xx, tag in ((x, "fp32"), (x.bfloat16(), "bf16")):
        el = xx.element_size()
        for s, gram in ((3, True), (2, False), (2, True)):
            a, nb = lane_assign(perms, s), -(-n // s)
            kind = ("K6" if nb <= 8 else "K7 + K5") if gram else "K7"
            label = f"{kind} lanes s={s} {tag} {(b, n, d)}"
            if gram:
                kernel = (lambda xx=xx, s=s:
                          bucketgram_lanes_perms(xx, perms, s))
                y, g = kernel()
            else:
                kernel = (lambda xx=xx, s=s:
                          bucketmeans_lanes_perms(xx, perms, s))
                y, g = kernel(), None
            wy, wg = bucket_means_gram_lanes_ref(xx, a, nb, with_gram=gram)
            err, tol = max_err(y, wy, ulp=tag == "bf16")
            if err > tol:
                raise AssertionError(f"18d {label}: means disagree with the "
                                     f"plain version ({err:.3e} > {tol:.3e})")
            if gram:
                for k in range(b):
                    agree(f"18d {label} Gram lane {k}", g[k], wg[k])
            library, lib_name = None, None
            if not gram:
                bm = torch.stack([assignment_matrix(a[k], nb)
                                  for k in range(b)]).to(xx.dtype)
                library = lambda bm=bm, xx=xx: torch.bmm(bm, xx)
                lib_name = "torch.bmm(bm, x)" + (
                    " (bf16 weights)" if tag == "bf16" else "")
            bnd = bound(1.0 * el * b * (n + nb) * d + 8.0 * b * n
                        + (4.0 * b * nb * nb if gram else 0.0),
                        2.0 * b * n * d
                        + (1.0 * b * nb * (nb + 1) * d if gram else 0.0), rate)
            log(f"  18d {label}: means within {'one bf16 ulp and ' if tag == 'bf16' else ''}"
                f"the fp32 tolerance of the plain version ({err:.3e} <= "
                f"{tol:.3e})")
            out.append(launch_pair(label, kernel, library, lib_name,
                                   LAUNCH_CALLS, bnd))


def no_sync_routes(x, perms, m, fs) -> None:
    """Each fleet-route call of the median lanes, K4 and K6 / K7's lanes
    (fp32 and bf16, with and without the mix, K7 + K5) once under
    torch.cuda.set_sync_debug_mode("error"): a call that waits for the
    card raises."""
    import torch
    from repro_torch.kernels import (
        bucketgram_lanes_perms, bucketmeans_lanes_perms, mixtrim_dyn,
        mixtrim_lanes,
    )
    calls = {}
    for xx, tag in ((x, "fp32"), (x.bfloat16(), "bf16")):
        calls.update({
            f"median lanes mix {tag}": lambda xx=xx: mixtrim_lanes(xx, m),
            f"median lanes {tag}": lambda xx=xx: mixtrim_lanes(xx, None),
            f"K4 mix {tag}": lambda xx=xx: mixtrim_dyn(xx, m, fs),
            f"K6 lanes s=3 {tag}":
                lambda xx=xx: bucketgram_lanes_perms(xx, perms, 3),
            f"K7 lanes s=2 {tag}":
                lambda xx=xx: bucketmeans_lanes_perms(xx, perms, 2),
            f"K7 + K5 lanes s=2 {tag}":
                lambda xx=xx: bucketgram_lanes_perms(xx, perms, 2)})
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls.values():
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"  18d no synchronizing call (sync-debug mode \"error\") in "
        f"{len(calls)} fleet-route calls: {', '.join(calls)}")


def phase_launch_sizes(dev, rate: float) -> list:
    """18d: every kernel the grid and the fed rounds launch, at their own
    shapes, against the PyTorch call that computes the same function where
    there is one (:func:`launch_pair`): K3 lanes at the grid's (5, 17 / 9,
    2842) and at (8, 17, 2^24) against torch.bmm(c[:, None], x); K3, K1 at
    the fed cohorts (10 / 12 / 17, 2842) against c @ x and
    torch.mm(x, x.T); K5 at the grid's shapes against torch.bmm(x, x.mT);
    K4 (f = 4, with and without the mix) alone; the median lanes with and
    without the mix against torch.median; K6 / K7's lanes on the fleet's
    permutation route at the grid's (5, 17, 2842), fp32 and bf16
    (:func:`launch_bucket_rows`), and every fleet-route call there once
    under sync-debug mode "error" (:func:`no_sync_routes`).  Each kernel
    is first held to
    its plain version on the same inputs, and printed beside its bound (each
    fp32 input read once, each output written once).  Returns the logged
    medians."""
    import torch
    from repro_torch.core.bucketing import adjusted_f_dyn
    from repro_torch.kernels import (
        combine, combine_lanes, combine_lanes_ref, combine_ref, gram,
        gram_batched, gram_batched_ref, gram_ref, mixtrim_dyn,
        mixtrim_dyn_ref, mixtrim_lanes, mixtrim_lanes_ref,
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    out = []

    def pair(label, kernel, plain, bytes_in, flops, library=None,
             lib_name=None, calls=LAUNCH_CALLS):
        got = kernel()
        agree(f"18d {label} vs its plain version", got, plain())
        bnd = bound(bytes_in + 4.0 * got.numel(), flops, rate)
        out.append(launch_pair(label, kernel, library, lib_name, calls, bnd))

    for b, n, d in (FLEET_GRID, FLEET_GRID_BKT, FLEET_BIG):
        x = torch.randn((b, n, d), generator=gen, device=dev)
        c = torch.softmax(torch.randn((b, n), generator=gen, device=dev), -1)
        calls = 5 if d > 1 << 20 else LAUNCH_CALLS
        pair(f"K3 lanes {(b, n, d)}", lambda: combine_lanes(x, c),
             lambda: combine_lanes_ref(x, c), 4.0 * b * n * (d + 1),
             2.0 * b * n * d, lambda: torch.bmm(c[:, None], x),
             "torch.bmm(c[:, None], x)", calls)
        if d > 1 << 20:
            del x, c
            continue
        pair(f"K5 {(b, n, d)}", lambda: gram_batched(x),
             lambda: gram_batched_ref(x), 4.0 * b * n * d,
             1.0 * b * n * (n + 1) * d, lambda: torch.bmm(x, x.mT),
             "torch.bmm(x, x.mT)")
        if n != FLEET_GRID[1]:
            continue
        fs = adjusted_f_dyn(torch.full((b,), F_GRID, device=dev), n)
        m = torch.softmax(torch.randn((b, n, n), generator=gen, device=dev), -1)
        for mm, tag in ((m, "mix"), (None, "no mix")):
            mix_in = 4.0 * b * n * n if mm is not None else 0.0
            mix_ops = 2.0 * b * n * n * d if mm is not None else 0.0
            pair(f"K4 {tag} {(b, n, d)}", lambda: mixtrim_dyn(x, mm, fs),
                 lambda: mixtrim_dyn_ref(x, mm, fs),
                 4.0 * b * n * d + 4 * b + mix_in, mix_ops + b * n * d)
            pair(f"median lanes {tag} {(b, n, d)}",
                 lambda: mixtrim_lanes(x, mm), lambda: mixtrim_lanes_ref(x, mm),
                 4.0 * b * n * d + mix_in, mix_ops,
                 *((lambda: torch.median(x, dim=1), "torch.median(x, dim=1)")
                   if mm is None else ()))
        perms = torch.stack([torch.randperm(n, generator=torch.Generator()
                                            .manual_seed(k))
                             for k in range(b)]).to(dev)
        launch_bucket_rows(x, perms, rate, out)
        no_sync_routes(x, perms, m, fs)
    torch.cuda.empty_cache()
    d = FLEET_GRID[2]
    for n in (10, 12, 17):
        x = torch.randn((n, d), generator=gen, device=dev)
        c = torch.softmax(torch.randn((n,), generator=gen, device=dev), -1)
        pair(f"K3 ({n}, {d})", lambda: combine(x, c), lambda: combine_ref(x, c),
             4.0 * n * (d + 1), 2.0 * n * d, lambda: c @ x, "c @ x")
        pair(f"K1 ({n}, {d})", lambda: gram(x), lambda: gram_ref(x),
             4.0 * n * d, 1.0 * n * (n + 1) * d, lambda: torch.mm(x, x.T),
             "torch.mm(x, x.T)")
    log(json.dumps({"launch_sizes": out}))
    return out


def phase_hier(dev, rate: float) -> tuple[dict, dict]:
    """Phase 18; returns (kernels-line rows, launches of 18b-c)."""
    t0 = time.perf_counter()
    log("-- 18a. the lane forms at the fleet's kernel shape "
        f"{FLEET_BIG}")
    rows = phase_lane_kernels(dev, rate)
    secs = {"18a": time.perf_counter() - t0}
    log("-- 18b. hierarchical fleet lanes: the grid's buckets and an 8-lane "
        "bucket at D = 2^24")
    total = phase_hier_fleet(dev)
    secs["18b"] = time.perf_counter() - t0 - sum(secs.values())
    log("-- 18c. hierarchical lanes through FleetService, snapshot and "
        "restore")
    add_counts(total, phase_hier_service(dev))
    secs["18c"] = time.perf_counter() - t0 - sum(secs.values())
    log("-- 18d. every kernel of the grid and the fed rounds at its own "
        "shapes, host and device per call, against the library call")
    phase_launch_sizes(dev, rate)
    secs["18d"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  seconds: { {k: round(v, 1) for k, v in secs.items()} }")
    idle = [k for k in ("bucketgram_lanes", "bucketmeans_lanes",
                        "mixtrim_lanes", "combine_lanes") if not total.get(k)]
    if idle:
        raise AssertionError(f"phase 18: lane forms never launched on the "
                             f"fleet's path: {idle}")
    return rows, total


# ---------------------------------------------------------------------------
# Phase 19: the attention-free and encoder-decoder families.
# ---------------------------------------------------------------------------

#: Phase 19: rwkv6-3b, zamba2-2.7b (depth cut; two groups of six, so the
#: shared block runs twice) and whisper-base (full depth; 1500 zero
#: frames as launch.train's lm_batch makes them, 128 tokens) at their
#: published widths; fields as ZOO_RUNS.  zamba2 runs n = 6: at n = 8 the
#: torch backend's NNM mix, a third (8, 747,364,160) fp32 stack beside the
#: two of the step, does not fit the card.
FAMILY_RUNS = (("19a", "rwkv6-3b", 4, 8, 2, 4, 256, 3),
               ("19b", "zamba2-2.7b", 12, 6, 2, 4, 256, 2),
               ("19c", "whisper-base", 6, 8, 2, 4, 128, 3))
#: 19d: gla_chunked against gla_naive at the families' scan widths, batch
#: 4 x seq 256, chunk 64: (arch, heads, K, V, RWKV's bonus u, a per-head
#: scalar decay as Mamba2's).
SCAN_WIDTHS = (("rwkv6-3b", 40, 64, 64, True, False),
               ("zamba2-2.7b", 80, 64, 64, False, True))


def phase_scan(dev, card: str) -> None:
    """19d: the chunked scan against its token-by-token oracle on the card,
    both plain torch in fp32 (RTOL: the two sum in other orders), decays
    drawn in [-MAX_STEP_DECAY, 0); each timed (no kernel: the reference's
    scan has no pallas_call)."""
    import torch
    from repro_torch.models import linear_scan as ls
    b, s, chunk = 4, 256, 64
    for arch, h, k, v, bonus, scalar in SCAN_WIDTHS:
        gen = torch.Generator(device=dev).manual_seed(19)
        q, kk = (torch.randn((b, s, h, k), generator=gen, device=dev)
                 for _ in range(2))
        vv = torch.randn((b, s, h, v), generator=gen, device=dev)
        w = -ls.MAX_STEP_DECAY * torch.rand(
            (b, s, h, 1 if scalar else k), generator=gen, device=dev)
        w = w.expand(b, s, h, k)
        u = torch.randn((h, k), generator=gen, device=dev) if bonus else None
        y, st = ls.gla_chunked(q, kk, vv, w, chunk=chunk, u=u)
        ny, ns = ls.gla_naive(q, kk, vv, w, u=u)
        for what, got, want in (("y", y, ny), ("state", st, ns)):
            if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
                raise AssertionError(f"19d {arch}: non-finite {what}")
            err, tol = max_err(got, want)
            if err > tol:
                raise AssertionError(f"19d {arch}: {what} chunked vs naive "
                                     f"{err} > {tol}")
            log(f"  19d {arch} (H {h}, K {k}, V {v}, u {bonus}): {what} "
                f"chunked vs naive max_abs_err={err:.3e} (tol {tol:.3e} = "
                f"{RTOL} x max|naive|) OK")
        ms = time_ms(lambda: ls.gla_chunked(q, kk, vv, w, chunk=chunk, u=u))
        naive_ms = time_ms(lambda: ls.gla_naive(q, kk, vv, w, u=u), reps=3)
        log(f"  19d {arch}: gla_chunked {ms:.3f} ms, gla_naive {naive_ms:.3f} "
            f"ms at ({b}, {s}, {h}, {k} / {v}), chunk {chunk}; card {card}")


def phase_families(dev, card: str) -> dict:
    """Phase 19; returns its launches."""
    total: dict = {}
    for run in FAMILY_RUNS:
        log(f"-- {run[0]}. {run[1]} at full width, {run[2]} layer(s), "
            f"n={run[3]} f={run[4]}")
        add_counts(total, phase_zoo_run(dev, card, *run))
    log("-- 19d. gla_chunked against gla_naive at the families' widths")
    phase_scan(dev, card)
    return total


#: Phase 20: cached decode and greedy serving at published widths, seeded
#: bf16 weights: (label, arch, layers, batch, prompt, new); max_seq =
#: prompt + new.  arctic-480b runs 1 of 35 layers: ``materialize`` draws
#: each expert leaf in fp32 before its cast, (1, 128, 7168, 4864) = 17.8
#: GB beside 28.1 GB of bf16 weights; two layers would not fit.  mixtral
#: runs 2 of 56 layers.  Cut for time, smollm, minitron, internvl2 and
#: rwkv6 run a quarter of their depth and zamba2 12 of 54 (two groups);
#: qwen2-7b (20b, the serving cell's shape) and whisper run at full
#: depth.
#: ``new`` is cut to keep the phase near a minute (the steps are
#: launch-bound, 10-50 ms each): 32 (qwen2-7b 64) where nothing else
#: bounds it; rwkv6 / zamba2 keep 64, since their forward check runs
#: prompt + new tokens, a whole number of 64-token scan chunks.
SERVE_RUNS = (("20a", "smollm-360m", 8, 4, 64, 32),
              ("20b", "qwen2-7b", 28, 8, 256, 64),
              ("20c", "minitron-8b", 8, 4, 64, 32),
              ("20d", "mixtral-8x22b", 2, 4, 64, 32),
              ("20e", "arctic-480b", 1, 4, 64, 32),
              ("20f", "internvl2-2b", 6, 4, 64, 32),
              ("20g", "rwkv6-3b", 8, 4, 64, 64),
              ("20h", "zamba2-2.7b", 12, 4, 64, 64),
              ("20i", "whisper-base", 6, 4, 64, 32))
#: bf16 decode against the bf16 forward of the same tokens: max |dec -
#: fwd| over every step's logits, as a share of max |fwd|.  The two run
#: the same math on other shapes ((B, 1, d) products against (B, S, d),
#: a masked softmax over the cache against one over the sequence), so
#: cuBLAS sums in other orders and a bf16 rounding of an activation
#: (relative 2^-9) may land one ulp apart; such flips are rare and carry
#: through the residual stream and the final norm into logits that are a
#: bf16 product themselves, of magnitude ~4 (ulp 2^-5, 1/128 of it).
#: 1/16 is 8 such ulps at the largest logit.  The recurrent families
#: amplify bf16 rounding through depth: on the CPU at 32 layers (d 512 /
#: 1024) rwkv6's bf16 forward and bf16 decode both land 22-24 % of max
#: |logits| from the fp32 forward of the same weights, and 8.6-10.8 % from
#: each other; zamba2's forward also rounds each Mamba2 conv output to
#: bf16 where decode keeps it fp32 (the reference's arithmetic; on the CPU
#: at d = 256: 3.6 % at 6 layers, 16.7 % at 54).  They are held at 1/4 in
#: bf16, and in fp32 at full depth below.
SERVE_REL = 1.0 / 16
SERVE_REL_RECURRENT = 1.0 / 4
#: fp32 decode against the fp32 forward (TF32 off): 1e-4 of max |fwd|.
SERVE_FP32_REL = 1e-4
#: fp32 runs: (label, arch, layers, batch, prompt, new).
SERVE_FP32_RUNS = (("20a fp32", "smollm-360m", 8, 4, 64, 32),
                   ("20d fp32", "mixtral-8x22b", 1, 4, 64, 32),
                   ("20g fp32", "rwkv6-3b", 8, 4, 64, 64),
                   ("20h fp32", "zamba2-2.7b", 12, 4, 64, 64))


def serve_forward(model, params, tokens, frames):
    """The port's full forward over ``tokens`` (B, S), as decode sees it:
    a MoE at a capacity factor where no token drops (one decoded token
    never does; a forward over S may): 8, or E / k where that is larger,
    so that an expert holds a whole row (greedy rows repeat tokens, and
    repeated tokens pick the same experts: arctic's 128 experts at 8 hold
    17 a row, and the forward dropped tokens); a VLM as the same weights
    in a dense config without the projector (decode embeds text only); an
    encoder-decoder over ``frames``."""
    import torch
    from repro_torch.models import build_model
    cfg = model.cfg
    if cfg.num_experts:
        cf = max(8.0, cfg.num_experts / cfg.experts_per_token)
        model = build_model(cfg.replace(capacity_factor=cf))
    if cfg.family == "vlm":
        model = build_model(cfg.replace(family="dense"))
        params = {k: v for k, v in params.items() if k != "projector"}
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    with torch.inference_mode():
        return model.forward(params, batch)


class RouterPicks:
    """Keeps the top-k expert ids of every MoE dispatch inside a ``with``
    block (``moe.top_k`` wrapped: a list append, no device work and no
    host sync), each (B, t, k)."""

    def __init__(self):
        self.picks: list = []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = orig = moe.top_k

        def top_k(probs, k):
            vals, idx = orig(probs, k)
            self.picks.append(idx)
            return vals, idx

        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k = self._orig


class RouterReplay:
    """Inside a ``with`` block, each MoE dispatch of a forward over S
    positions routes as decode did: ``moe.top_k`` returns decode's expert
    ids (``dec_picks``: one (B, 1, k) a step and layer, step-major) for the
    first T positions and its own beyond, the gates read from the
    forward's own probabilities at those ids.  A bf16 rounding can tip a
    near-tie of the router between decode and the forward, after which a
    row follows other experts; replayed, the two differ by rounding only.
    ``flips()`` counts the (position, layer) decisions where the forward's
    own top-k set differed from decode's."""

    def __init__(self, dec_picks: list, layers: int):
        import torch
        self.dec = [torch.cat(dec_picks[l::layers], 1) for l in range(layers)]
        self.own: list = []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = orig = moe.top_k

        def top_k(probs, k):
            _, own = orig(probs, k)
            dec = self.dec[len(self.own) % len(self.dec)]
            self.own.append(own)
            import torch
            idx = torch.cat([dec, own[:, dec.shape[1]:]], 1)
            return torch.gather(probs, -1, idx), idx

        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k = self._orig

    def flips(self) -> int:
        return sum(int((own[:, :dec.shape[1]].sort(-1).values
                        != dec.sort(-1).values).any(-1).sum())
                   for own, dec in zip(self.own, self.dec))


def phase_serve_run(dev, card: str, label: str, arch: str, layers: int,
                    batch: int, prompt: int, new: int,
                    dtype=None) -> dict:
    """One phase-20 run: greedy ServeEngine.generate through
    launch.serve.clocked_generate (prefill ms, each step's ms, each step's
    logits), held to the port's forward of the same tokens (a MoE's
    forward replaying decode's routing: RouterReplay); no kernel launch.
    Returns its numbers."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import roofline
    from repro_torch.launch.serve import clocked_generate
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_leaves
    t_run = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(num_layers=layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(0, dev)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    prompts = np.random.default_rng(20).integers(0, cfg.vocab_size,
                                                 (batch, prompt))
    max_seq = prompt + new
    eng = ServeEngine(model, params, batch_size=batch, max_seq=max_seq)
    frames = cache = None
    if cfg.family == "encdec":
        gen = torch.Generator(device=dev).manual_seed(20)
        frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=dev)
        cache = model.prefill_cache(params, frames, batch, max_seq)

    kdispatch.reset_launch_counts()
    kdispatch.reset_fallbacks()
    with RouterPicks() as dec_route:
        run = clocked_generate(eng, prompts, new, cache, keep_logits=True)
    torch.cuda.synchronize(dev)
    launches = {k: v for k, v in kdispatch.launch_counts().items() if v}
    if launches:
        raise AssertionError(f"{label}: serving launched kernels: {launches}")
    no_fallback(label)
    tokens, dec = run["tokens"], run.pop("logits")
    if tokens.shape != (batch, new) or tokens.dtype != np.int32:
        raise AssertionError(f"{label}: tokens {tokens.shape} {tokens.dtype}")
    if not np.array_equal(dec.argmax(-1).cpu().numpy(), tokens):
        raise AssertionError(f"{label}: tokens are not the logits' argmax")
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"{label}: non-finite decode logits")

    # The forward of prompt + generated (prompt + new positions: a whole
    # number of the scan's chunks for rwkv6 / zamba2; the last token, never
    # fed to decode, gives the one position not compared).
    seq = torch.cat([torch.as_tensor(prompts, device=dev),
                     torch.as_tensor(tokens, device=dev).long()], 1)
    replay = RouterReplay(dec_route.picks, cfg.num_layers) \
        if cfg.num_experts else contextlib.nullcontext()
    with replay:
        fwd = serve_forward(model, params, seq, frames)[:, prompt - 1:-1]
    flips = replay.flips() if cfg.num_experts else None
    err = float((dec - fwd).abs().max())
    scale = float(fwd.abs().max())
    rel = SERVE_FP32_REL if cfg.dtype == torch.float32 else \
        SERVE_REL_RECURRENT if cfg.family in ("ssm", "hybrid") else SERVE_REL
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    if err > rel * scale:
        raise AssertionError(f"{label}: decode vs forward {err:.4g} > "
                             f"{rel:.4g} x {scale:.4g}")
    del fwd, dec

    # Bound per decoded token: the median step's bytes (roofline), MoE
    # reading the experts its batch's top-k picked at each step.
    step_ms = run["step_ms"][1:]
    ms = statistics.median(step_ms)
    reads = [None] * (new - 1)
    if cfg.num_experts:
        picks = dec_route.picks[-(new - 1) * cfg.num_layers:]
        reads = [float(sum(int(torch.unique(x).numel()) for x in
                           picks[i * cfg.num_layers:(i + 1) * cfg.num_layers]))
                 for i in range(new - 1)]
    bnd = statistics.median(
        [1e3 * max(t.memory_s, t.compute_s) for t in
         (roofline.decode_step_terms(cfg, batch, max_seq, prompt + i,
                                     experts_read=reads[i])
          for i in range(1, new - 1))])
    all_read = statistics.median(
        [1e3 * roofline.decode_step_terms(cfg, batch, max_seq,
                                          prompt + i).memory_s
         for i in range(1, new - 1)])
    peak = torch.cuda.max_memory_allocated(dev)
    res = {"label": label, "arch": arch, "layers": layers, "batch": batch,
           "prompt": prompt, "new": new, "dtype": str(cfg.dtype),
           "prefill_ms": run["prefill_ms"], "ms": ms,
           "tok_s": batch / ms * 1e3, "peak": peak, "bound_ms": bnd,
           "share": bnd / ms, "err": err, "scale": scale, "rel": rel,
           "routing_flips": flips, "agree": agree,
           "weights": weights, "step_ms_range": [min(step_ms), max(step_ms)],
           "experts_read": (statistics.mean(reads[1:])
                            if cfg.num_experts else None),
           "all_experts_bound_ms": all_read}
    extra = ""
    if cfg.num_experts:
        extra = (f"; experts read a step {res['experts_read']:.1f} of "
                 f"{cfg.num_layers * cfg.num_experts} (bound with every "
                 f"expert {all_read:.3f} ms: the capacity dispatch reads "
                 f"them all); the forward replays decode's routing, its own "
                 f"top-k differed in {flips} of {cfg.num_layers * batch * (prompt + new - 1)} "
                 f"(layer, row, position) decisions")
    log(f"  {label} {arch} {res['dtype'][6:]}: {layers} of {full.num_layers} "
        f"layers, batch {batch}, prompt {prompt}, new {new}, weights "
        f"{weights / 1e9:.2f} GB; prefill {run['prefill_ms']:.1f} ms; "
        f"{ms:.3f} ms per decoded token (steps {min(step_ms):.3f}-"
        f"{max(step_ms):.3f}), {res['tok_s']:.1f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB; bound {bnd:.3f} ms ({100 * bnd / ms:.1f} "
        f"%){extra}; decode vs forward max_abs_err={err:.4g} (tol "
        f"{rel:.4g} x {scale:.4g}), argmax agree {100 * agree:.1f} %; "
        f"first row "
        f"{tokens[0, :8].tolist()}; no kernel launch; "
        f"{time.perf_counter() - t_run:.1f} s; card {card}")
    del params, eng, model, cache
    torch.cuda.empty_cache()
    return res


def phase_serve(dev, card: str) -> list:
    """Phase 20; returns each run's numbers."""
    import torch
    out = []
    for run in SERVE_RUNS:
        log(f"-- {run[0]}. {run[1]} served at full width, {run[2]} layer(s), "
            f"batch {run[3]}, prompt {run[4]}, {run[5]} new")
        out.append(phase_serve_run(dev, card, *run))
    for run in SERVE_FP32_RUNS:
        log(f"-- {run[0]}. {run[1]} in fp32, {run[2]} layer(s)")
        out.append(phase_serve_run(dev, card, *run, dtype=torch.float32))
    return out


# ---------------------------------------------------------------------------
# Phase 21: the multi-device aggregation backends ("cuda_sharded" /
# "cuda_hier", kernels/shard.py) in worlds of processes that share the card
# over gloo (``world_run``'s kept worlds).
# ---------------------------------------------------------------------------

MESH_LIMIT = 600                # seconds a world may take in all
MESH_SEED = 21                  # 21a's dense stack
SEED_COLS = 1 << 18             # columns of one seeded chunk (seeded_block)
HIER_SEED_ROWS = 1024           # ... and its rows at n = 10240 (phase 6, 21b)
STACK_GB = 4.0 * N_MAIN * D_MAIN / 1e9   # 21a's whole stack: 11.58 GB
#: 21a's dense cases at (N_MAIN, D_MAIN), F_MAIN, and each one's launches.
MESH_DENSE = (("nnm+cwtm", dict(pre="nnm", rule="cwtm"),
               dict(gram=1, mixtrim=1, combine=0)),
              ("cwtm", dict(pre=None, rule="cwtm"),
               dict(gram=0, mixtrim=1, combine=0)),
              ("nnm+gm", dict(pre="nnm", rule="gm"),
               dict(gram=1, mixtrim=0, combine=1)))
#: 21a's lane cases at FLEET_BIG (f = 0..7 per lane): K5 + K4 / K3 lanes.
MESH_LANES = (("lanes nnm+cwtm", dict(pre="nnm", rule="cwtm"),
               dict(gram_batched=1, mixtrim_dyn=1, combine_lanes=0)),
              ("lanes nnm+gm", dict(pre="nnm", rule="gm"),
               dict(gram_batched=1, mixtrim_dyn=0, combine_lanes=1)))
#: 21c: (name, layers, n, f, spec, steps, launches a step); full width,
#: the depth cut to 2 of 32 layers for time (32 and 16, then 4 and 2
#: before).
MESH_TRAIN = (("nnm+cwtm", 2, N_MAIN, F_MAIN,
               dict(pre="nnm", rule="cwtm"), 2,
               dict(gram=1, mixtrim=1, bucketgram=0, bucketmeans=0)),
              ("hier+nnm+cwtm", 2, N_HIER, F_HIER,
               dict(pre="nnm", rule="cwtm", hier=True, bucket_size=2), 2,
               dict(gram=0, mixtrim=1, bucketgram=1, bucketmeans=0)))
MESH_KERNELS = ("gram", "mixtrim", "combine", "gram_batched", "mixtrim_dyn",
                "combine_lanes", "bucketgram", "bucketmeans")


def seeded_block(seed: int, rows: tuple, cols: tuple, dev, rb: int,
                 cb: int = SEED_COLS):
    """Rows [r0, r1) x columns [c0, c1) of a stack whose (rb, cb) chunk
    (i, j) is ``torch.randn`` from a generator seeded with (seed, i, j):
    any block regenerates alone, on any rank, equal to that block of the
    whole."""
    import torch
    (r0, r1), (c0, c1) = rows, cols
    out = torch.empty((r1 - r0, c1 - c0), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    for i in range(r0 // rb, -(-r1 // rb)):
        for j in range(c0 // cb, -(-c1 // cb)):
            gen.manual_seed(seed * 1_000_003 + i * 100_003 + j)
            chunk = torch.randn((rb, cb), generator=gen, device=dev)
            a, b = max(r0, i * rb), min(r1, (i + 1) * rb)
            c, e = max(c0, j * cb), min(c1, (j + 1) * cb)
            out[a - r0:b - r0, c - c0:e - c0] = \
                chunk[a - i * rb:b - i * rb, c - j * cb:e - j * cb]
            del chunk
    return out


def collective_summary() -> dict:
    """Each collective's count, bytes, transport and seconds since the
    last reset (``launch.mesh.collective_log``)."""
    from repro_torch.launch.mesh import collective_log
    out: dict = {}
    for c in collective_log():
        key = f"{c['op']}/{c['axis']}/{c['transport']}"
        row = out.setdefault(key, {"calls": 0, "bytes": 0, "s": 0.0})
        row["calls"] += 1
        row["bytes"] += c["bytes"]
        row["s"] = round(row["s"] + c["seconds"], 4)
    return out


# Phases 21-23 run their cases in worlds of 2 and of 4 ranks, seven times
# in all.  A world's processes start once (a rank's CUDA context, imports
# and gloo join took 10-20 s a world on the card's host) and stay for the
# next cases of that size: ``world_run`` hands each rank the case and
# waits for all of them, as ``spawn_world`` does.  One world is alive at a
# time (21b's 4 ranks hold 70 GiB of the card; two idle ranks' contexts
# left it short), so the phases order their cases to switch sizes three
# times: 21b; 21a, 21c and 22's (1, 2) cases; 22's (2, 2) cases and 23.
_WORLDS: dict = {}


def _kept_rank(rank: int, world: int, port: int, timeout: float, tasks,
               results) -> None:
    """A rank of a kept world: joins the gloo world once, then runs each
    ``(fn, args)`` from ``tasks`` until ``None``, the card's cache freed
    after each; the first failure is reported and ends the rank."""
    import datetime
    import gc
    import traceback
    import torch
    import torch.distributed as dist
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        while (task := tasks.get()) is not None:
            fn, args = task
            results.put(("ok", rank, fn(rank, world, *args)))
            gc.collect()
            torch.cuda.empty_cache()
    except BaseException:                            # noqa: BLE001 - reported
        results.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:                        # noqa: BLE001 - exiting
                pass


class KeptWorld:
    """``world`` spawned processes joined once in a gloo world over
    ``tcp://127.0.0.1``, running cases in turn (:func:`world_run`)."""

    def __init__(self, world: int):
        import torch.multiprocessing as mp
        from repro_torch.launch.mesh import GROUP_TIMEOUT, free_port
        ctx = mp.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        port = free_port()
        self.procs = [ctx.Process(target=_kept_rank, daemon=True,
                                  args=(r, world, port, GROUP_TIMEOUT,
                                        self.tasks[r], self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, args: tuple, limit: float) -> list:
        """``fn(rank, world, *args)`` on every rank; the ranks' results in
        rank order.  A rank's failure or the limit closes the world and
        raises, as ``spawn_world`` does."""
        import queue
        for q in self.tasks:
            q.put((fn, tuple(args)))
        out: dict = {}
        deadline = time.monotonic() + limit
        try:
            while len(out) < self.world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world_run: {self.world - len(out)} of {self.world} "
                        f"ranks did not finish within {limit:.0f} s")
                try:
                    status, rank, value = self.results.get(
                        timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if p.exitcode is not None and r not in out]
                    if dead:
                        raise RuntimeError(
                            f"world_run: rank {dead[0]} exited with code "
                            f"{self.procs[dead[0]].exitcode} before "
                            f"reporting")
                    continue
                if status == "error":
                    raise RuntimeError(f"world_run: rank {rank} failed:\n"
                                       f"{value}")
                out[rank] = value
        except BaseException:
            self.close()
            raise
        return [out[r] for r in range(self.world)]

    def close(self) -> None:
        """Ask every rank to leave, then kill any that has not."""
        for q in self.tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self.procs:
            p.join(timeout=10.0)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        self.results.close()


def world_run(fn, world: int, args: tuple = (), limit: float = 600.0) -> list:
    """``fn(rank, world, *args)`` on the kept world of ``world`` ranks
    (started on first use, after any world of another size is stopped);
    the ranks' results in rank order."""
    kept = _WORLDS.get(world)
    if kept is None:
        close_worlds()
        kept = _WORLDS[world] = KeptWorld(world)
    try:
        return kept.run(fn, args, limit)
    except BaseException:
        _WORLDS.pop(world, None)
        raise


def close_worlds() -> None:
    """Stop every kept world's processes."""
    while _WORLDS:
        _WORLDS.popitem()[1].close()


def _rank_setup(rank: int):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from repro_torch.kernels import _build
    _build.library()
    return dev


def _counts(keys=MESH_KERNELS) -> dict:
    from repro_torch.kernels import dispatch as kdispatch
    c = kdispatch.launch_counts()
    return {k: c[k] for k in keys}


def _mesh_dense_rank(rank: int, world: int, tmp: str) -> dict:
    """21a on one rank: its (n, D/k) block of the dense stack from the
    seeds, each case through ``robust_aggregate_block`` ("cuda_sharded"),
    held to the single-device run's outputs in ``tmp``; then the lane
    cases through ``batched_robust_aggregate``."""
    import numpy as np
    import torch
    dev = _rank_setup(rank)
    from repro_torch.core import gram as gramlib
    from repro_torch.core.robust import (batched_robust_aggregate,
                                         robust_aggregate_block)
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import combine_lanes, mixtrim_dyn
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.kernels import shard as shardlib
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_mesh((world,), ("shard",))
    sh = shardlib.ShardCtx(mesh, "shard")
    c0, c1 = sh.cols(D_MAIN)
    out = {"rank": rank, "cols": (c0, c1), "cases": {}}
    kdispatch.reset_fallbacks()
    with tmesh.use_mesh(mesh):
        torch.cuda.reset_peak_memory_stats(dev)
        block = seeded_block(MESH_SEED, (0, N_MAIN), (c0, c1), dev, N_MAIN)
        # The all-reduced Gram against K1 on the whole stack, the diagonal
        # and the off-diagonal entries each within 1e-5 of their own
        # largest magnitude (the summation-order bound of
        # tests/test_torch_cuda.py, 2 gamma_D |X| |X|^T, is vacuous at this
        # D: D u = 21.6 > 1; and the off-diagonal entries, ~sqrt(D), are
        # ~1e-4 of the diagonal's ~D, so one tolerance would not hold them).
        g = shardlib.sharded_gram(block, mesh=mesh, axis="shard")
        g1 = torch.from_numpy(np.load(f"{tmp}/gram.npy")).to(dev)
        eye = torch.eye(N_MAIN, dtype=torch.bool, device=dev)
        err = (g.double() - g1.double()).abs()
        for part, sel in (("diag", eye), ("off", ~eye)):
            out[f"gram_{part}_err"] = float(err[sel].max())
            out[f"gram_{part}_tol"] = RTOL * float(g1[sel].abs().max())
        out["gram_ok"] = all(out[f"gram_{p}_err"] <= out[f"gram_{p}_tol"]
                             for p in ("diag", "off"))
        for name, kw, expect in MESH_DENSE:
            spec = AggregatorSpec(backend="cuda_sharded", f=F_MAIN, **kw)
            robust_aggregate_block(block, spec, d=D_MAIN)      # warm-up
            kdispatch.reset_launch_counts()
            tmesh.reset_collective_log()
            internals = {}
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            local = robust_aggregate_block(block, spec, d=D_MAIN,
                                           internals=internals)
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            counts = _counts(("gram", "mixtrim", "combine"))
            full = sh.gather(local, D_MAIN).cpu()
            want = torch.from_numpy(np.load(f"{tmp}/{name}.npy"))
            row = {"ms": ms, "counts": counts, "expect": expect,
                   "collectives": collective_summary(),
                   "record": kdispatch.last_dispatch().describe()}
            m = internals.get("mix_matrix")
            if m is not None:
                row["m_equal"] = bool(torch.equal(
                    m.cpu(), torch.from_numpy(np.load(f"{tmp}/{name}_m.npy"))))
            else:
                row["m_equal"] = True
            # The gather is exact; the slice against the single device's.
            row["gathered"] = bool(torch.equal(full[c0:c1], local.cpu()))
            row["bitwise"] = bool(torch.equal(full, want))
            row["err"], row["tol"] = max_err(local, want[c0:c1].to(dev))
            out["cases"][name] = row
            del local, full, want
        del block
        torch.cuda.empty_cache()
        out["peak_dense"] = torch.cuda.max_memory_allocated(dev)
        # The lane forms on the mesh: every rank holds the whole (replicated)
        # lane stack, as a fleet bucket does; the API takes its block.
        b, n, d = FLEET_BIG
        x = seeded_block(MESH_SEED + 1, (0, b * n), (0, d), dev,
                         b * n).view(b, n, d)
        fs = torch.arange(b, device=dev) % (n // 2)
        for name, kw, expect in MESH_LANES:
            spec = AggregatorSpec(backend="cuda_sharded", **kw)
            batched_robust_aggregate({"x": x}, spec, fs)       # warm-up
            kdispatch.reset_launch_counts()
            tmesh.reset_collective_log()
            internals = {}
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            got = batched_robust_aggregate({"x": x}, spec, fs,
                                           internals=internals)["x"]
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            want = torch.from_numpy(np.load(f"{tmp}/{name}.npy")).to(dev)
            m_s = internals["mix_matrix"]
            m1 = torch.from_numpy(np.load(f"{tmp}/{name}_m.npy")).to(dev)
            row = {"ms": ms, "counts": _counts(tuple(expect)),
                   "expect": expect, "collectives": collective_summary(),
                   "record": kdispatch.last_dispatch().describe(),
                   "m_equal": bool(torch.equal(m_s, m1)), "gathered": True,
                   "rows": 0}
            if not row["m_equal"]:
                # NNM near-ties (phase 6's rule, lane by lane): the sharded
                # Gram against K5 on the whole stack, each differing row a
                # near-tie; the output then held to the single-device
                # kernel run with the sharded path's M.
                g_s = shardlib.sharded_gram(sh.take(x), mesh=mesh,
                                            axis="shard")
                g1 = torch.from_numpy(np.load(f"{tmp}/lanes_gram.npy")).to(dev)
                for k in range(b):
                    row["rows"] += _nnm_near_ties(g_s[k], g1[k], m_s[k],
                                                  m1[k], n - int(fs[k]))
                if kw["rule"] == "cwtm":
                    want = mixtrim_dyn(x, m_s, fs)
                else:
                    c = gramlib.coeff_for_rule_dyn(
                        "gm", gramlib.mixed_gram(g_s, m_s), fs)
                    want = combine_lanes(x, (c[:, None] @ m_s)[:, 0]
                                         .contiguous())
            row["bitwise"] = bool(torch.equal(got, want))
            row["err"], row["tol"] = max_err(got, want)
            out["cases"][name] = row
            del got, want
        del x
        torch.cuda.empty_cache()
    out["fallbacks"] = [f"{d.primitive}: {d.used} ({d.reason})"
                        for d in kdispatch.fallback_log()]
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def _train_run(dev, name: str, layers: int, n: int, f: int, spec_kw: dict,
               steps: int, backend: str, worker_axes=None):
    """Full-width smollm-360m (``layers`` deep) D-SHB through train_loop,
    ALIE, seeded weights, one step a segment; returns (final params,
    history, ms per step, peak bytes, launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine
    from repro_torch.training import ByzantineConfig, TrainerConfig, train_loop
    model = build_model(get_config("smollm-360m").replace(num_layers=layers))
    params = model.init(0, dev)
    cfg = TrainerConfig(agg=AggregatorSpec(f=f, backend=backend, **spec_kw),
                        byz=ByzantineConfig(f=f, attack="alie"),
                        worker_axes=worker_axes)
    torch.cuda.reset_peak_memory_stats(dev)
    kdispatch.reset_launch_counts()
    final, out = train_loop(model.loss, params, lm_batches(n), sgd(clip=2.0),
                            cfg, cosine(0.05, steps, warmup=0), steps, seed=0,
                            track_best=False, chunk=1)
    ms = [1e3 * sec for _, _, sec in out["scan_report"]["segments"]]
    return (final, out["history"], ms, torch.cuda.max_memory_allocated(dev),
            _counts(("gram", "mixtrim", "bucketgram", "bucketmeans")))


def _param_digest(params) -> str:
    import hashlib
    import torch
    from repro_torch.tree import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().contiguous().view(-1).view(
            torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh_train_rank(rank: int, world: int, tmp: str) -> dict:
    """21c on one rank: each MESH_TRAIN run through train_loop with
    ``worker_axes`` under a 1-D mesh, held to the single-device run's
    parameters and losses in ``tmp``."""
    import torch
    dev = _rank_setup(rank)
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.tree import tree_leaves
    mesh = tmesh.make_mesh((world,), ("shard",))
    out = {"rank": rank, "runs": {}}
    kdispatch.reset_fallbacks()
    with tmesh.use_mesh(mesh):
        for name, layers, n, f, spec_kw, steps, expect in MESH_TRAIN:
            backend = "cuda_hier" if spec_kw.get("hier") else "cuda_sharded"
            tmesh.reset_collective_log()
            final, hist, ms, peak, counts = _train_run(
                dev, name, layers, n, f, spec_kw, steps, backend,
                worker_axes=("shard",))
            ref = torch.load(f"{tmp}/{name}.pt", map_location=dev)
            scale = max(float(r.float().abs().max()) for r in ref["params"])
            err, diff = 0.0, 0
            for a, b in zip(tree_leaves(final), ref["params"]):
                err = max(err, float((a.float() - b.float()).abs().max()))
                diff += int((a != b).sum())
            out["runs"][name] = {
                "ms": ms, "peak": peak, "counts": counts,
                "expect": {k: v * steps for k, v in expect.items()},
                "loss": hist["loss"], "ref_loss": ref["loss"],
                "kappa_hat": hist["kappa_hat"], "err": err, "scale": scale,
                "diff": diff, "digest": _param_digest(final),
                "record": kdispatch.last_dispatch().describe(),
                "collectives": collective_summary()}
            del final, ref
            torch.cuda.empty_cache()
    out["fallbacks"] = [f"{d.primitive}: {d.used} ({d.reason})"
                        for d in kdispatch.fallback_log()]
    return out


def _mesh_hier_rank(rank: int, world: int, tmp: str) -> dict:
    """21b on one rank of the 2 x 2 ("workers", "model") mesh: its
    (n/2, D/2) tile of phase 6's stack from the seeds, both hierarchical
    aggregates through ``robust_aggregate_block`` ("cuda_hier": K7 on the
    tile, the partial means summed over "workers", K1 on the means, the
    Gram summed over "model", K2), held to phase 6's aggregates under its
    near-tie rule."""
    import numpy as np
    import torch
    dev = _rank_setup(rank)
    from repro_torch.core import bucketing as bucketlib
    from repro_torch.core import gram as gramlib
    from repro_torch.core.robust import robust_aggregate_block
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.kernels import mixtrim_ref
    from repro_torch.kernels import shard as shardlib
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_hier_mesh(2, world // 2)
    sh = shardlib.ShardCtx(mesh, "model", "workers")
    n, d, f = HIER_N, HIER_D, HIER_N // 32
    (r0, r1), (c0, c1) = sh.rows(n), sh.cols(d)
    perm = torch.from_numpy(np.load(f"{tmp}/perm.npy"))
    out = {"rank": rank, "tile": ((r0, r1), (c0, c1)), "cases": {}}
    kdispatch.reset_fallbacks()
    torch.cuda.reset_peak_memory_stats(dev)
    tile = seeded_block(3, (r0, r1), (c0, c1), dev, HIER_SEED_ROWS)
    with tmesh.use_mesh(mesh):
        for name, (spec_kw, _) in _hier_specs(f).items():
            spec = AggregatorSpec(backend="cuda_hier", **spec_kw)
            robust_aggregate_block(tile, spec, d=d, n=n, perm=perm)  # warm-up
            kdispatch.reset_launch_counts()
            tmesh.reset_collective_log()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            local = robust_aggregate_block(tile, spec, d=d, n=n, perm=perm)
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            counts = _counts(("bucketmeans", "bucketgram", "gram", "mixtrim"))
            colls = collective_summary()
            want = torch.from_numpy(np.load(f"{tmp}/{name}.npy"))[c0:c1].to(dev)
            row = {"ms": ms, "counts": counts, "collectives": colls,
                   "record": kdispatch.last_dispatch().describe(), "rows": 0}
            if spec_kw["pre"] == "nnm":
                nb = bucketlib.num_buckets(n, HIER_S)
                fb = bucketlib.adjusted_f(f, nb)
                assign = bucketlib.bucket_assignment(n, HIER_S, perm=perm)
                y, g_s = shardlib.sharded_bucketgram(
                    tile, assign, nb, mesh=mesh, worker_axis="workers",
                    model_axis="model")
                g6 = torch.from_numpy(np.load(f"{tmp}/gram.npy")).to(dev)
                m6 = torch.from_numpy(np.load(f"{tmp}/m.npy")).to(dev)
                # The pipeline's M: the same NNM of the same (repeatable)
                # sharded Gram of the means.
                m_s = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g_s), fb)
                row["rows"] = _nnm_near_ties(g_s, g6, m_s, m6, nb - fb)
                if row["rows"]:
                    want = mixtrim_ref(y, m_s, fb)
                del y
            row["err"], row["tol"] = max_err(local, want)
            out["cases"][name] = row
            del local, want
    del tile
    out["fallbacks"] = [f"{d.primitive}: {d.used} ({d.reason})"
                        for d in kdispatch.fallback_log()]
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def _save(tmp: str, name: str, t) -> None:
    import numpy as np
    np.save(f"{tmp}/{name}.npy", t.detach().cpu().numpy())


def _mesh_check(what: str, ranks: list) -> None:
    for r in ranks:
        if r["fallbacks"]:
            raise AssertionError(f"{what}: rank {r['rank']} recorded "
                                 f"fallbacks: {r['fallbacks']}")


def phase_mesh_dense(dev, tmp: str) -> dict:
    """21a: the single-device kernel path first (its outputs to ``tmp``,
    the card freed), then a world of 2 ranks."""
    import torch
    from repro_torch.core.robust import batched_robust_aggregate, robust_aggregate
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import gram, gram_batched
    x = seeded_block(MESH_SEED, (0, N_MAIN), (0, D_MAIN), dev, N_MAIN)
    _save(tmp, "gram", gram(x))
    for name, kw, _ in MESH_DENSE:
        internals = {}
        vec = robust_aggregate({"x": x}, AggregatorSpec(
            backend="cuda", f=F_MAIN, **kw), internals=internals)["x"]
        _save(tmp, name, vec)
        if "mix_matrix" in internals:
            _save(tmp, f"{name}_m", internals["mix_matrix"])
        del vec
    del x
    torch.cuda.empty_cache()
    b, n, d = FLEET_BIG
    x = seeded_block(MESH_SEED + 1, (0, b * n), (0, d), dev, b * n).view(b, n, d)
    fs = torch.arange(b, device=dev) % (n // 2)
    _save(tmp, "lanes_gram", gram_batched(x))
    for name, kw, _ in MESH_LANES:
        internals = {}
        got = batched_robust_aggregate({"x": x}, AggregatorSpec(
            backend="cuda", **kw), fs, internals=internals)["x"]
        _save(tmp, name, got)
        _save(tmp, f"{name}_m", internals["mix_matrix"])
        del got
    del x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = world_run(_mesh_dense_rank, 2, (tmp,), limit=MESH_LIMIT)
    log(f"  world of 2 ranks (gloo, sharing the card): {time.perf_counter() - t0:.1f} s")
    _mesh_check("21a", ranks)
    total = {}
    for r in ranks:
        c0, c1 = r["cols"]
        log(f"  rank {r['rank']}: columns [{c0}, {c1}) of D = {D_MAIN}; "
            f"Gram vs single device max |diff| diagonal "
            f"{r['gram_diag_err']:.3e} (tol {r['gram_diag_tol']:.3e}), off "
            f"the diagonal {r['gram_off_err']:.3e} (tol "
            f"{r['gram_off_tol']:.3e}; each 1e-5 of its largest |G|) "
            f"{'OK' if r['gram_ok'] else 'FAIL'}; peak {r['peak_dense'] / 1e9:.2f} GB at the dense shape "
            f"(whole stack {STACK_GB:.2f} GB), {r['peak'] / 1e9:.2f} GB with "
            f"the lanes")
        if not r["gram_ok"]:
            raise AssertionError("21a: the all-reduced Gram disagrees "
                                 "with K1 on the whole stack")
        if not r["peak_dense"] < STACK_GB * 1e9:
            raise AssertionError(f"21a: rank {r['rank']} peak "
                                 f"{r['peak_dense']} >= the whole stack")
        for name, row in r["cases"].items():
            coord = "gm" not in name
            if not row["gathered"]:
                raise AssertionError(f"21a {name}: the gathered aggregate "
                                     f"differs from the rank's slice")
            if not row["m_equal"] and "lanes" not in name:
                raise AssertionError(f"21a {name}: the NNM matrix differs "
                                     f"from the single device's")
            if row["counts"] != {k: v for k, v in row["expect"].items()}:
                raise AssertionError(f"21a {name} rank {r['rank']}: launches "
                                     f"{row['counts']}, expected "
                                     f"{row['expect']}")
            if coord and row["m_equal"] and not row["bitwise"]:
                raise AssertionError(f"21a {name}: a coordinate rule with the "
                                     f"single device's NNM matrix differs in "
                                     f"bits")
            if not row["m_equal"] or not coord:
                if row["err"] > row["tol"]:
                    raise AssertionError(f"21a {name}: {row['err']} > "
                                         f"{row['tol']}")
            for k, v in row["counts"].items():
                total[k] = total.get(k, 0) + v
            ties = "" if row["m_equal"] else (
                f" ({row.get('rows', 0)} rows, each a checked near-tie; held "
                f"to the single-device kernels with the sharded M)")
            log(f"  21a {name} rank {r['rank']}: {row['ms']:.1f} ms (host "
                f"clock after a warm-up, the gather not included), launches "
                f"{row['counts']},"
                f" NNM matrix {'equal' if row['m_equal'] else 'differs'}{ties}, "
                f"{'bit for bit' if row['bitwise'] else 'max_abs_err ' + format(row['err'], '.3e') + ' tol ' + format(row['tol'], '.3e')}"
                f" the single device; collectives {row['collectives']}")
        if r["rank"] == 0:
            log(r["cases"]["nnm+cwtm"]["record"])
    return total


def phase_mesh_hier(tmp: str) -> dict:
    """21b: a world of 4 ranks on the 2 x 2 mesh against phase 6's
    aggregates (saved to ``tmp`` by phase 6)."""
    t0 = time.perf_counter()
    ranks = world_run(_mesh_hier_rank, 4, (tmp,), limit=MESH_LIMIT)
    log(f"  world of 4 ranks (2 x 2, gloo, sharing the card): "
        f"{time.perf_counter() - t0:.1f} s")
    _mesh_check("21b", ranks)
    total = {}
    for r in ranks:
        (r0, r1), (c0, c1) = r["tile"]
        for name, row in r["cases"].items():
            spec_kw, expect = _hier_specs(HIER_N // 32)[name]
            want = {"bucketmeans": 1, "bucketgram": 0,
                    "gram": expect["gram"], "mixtrim": 1}
            if row["counts"] != want:
                raise AssertionError(f"21b {name} rank {r['rank']}: launches "
                                     f"{row['counts']}, expected {want}")
            if row["err"] > row["tol"]:
                raise AssertionError(f"21b {name} rank {r['rank']}: "
                                     f"{row['err']} > {row['tol']}")
            # K1 on the 640 means is the tiled product, K2 at 640 workers
            # mixtrim_select: their own rows of the kernels line.
            key = "mixtrim_select" + ("" if spec_kw["pre"] else "_nomix")
            for k, v in (("bucketmeans", row["counts"]["bucketmeans"]),
                         ("gram_tiled", row["counts"]["gram"]),
                         (key, row["counts"]["mixtrim"])):
                total[k] = total.get(k, 0) + v
            log(f"  21b {name} rank {r['rank']} tile rows [{r0}, {r1}) x "
                f"cols [{c0}, {c1}): {row['ms']:.1f} ms (host clock after a "
                f"warm-up), "
                f"launches {row['counts']}, NNM rows that differ from phase "
                f"6: {row['rows']}, max_abs_err {row['err']:.3e} tol "
                f"{row['tol']:.3e}; collectives {row['collectives']}")
        log(f"  21b rank {r['rank']}: peak {r['peak'] / 1e9:.2f} GB")
        if r["rank"] == 0:
            log(r["cases"]["hier+nnm+cwtm"]["record"])
    return total


def phase_mesh_train(dev, tmp: str) -> dict:
    """21c: each run on the single device first (parameters and losses to
    ``tmp``, the card freed), then a world of 2 ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.tree import tree_leaves
    for name, layers, n, f, spec_kw, steps, _ in MESH_TRAIN:
        cfg = get_config("smollm-360m").replace(num_layers=layers)
        final, hist, ms, peak, counts = _train_run(
            dev, name, layers, n, f, spec_kw, steps, "cuda")
        width = sum(leaf.numel() for leaf in tree_leaves(final))
        log(f"  21c {name} single device: {layers} of 32 layers, d "
            f"{cfg.d_model}, D = {width:,} (an ({n}, D) fp32 stack of "
            f"{4 * n * width / 1e9:.2f} GB), ms/step "
            f"{[round(v, 1) for v in ms]}, loss "
            f"{[round(v, 5) for v in hist['loss']]}, peak {peak / 1e9:.2f} GB")
        torch.save({"params": [p.detach() for p in tree_leaves(final)],
                    "loss": hist["loss"]}, f"{tmp}/{name}.pt")
        del final
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = world_run(_mesh_train_rank, 2, (tmp,), limit=MESH_LIMIT)
    log(f"  world of 2 ranks (gloo, sharing the card): {time.perf_counter() - t0:.1f} s")
    _mesh_check("21c", ranks)
    total = {}
    for name, *_ in MESH_TRAIN:
        rows = [r["runs"][name] for r in ranks]
        if len({row["digest"] for row in rows}) != 1:
            raise AssertionError(f"21c {name}: the ranks' parameter copies "
                                 f"differ")
        for r, row in zip(ranks, rows):
            if row["counts"] != row["expect"]:
                raise AssertionError(f"21c {name} rank {r['rank']}: launches "
                                     f"{row['counts']}, expected "
                                     f"{row['expect']}")
            if row["err"] > 1e-5 * row["scale"]:
                raise AssertionError(f"21c {name}: parameters off the single "
                                     f"device by {row['err']} > 1e-5 x "
                                     f"{row['scale']}")
            for a, b in zip(row["loss"], row["ref_loss"]):
                if abs(a - b) > 1e-5 * abs(b):
                    raise AssertionError(f"21c {name}: loss {row['loss']} vs "
                                         f"{row['ref_loss']}")
            for k, v in row["counts"].items():
                total[k] = total.get(k, 0) + v
            log(f"  21c {name} rank {r['rank']}: ms/step "
                f"{[round(v, 1) for v in row['ms']]}, peak "
                f"{row['peak'] / 1e9:.2f} GB, launches {row['counts']}, loss "
                f"{[round(v, 5) for v in row['loss']]} (single device "
                f"{[round(v, 5) for v in row['ref_loss']]}), parameters: max "
                f"|diff| {row['err']:.3e} (tol {1e-5 * row['scale']:.3e}), "
                f"{row['diff']} entries differ; collectives "
                f"{row['collectives']}")
        log(f"  21c {name}: both ranks' parameters equal bit for bit "
            f"(sha256 {rows[0]['digest'][:16]})")
        log(rows[0]["record"])
    return total


def phase_mesh(dev, hier_ref_dir: str) -> dict:
    """Phase 21; returns the launches summed over every rank."""
    import tempfile
    total = {}
    # 21b first: its 4 ranks hold 70 GiB of the card, so it runs with no
    # other world's ranks alive; 21a, 21c and phase 22's (1, 2) cases then
    # share the world of 2.
    t0 = time.perf_counter()
    log(f"-- 21b. cuda_hier on a 2 x 2 mesh: n={HIER_N} s={HIER_S} "
        f"f={HIER_N // 32} D={HIER_D} fp32, tiles ({HIER_N // 2}, "
        f"{HIER_D // 2})")
    add_counts(total, phase_mesh_hier(hier_ref_dir))
    log(f"  21b: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        log(f"-- 21a. cuda_sharded at the dense shape: n={N_MAIN} f={F_MAIN} "
            f"D={D_MAIN} fp32 over 2 ranks; the lane forms at {FLEET_BIG}")
        add_counts(total, phase_mesh_dense(dev, tmp))
        log(f"  21a: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        log("-- 21c. the trainer: full-width smollm-360m, D-SHB, ALIE, "
            "worker_axes over 2 ranks")
        add_counts(total, phase_mesh_train(dev, tmp))
        log(f"  21c: {time.perf_counter() - t0:.1f} s")
    idle = [k for k in ("gram", "mixtrim", "combine", "gram_batched",
                        "mixtrim_dyn", "combine_lanes", "bucketgram",
                        "bucketmeans", "gram_tiled", "mixtrim_select",
                        "mixtrim_select_nomix") if not total.get(k)]
    if idle:
        raise AssertionError(f"phase 21: kernels never launched on the mesh "
                             f"paths: {idle}")
    return total


# ---------------------------------------------------------------------------
# Phase 22: the model-parallel mesh.  Each rank of a ("data", "model") world
# holds its shard of the padded model (heads, ff, vocabulary, experts; the
# rwkv6 / Mamba2 heads, whisper's encoder and cross attention), runs its
# data index's workers split over the model ranks (the layers' collectives
# on the model axis) and aggregates its model shard's columns of the worker
# stack with K1 / K2 (K6 / K7 on the hierarchical form; the sketch Gram and
# K2 with sketch_dim).  Every case runs first on one device (the padded
# model whole under mesh_axes_scope), then over the world.
# ---------------------------------------------------------------------------

#: (name, arch, layers, dtype, n, f, spec, steps, mesh shapes, tight, fsdp)
#: ``tight``: fp32, held at 1e-5 with the stack's Gram.  22e-22j: every
#: other family at its published widths (bf16, depth cut; whisper's
#: encoder cut with its decoder), each family again in fp32
#: with the Gram (22i: a bf16 run's 5e-3 bound on the parameters lies
#: above most elements of an update clipped to a norm of 0.1, so it checks
#: the forward pass more than the split gradients), and the sketch route
#: (sketch_dim 512, phase 15b's).
MODEL_RUNS = (
    ("22a", "smollm-360m", 4, "bf16", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 2, ((2, 2),), False, False),
    ("22b nnm+cwtm", "smollm-360m", 2, "fp32", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 2, ((1, 2), (2, 2)), True, False),
    ("22b hier+nnm+cwtm", "smollm-360m", 2, "fp32", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm", hier=True, bucket_size=2), 2,
     ((1, 2), (2, 2)), True, False),
    ("22c", "mixtral-8x22b", 1, "bf16", 4, 1,
     dict(pre="nnm", rule="cwtm"), 2, ((1, 2),), False, True),
    ("22e", "rwkv6-3b", 1, "bf16", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 1, ((2, 2),), False, False),
    ("22f", "zamba2-2.7b", 12, "bf16", 6, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 1, ((1, 2),), False, False),
    ("22g", "internvl2-2b", 2, "bf16", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 1, ((1, 2),), False, False),
    ("22h", "whisper-base", 2, "bf16", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 1, ((2, 2),), False, False),
    ("22i rwkv6", "rwkv6-3b", 2, "fp32", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 2, ((1, 2),), True, False),
    ("22i zamba2", "zamba2-2.7b", 6, "fp32", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 2, ((1, 2),), True, False),
    ("22i internvl2", "internvl2-2b", 2, "fp32", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 2, ((1, 2),), True, False),
    ("22i whisper", "whisper-base", 2, "fp32", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 2, ((1, 2),), True, False),
    ("22j", "smollm-360m", 2, "fp32", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm", sketch_dim=SKETCH_DIM), 2,
     ((1, 2), (2, 2)), True, False),
)
MODEL_PAR = 2
MODEL_SEQ, MODEL_BATCH = 128, 4          # each worker's batch: 4 x 128 tokens
MODEL_PEAK_GB = 72.0                      # each world's summed peak
MODEL_RESUME_STEPS = 2                    # 22d: killed after step 1's snapshot


def model_batches(cfg, n: int, steps: int) -> list:
    """Dirichlet-heterogeneous synthetic LM batches over the config's
    vocabulary; a VLM's seeded normal patches before its MODEL_SEQ text
    tokens, an encoder-decoder's seeded normal frames (zeros would give
    the projector / the encoder no signal)."""
    import numpy as np
    from repro_torch.data import build_heterogeneous, make_lm_corpus, worker_batches
    seqs, topics = make_lm_corpus(n_tokens=400_000, vocab=cfg.vocab_size,
                                  seq_len=MODEL_SEQ + 1, seed=0)
    ds = build_heterogeneous({"seq": seqs, "y": topics}, "y", n, alpha=0.1,
                             seed=0)
    it = worker_batches(ds, MODEL_BATCH, seed=0)
    out = []
    for t in range(steps):
        b = next(it)
        batch = {"tokens": b["seq"][..., :-1], "labels": b["seq"][..., 1:]}
        rng = np.random.default_rng(22 + t)
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (n, MODEL_BATCH, cfg.num_patches, cfg.vision_dim),
                dtype=np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (n, MODEL_BATCH, cfg.encoder_seq, cfg.d_model),
                dtype=np.float32)
        out.append(batch)
    return out


def _model_setup(run, dev, mesh):
    """(model, its config, MeshAxes, TrainerConfig) of one MODEL_RUNS entry,
    on one device (mesh None) or over ``mesh``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.launch.launch_config import fsdp_keys_for
    from repro_torch.launch.mesh import mesh_axes_for
    from repro_torch.models import build_model
    from repro_torch.models import common
    from repro_torch.training import ByzantineConfig, TrainerConfig
    import dataclasses
    name, arch, layers, dtype, n, f, spec_kw, steps, _, _, fsdp, *layout = run
    full = get_config(arch)
    cfg = full.replace(num_layers=layers, dtype=torch.bfloat16
                       if dtype == "bf16" else torch.float32)
    if full.encoder_layers:
        cfg = cfg.replace(encoder_layers=min(layers, full.encoder_layers))
    axes = mesh_axes_for(cfg, model_par=MODEL_PAR)
    if layout:                  # phase 23: seq_par / expert_fsdp
        axes = dataclasses.replace(axes, **layout[0])
    model = build_model(cfg)
    with common.mesh_axes_scope(axes):
        specs = common.leaf_specs(model.param_descs())
    if mesh is None:
        backend = "cuda"
    else:
        backend = "cuda_hier" if spec_kw.get("hier") else "cuda_sharded"
    tcfg = TrainerConfig(
        agg=AggregatorSpec(f=f, backend=backend, **spec_kw),
        byz=ByzantineConfig(f=f, attack="alie"),
        fsdp_keys=fsdp_keys_for(full) if fsdp else (),
        worker_axes=None if mesh is None else ("data",),
        param_specs=None if mesh is None else specs)
    return model, cfg, axes, tcfg


def _stack_gram(a, mesh, hier: bool):
    """The attacked stack's (n, n) Gram in fp64 (column chunks), summed
    over the blocks of a world: over both axes, or the model axis where
    the hierarchical form keeps the columns whole on every data rank."""
    import torch
    g = torch.zeros((a.shape[0], a.shape[0]), dtype=torch.float64,
                    device=a.device)
    for c in range(0, a.shape[1], 1 << 23):
        x = a[:, c:c + (1 << 23)].double()
        g += x @ x.T
    if mesh is not None:
        mesh.all_reduce(g, "model" if hier else ("model", "data"),
                        record=False)
    return g


def _sketch_gram(internals: dict, tcfg, params, signs: list, mesh, dev):
    """The attacked stack's sketch Gram (fp64 on the host): the whole
    stack's fold on one device; on a world this rank's block folded where
    the whole leaves hold it (``kernels.dispatch.sketch_fold_model``, as
    the trainer folds it), the partial sketches summed over both axes."""
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.training import trainer
    a = internals["attacked"][None]
    s = tcfg.agg.sketch_dim
    if mesh is None:
        segs = [(off, size) for off, size, _ in internals["layout"].segments]
        sk = kdispatch.sketch_fold(a, segs, s, signs)
    else:
        mc = trainer.model_columns(tcfg, params)
        sh = trainer.trainer_shard(tcfg, dev, mc)
        sk = kdispatch.sketch_fold_model(
            a, s, signs, mc=mc,
            local=(sh.span[0] - mc.offset, sh.span[1] - mc.offset))
        sk = mesh.all_reduce(sk, sh.axis, record=False)
    return (sk @ sk.mT)[0].double().cpu()


def _model_train(run, dev, mesh=None, gram: bool = False) -> dict:
    """One MODEL_RUNS entry's steps; returns its metrics, ms per step,
    peak, launches, collectives, the final parameters (this rank's
    shards) and, with ``gram``, each step's stack Gram (and sketch Gram
    under ``sketch_dim``, its signs drawn on the whole padded leaves from
    a generator seeded by the step, the same on every rank)."""
    import torch
    from repro_torch.core.robust import draw_signs
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import common
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine
    from repro_torch.training import build_train_step, init_state
    from repro_torch.training.trainer import split_params, to_device
    from repro_torch.tree import tree_leaves
    name, arch, layers, dtype, n, f, spec_kw, steps, *_ = run
    model, cfg, axes, tcfg = _model_setup(run, dev, mesh)
    batches = model_batches(cfg, n, steps)
    sketch = spec_kw.get("sketch_dim")
    with common.mesh_axes_scope(axes):
        widths = [math.prod(d.shape)
                  for d in tree_leaves(model.param_descs())]
    t_run = time.perf_counter()
    scope = tmesh.use_mesh(mesh) if mesh is not None \
        else contextlib.nullcontext()
    torch.cuda.reset_peak_memory_stats(dev)
    with scope, common.mesh_axes_scope(axes):
        params = model.init(0, dev)
        robust, _ = split_params(params, tcfg.fsdp_keys)
        width = sum(p.numel() for p in robust)
        total = sum(p.numel() for p in tree_leaves(params))
        del robust
        opt = sgd(clip=2.0)
        step = build_train_step(model.loss, opt, tcfg,
                                cosine(0.05, steps, warmup=0))
        state = init_state(params, opt, n, tcfg)
        del params
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        tmesh.reset_collective_log()
        hist = {"loss": [], "kappa_hat": [], "direction_norm": [], "ms": [],
                "grams": [], "sketch_grams": []}
        for t in range(steps):
            perm = torch.randperm(n, generator=torch.Generator()
                                  .manual_seed(t)).to(dev)
            signs = draw_signs(widths, sketch, torch.Generator()
                               .manual_seed(1000 + t), dev) \
                if sketch else None
            batch = to_device(batches[t], dev)
            internals: dict = {}
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch, internals, perm=perm, signs=signs)
            torch.cuda.synchronize(dev)
            hist["ms"].append(1e3 * (time.perf_counter() - t0))
            for k in ("loss", "kappa_hat", "direction_norm"):
                hist[k].append(float(m[k]))
            if gram:
                hist["grams"].append(_stack_gram(
                    internals["attacked"], mesh,
                    bool(spec_kw.get("hier"))).cpu())
            if sketch:
                hist["sketch_grams"].append(_sketch_gram(
                    internals, tcfg, state["params"], signs, mesh, dev))
            del internals, batch
        counts = _counts(("gram", "mixtrim", "bucketgram", "bucketmeans",
                          "combine"))
        colls = collective_summary()
        model_ar = sum(c["calls"] for k, c in colls.items()
                       if k.startswith("all_reduce/model/"))
    return {"params": [p.detach() for p in tree_leaves(state["params"])],
            "momentum_width": state["momentum"].shape[1], "hist": hist,
            "peak": torch.cuda.max_memory_allocated(dev), "counts": counts,
            "collectives": colls, "model_all_reduces": model_ar / steps,
            "width": width, "params_total": total,
            # The sketch Gram's torch decision is the route, not a
            # fallback (phase 15b's allowance).
            "fallbacks": [f"{d.primitive}: {d.used} ({d.reason})"
                          for d in kdispatch.fallback_log()
                          if d.primitive != "sketch_gram"],
            "record": kdispatch.last_dispatch().describe(),
            "seconds": time.perf_counter() - t_run}


def _model_compare(run, got: dict, ref_path: str, mesh) -> dict:
    """This rank's shards against the single device's whole parameters
    (sliced to the shard), and the metrics against its history."""
    import torch
    from repro_torch.models import common
    from repro_torch.tree import tree_leaves
    ref = torch.load(ref_path, map_location=got["params"][0].device)
    model, _, axes, _ = _model_setup(run, None, mesh)
    with common.mesh_axes_scope(axes):
        descs = tree_leaves(model.param_descs())
    err, scale = 0.0, 0.0
    for a, b, d in zip(got["params"], ref["params"], descs):
        b = b[common.shard_slice(d, axes, mesh)]
        err = max(err, float((a.float() - b.float()).abs().max()))
        scale = max(scale, float(b.float().abs().max()))
    out = {"err": err, "scale": scale, "loss": got["hist"]["loss"],
           "ref_loss": ref["loss"], "ms": got["hist"]["ms"],
           "ref_ms": ref["ms"], "peak": got["peak"],
           "counts": got["counts"], "collectives": got["collectives"],
           "model_all_reduces": got["model_all_reduces"],
           "fallbacks": got["fallbacks"], "record": got["record"],
           "momentum_width": got["momentum_width"], "tight": run[9],
           "seconds": got["seconds"]}
    for key, tag in (("grams", "gram"), ("sketch_grams", "sketch")):
        if got["hist"][key]:
            out[f"{tag}_err"] = max(float((a - b.cpu()).abs().max())
                                    for a, b in zip(got["hist"][key],
                                                    ref[key]))
            out[f"{tag}_scale"] = max(float(b.abs().max()) for b in ref[key])
    return out


def _model_resume(dev, mesh, tmp: str) -> dict:
    """22d on one rank: 22b's nnm+cwtm run through train_loop in segments
    of one step, uninterrupted, then killed after the first snapshot and
    resumed from it; this rank's shards and momentum block, bit for bit."""
    import dataclasses
    import torch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import common
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine
    from repro_torch.resilience import CheckpointConfig, FaultPlan
    from repro_torch.resilience.faults import SimulatedPreemption
    from repro_torch.rounds import RoundOptions
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_leaves
    run = MODEL_RUNS[1]
    steps = MODEL_RESUME_STEPS
    model, cfg, axes, tcfg = _model_setup(run, dev, mesh)
    batches = model_batches(cfg, run[4], steps)
    ck = CheckpointConfig(dir=f"{tmp}/22d", fault_plan=FaultPlan(kill_at=0))
    with tmesh.use_mesh(mesh), common.mesh_axes_scope(axes):
        init = model.init(0, dev)

        def go(options):
            final, info = train_loop(model.loss, init, iter(batches),
                                     sgd(clip=2.0), tcfg,
                                     cosine(0.05, steps, warmup=0), steps,
                                     seed=0, chunk=1, options=options)
            return [t.detach() for t in tree_leaves(final)] + \
                [info["state"]["momentum"]], info

        t0 = time.perf_counter()
        full, _ = go(None)
        try:
            go(RoundOptions(checkpoint=ck))
            killed = False
        except SimulatedPreemption:
            killed = True
        resumed, info = go(RoundOptions(checkpoint=dataclasses.replace(
            ck, fault_plan=None)))
        seconds = time.perf_counter() - t0
    equal = all(torch.equal(a, b) for a, b in zip(full, resumed))
    return {"killed": killed, "resumed_from":
            info["scan_report"]["resumed_from"], "equal": equal,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 22k-22r: cached decode and ServeEngine on the model mesh.
# ---------------------------------------------------------------------------

#: (label, arch, layers, dtype, batch, prompt, new, mesh shape): greedy
#: serving through ServeEngine at published widths from seeded weights,
#: each first on one device (the padded model whole), then over its mesh
#: (phase 22's world of that size): 22k-22p bf16, 22q the tight set in
#: fp32 (TF32 off).
MODEL_DECODE_RUNS = (
    ("22k", "qwen2-7b", 4, "bf16", 8, 64, 32, (2, 2)),
    ("22l", "mixtral-8x22b", 2, "bf16", 4, 64, 32, (1, 2)),
    ("22m", "internvl2-2b", 6, "bf16", 4, 64, 32, (1, 2)),
    ("22n", "rwkv6-3b", 8, "bf16", 4, 64, 32, (2, 2)),
    ("22o", "zamba2-2.7b", 12, "bf16", 4, 64, 32, (1, 2)),
    ("22p", "whisper-base", 2, "bf16", 4, 64, 32, (2, 2)),
    ("22q smollm", "smollm-360m", 4, "fp32", 4, 16, 16, (1, 2)),
    ("22q mixtral", "mixtral-8x22b", 1, "fp32", 4, 16, 16, (1, 2)),
    ("22q rwkv6", "rwkv6-3b", 2, "fp32", 4, 16, 16, (1, 2)),
    ("22q zamba2", "zamba2-2.7b", 6, "fp32", 4, 16, 16, (1, 2)),
    ("22q whisper", "whisper-base", 6, "fp32", 4, 16, 16, (1, 2)),
)
#: 22r, the KV cache's sequence split: qwen2-7b at 2 of 28 layers, fp32,
#: its kv heads unsplit (``MeshAxes(shard_kv=False)``: what the
#: reference's model axis of 16 gives qwen2's 4 kv heads; no published
#: arch at par 2 gives it) and max_seq 16384, a span above 8192.
#: (label, batch, mesh shape): batch 2 on (1, 2) puts the sequence over
#: the model axis ("seq_model"), batch 1 on (2, 2) over both ("seq_both").
MODEL_SEQ_RUNS = (("22r seq_model", 2, (1, 2)), ("22r seq_both", 1, (2, 2)))
SEQ_LAYERS, SEQ_SPAN = 2, 16384
#: (first position, steps, cache seed): the cache's first positions filled
#: from the seed, then seeded tokens stepped from there: from 12000 the
#: live slots span the ranks; from 100 every rank but the first holds only
#: masked slots.
SEQ_PARTS = ((12000, 8, 31), (100, 4, 32))
DECODE_FP32_REL = 1e-5               # 22q / 22r: of max |logits|, each leaf


def _decode_setup(run):
    """(model, config, MeshAxes) of one MODEL_DECODE_RUNS entry."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_axes_for
    from repro_torch.models import build_model
    _, arch, layers, dtype, *_ = run
    full = get_config(arch)
    cfg = full.replace(num_layers=layers, dtype=torch.bfloat16
                       if dtype == "bf16" else torch.float32)
    if full.encoder_layers:                 # whisper: cut with its decoder
        cfg = cfg.replace(encoder_layers=min(layers, full.encoder_layers))
    return build_model(cfg), cfg, mesh_axes_for(cfg, model_par=MODEL_PAR)


def _decode_rel(cfg) -> float:
    import torch
    if cfg.dtype == torch.float32:
        return DECODE_FP32_REL
    return SERVE_REL_RECURRENT if cfg.family in ("ssm", "hybrid") \
        else SERVE_REL


class RouterGaps(RouterPicks):
    """:class:`RouterPicks` that also keeps, per dispatch, the gap between
    the k-th and the (k+1)-th router probability of every (row, token)
    and the largest: what says whether a pick is a near-tie."""

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = orig = moe.top_k
        self.gaps: list = []

        def top_k(probs, k):
            vals, idx = orig(probs, min(k + 1, probs.shape[-1]))
            self.picks.append(idx[..., :k])
            self.gaps.append((vals[..., k - 1] - vals[..., -1],
                              vals[..., 0]))
            return vals[..., :k], idx[..., :k]

        moe.top_k = top_k
        return self


class RouterFollow(RouterPicks):
    """Inside a ``with`` block each MoE dispatch routes as another run did
    at the same dispatch (``want``: its (B, t, k) picks in order, this
    rank's rows ``lo:hi``), the gates read from this run's own
    probabilities at those experts (as :class:`RouterReplay`); this run's
    own picks are kept in ``picks``, to count where they differ."""

    def __init__(self, want: list, lo: int, hi: int):
        super().__init__()
        self.want, self.lo, self.hi = want, lo, hi

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._orig = orig = moe.top_k

        def top_k(probs, k):
            _, own = orig(probs, k)
            idx = self.want[len(self.picks)][self.lo:self.hi].to(
                probs.device)
            self.picks.append(own)
            return torch.gather(probs, -1, idx), idx

        moe.top_k = top_k
        return self


def _decode_start(model, cfg, params, eng, batch: int, max_seq: int, dev):
    """A fresh cache: whisper's from prefill_cache over seeded frames
    (the whole batch's; on a mesh each data rank encodes its rows)."""
    import torch
    if cfg.family != "encdec":
        return eng.init_cache()
    gen = torch.Generator(device=dev).manual_seed(22)
    frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                         generator=gen, device=dev)
    return model.prefill_cache(params, frames, batch, max_seq)


def _decode_one(run, dev, tmp: str) -> dict:
    """A MODEL_DECODE_RUNS entry on one device: greedy through
    clocked_generate, every step's logits, the final cache and the
    router's picks to ``tmp``; returns its numbers."""
    import numpy as np
    import torch
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import roofline
    from repro_torch.launch.serve import clocked_generate
    from repro_torch.models import common
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_leaves
    label, _, _, _, batch, prompt, new, _ = run
    model, cfg, axes = _decode_setup(run)
    max_seq = prompt + new
    prompts = np.random.default_rng(22).integers(0, cfg.vocab_size,
                                                 (batch, prompt))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with common.mesh_axes_scope(axes):
        params = model.init(0, dev)
        eng = ServeEngine(model, params, batch_size=batch, max_seq=max_seq)
        cache = _decode_start(model, cfg, params, eng, batch, max_seq, dev)
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        with RouterGaps() as route:
            out = clocked_generate(eng, prompts, new, cache, keep_logits=True)
        torch.cuda.synchronize(dev)
    launches = {k: v for k, v in kdispatch.launch_counts().items() if v}
    if launches:
        raise AssertionError(f"{label}: decode launched kernels: {launches}")
    no_fallback(label)
    logits = out["logits"]
    top2 = logits.topk(2, dim=-1).values
    torch.save({"logits": logits.cpu(),
                "tokens": torch.from_numpy(out["tokens"]),
                "cache": [t.cpu() for t in tree_leaves(cache)],
                "picks": [p.cpu() for p in route.picks]},
               f"{tmp}/{label}.decode.pt")
    bnd = statistics.median(
        [1e3 * max(t.memory_s, t.compute_s) for t in
         (roofline.decode_step_terms(cfg, batch, max_seq, prompt + i)
          for i in range(1, new - 1))])
    res = {"tokens": out["tokens"], "gap": (top2[..., 0] - top2[..., 1]
                                            ).cpu().numpy(),
           "scale": float(logits.abs().max()), "prefill_ms": out["prefill_ms"],
           "ms": statistics.median(out["step_ms"][1:]), "bound_ms": bnd,
           "peak": torch.cuda.max_memory_allocated(dev),
           "picks": [p.cpu().numpy() for p in route.picks],
           "router": [(g.cpu().numpy(), m.cpu().numpy())
                      for g, m in route.gaps]}
    del params, eng, cache, out, logits, route
    torch.cuda.empty_cache()
    return res


def _decode_rank(run, dev, mesh, tmp: str) -> dict:
    """A MODEL_DECODE_RUNS entry on one rank: the rank's own greedy run
    through clocked_generate (its tokens, prefill ms, ms per token,
    collectives a token), then a teacher-forced pass fed the one
    device's tokens: each step's logits of this rank's rows and the final
    cache's shard against the one device's.  The teacher-forced pass
    starts from a clone of the greedy run's prefill (the same prompts);
    a MoE's prefills its own cache, routing as the one device routed
    (:class:`RouterFollow`; its own picks kept)."""
    import numpy as np
    import torch
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.serve import clocked_generate
    from repro_torch.models import common
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_leaves, tree_map
    label, _, _, _, batch, prompt, new, _ = run
    model, cfg, axes = _decode_setup(run)
    max_seq = prompt + new
    prompts = np.random.default_rng(22).integers(0, cfg.vocab_size,
                                                 (batch, prompt))
    ref = torch.load(f"{tmp}/{label}.decode.pt")
    t_run = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with tmesh.use_mesh(mesh), common.mesh_axes_scope(axes):
        params = model.init(0, dev)
        eng = ServeEngine(model, params, batch_size=batch, max_seq=max_seq)
        lo, hi = common.batch_block(batch)
        kdispatch.reset_launch_counts()
        kdispatch.reset_fallbacks()
        kept: dict = {}

        def keep(c, p):
            c, lg, n = ServeEngine.prefill(eng, c, p)
            kept["cache"], kept["logits"] = tree_map(torch.clone, c), lg
            return c, lg, n

        start = _decode_start(model, cfg, params, eng, batch, max_seq, dev)
        eng.prefill = keep          # clocked_generate times it, then drops it
        tmesh.reset_collective_log()
        greedy = clocked_generate(eng, prompts, new, start)
        eng.__dict__.pop("prefill", None)
        colls = collective_summary()
        del start
        forced = torch.as_tensor(ref["tokens"], device=dev).long()[lo:hi]
        with torch.inference_mode(), RouterFollow(ref["picks"], lo,
                                                  hi) as route:
            cache, lg = kept.pop("cache"), kept.pop("logits")
            if cfg.num_experts:
                cache = _decode_start(model, cfg, params, eng, batch,
                                      max_seq, dev)
                cache, lg, _ = eng.prefill(cache, prompts)
            steps = [lg[:, -1]]
            for i in range(new - 1):
                lg, cache = model.decode_step(
                    params, cache, forced[:, i:i + 1], prompt + i,
                    batch=batch, max_seq=max_seq)
                steps.append(lg[:, -1])
        want = ref["logits"][lo:hi].to(dev)
        err = float((torch.stack(steps, 1) - want).abs().max())
        cdescs = model.cache_descs(batch, max_seq)
        cache_err = 0.0
        for got, whole, d in zip(tree_leaves(cache), ref["cache"],
                                 tree_leaves(cdescs)):
            w = whole[common.shard_slice(d, axes, mesh)].to(dev).float()
            cache_err = max(cache_err, float((got.float() - w).abs().max())
                            / max(float(w.abs().max()), 1e-30))
        launches = {k: v for k, v in kdispatch.launch_counts().items() if v}
        fallbacks = [f"{d.primitive}: {d.used} ({d.reason})"
                     for d in kdispatch.fallback_log()]
    calls = prompt + new - 1
    out = {"err": err, "cache_err": cache_err, "tokens": greedy["tokens"],
           "prefill_ms": greedy["prefill_ms"],
           "ms": statistics.median(greedy["step_ms"][1:]),
           "per_token": {k: c["calls"] / calls for k, c in colls.items()},
           "peak": torch.cuda.max_memory_allocated(dev),
           "launches": launches, "fallbacks": fallbacks,
           "picks": [p.cpu().numpy() for p in route.picks]
           if cfg.num_experts else None, "rows": (lo, hi),
           "seconds": time.perf_counter() - t_run}
    del params, eng, greedy, cache, steps, want, forced
    torch.cuda.empty_cache()
    return out


def _seq_cache(model, batch: int, fill: int, seed: int, dev):
    """The whole 22r cache: its first ``fill`` positions seeded normal
    values (the same on every rank and on one device), zeros after."""
    import torch
    from repro_torch.tree import tree_leaves, tree_map
    gen = torch.Generator(device=dev).manual_seed(seed)
    cache = tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                           device=dev),
                     model.cache_descs(batch, SEQ_SPAN))
    for t in tree_leaves(cache):
        t[:, :, :fill] = torch.randn(t[:, :, :fill].shape, generator=gen,
                                     device=dev, dtype=t.dtype)
    return cache


def _seq_setup():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import MeshAxes
    cfg = get_config("qwen2-7b").replace(num_layers=SEQ_LAYERS,
                                         dtype=torch.float32)
    return build_model(cfg), cfg, MeshAxes(model_par=MODEL_PAR,
                                           shard_kv=False)


def _seq_steps(model, params, cache, batch: int, pos0: int, steps: int,
               dev, lo: int, hi: int) -> tuple[list, list]:
    """Seeded tokens stepped from ``pos0``: each step's logits (this
    rank's rows) and ms."""
    import numpy as np
    import torch
    tokens = torch.as_tensor(np.random.default_rng(pos0).integers(
        0, model.cfg.vocab_size, (batch, steps)), device=dev)[lo:hi]
    logits, ms = [], []
    for i in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, cache, tokens[:, i:i + 1],
                                      pos0 + i, batch=batch,
                                      max_seq=SEQ_SPAN)
        torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(lg)
    return logits, ms


def _seq_one(run, dev, tmp: str) -> dict:
    """22r on one device: every part's logits and final cache to
    ``tmp``."""
    import torch
    from repro_torch.models import common
    from repro_torch.tree import tree_leaves
    label, batch, _ = run
    model, cfg, axes = _seq_setup()
    saved, ms = {}, []
    with common.mesh_axes_scope(axes):
        params = model.init(0, dev)
        for pos0, steps, seed in SEQ_PARTS:
            cache = _seq_cache(model, batch, pos0, seed, dev)
            lg, part_ms = _seq_steps(model, params, cache, batch, pos0,
                                     steps, dev, 0, batch)
            ms += part_ms[1:]
            saved[pos0] = {"logits": [t.cpu() for t in lg],
                           "cache": [t.cpu() for t in tree_leaves(cache)]}
            del cache
    torch.save(saved, f"{tmp}/{label}.seq.pt")
    del params
    torch.cuda.empty_cache()
    return {"ms": statistics.median(ms)}


def _seq_rank(run, dev, mesh, tmp: str) -> dict:
    """22r on one rank: every part against the one device's logits (this
    rank's rows) and cache (this rank's shard)."""
    import torch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import attention, common
    from repro_torch.tree import tree_leaves
    from repro_torch.tree import tree_map
    label, batch, _ = run
    model, cfg, axes = _seq_setup()
    ref = torch.load(f"{tmp}/{label}.seq.pt")
    err, cache_err, ms = 0.0, 0.0, []
    torch.cuda.reset_peak_memory_stats(dev)
    with tmesh.use_mesh(mesh), common.mesh_axes_scope(axes):
        seq_axes = attention.cache_seq_axes(cfg, batch, SEQ_SPAN)
        params = model.init(0, dev)
        descs = tree_leaves(model.cache_descs(batch, SEQ_SPAN))
        lo, hi = common.batch_block(batch)
        tmesh.reset_collective_log()
        for pos0, steps, seed in SEQ_PARTS:
            whole = _seq_cache(model, batch, pos0, seed, dev)
            cache = tree_map(lambda t, d: t[common.shard_slice(
                d, axes, mesh)].clone(), whole,
                model.cache_descs(batch, SEQ_SPAN))
            del whole
            lg, part_ms = _seq_steps(model, params, cache, batch, pos0, steps,
                                     dev, lo, hi)
            ms += part_ms[1:]
            want = ref[pos0]
            for a, b in zip(lg, want["logits"]):
                b = b[lo:hi].to(dev)
                err = max(err, float((a - b).abs().max())
                          / float(b.abs().max()))
            for a, b, d in zip(tree_leaves(cache), want["cache"], descs):
                scale = float(b.abs().max())
                b = b[common.shard_slice(d, axes, mesh)].to(dev)
                cache_err = max(cache_err,
                                float((a - b).abs().max()) / scale)
            del cache
        colls = collective_summary()
    calls = sum(steps for _, steps, _ in SEQ_PARTS)
    return {"err": err, "cache_err": cache_err, "ms": statistics.median(ms),
            "seq_axes": seq_axes, "span": descs[0].shape[2] // mesh.size(
                seq_axes),
            "per_token": {k: c["calls"] / calls for k, c in colls.items()},
            "peak": torch.cuda.max_memory_allocated(dev)}


def _check_decode(run, one: dict, ranks: list, card: str) -> None:
    """A MODEL_DECODE_RUNS entry's contracts on every rank, its line
    logged: the teacher-forced logits within the bound of max |logits|
    (fp32: every cache leaf too), the greedy tokens equal on every rank
    and equal the one device's until the row's first difference, which
    must lie at a near-tie (the one device's top two logits within the
    bound, whatever this run's own gap) or at or after the first output
    step a routing flip reaches; MoE routing
    flips only at near-ties of the router (its k-th and (k+1)-th
    probabilities within SERVE_REL of the largest), no launch, no
    fallback, the summed peak under MODEL_PEAK_GB."""
    import numpy as np
    label, arch, layers, dtype, batch, prompt, new, shape = run
    _, cfg, axes = _decode_setup(run)
    rel = _decode_rel(cfg)
    tol = rel * one["scale"]
    worst = max(r["err"] for r in ranks)
    for i, r in enumerate(ranks):
        if r["launches"] or r["fallbacks"]:
            raise AssertionError(f"{label} rank {i}: launches "
                                 f"{r['launches']}, fallbacks "
                                 f"{r['fallbacks']}")
        if r["err"] > tol:
            raise AssertionError(f"{label} rank {i}: teacher-forced logits "
                                 f"off by {r['err']:.4g} > {tol:.4g}")
        if dtype == "fp32" and r["cache_err"] > DECODE_FP32_REL:
            raise AssertionError(f"{label} rank {i}: cache off by "
                                 f"{r['cache_err']:.3g} of its max")
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError(f"{label}: the ranks' tokens differ")
    # A routing flip (the world's own top-k against the one device's, at
    # the same dispatch) must be a near-tie of the router; the greedy run
    # follows its own routing, so a row is compared only up to the first
    # output step a flip reaches.
    first = np.full(batch, new)
    flips = 0
    blocks = {r["rows"]: r for r in ranks} if cfg.num_experts else {}
    for (lo, hi), r in blocks.items():
        for c, (got, want, (gap, top)) in enumerate(zip(
                r["picks"], one["picks"], one["router"])):
            diff = (np.sort(got, -1) != np.sort(want[lo:hi], -1)).any(-1)
            flips += int(diff.sum())
            if (diff & (gap[lo:hi] > SERVE_REL * top[lo:hi])).any():
                raise AssertionError(f"{label}: a routing flip away from a "
                                     f"near-tie")
            rows = lo + np.nonzero(diff.any(-1))[0]
            first[rows] = np.minimum(
                first[rows], max(0, c // cfg.num_layers - prompt + 1))
    cut = []
    for b in range(batch):
        differ = ranks[0]["tokens"][b] != one["tokens"][b]
        if not differ.any():
            continue
        t0 = int(np.argmax(differ))
        if t0 < first[b] and one["gap"][b, t0] > tol:
            raise AssertionError(f"{label} row {b}: greedy tokens "
                                 f"{ranks[0]['tokens'][b].tolist()} vs one "
                                 f"device {one['tokens'][b].tolist()} differ "
                                 f"at step {t0}, whose top two lie "
                                 f"{one['gap'][b, t0]:.4g} apart (> {tol:.4g})")
        cut.append(t0)
    peaks = [r["peak"] / 1e9 for r in ranks]
    if sum(peaks) > MODEL_PEAK_GB:
        raise AssertionError(f"{label}: summed peak {sum(peaks):.2f} GB > "
                             f"{MODEL_PEAK_GB}")
    per = ranks[0]["per_token"]
    colls = ", ".join(f"{k} {v:.1f}" for k, v in sorted(per.items()))
    extra = (f"; routing replayed from one device, its own top-k differed "
             f"in {flips} (dispatch, row) decisions, each a router near-tie"
             if cfg.num_experts else "")
    log(f"  {label} {arch} {dtype}: {layers} of {get_full_layers(arch)} "
        f"layers, {padded_heads(cfg, axes)}, batch {batch}, prompt {prompt}, "
        f"new {new}, mesh (data {shape[0]}, model {shape[1]}): prefill "
        f"{one['prefill_ms']:.1f} ms one device / {ranks[0]['prefill_ms']:.1f}"
        f" world; {one['ms']:.3f} ms per decoded token one device (bound "
        f"{one['bound_ms']:.3f}) / {ranks[0]['ms']:.3f} world (rank 0, "
        f"median step after the first); teacher-forced logits max |diff| "
        f"{worst:.4g} (tol {rel:g} x {one['scale']:.4g} = {tol:.4g}), cache "
        f"max |diff| {max(r['cache_err'] for r in ranks):.3g} of its max; "
        f"greedy tokens equal the one device's"
        + (f" except from a near-tie on in {len(cut)} of {batch} rows "
           f"(steps {cut}; {batch * new - sum(new - t for t in cut)} of "
           f"{batch * new} tokens equal)" if cut else f" (all {batch * new})") + f"{extra}; collectives a token a rank: "
        f"{colls}; peaks {[round(p, 2) for p in peaks]} GB (sum "
        f"{sum(peaks):.2f}); no kernel launch, no fallback; "
        f"{max(r['seconds'] for r in ranks):.1f} s; card {card}")


def _check_seq(run, one: dict, ranks: list, card: str) -> None:
    """22r's contracts on every rank, its line logged."""
    label, batch, shape = run
    want = ("model",) if batch > 1 else ("data", "model")
    for i, r in enumerate(ranks):
        if r["seq_axes"] != want:
            raise AssertionError(f"{label} rank {i}: sequence over "
                                 f"{r['seq_axes']}, expected {want}")
        if max(r["err"], r["cache_err"]) > DECODE_FP32_REL:
            raise AssertionError(f"{label} rank {i}: logits off by "
                                 f"{r['err']:.3g}, cache {r['cache_err']:.3g}"
                                 f" of their max")
    per = ranks[0]["per_token"]
    colls = ", ".join(f"{k} {v:.1f}" for k, v in sorted(per.items()))
    log(f"  {label}: qwen2-7b {SEQ_LAYERS} of 28 layers, fp32, kv heads "
        f"unsplit, batch {batch}, span {SEQ_SPAN} over {want} "
        f"({ranks[0]['span']} slots a rank), mesh (data {shape[0]}, model "
        f"{shape[1]}); steps from {[p for p, _, _ in SEQ_PARTS]}: logits max "
        f"|diff| {max(r['err'] for r in ranks):.3g}, cache "
        f"{max(r['cache_err'] for r in ranks):.3g} of their max (tol "
        f"{DECODE_FP32_REL:g}); {one['ms']:.3f} ms a step one device / "
        f"{ranks[0]['ms']:.3f} world (rank 0); collectives a step a rank: "
        f"{colls}; peaks {[round(r['peak'] / 1e9, 2) for r in ranks]} GB; "
        f"card {card}")


def _model_rank(rank: int, world: int, tmp: str) -> dict:
    """Phase 22 on one rank of a (world / 2, 2) ("data", "model") mesh:
    every MODEL_RUNS entry for this mesh shape, then (4 ranks) 22d, then
    the decode runs (MODEL_DECODE_RUNS, MODEL_SEQ_RUNS) of this shape."""
    import torch
    dev = _rank_setup(rank)
    from repro_torch.launch import mesh as tmesh
    shape = (world // MODEL_PAR, MODEL_PAR)
    mesh = tmesh.make_debug_mesh(*shape)
    out = {"rank": rank, "runs": {}, "counts": {}, "decode": {}, "seq": {}}
    for run in MODEL_RUNS:
        if shape not in run[8]:
            continue
        got = _model_train(run, dev, mesh, gram=run[9])
        row = _model_compare(run, got, f"{tmp}/{run[0]}.pt", mesh)
        add_counts(out["counts"], row["counts"])
        out["runs"][run[0]] = row
        del got
        torch.cuda.empty_cache()
    if world == 4:
        out["resume"] = _model_resume(dev, mesh, tmp)
    for run in MODEL_DECODE_RUNS:
        if run[7] == shape:
            out["decode"][run[0]] = _decode_rank(run, dev, mesh, tmp)
    for run in MODEL_SEQ_RUNS:
        if run[2] == shape:
            out["seq"][run[0]] = _seq_rank(run, dev, mesh, tmp)
    return out


def phase_model_mesh(dev, card: str) -> dict:
    """Phase 22; returns the launches summed over every rank."""
    import tempfile
    import torch
    total: dict = {}
    single: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in MODEL_RUNS:
            t0 = time.perf_counter()
            got = _model_train(run, dev, None, gram=run[9])
            add_counts(single, got["counts"])
            model, cfg, axes, tcfg = _model_setup(run, dev, None)
            update = _largest_update(model, axes, got["params"], dev)
            log(f"-- {run[0]}: {run[1]} {run[2]} of "
                f"{get_full_layers(run[1])} layers, {run[3]}, d "
                f"{cfg.d_model}, heads {cfg.num_heads} -> "
                f"{padded_heads(cfg, axes)} (model axis {MODEL_PAR}), n="
                f"{run[4]} f={run[5]}, {run[6]}, ALIE, {run[7]} steps; "
                f"fsdp_keys {tcfg.fsdp_keys}; D = {got['params_total']:,} "
                f"(robust {got['width']:,})")
            log(f"  single device: ms/step "
                f"{[round(v, 1) for v in got['hist']['ms']]}, loss "
                f"{got['hist']['loss']}, largest |update| {update:.3e}, peak "
                f"{got['peak'] / 1e9:.2f} GB, launches {got['counts']} "
                f"({time.perf_counter() - t0:.1f} s)")
            if got["fallbacks"]:
                raise AssertionError(f"{run[0]}: fallbacks {got['fallbacks']}")
            _check_run_launches(run[0], got["counts"], run[6])
            torch.save({"params": got["params"], "loss": got["hist"]["loss"],
                        "ms": got["hist"]["ms"], "grams": got["hist"]["grams"],
                        "sketch_grams": got["hist"]["sketch_grams"]},
                       f"{tmp}/{run[0]}.pt")
            del got
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        one = {run[0]: _decode_one(run, dev, tmp) for run in MODEL_DECODE_RUNS}
        seq_one = {run[0]: _seq_one(run, dev, tmp) for run in MODEL_SEQ_RUNS}
        log(f"  22k-22r on one device: {time.perf_counter() - t0:.1f} s")
        for world in (2, 4):
            t0 = time.perf_counter()
            ranks = world_run(_model_rank, world, (tmp,), limit=MESH_LIMIT)
            log(f"  world of {world} ranks, mesh (data {world // MODEL_PAR}, "
                f"model {MODEL_PAR}) over gloo on one card ({card}): "
                f"{time.perf_counter() - t0:.1f} s")
            _check_model_world(world, ranks)
            for run in MODEL_DECODE_RUNS:
                if run[0] in ranks[0]["decode"]:
                    _check_decode(run, one[run[0]],
                                  [r["decode"][run[0]] for r in ranks], card)
            for run in MODEL_SEQ_RUNS:
                if run[0] in ranks[0]["seq"]:
                    _check_seq(run, seq_one[run[0]],
                               [r["seq"][run[0]] for r in ranks], card)
            for r in ranks:
                add_counts(total, r["counts"])
    return add_counts(total, single)


def _largest_update(model, axes, params: list, dev) -> float:
    """The largest |final - initial| element over the run's parameters:
    what a bound on the parameters has to lie below to catch a wrong or
    missing gradient."""
    from repro_torch.models import common
    from repro_torch.tree import tree_leaves
    with common.mesh_axes_scope(axes):
        init = tree_leaves(model.init(0, dev))
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(params, init))


def get_full_layers(arch: str) -> int:
    from repro_torch.configs import get_config
    return get_config(arch).num_layers


def padded_heads(cfg, axes) -> str:
    from repro_torch.models import attention, common, rwkv, ssm
    mixer = {"ssm": ("rwkv6", rwkv), "hybrid": ("Mamba2", ssm)}
    with common.mesh_axes_scope(axes):
        hq, hkv = attention.resolved_heads(cfg)
        out = f"{hq} q / {hkv} kv (from {cfg.num_heads} / {cfg.num_kv_heads})"
        if cfg.family in mixer:
            kind, mod = mixer[cfg.family]
            out += f", {mod._dims(cfg)[0]} {kind} heads (from {cfg.ssm_heads})"
    return out


def _check_run_launches(name: str, counts: dict, spec: dict) -> None:
    """A run's launches: K1 and K2 (K6 / K7 and K2 on the hierarchical
    form; K2 and no K1 on the sketch route)."""
    if spec.get("sketch_dim"):
        ok = counts["gram"] == 0 and counts["mixtrim"] > 0
    elif spec.get("hier"):
        ok = counts["mixtrim"] > 0 and (counts["bucketgram"]
                                        or counts["bucketmeans"])
    else:
        ok = counts["gram"] > 0 and counts["mixtrim"] > 0
    if not ok:
        raise AssertionError(f"{name}: launches {counts} ({spec})")


def _check_model_world(world: int, ranks: list, runs=MODEL_RUNS) -> None:
    """Phase 22's contracts on one world's results, each rank's line
    logged, then each run's summed peak and time (phase 23 with its
    ``runs``)."""
    specs = {run[0]: run[6] for run in runs}
    for r in ranks:
        for name, row in r["runs"].items():
            _check_run_launches(f"{name} rank {r['rank']}", row["counts"],
                                specs[name])
            if row["fallbacks"]:
                raise AssertionError(f"{name} rank {r['rank']}: fallbacks "
                                     f"{row['fallbacks']}")
            tight = row["tight"]
            ptol = (1e-5 * row["scale"]) if tight else 5e-3
            if row["err"] > ptol:
                raise AssertionError(f"{name} rank {r['rank']}: parameters "
                                     f"off by {row['err']} > {ptol}")
            for a, b in zip(row["loss"], row["ref_loss"]):
                if abs(a - b) > (1e-5 * abs(b) if tight else 1e-3):
                    raise AssertionError(f"{name}: loss {row['loss']} vs one "
                                         f"device {row['ref_loss']}")
            grams = ""
            for tag in ("gram", "sketch") if tight else ():
                if f"{tag}_err" not in row:
                    continue
                tol = 1e-5 * row[f"{tag}_scale"]
                if row[f"{tag}_err"] > tol:
                    raise AssertionError(f"{name} rank {r['rank']}: {tag} "
                                         f"Gram off by {row[f'{tag}_err']} "
                                         f"> {tol}")
                grams += (f", {tag} Gram max |diff| {row[f'{tag}_err']:.3e} "
                          f"(tol {tol:.3e})")
            WORLD_ROWS[(name, r["rank"])] = row
            log(f"  {name} rank {r['rank']}: ms/step "
                f"{[round(v, 1) for v in row['ms']]} (one device "
                f"{[round(v, 1) for v in row['ref_ms']]}), loss "
                f"{row['loss']} (one device {row['ref_loss']}), parameters "
                f"max |diff| {row['err']:.3e} (tol {ptol:.3e}){grams}, peak "
                f"{row['peak'] / 1e9:.2f} GB, block width "
                f"{row['momentum_width']:,}, launches {row['counts']}, "
                f"model-axis all-reduces / step {row['model_all_reduces']:.0f}"
                f"; collectives {row['collectives']}")
        if r["rank"] == 0:
            for name, row in r["runs"].items():
                log(f"  {name}: {row['record']}")
        if "resume" in r:
            res = r["resume"]
            if not (res["killed"] and res["resumed_from"] == 1
                    and res["equal"]):
                raise AssertionError(f"22d rank {r['rank']}: {res}")
            log(f"  22d rank {r['rank']}: killed after step 1's snapshot, "
                f"resumed from {res['resumed_from']}, shards and momentum "
                f"equal bit for bit ({res['seconds']:.1f} s)")
    for name in ranks[0]["runs"]:
        rows = [r["runs"][name] for r in ranks]
        peak = sum(row["peak"] for row in rows)
        log(f"  {name} on {world} ranks: peaks "
            f"{[round(row['peak'] / 1e9, 2) for row in rows]} GB, the "
            f"world's sum {peak / 1e9:.2f} GB; "
            f"{max(row['seconds'] for row in rows):.1f} s")
        if peak / 1e9 > MODEL_PEAK_GB:
            raise AssertionError(f"{name}: summed peak {peak / 1e9:.2f} GB > "
                                 f"{MODEL_PEAK_GB}")


# ---------------------------------------------------------------------------
# Phase 23: sequence parallelism and expert FSDP on the model mesh.
# ---------------------------------------------------------------------------

#: MODEL_RUNS entries with a 12th field, the MeshAxes changes; each runs
#: on one device first (the layout changes nothing there), then on (2, 2).
SEQ_FSDP_RUNS = (
    ("23a", "smollm-360m", 4, "bf16", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 2, ((2, 2),), False, False,
     dict(seq_par=True)),
    ("23b", "smollm-360m", 2, "fp32", N_MAIN, F_MAIN,
     dict(pre="nnm", rule="cwtm"), 2, ((2, 2),), True, False,
     dict(seq_par=True)),
    # One step: the reference's sharded-vs-single contract (its loss and
    # the parameters after it); a second step's loss drifts past 1e-3
    # with the robust aggregate's and the router's choices (PERF.md).
    ("23c", "mixtral-8x22b", 1, "bf16", 4, 1,
     dict(pre="nnm", rule="cwtm"), 1, ((2, 2),), False, True,
     dict(seq_par=True, expert_fsdp=True)),
)
#: The runs whose collectives 23d reckons with the dry run.
SEQ_FSDP_DRY = ("23a", "23c")
#: Each world row of phases 22 / 23 by (run, rank), for 23's comparison.
WORLD_ROWS: dict = {}


def _dry_trainer(run):
    """A SEQ_FSDP_RUNS entry's (config, TrainerConfig, MeshAxes changes,
    fsdp_keys) as ``launch.dryrun.dryrun_one`` takes them."""
    import dataclasses
    import torch
    model, cfg, axes, tcfg = _model_setup(run, torch.device("cpu"), None)
    # The world's backend; worker axes and specs come from the dry run.
    tcfg = dataclasses.replace(tcfg, agg=dataclasses.replace(
        tcfg.agg, backend="cuda_sharded"))
    return cfg, tcfg, run[11], tcfg.fsdp_keys


def dry_seq_fsdp() -> dict:
    """23d's dry runs (``--23d-dry``, a CPU process): each run of
    SEQ_FSDP_DRY as rank 0 of a fake (2, 2) world, one step of MODEL_BATCH
    x MODEL_SEQ tokens a worker; {run: {"collectives", "flops",
    "peak_bytes"}}."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    out = {}
    for run in SEQ_FSDP_RUNS:
        if run[0] not in SEQ_FSDP_DRY:
            continue
        cfg, tcfg, layout, keys = _dry_trainer(run)
        n = run[4]
        rec = dryrun.dryrun_one(
            run[1], "train_4k", cfg=cfg, verbose=False, mesh_shape=(2, 2),
            shape=InputShape(run[0], MODEL_SEQ, n * MODEL_BATCH, "train"),
            n_workers=n, trainer=tcfg, fsdp_keys=keys,
            seq_par=layout.get("seq_par", False),
            expert_fsdp=layout.get("expert_fsdp", False))
        out[run[0]] = {"collectives": rec["collectives"],
                       "flops": rec["cost"]["flops"],
                       "peak_bytes": rec["memory"]["peak_bytes"]}
    return out


def _seq_fsdp_rank(rank: int, world: int, tmp: str) -> dict:
    """Phase 23 on one rank of the (2, 2) world: every SEQ_FSDP_RUNS
    entry against its one-device run."""
    import torch
    dev = _rank_setup(rank)
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_debug_mesh(2, MODEL_PAR)
    out = {"rank": rank, "runs": {}, "counts": {}}
    for run in SEQ_FSDP_RUNS:
        got = _model_train(run, dev, mesh, gram=run[9])
        row = _model_compare(run, got, f"{tmp}/{run[0]}.pt", mesh)
        add_counts(out["counts"], row["counts"])
        out["runs"][run[0]] = row
        del got
        torch.cuda.empty_cache()
    return out


def _per_step(colls: dict, steps: int) -> dict:
    """Phase 22 / 23's collective summary ({"op/axis/transport": {calls,
    bytes, s}}) as the dry run keys it ({"op@axis": {calls, bytes}}), a
    step's worth."""
    out: dict = {}
    for key, row in colls.items():
        op, axis, _ = key.split("/")
        if row["calls"] % steps or row["bytes"] % steps:
            raise AssertionError(f"{key}: {row} does not split over "
                                 f"{steps} equal steps")
        out[f"{op}@{axis}"] = {"calls": row["calls"] // steps,
                               "bytes": row["bytes"] // steps}
    return out


def phase_seq_fsdp(dev, card: str) -> dict:
    """Phase 23; returns the launches summed over every rank."""
    import tempfile
    import torch
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    dry = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                            "--23d-dry"], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env)
    total: dict = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for run in SEQ_FSDP_RUNS:
                t0 = time.perf_counter()
                got = _model_train(run, dev, None, gram=run[9])
                add_counts(total, got["counts"])
                model, cfg, axes, tcfg = _model_setup(run, dev, None)
                log(f"-- {run[0]}: {run[1]} {run[2]} of "
                    f"{get_full_layers(run[1])} layers, {run[3]}, "
                    f"{run[11]}, n={run[4]} f={run[5]}, {run[6]}, ALIE, "
                    f"{run[7]} steps; fsdp_keys {tcfg.fsdp_keys}; D = "
                    f"{got['params_total']:,} (robust {got['width']:,})")
                log(f"  single device: ms/step "
                    f"{[round(v, 1) for v in got['hist']['ms']]}, loss "
                    f"{got['hist']['loss']}, peak {got['peak'] / 1e9:.2f} "
                    f"GB, launches {got['counts']} "
                    f"({time.perf_counter() - t0:.1f} s)")
                if got["fallbacks"]:
                    raise AssertionError(f"{run[0]}: fallbacks "
                                         f"{got['fallbacks']}")
                _check_run_launches(run[0], got["counts"], run[6])
                torch.save({"params": got["params"],
                            "loss": got["hist"]["loss"],
                            "ms": got["hist"]["ms"],
                            "grams": got["hist"]["grams"],
                            "sketch_grams": got["hist"]["sketch_grams"]},
                           f"{tmp}/{run[0]}.pt")
                del got
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = world_run(_seq_fsdp_rank, 4, (tmp,), limit=MESH_LIMIT)
            log(f"  world of 4 ranks, mesh (data 2, model {MODEL_PAR}) over "
                f"gloo on one card ({card}): {time.perf_counter() - t0:.1f} s")
            _check_model_world(4, ranks, SEQ_FSDP_RUNS)
            for r in ranks:
                add_counts(total, r["counts"])
        t0 = time.perf_counter()
        stdout, stderr = dry.communicate(timeout=MESH_LIMIT)
        if dry.returncode != 0:
            raise AssertionError(f"23d: the dry run failed:\n{stderr[-3000:]}")
        reck = json.loads(stdout.strip().splitlines()[-1])
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    log(f"-- 23d: launch.dryrun of {', '.join(SEQ_FSDP_DRY)} on a fake "
        f"(2, 2) world, rank 0, on the CPU (waited "
        f"{time.perf_counter() - t0:.1f} s after the world)")
    steps = {run[0]: run[7] for run in SEQ_FSDP_RUNS}
    for name in SEQ_FSDP_DRY:
        row = ranks[0]["runs"][name]
        got = _per_step(row["collectives"], steps[name])
        want = reck[name]["collectives"]
        if got != want:
            raise AssertionError(f"23d {name}: measured collectives a step "
                                 f"{got} != the dry run's {want}")
        ms = statistics.median(row["ms"])
        flops = reck[name]["flops"]
        log(f"  {name} rank 0: collectives a step equal the dry run's "
            f"{want}; dry-run FLOPs a step {flops:.4e} (FlopCounterMode) "
            f"beside the measured {ms:.1f} ms a step: "
            f"{flops / (ms / 1e3) / 1e12:.3f} TFLOP/s; dry-run peak "
            f"{reck[name]['peak_bytes'] / 1e9:.2f} GB, measured "
            f"{row['peak'] / 1e9:.2f} GB")
    for name in ("23a", "23c"):
        for r in ranks:
            row = r["runs"][name]
            base = WORLD_ROWS.get(("22a" if name == "23a" else "22c",
                                   r["rank"]))
            beside = "" if base is None else (
                f"; without it ({'22a' if name == '23a' else '22c'}): ms/step "
                f"{[round(v, 1) for v in base['ms']]}, peak "
                f"{base['peak'] / 1e9:.2f} GB, collectives a step "
                f"{_per_step(base['collectives'], 2)}")
            log(f"  {name} rank {r['rank']}: ms/step "
                f"{[round(v, 1) for v in row['ms']]}, peak "
                f"{row['peak'] / 1e9:.2f} GB, collectives a step "
                f"{_per_step(row['collectives'], steps[name])}{beside}")
    return total


def main() -> int:
    import torch
    if sys.argv[1:] == ["--23d-dry"]:
        # 23d's CPU helper: phase 23 starts it; needs no card.
        print(json.dumps(dry_seq_fsdp()))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def head(title: str) -> None:
        log(f"== {title} [{time.perf_counter() - t_start:.0f} s]")

    from repro_torch.kernels import _build

    head("1. environment")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    rate = mem_rate(name)
    log(f"memory rate for bounds: {rate / 1e12:.2f} TB/s; fp32 peak "
        f"{FP32_TFLOPS / 1e12:.0f} TFLOP/s (data sheet)")

    head("2. build")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_SECONDS:.1f} s)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line.lower() or line.startswith("=="):
            log("  " + line.strip())

    if sys.argv[1:] == ["--18d"]:
        head("18d alone: the launch-sized shapes, host and device per call")
        phase_launch_sizes(dev, rate)
        log(card)
        return 0
    if sys.argv[1:] == ["--22"]:
        head("22 alone: the model-parallel mesh")
        log(json.dumps({"model_mesh_launches": phase_model_mesh(dev, card)}))
        log(card)
        return 0
    if sys.argv[1:] == ["--23"]:
        head("23 alone: sequence parallelism and expert FSDP")
        log(json.dumps({"seq_fsdp_launches": phase_seq_fsdp(dev, card)}))
        log(card)
        return 0

    head("3. kernels against their plain versions")
    rows = phase_kernels(dev, rate)
    phase_k2_wide(dev, rate)
    phase_gram_sweep(dev, rate)

    head("4. K6 / K7 against their plain versions")
    rows.update(phase_bucketgram(dev, rate))

    head("5. K2 above 64 workers against its plain version")
    phase_mixtrim_large(dev, rate)

    head("6. hierarchical aggregates at n = 10240 (640 means)")
    hier_refs = tempfile.TemporaryDirectory()       # phase 21b reads it
    hier = phase_hier_aggregate(dev, rate, hier_refs.name)
    rows.update(hier["rows"])

    head("7. main path: nnm+cwtm, 3 steps, full-width smollm-360m")
    out, counts_main = run_train("nnm+cwtm", 3, capture=True)
    if counts_main["gram"] != 3 or counts_main["mixtrim"] != 3:
        raise AssertionError(f"expected 3 K1 and 3 K2 launches: {counts_main}")
    peak7 = out["peak_bytes"]
    log(out["dispatch"].describe())
    del out["state"]
    torch.cuda.empty_cache()
    phase_backends(out)
    del out
    torch.cuda.empty_cache()

    head("8. gram-rule path: nnm+gm, 2 steps, full depth")
    out, counts_gm = run_train("nnm+gm", 2, capture=False)
    if counts_gm["combine"] != 2 or counts_gm["gram"] != 2:
        raise AssertionError(f"expected 2 K1 and 2 K3 launches: {counts_gm}")
    del out
    torch.cuda.empty_cache()

    head(f"9. hierarchical trainer: n={N_HIER} f={F_HIER}, full-width "
         f"smollm-360m at {HIER_TRAIN_LAYERS} of 32 layers")
    counts_hier = run_loop(dev, "hier+nnm+cwtm", dict(pre="nnm", rule="cwtm"), 3,
                           dict(bucketgram=1, mixtrim=1, gram=0,
                                bucketmeans=0, combine=0))
    counts_hmean = run_loop(dev, "hier+cwtm", dict(pre=None, rule="cwtm"), 2,
                            dict(bucketmeans=1, mixtrim=1, gram=0,
                                 bucketgram=0, combine=0))
    run_loop(dev, "hier+nnm+gm", dict(pre="nnm", rule="gm"), 2,
             dict(bucketgram=1, combine=1, gram=0, bucketmeans=0, mixtrim=0))
    out, counts_bkt = run_train("bucketing+cwtm", 2, capture=False, n=N_HIER,
                                f=F_HIER)
    want = dict(mixtrim=2, gram=0, bucketgram=0, bucketmeans=0, combine=0)
    if {k: counts_bkt[k] for k in want} != want:
        raise AssertionError(f"bucketing+cwtm: launches {counts_bkt}, "
                             f"expected {want}")
    del out
    torch.cuda.empty_cache()

    head("10. K5 / K4 on lane-batched stacks")
    phase_ptxas()
    phase_sort_01(dev)
    rows.update(phase_fleet_kernels(dev, rate))

    head(f"11. fleet grid: --full, {GRID_ROUNDS} rounds, n=17 f=4 alpha=0.1")
    counts_grid = phase_grid(dev, GRID_ROUNDS)

    head("12. the federated engine")
    log("-- 12a. registry scenarios, 20 rounds, the 48-48-10 MLP (D = 2842)")
    counts_fed = phase_fed_scenarios(dev, rate)
    log("-- 12b. FedServer + run_rounds at full width: smollm-360m, ALIE "
        "eta 8, NNM + CWTM")
    counts_fed["fed full width"] = phase_fed_full(dev, rate)

    head("13. resumable runs: the trainer's scan engine, kill and resume")
    counts_resume = phase_resume_trainer(dev)
    log("-- 13c. fed: labelskew_alie_partial, 20 rounds in segments of 5, "
        "killed and torn, resumed")
    for k, v in phase_resume_fed(dev).items():
        counts_resume[k] = counts_resume.get(k, 0) + v
    log("-- 13d. fleet: the cwtm|nnm grid bucket, killed and resumed")
    for k, v in phase_resume_fleet(dev).items():
        counts_resume[k] = counts_resume.get(k, 0) + v
    log(json.dumps({"resume_launches": counts_resume}))

    head("14. the continuous fleet service (repro_torch.serving)")
    log(f"-- 14a. the grid up front: FleetService against FleetRunner, "
        f"{SERVICE_ROUNDS} rounds")
    counts_service = phase_service_grid(dev)
    log("-- 14b. churn: cwtm|nnm and gm|nnm, 3 lanes each")
    add_counts(counts_service, phase_service_churn(dev))
    log("-- 14c. every registered scenario through launch.service")
    add_counts(counts_service, phase_service_registry(dev))
    log("-- 14d. the preemption drill through launch.service --kill-at 2")
    add_counts(counts_service, phase_service_drill(dev))
    log(json.dumps({"service_launches": counts_service}))

    t15 = time.perf_counter()
    head("15. the optimized attacks, the sketch Gram, the breakdown sweep")
    log("-- 15a. alie_opt / foe_opt on the main path, full-width smollm-360m")
    counts_opt = phase_opt_trainer(dev, peak7)
    log(f"-- 15b. the sketch Gram (sketch_dim = {SKETCH_DIM}) on the main path")
    add_counts(counts_opt, phase_sketch(dev, rate))
    log("-- 15c. the fed server under foe_opt / alie_opt")
    add_counts(counts_opt, phase_opt_fed(dev))
    log("-- 15d. the breakdown-frontier sweep, kernel and torch backends")
    add_counts(counts_opt, phase_breakdown(dev))
    log(json.dumps({"opt_sketch_breakdown_launches": counts_opt}))
    log(f"  phase 15: {time.perf_counter() - t15:.1f} s")

    t16 = time.perf_counter()
    head("16. the in-round health taps and the runtime's exporters")
    counts_taps = phase_taps(dev, peak7)
    log(json.dumps({"taps_launches": counts_taps}))
    log(f"  phase 16: {time.perf_counter() - t16:.1f} s")

    t17 = time.perf_counter()
    head("17. the attention-family zoo at full width: mixtral-8x22b "
        "(FSDP experts), qwen2-7b, internvl2-2b")
    counts_zoo = phase_zoo(dev, card)
    log(json.dumps({"zoo_launches": counts_zoo}))
    log(f"  phase 17: {time.perf_counter() - t17:.1f} s")

    t18 = time.perf_counter()
    head("18. hierarchical fleet lanes; the lane forms of K2's median, K3, "
        "K6 and K7")
    hier_rows, counts_hfleet = phase_hier(dev, rate)
    rows.update(hier_rows)
    log(json.dumps({"hier_fleet_launches": counts_hfleet}))
    log(f"  phase 18: {time.perf_counter() - t18:.1f} s")

    t19 = time.perf_counter()
    head("19. the attention-free and encoder-decoder families at full "
        "width: rwkv6-3b, zamba2-2.7b, whisper-base")
    counts_fam = phase_families(dev, card)
    log(json.dumps({"family_launches": counts_fam}))
    log(f"  phase 19: {time.perf_counter() - t19:.1f} s")

    t20 = time.perf_counter()
    head("20. cached decode and greedy serving at full width: nine archs "
        "through ServeEngine")
    serve_runs = phase_serve(dev, card)
    log(json.dumps({"serve": serve_runs}))
    log(f"  phase 20: {time.perf_counter() - t20:.1f} s")

    t21 = time.perf_counter()
    head(f"21. the multi-device aggregation backends: ranks sharing the "
        f"card over gloo; card: {card}")
    counts_mesh = phase_mesh(dev, hier_refs.name)
    hier_refs.cleanup()
    log(json.dumps({"mesh_launches": counts_mesh}))
    log(f"  phase 21: {time.perf_counter() - t21:.1f} s")

    t22 = time.perf_counter()
    head(f"22. the model-parallel mesh: shards of the padded model over a "
        f"(data, model) world of ranks sharing the card over gloo; card: "
        f"{card}")
    counts_model = phase_model_mesh(dev, card)
    log(json.dumps({"model_mesh_launches": counts_model}))
    log(f"  phase 22: {time.perf_counter() - t22:.1f} s")

    t23 = time.perf_counter()
    head(f"23. sequence parallelism and expert FSDP on the model mesh: "
         f"(data 2, model 2) over gloo; card: {card}")
    counts_seq = phase_seq_fsdp(dev, card)
    log(json.dumps({"seq_fsdp_launches": counts_seq}))
    log(f"  phase 23: {time.perf_counter() - t23:.1f} s")
    close_worlds()

    head("24. summary")
    table = [("K1", "gram", "ported, checked"),
             ("K1 n = 640", "gram_tiled", "ported, redesigned, checked"),
             ("K2", "mixtrim", "ported, redesigned, checked"),
             ("K2 > 64", "mixtrim_select", "ported, redesigned, checked"),
             ("K2 > 64 no mix", "mixtrim_select_nomix", "ported, redesigned, checked"),
             ("K3", "combine", "ported, redesigned, checked"),
             ("K4", "mixtrim_dyn", "ported, checked"),
             ("K5", "gram_batched", "ported, checked"), ("K6", "bucketgram", "ported, checked"),
             ("K7", "bucketmeans", "ported, checked"),
             ("K2 median lanes", "mixtrim_lanes", "ported, redesigned, checked"),
             ("K3 lanes", "combine_lanes", "ported, redesigned, checked"),
             ("K6 lanes", "bucketgram_lanes", "ported, redesigned, checked"),
             ("K7 lanes", "bucketmeans_lanes", "ported, redesigned, checked")]
    log("kernels: " + "; ".join(f"{k} {n}: {s}" for k, n, s in table))

    def lane_total(name: str) -> int:
        return sum(c.get(name, 0) for c in (counts_grid, counts_resume,
                                             counts_service, counts_opt,
                                             counts_taps, counts_hfleet))

    meta = {
        "gram": ("src/repro_torch/kernels/csrc/gram.cu",
                 "src/repro/kernels/gram/kernel.py:50",
                 counts_main["gram"] + counts_resume["gram"]
                 + counts_opt["gram"] + counts_taps["gram"]
                 + counts_zoo["gram"] + counts_fam["gram"]),
        "gram_tiled": ("src/repro_torch/kernels/csrc/gram.cu",
                       "src/repro/kernels/gram/kernel.py:50",
                       hier["launches"]["gram_tiled"]),
        "mixtrim": ("src/repro_torch/kernels/csrc/mixtrim_dyn.cuh",
                    "src/repro/kernels/mixtrim/kernel.py:177",
                    counts_main["mixtrim"] + counts_resume["mixtrim"]
                    + counts_service["mixtrim"] + counts_opt["mixtrim"]
                    + counts_taps["mixtrim"] + counts_zoo["mixtrim"]
                    + counts_fam["mixtrim"]),
        "combine": ("src/repro_torch/kernels/csrc/combine.cu",
                    "src/repro/kernels/combine/kernel.py:34",
                    counts_gm["combine"] + counts_service["combine"]
                    + counts_opt["combine"] + counts_taps["combine"]),
        "mixtrim_select": ("src/repro_torch/kernels/csrc/mixtrim_select.cu",
                           "src/repro/kernels/mixtrim/kernel.py:177",
                           hier["launches"]["mixtrim_select"]),
        "mixtrim_select_nomix": ("src/repro_torch/kernels/csrc/mixtrim_select.cu",
                                 "src/repro/kernels/mixtrim/kernel.py:177",
                                 hier["launches"]["mixtrim_select_nomix"]),
        "mixtrim_dyn": ("src/repro_torch/kernels/csrc/mixtrim_dyn.cuh",
                        "src/repro/kernels/mixtrim/kernel.py:213",
                        counts_grid["mixtrim_dyn"]
                        + counts_resume["mixtrim_dyn"]
                        + counts_service["mixtrim_dyn"]
                        + counts_opt["mixtrim_dyn"]
                        + counts_taps["mixtrim_dyn"]
                        + counts_hfleet["mixtrim_dyn"]),
        "gram_batched": ("src/repro_torch/kernels/csrc/gram_batched.cu",
                         "src/repro/kernels/gram/kernel.py:73",
                         counts_grid["gram_batched"]
                         + counts_resume["gram_batched"]
                         + counts_service["gram_batched"]
                         + counts_opt["gram_batched"]
                         + counts_taps["gram_batched"]
                         + counts_hfleet["gram_batched"]),
        "bucketgram": ("src/repro_torch/kernels/csrc/bucketgram.cu",
                       "src/repro/kernels/bucketgram/kernel.py:75",
                       counts_hier["bucketgram"] + counts_opt["bucketgram"]),
        "bucketmeans": ("src/repro_torch/kernels/csrc/bucketgram.cu",
                        "src/repro/kernels/bucketgram/kernel.py:75",
                        counts_hmean["bucketmeans"]),
        "mixtrim_lanes": ("src/repro_torch/kernels/csrc/mixtrim_dyn.cuh",
                          "src/repro/kernels/mixtrim/kernel.py:177",
                          lane_total("mixtrim_lanes")),
        "combine_lanes": ("src/repro_torch/kernels/csrc/combine.cu",
                          "src/repro/kernels/combine/kernel.py:34",
                          lane_total("combine_lanes")),
        "bucketgram_lanes": ("src/repro_torch/kernels/csrc/bucketgram.cu",
                             "src/repro/kernels/bucketgram/kernel.py:75",
                             lane_total("bucketgram_lanes")),
        "bucketmeans_lanes": ("src/repro_torch/kernels/csrc/bucketgram.cu",
                              "src/repro/kernels/bucketgram/kernel.py:75",
                              lane_total("bucketmeans_lanes")),
    }
    kernels = []
    for k, (src, rep, launches) in meta.items():
        launches += counts_mesh.get(k, 0)          # phase 21's, every rank
        launches += counts_model.get(k, 0)         # phase 22's, every rank
        launches += counts_seq.get(k, 0)           # phase 23's, every rank
        r = rows[k]
        kernels.append({"name": k, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches, "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"fed_launches": counts_fed}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        close_worlds()
    sys.exit(code)
