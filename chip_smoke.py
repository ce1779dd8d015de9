#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and hold its
kernels to their plain versions.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

The main paths are ``provision(ProvisionSpec(...))``,
``provision_stream(ProvisionSpec(...))``, the eval
``repro_torch.eval.evaluate(EvalGrid(...))``, the serving stepper
``FleetProvisioner(...).advance(chunk)``, the serving cluster with real
tokens (``InferenceEngine.generate`` and ``run_cluster``, llama3.2-1b at
full width), training (``Trainer``, the same model at full width), the
hybrid, MoE and xLSTM families (hymba-1.5b, qwen3-moe-30b-a3b,
llama4-scout-17b-a16e, xlstm-1.3b), the vlm and encoder-decoder ones
(paligemma-3b, seamless-m4t-large-v2), the multi-device provisioning route,
elastic restore (``reshard_restore``, llama3.2-1b at full width across
four ranks), the sharded steps (``launch.steps``, the same model and
hymba-1.5b on a (2, 2) mesh) and the four example twins
(``examples/*_torch.py``) of ``repro_torch``; the first
two at the size of the largest fleet of ``benchmarks/provision_bench.py``:
N = 4096 levels (servers), T = 1008 ten-minute slots (one week), B = 8 synthetic
``msr_like_trace`` demand traces with mean N/4, windows 0..5 under the
paper's costs (Δ = 6): G = 48 (window, trace) cells per online policy.
Demand and random draws are made from ``SEED``.

Phases, one line or more each:

1. device — the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build — kernels K1 and K2 (one library) and K3 and K4 (another) from
   ``src/repro_torch/kernels/csrc``, the two builds at once (timed); then
   the attention library's SASS (``cuobjdump --dump-sass``) must hold
   ``HGMMA`` in every instance of K3's tensor-core kernel
   ``flash_wgmma_kernel`` (bf16 and fp16), and ``UTMALDG`` (TMA) or
   ``LDGSTS`` (cp.async) in each of those and in every instance of K4's
   split pass;
3. kernel — K1 against its plain PyTorch version on the card, on the inputs
   the main path gives it (A1, A2, A3, delayedoff, A2 with decision
   counters and reason codes, and a typed two-group fleet with fractional
   Δ_l), and on straddling demand (A1, and A2 with codes) that sits on the
   first and last level of blocks of 128 and changes on the slot loop's
   32-slot sub-tile boundaries: the on-matrices, counters and codes must
   be equal bit for bit (the same input tensors, so no tolerance), and the
   straddling cases must take every path of the loop; then two peeks the
   loop does not tabulate (longer than its 64 slots): A2 with codes at Δ =
   100 over 300 slots, and A2 at the longest horizon the card takes (one
   more must be refused), held to the plain version peeking the whole
   trace; the share of sub-tiles each path took; K1's device time (the
   profiler's CUPTI records, mean of 20 launches), the wrapper call's time
   and the plain version's (CUDA events, medians of 20 and 3 calls), and
   the bound, whose operations count only the updates that are not in a
   steady state (the old bound, which counts every update, beside it);
4. provision — A1, A2 and offline end to end, each call counted on its
   own: one K2 launch per online call and no K1 launch; then A2 with
   ``record_decisions``: one K1 launch and no K2 launch.  ``x``,
   ``level_cost`` and ``cost`` must equal the plain route's on the card,
   and the recorded call's ``decisions`` and ``decision_counts`` too;
   offline must cost no more than any online policy on every trace and
   window, and the mean competitive ratio must meet the paper's bound
   (plus the eval harness's 0.05 tolerance); median wall time per call;
5. breakdown — one A1, one A2 and one recorded A2 call under
   ``torch.profiler``: device busy time, K1's and K2's share, and the
   kernels that take the most;
6. stream kernel — first the uniforms route's waits (the test-only probe
   ``_uniform_waits_probe``, K2's arithmetic on every entry) against
   PyTorch's ``log1p`` route on every entry of the A2, A3 and AQ-rand
   tables of the smoke inputs, which must be equal in every bit;
   then kernel K2 against its plain version on the card, on the inputs
   ``provision_stream()`` gives it, for the cases of phase 3 plus AQ-rand,
   the keyed policies on the uniforms route and on the table route, each
   at ``t_chunk`` 512 (which leaves a part tile at the end) and at
   ``t_chunk`` = T, plus one trace cut at slot 601 with the carry threaded
   into a second call, and the two untabulated peeks of phase 3 on A3's
   uniforms route: x, every per-lane total and the carry must be equal
   bit for bit; K2's device time on each route, call time, plain time,
   bound and path shares as in phase 3;
7. provision_stream — A1, A2 and A2 with decision counters end to end
   through K2: ``x``, ``level_cost``, ``cost`` and ``decision_counts`` must
   equal ``provision()``'s bit for bit, and ``x``, ``level_cost`` and
   ``cost`` the plain route's, with one K2 launch per call and no K1
   launch; median wall time and a ``torch.profiler`` breakdown;
8. year — ``provision_stream()`` over a year of ten-minute slots
   (T = 52,560) at B = 8: A1, delayedoff and A2 (the uniforms route: its
   uniforms take 13.8 GB where the table route's waits would take 41);
   wall time, K2 launches and peak device memory of each; the uniforms
   route against the table route over the year on two traces; three cells
   held to ``provision()`` run on that cell alone, every A1 cell's cost
   against offline's within 2 - α, and A2's mean ratio within its bound;
11. eval (run after phase 8, before 9 and 10) — the competitive-ratio eval
   ``repro_torch.eval.evaluate`` on the card: (a) the reference CLI's
   smoke grid (144 cells: 6 scenarios, A1/A2/A3 at noise 0 and 0.2 and
   windows 0, 2, 4, AQ-det/AQ-rand on a two-type fleet, A1 deferred at
   slacks 0, 2, 6, 12), whose 48 cells that draw nothing (A1 at noise 0,
   AQ-det, the deferral cells) must equal ``BENCH_provision.json`` (read
   as JSON) on every field but ``wall_ms`` and ``compiles``; (b) its full
   grid (a week of 10-minute slots, 16 traces, noise 0 to 0.5, windows
   0..5: G = 384 cells per online block, 468 cells); both must pass the
   CLI's gates (every cell ``bound_ok``, every deferral cell ``slo_ok``,
   the AQ-det 2d bound, the deferral cell count, the widest slack no
   dearer than rigid); in each grid, one online block per policy (A1,
   A2, A3; N = 149, G = 24 and 384), one typed AQ-rand cell (N = 192) and
   the slack-12 deferral cell, rebuilt by the eval's spec builders from
   the grid's seed, must give the same leaves (x, costs, ``group_cost``,
   the queue fields) through K2 as through the plain route, and K2's mean
   costs must equal the report's; (c) 54 K2 launches and no K1 launch per
   ``evaluate`` (the module counters and the telemetry counter), the wall
   ms of each block kind (policy, typed, deferral, offline baselines) and
   of what lies in no block, and the deferral layer's share of the
   deferral cells' time, all from the spans of that one ``evaluate``
   (the layer's spans, ``provision/deferral_apply`` and ``_metrics``, nest
   in the deferral cells' spans and wait for the card); (d) ``provision()``
   with ``DeferralSpec(slack=6)`` at the smoke fleet of phase 4, A1 and
   A2, equal to its plain route on every leaf, the five queue fields
   included;
12. stepper (run after phase 11, before 9 and 10) — the serving stepper
   ``repro_torch.serving.FleetProvisioner.advance()`` on one fleet of N =
   4096 replicas over the week of phase 4's first trace (capped at N),
   under the paper's costs: A1 and A2 at window 2, delayedoff, AQ-rand
   (its draws slot-indexed, from ``SEED``) and A1 deferred at slack 6,
   each at ``t_chunk`` 1, 64 and 1024 (the last holds the whole week).
   After every call, ``x``, every leaf of ``last_plan`` and the carry
   (``r``, ``on``, ``wait``, the deferral and queue carries) must equal
   those of a second planner on the plain route (``_advance(chunk,
   kernel=False)``); every call must launch K2 once and K1 never, and
   each loop build no kernel library (``tracer_sanitizer``).
   delayedoff and AQ-rand must give one schedule at the three chunk sizes;
   one-shot A1 and delayedoff must equal ``plan()`` (``provision()``
   through K2), and their chunk cost plus the forced final offs
   ``plan().cost``.  Printed: the plan latency p50/p99 of each policy and
   chunk size, and K2's device time for the first chunk's step (the
   profiler) beside it.  Then the eval CLI's ``streaming_latency`` on the
   card: its rows must have ``compiles`` 0 and the policy, ``t_chunk``,
   ``chunks`` and ``slots`` of ``BENCH_provision.json`` (read as JSON).

13. serve (run after phase 12, before 9 and 10) — the serving path with
   real tokens at llama3.2-1b's full width (16 layers, d 2048, 32/8 heads
   of 64, d_ff 8192, vocab 128,256, tied embeddings; 1,235,814,400
   parameters, random weights from ``SEED`` on the card, bf16 compute):
   the parameter count and bytes and the peak device memory; K3 (B 4, S
   192; B 1, S 1, 7, 17, 32) and K4 (B 4 over 256 slots at lengths 193 and
   256; B 1 over 96 slots at lengths 1, 33, 47) on layer 0's own
   projections, each held to its plain version as in phases 9 and 10, K3
   and K4 timed at the bench's shapes beside their bounds, plain versions
   and SDPA; the whole model through ``InferenceEngine._generate`` on one
   token stream (the float32 model's greedy picks): in float32 the kernel
   route against the plain route (``kernel=False``), every row of the
   prefill's and 8 decode steps' logits within 1e-4 of its largest value
   and the greedy tokens equal; in bf16, the served config, the kernel
   route no farther from the float32 model than 1.25 times the plain
   route, and its greedy tokens equal to the plain route's wherever the
   plain top-2 margin exceeds 2e-2 of the row's largest logit; then the
   main path, counted: ``generate`` (B 4, prompt 192, 64 new tokens, 256
   slots) must launch K3 exactly 16 times (one per layer) and K4 exactly 32
   times per decode step; the bench's prefill ms, decode-step p50/p99 ms
   and tokens/s, and under the profiler the device busy share, launches
   and K3's and K4's shares; last ``run_cluster`` with the launcher's
   defaults (A1, alpha 0.5, 60 slots, concurrency 4) and full-width engines
   (max_batch 1, max_seq 96) must serve every session, generate tokens,
   launch K3 16 times per session and K4 32 times per decode step, and
   report the cost, static cost, reduction and ``ScalerReport`` of the
   same run without engines.
14. train (run after phase 13, before 9 and 10) — training at llama3.2-1b's
   full width (float32 parameters and AdamW moments, bf16 compute,
   ``remat="full"``, B 4, S 128, the reference launcher's defaults): (a)
   K3 and K4 through ``kernels.ops`` with an input that requires grad and
   grad enabled must raise ``RuntimeError`` naming the kernel and launch
   nothing, and under ``no_grad`` launch and equal the call without grad;
   (b) ``loss_fn`` through K3 under ``no_grad`` (16 K3 launches, no K4)
   against the einsum route (``kernel=False``) on one batch, within 1e-4
   relative in float32 compute and 1e-2 in bf16, both printed with their
   ms; (c) the ``Trainer``: after its first backward pass every parameter
   tensor has a finite, nonzero gradient; the device busy share, launches
   and top kernels of 3 steps under the profiler; then ``Trainer.run`` for
   20 steps (AdamW warmup 5), which must launch neither kernel, log a
   finite loss every step and end below its first; step p50/p99 ms,
   tokens/s and peak device memory; (d) 2 layers of the full width
   crashed at step 4 after the checkpoint at step 3 (under
   ``build/chip_smoke_train/``, removed after), resumed to step 5, must
   equal a clean run bit for bit with deterministic algorithms on; (e)
   offline ``provision()`` on the card must equal the port's
   ``dp_optimal_cost`` (rel 1e-6) on 4 seeded traces at 3 cost models, and
   phase 13's cluster must cost the port's ``simulate`` plus beta_off for
   each session cut at the horizon, within A1's bound against the port's
   ``a0_cost``; (f) the card's idle ``power.draw`` (median of 10 samples)
   and the cold builds' seconds, which ``replica_cost_model``'s defaults
   take.
15. families (run after phase 14, before 9 and 10) — the hybrid, MoE and
   xLSTM families, random weights from ``SEED`` on the card, bf16 serving:
   (a) hymba-1.5b whole (32 layers, d 1600, 25/5 heads of 64, window 2048,
   SSM state 16; 1,644,860,800 parameters) on three token streams through
   ``InferenceEngine._generate``: B 1 with a prompt of 4096 and 16 new
   tokens (K3's window path in every layer, the ring full from the first
   step), B 2 with 2040 and 16 (the ring wraps at 2048), B 1 with 2100 and
   8 (ROADMAP.md § 3.9: K4 over the ring's valid slots gathered to the
   front); each held to phase 13's rules (float32 kernel route == plain
   route within 1e-4 per row, greedy tokens equal where decided; bf16
   kernel route no farther from the float32 model than 1.25 times the plain
   route), with 32 K3 launches per prefill and 64 K4 per decode step on the
   bf16 kernel route, and prefill-then-decode equal to ``logits_fn`` over
   the whole sequence within 1e-4 in float32 (printed, not held, on the
   § 3.9 stream, where the reference's ring loses positions); then the
   engine bench (prefill ms, decode p50/p99, tokens/s, the profiler's busy
   share and launches), K3 at B 1, S 4096 with the window and K4 over the
   full 2048-slot ring on layer 0's projections, held to their plain
   versions and timed beside their bounds and SDPA; and (d) ``run_cluster``
   with the launcher's defaults and hymba engines (max_seq 96) at full
   width, their depth cut to 4 of 32 layers, whose report must equal the
   run without engines, 4 K3 launches per session and 8 K4 per decode
   step.  (b) qwen3-moe-30b-a3b (4 of 48 layers) and
   llama4-scout-17b-a16e (2 of 48) at full width, B 4, prompt 192, 8 new
   tokens: float32 kernel route == plain route as in (a), the bf16 routes'
   distances and their routing flips (top-k sets that differ between the
   routes) printed, the launch counts, prefill-then-decode == ``logits_fn``
   in float32 with dropless capacity (as the reference's consistency test),
   the bench, and for llama4-scout K3 (B 4, S 192, 40/8 heads of 128) and
   K4 (200 slots at 193) timed as in (a).  (c) xlstm-1.3b whole (48 layers,
   every 8th an sLSTM; 5,845,649,792 parameters), B 2, prompt 192, 16 new
   tokens: no K3 or K4 launch in the whole part, prefill-then-decode ==
   ``logits_fn`` within 1e-4 in float32, ``generate`` and the bench.  Each
   model's peak device memory and seconds are printed, and each is freed
   before the next.
16. vlm and encoder-decoder (run after phase 15, before 9 and 10) — random
   weights from ``SEED``, bf16 serving, float32 checks, frontend
   embeddings random wherever a check compares (the stub's zeros would
   hide a wrong position or cross-attention): (c) K3 at S_q != S_kv as a
   bare kernel (191 over 192 and 64 over 1000 keys at seamless's 16 heads
   of 64, float32 and bf16), each held to its plain version as in phase 9
   with two planted faults (zeros; the keys past S_q dropped) rejected and
   timed beside SDPA and its bound, and a causal call at unequal lengths
   refused without a launch; (a) paligemma-3b whole (18 layers, d 2048,
   8/1 heads of 256; 2,512,857,088 parameters) on B 4, 256 image tokens
   and a prompt of 192 in 512 slots, 16 new tokens, by phase 15's rules
   (18 K3 launches per prefill, 36 K4 per decode step), prefill-then-decode
   == ``logits_fn`` within 1e-4, then the launcher's engine (B 1, 96
   slots, a prompt of 32: its cache overflows from the prefill on,
   ROADMAP.md § 3.10) by the same rules, its distance to the whole forward
   printed, and its ``generate`` with the stub's zeros counted; (b)
   seamless-m4t-large-v2 whole (24 + 24 layers, d 1024, 16/16 heads of 64;
   1,773,477,888 parameters) on B 4, 192 frames and a prompt of 192, 16
   new tokens, by the same rules (72 K3 launches per prefill, 96 K4 per
   step), prefill-then-decode == ``logits_fn`` with 191 tokens over 192
   frames (K3 at S_q != S_kv in every cross-attention) and ``generate``
   with zero frames; (d) for both, ``loss_fn`` through K3 under
   ``no_grad`` against the einsum route (1e-4 relative in float32, 1e-2 in
   bf16); each model's bench, K3 and K4 at its shapes timed, peak memory.
17. mesh (run after phase 16, before 9 and 10) — the multi-device route,
   ``ProvisionSpec(mesh=...)``, each rank a process of
   ``repro_torch.distributed.world.run_world`` (a ``FileStore`` in a
   temporary directory, a 120 s group timeout, every group destroyed):
   (a) phase 4's fleet in a world of one over NCCL, A1, A2, A3,
   delayedoff, AQ-det and AQ-rand through ``provision(mesh=)`` and
   ``provision_stream(mesh=)``, A2 over a noise sweep of S = 2, A1 and
   AQ-rand with ``record_decisions``; (b) a fleet of 4099 levels (not a
   multiple of 4) over phase 4's demand times 1.6 (past the cap), untyped
   and typed (three groups of 1000, 1500 and 1599, Δ 2.5, 3.0, 2.5), A1,
   A3 and AQ-rand through both entry points, in a world of four processes
   on the one card over gloo.  Every rank's x, level_cost, cost, energy,
   toggle_cost, group_cost and decision_counts must equal the
   single-device kernel route's and the plain route's, and the other
   ranks', and each call launch K2 once and K1 never on each rank; (c)
   ``FleetProvisioner(mesh=).plan_sweep`` equal to the planner without a
   mesh, and the eval CLI's mesh smoke (cells equal, one K2 launch for its
   block); (d) two planted faults (pad lanes routed past the fleet and
   unmasked; the level blocks gathered in reverse) must change a leaf;
   (e) wall ms of A1 on the mesh route at worlds 1 and 4 beside the
   single-device route, and K2's CUPTI ms per rank; (f) only on a machine
   with several cards: (b)'s cases and planted faults in a world of one
   process per card over NCCL, each rank on its own card, checked as (b)
   (there (b)'s gloo ranks take a card each too).
18. sharding (run after phase 17, before 9 and 10) — the sharding rules and
   elastic restore: (a) for all ten archs at full width, ``param_specs``
   on ``abstract_params`` (meta tensors) on the 16x16 mesh (train,
   serving, ``fsdp_only``) and the 2x16x16 one (train, serving), planned
   from the mesh's shape alone: every sharded dim divides by its axes,
   each leaf's per-device bytes times its number of distinct shards sum
   to the whole parameter bytes, and the per-device GB are printed (a
   plan, not a time); (b) llama3.2-1b at full width in float32 from
   ``SEED`` (1,235,814,400 parameters, 4.94 GB) drawn on the card and
   saved unsharded with the port's ``save`` under
   ``build/chip_smoke_elastic/`` (removed after), then in one world of
   four processes on the one card over gloo ``reshard_restore`` onto a
   (2, 2) ``("data", "model")`` mesh (twice: the second warm) and onto
   (4, 1): on every rank each leaf's placements must be the model's
   training layout (``ELASTIC_LAYOUT``) and ``to_local()`` equal, bit for
   bit, to the block of the saved array at the rank's mesh coordinate,
   cut with ``torch.chunk`` (no rule code); each rank's resident bytes
   and each restore's wall time are printed; two planted faults on layer
   0's own checkpoint (wq's two sharded dims swapped in its placements; a
   rank given the next rank's blocks) must fail that check; (c) only
   with four cards or more: (b) over NCCL with a card per rank, plus a
   save of the (2, 2)-sharded tree (each leaf gathered) restored onto (4,
   1) and checked on every rank against the first checkpoint.
19. steps (run after phase 18, before 9 and 10) — the step builders
   (``repro_torch.launch.steps``) and the dry-run: (b) llama3.2-1b at full
   width and depth in float32 from ``SEED``, saved under
   ``build/chip_smoke_steps/`` (removed after) with the single-device
   float32 and bf16 plain routes over phase 13's stream and two float32
   train steps computed first and freed; then a world of four processes
   on the one card over gloo, mesh (2, 2) ``("data", "model")``, each
   rank's blocks restored from the checkpoint (no collective): the
   prefill and 8 decode steps on the float32 kernel route held to the
   single-device plain route (every row within 1e-4 of its largest value,
   greedy tokens equal), the bf16 kernel route no farther from the float32
   model than 1.25 times the single-device bf16 plain route, exactly 16 K3
   launches per prefill and 32 K4 per decode step on every rank (module
   counters), two planted faults rejected on every rank (one rank's wq
   block from its neighbour; K4 given the next rank's kv heads), two
   float32 train steps whose losses are within 1e-4 relative of one
   device's and whose parameters after step 1 are within 1e-4 of each
   leaf's largest value of the single-device update (the elements whose
   clipped gradient is nonzero and below 100 AdamW eps counted, not held),
   and wall ms per rank between a barrier and a sync; (e) in the same
   world after (b), hymba-1.5b at full width and depth (1,644,860,800
   parameters) by the same rules on B 2, a prompt of 2304 tokens (past its
   2048-token window and even: the ring wraps, the sequence splits) and 8
   decode steps: its 25 query and 5 KV heads do not divide ``"model"``, so
   attention takes the sequence layout with K3 under the window on each
   rank's batch rows and K4 over the ring's valid slots gathered to the
   front, its 50 SSM heads split over ``"model"``; exactly 32 K3 launches
   per prefill and 64 K4 per decode step on every rank, two planted faults
   rejected on every rank (K3 called without its window; K4 reading the
   ring's first slots without the gather), one float32 train step (B 2, S
   128) by (b)'s rules; (c) the same three steps of both models traced on
   a fake world of four at (2, 2) in a subprocess: every rank's resident
   bytes equal the trace's argument bytes and the float32 plain route's
   collectives equal the trace's in count and bytes by kind (llama's kernel
   route's printed beside them); (d) only with four cards or more: (b) and
   (e) over NCCL, a card per rank; (a) the dry-run of llama3.2-1b's three
   cells on 16x16 (train_4k also on 2x16x16), command-r-plus-104b x
   decode_32k, hymba-1.5b x decode_32k, long_500k and train_4k and
   xlstm-1.3b x decode_32k and long_500k on the card's host (a fake group
   of 256 or 512 ranks in this process, meta tensors): per-device bytes,
   FLOPs, collectives by kind, the roofline's three terms with the H100
   constants, the trace's wall s.
20. examples (run after phase 19, before 9 and 10) — ``python -m
   repro_torch.lint src/repro_torch chip_smoke.py --strict`` (a subprocess
   beside the rest) must exit 0; then each example twin's ``main`` on the
   card at its defaults, every launch counter set to 0 just before and
   read just after: ``quickstart_torch.py`` (2 K2 launches; its offline,
   A1 and DELAYEDOFF costs equal the port's fluid model's),
   ``trace_provisioning_torch.py`` (6 K2 launches here, and the 3 of its
   mesh rank, a world of one over NCCL, checked by the twin; Fig. 3's A1
   column and Fig. 4d equal the fluid model's, the heterogeneous fleet the
   plain CPU route's, the drawn A3 column and noise sweep within their
   bounds plus 0.05, the sharded schedule identical),
   ``serve_autoscale_torch.py`` (6 K2 launches; 2 K3 per prefill and 4 K4
   per decode step of the reduced model, its head dim raised to 64; A1's
   sweep equals the plain CPU planner's, the cluster's reports those
   without engines, every session's tokens generated), K3 and K4 at that
   twin's shapes held to their plain versions (bf16, phase 9's limits),
   and ``train_lm_torch.py`` (300 steps, the loss falls; a rerun resumes
   from step 300 and takes 10 more; no kernel); each twin's wall seconds.

9. flash — kernel K3 through the public wrapper
   ``repro_torch.kernels.ops.flash_attention`` (default blocks 512/512) at
   the full attention widths of three models the repo supports: yi-9b
   causal (B 1, S 4096, H 32, KVH 4, hd 128) in bf16 and in float32,
   hymba-1.5b causal with its 2048-token window (S 4096, H 25, KVH 5, hd
   64) in bf16, llama3.2-1b non-causal (S 1024, H 32, KVH 8, hd 64) in
   float32; inputs from ``SEED``, q and k at std ``QK_STD`` so that each
   softmax is peaked.  The launch count of that run, then each output
   against K3's plain version on the same tensors: every element within
   the reference's tolerance (float32 2e-5, bf16 2e-2; no TF32 anywhere)
   and every row within that tolerance of its largest value; planted faults
   (zeros, the window or the causal mask ignored) must fail that check.
   K3's device time (of the kernel the type picks: ``flash_wgmma_kernel``
   for bf16, ``flash_kernel`` for float32), the call's, the plain
   version's, the bound and what sets it, and
   ``F.scaled_dot_product_attention(..., enable_gqa=True)`` on the same
   inputs as the library yardstick, with the TFLOP/s of both and K3's share
   of the bound; then seven instances the main
   path does not reach (a ragged last tile in fp16, head dim 256 in float32
   and in bf16, a window without the causal mask in float32 and in fp16,
   hymba's window in float32, a ragged S of 500 with a window in bf16),
   each held to the plain version;
10. decode — kernel K4 (its split pass and merge) through
   ``repro_torch.kernels.ops.decode_attention`` (block_k 1024): yi-9b at
   B 16, S 32,768 in bf16 with ragged lengths from ``SEED`` (one at S, one
   at 1), hymba-1.5b's long decode (B 1, S 524,288, length S) in bf16, and
   yi-9b at B 4, S 8192 in float32 with lengths [0, 1, 4097, 8192], where
   row 0 must be exactly zero; checked, timed and bounded as in phase 9
   (TB/s in place of TFLOP/s),
   the planted faults being zeros and the second half of each sequence
   dropped; then five instances (lengths below 0 and above S in fp16, a
   query-head group of 12, head dim 256, hymba's long decode in float32, a
   group of 32 in bf16), each held to the plain version.

The line before the last is a JSON object with K1's to K4's numbers (K2's
launches include the eval's, the stepper's and every rank's of phase 17, K3's and K4's the serving
paths' of phases 13, 15 and 16 and rank 0's bf16 main paths of phase 19,
K3's the no-grad losses of phases 14 and 16, and all three the twins' of
phase 20); the
last is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before them.
"""
from __future__ import annotations

import concurrent.futures
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_LEVELS, N_SLOTS, N_TRACES = 4096, 1008, 8
WINDOWS = list(range(6))
YEAR_SLOTS = 52560               # a year of ten-minute slots
YEAR_TABLE_TRACES = 2            # the table route's (W*B, T, N) waits at B = 8: 41 GB
STRADDLE_BLOCKS = (0, 5, 17, 31) # level blocks whose edges the straddling demand sits on
STREAM_T_CHUNK = 512             # K2's default tile; 1008 = 512 + 496
CUT = 601                        # where the chained case splits the trace
LONG_WINDOWS = [70, 99]          # a peek of 100 slots, past the loop's 64-slot table
LONG_SLOTS, LIMIT_SLOTS = 300, 80  # slots of the long-peek and the longest-peek cases
SEED = 0
# H100 SXM data sheet: HBM3, float32 outside the tensor cores, dense bf16 and fp16 tensor cores
from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS_BF16 as BF16_OPS_PER_S  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS_F32 as FP32_OPS_PER_S  # noqa: E402
OPS_PER_UPDATE = 8               # compares and selects of one (cell, slot, level) update
KERNEL_REPS, PLAIN_REPS, PROVISION_REPS = 20, 3, 3
PROFILE_ATTEMPTS = 3
HOLD_CYCLES, HOLD_DOUBLINGS = 1 << 21, 6     # a hold of about 1 ms at 1.98 GHz, at most 64 times that


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Median milliseconds of one ``fn()`` call over ``reps`` runs, each
    between its own pair of CUDA events, after a warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def held_ms(fn, reps):
    """Median device milliseconds of one ``fn()`` call over ``reps`` calls,
    each between a pair of CUDA events while a spinning kernel
    (``torch.cuda._sleep``) holds the stream until the host has queued the
    whole call: the device span of the call's launches, without the host's
    launch overhead between them.  A call is kept only if its start event
    was still pending when the host had queued its end event; else the hold
    doubles, up to ``HOLD_CYCLES << HOLD_DOUBLINGS``, and a call that still
    outruns it (one that waits for the card) fails the run."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles, times = HOLD_CYCLES, []
    while len(times) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            times.append(start.elapsed_time(end))
            continue
        cycles *= 2
        check(cycles <= HOLD_CYCLES << HOLD_DOUBLINGS,
              f"held stream: the host had not queued the call after a hold of "
              f"{cycles // 2} cycles")
    return statistics.median(times)


def kernel_ms(fn, reps, name="grid_scan_kernel"):
    """Mean device milliseconds per ``fn()`` call of the kernel ``name`` (or
    of the kernels of a tuple of names, each launched once a call) over
    ``reps`` calls, from the profiler's CUPTI records: the kernels' own time
    on the card, without the wrapper's host work around it.

    Each session opens with one untimed fill before the ``reps`` calls
    (without it the profiler lost the record of the first kernel in most
    sessions), and should then hold exactly ``reps`` records of each kernel.
    It often holds fewer of K3's and K4's, which are launched from their
    own library: from one in 20 lost to 11 in 20, the same count in every
    session of a call.  A session short of records is profiled again, at
    most ``PROFILE_ATTEMPTS`` times; if all of them are, the time is
    :func:`held_ms` of the call, which needs no profiler, printed beside the
    mean of the records the last session kept.  For K3's and K4's wrappers
    the call's device span is their launches alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (name,) if isinstance(name, str) else tuple(name)
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen = {n: sum(e.count for e in events if n in e.key) for n in names}
        if all(seen[n] == reps for n in names):
            return sum(e.self_device_time_total for e in events
                       if any(n in e.key for n in names)) / 1e3 / reps
        print(f"profiler: kept {seen} of {reps} launches each; profiling again", flush=True)
    kept = sum(sum(e.self_device_time_total for e in events if n in e.key) / seen[n]
               for n in names if seen[n]) / 1e3
    ms = held_ms(fn, reps)
    print(f"profiler: kept {seen} of {reps} launches each in {PROFILE_ATTEMPTS} sessions; "
          f"timed on a held stream: {ms:.4f} ms per call (the kept records' mean "
          f"{kept:.4f} ms)", flush=True)
    return ms


def bound_ms(inputs, record, ons, stream=False):
    """Least time for a scan kernel's work on these inputs: the bytes it must
    move over the memory rate, or its operations over the float32 rate,
    whichever is larger.  Outputs: K1's one-byte on-matrix (with the counters
    and the one-byte codes under record), or K2's x, per-lane totals and
    carry.  Each input row the cells use is counted once; of the waits only
    the entries this run's demand consumes (one per lane turning idle: busy
    at t - 1, not at t), each once however many cells read it (the windows
    of a trace read the same uniforms), as table entries or, on the
    uniforms route, as one or two uniforms each.  The operations are
    ``OPS_PER_UPDATE`` for each (cell, slot, level) update that is not in a
    steady state — the lane was on at t - 1 and is not busy at t — counted
    from ``ons``, the plain version's (G, T, N) on-matrix of the same
    inputs.  Returns the bound, what sets it, and the bound that counts all
    G·T·N updates (the one of earlier runs)."""
    import torch

    from repro_torch.core.torch_provision import UniformWaits

    a, thr, cells = inputs["traces"], inputs["thresholds"], inputs["cell_trace"]
    drawn = isinstance(thr, UniformWaits)
    G, T, N = cells.shape[0], a.shape[1], (thr.span if drawn else thr).shape[-1]

    def rows(c):
        return torch.unique(c).numel()

    if stream:          # x, run/up/down (+ 4 counters), carry r/on/wait
        base = G * T * 4 + G * (7 if record else 3) * N * 4 + G * N * 9
    else:               # on-matrix (+ 4 counters and the codes)
        base = G * T * N + (G * 4 * N * 4 + G * T * N if record else 0)
    base += rows(cells) * T * 4 + 4 * G * 4 + N * 4              # demand, cell maps, routes
    base += rows(inputs["cell_hor"]) * N * 4
    if inputs["horizon"]:
        base += rows(inputs["cell_pred"]) * T * 4
    busy = a[cells.long()][:, :, None] > inputs["routes"]        # (G, T, N)
    newly = busy[:, :-1] & ~busy[:, 1:]                          # newly idle at 1 .. T - 1

    def consumed(row_of_cell):
        """Entries of the wait rows the cells read, each counted once."""
        row_of_cell = row_of_cell.to(newly.device)
        return sum(int(newly[row_of_cell == r].any(dim=0).sum())
                   for r in torch.unique(row_of_cell))

    if drawn:           # the uniforms a lane consumes, and the span (and p0) rows
        per = 2 if thr.p0 is not None else 1
        needed = consumed(thr.cell) * 4 * per + rows(inputs["cell_thr"]) * N * 4 * per
    elif thr.shape[1] == 1:
        needed = rows(inputs["cell_thr"]) * N * 4
    else:
        needed = consumed(inputs["cell_thr"]) * 4
    updates = int((ons[:, :-1] & ~busy[:, 1:]).sum())
    del busy, newly
    by_bytes = (base + needed) / HBM_BYTES_PER_S * 1e3
    by_ops = updates * OPS_PER_UPDATE / FP32_OPS_PER_S * 1e3
    kind = "bytes" if by_bytes >= by_ops else "operations"
    old = max(by_bytes, G * T * N * OPS_PER_UPDATE / FP32_OPS_PER_S * 1e3)
    return max(by_bytes, by_ops), kind, old


def path_shares(paths):
    """The share of (level block, cell, sub-tile) triples that took each path
    of the slot loop, from a kernel's path counters."""
    n = [int(v) for v in paths.tolist()]
    total = max(sum(n), 1)
    return (f"paths of {sum(n)} (block, cell, sub-tile): step {n[0] / total:.1%}, "
            f"all busy {n[1] / total:.1%}, all idle {n[2] / total:.1%}")


def straddle_demand():
    """(8, T) demand rows that sit on the edges of a block of 128 levels: at
    its first level j0 (no lane busy), j0 + 1, its last level j0 + 127 (all
    but the last lane busy), j0 + 128 (every lane busy) and one either side,
    constant over each 32-slot sub-tile of the slot loop and changing on its
    boundaries, with single-slot dips and bumps at a sub-tile's last and
    first slot.  Rows 2i and 2i + 1 take block ``STRADDLE_BLOCKS[i]``; the
    odd rows are shifted by 16 slots, so that they change inside sub-tiles."""
    import numpy as np

    offsets = (128, 0, 0, 127, 128, 1, 0, 129, 128, -1, -1, 128, 127, 127, 0)
    rows = []
    for block in STRADDLE_BLOCKS:
        j0 = block * 128
        row = np.empty(N_SLOTS, np.int64)
        for s in range(0, N_SLOTS, 32):
            row[s:s + 32] = j0 + offsets[(s // 32) % len(offsets)]
            if (s // 32) % 7 == 3:
                row[min(s + 31, N_SLOTS - 1)] -= 1
            if (s // 32) % 7 == 5:
                row[s] += 1
        row = np.clip(row, 0, None)
        rows += [row, np.roll(row, 16)]
    return np.stack(rows).astype(np.int32)


# phase 9: (name, B, S, H, KVH, hd, causal, window, dtype name)
FLASH_CASES = (
    ("yi-9b causal bf16", 1, 4096, 32, 4, 128, True, 0, "bfloat16"),
    ("yi-9b causal f32", 1, 4096, 32, 4, 128, True, 0, "float32"),
    ("hymba-1.5b causal window 2048 bf16", 1, 4096, 25, 5, 64, True, 2048, "bfloat16"),
    ("llama3.2-1b non-causal f32", 1, 1024, 32, 8, 64, False, 0, "float32"),
)
# phase 10: (name, B, S, H, KVH, hd, lengths or None to draw, dtype name)
DECODE_CASES = (
    ("yi-9b bf16", 16, 32768, 32, 4, 128, None, "bfloat16"),
    ("hymba-1.5b long decode bf16", 1, 524288, 25, 5, 64, (524288,), "bfloat16"),
    ("yi-9b f32", 4, 8192, 32, 4, 128, (0, 1, 4097, 8192), "float32"),
)
# instances and edges the main path does not reach, each held to the plain version:
# (name, B, S, H, KVH, hd, causal, window, dtype name); S = 200 leaves a ragged tile
FLASH_EDGES = (
    ("ragged S, fp16", 2, 200, 6, 2, 64, True, 0, "float16"),
    ("hd 256, MQA", 1, 512, 8, 1, 256, True, 0, "float32"),
    ("window 70, non-causal", 1, 320, 4, 4, 128, False, 70, "float32"),
    ("hymba-1.5b window 2048, f32", 1, 4096, 25, 5, 64, True, 2048, "float32"),
)
# the tensor-core kernel's other instances: hd 256 (32-key tiles), a window
# without the causal mask, and several query blocks with a ragged tail; drawn
# from a generator of their own, so that phase 10's inputs stay those of runs
# before these were added
FLASH_TC_EDGES = (
    ("hd 256, MQA, bf16", 1, 512, 8, 1, 256, True, 0, "bfloat16"),
    ("window 70, non-causal, fp16", 1, 320, 4, 4, 128, False, 70, "float16"),
    ("ragged S 500, window 300, bf16", 2, 500, 10, 5, 128, True, 300, "bfloat16"),
)
# (name, B, S, H, KVH, hd, lengths, dtype name)
DECODE_EDGES = (
    ("negative and above-S lengths, fp16", 3, 2048, 8, 2, 64, (-3, 5000, 700), "float16"),
    ("group of 12 (command-r)", 2, 4096, 24, 2, 128, (4096, 65), "float32"),
    ("hd 256, MQA", 2, 1024, 8, 1, 256, (1024, 3), "bfloat16"),
    ("hymba-1.5b long decode, f32", 1, 524288, 25, 5, 64, (524288,), "float32"),
    # bf16 with two m-tiles of 16 heads (a group of 32 at hd 64)
    ("group of 32, bf16", 2, 2048, 32, 1, 64, (2048, 100), "bfloat16"),
)
ATTENTION_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}  # the reference's
# q and k are drawn at this standard deviation, v at 1: the scores then have
# a deviation of QK_STD ** 2, so that a few per cent of the keys carry each
# softmax and a missing key, tile or window moves the output by far more
# than the tolerance of the row-relative check (``compare``)
QK_STD = 1.5


def admitted_pairs(S, causal, window):
    """(query, key) pairs the attention mask admits: key j of query i when
    j <= i (causal) and j > i - window (window > 0)."""
    import torch

    i = torch.arange(S, dtype=torch.int64)
    lo = (i - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(i)
    hi = i + 1 if causal else torch.full_like(i, S)
    return int((hi - lo).clamp(min=0).sum())


def attention_bound_ms(flops, nbytes, dtype_name):
    """Least time for an attention call: its flops over the card's peak for
    the inputs' type (bf16 on the tensor cores, float32 outside them) or its
    bytes over the memory rate, whichever is larger."""
    rate = FP32_OPS_PER_S if dtype_name == "float32" else BF16_OPS_PER_S
    by_ops, by_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def sass_check(library):
    """The attention library as built: every instance of K3's tensor-core
    kernel must hold ``HGMMA`` (wgmma) in its SASS, and every instance of
    it and of K4's split pass an asynchronous load, ``UTMALDG`` (TMA) or
    ``LDGSTS`` (cp.async), or the run fails.  Returns the instances counted
    of each."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    ops = {}
    name = None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            ops[name] = set()
        elif name:
            ops[name].update(op for op in ("HGMMA", "LDGSTS", "UTMALDG") if op in line)
    flash = [n for n in ops if "flash_wgmma_kernel" in n]
    split = [n for n in ops if "decode_split" in n]
    check(len(flash) == 6, f"sass: {len(flash)} instances of flash_wgmma_kernel, expected 6 "
          "(bf16 and fp16 at head dims 64, 128, 256)")
    check(split, "sass: no instance of K4's split pass")
    for n in flash:
        check("HGMMA" in ops[n], f"sass: no HGMMA in {n}")
    for n in flash + split:
        check(ops[n] & {"LDGSTS", "UTMALDG"}, f"sass: no LDGSTS or UTMALDG in {n}")
    return len(flash), len(split)


def row_err(got, want):
    """Largest |got - want| of each output row (one query head) over that
    row's largest |want|."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    return err / want.float().abs().amax(dim=-1).clamp_min(1e-30)


def compare(got, want, dtype, what):
    """Largest absolute and row-relative differences of ``got`` from
    ``want``.  Every element must be within the reference's tolerance
    (atol = rtol = tol), and every row within tol of its largest |want|,
    so that the check scales with what it compares: a row of zeros
    passes only where the kernel's is zero."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape/dtype")
    check(bool(torch.isfinite(got).all()), f"{what}: not finite")
    err = (got.float() - want.float()).abs()
    tol = ATTENTION_TOL[dtype]
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"{what}: kernel and plain version differ by {float(err.max())}")
    rel = float(row_err(got, want).max())
    check(rel <= tol, f"{what}: a row differs by {rel:.3e} of its largest value, above {tol}")
    return float(err.max()), rel


def attention_phases(smi):
    """Phases 9 and 10: K3 and K4 driven through ``repro_torch.kernels.ops``
    with their launch counts, then held to their plain versions and timed;
    returns their entries of the kernels JSON line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    # the plain versions and the yardstick compute float32 in float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(q_shape, kv_shape, dtype, g=gen):
        """q, k and v from ``g``: q and k at ``QK_STD``, v at 1."""
        return tuple((torch.randn(*shape, generator=g, device=dev) * std)
                     .to(getattr(torch, dtype))
                     for shape, std in ((q_shape, QK_STD), (kv_shape, QK_STD), (kv_shape, 1.0)))

    def rejects(faults, want, dtype, what):
        """The check must fail on each planted fault: names of the faults and
        the row-relative error of each."""
        seen = []
        for fault, bad in faults:
            try:
                compare(bad, want, dtype, f"{what} planted {fault}")
            except SmokeFailure:
                seen.append(f"{fault} ({float(row_err(bad, want).max()):.2e})")
                continue
            raise SmokeFailure(f"{what}: the check passed a planted fault ({fault})")
        return ", ".join(seen)

    # 9. K3 through the ops entry point: the main path, counted
    t_phase = time.perf_counter()
    inputs = [qkv((b, s, h, hd), (b, s, kvh, hd), dt)
              for _, b, s, h, kvh, hd, _, _, dt in FLASH_CASES]
    torch.cuda.synchronize()
    flash.flash_launches = 0
    outs = [ops.flash_attention(q, k, v, causal=causal, window=window)
            for (q, k, v), (_, _, _, _, _, _, causal, window, _) in zip(inputs, FLASH_CASES)]
    torch.cuda.synchronize()
    k3_launches = flash.flash_launches
    check(k3_launches == len(FLASH_CASES),
          f"flash: K3 launched {k3_launches} times for {len(FLASH_CASES)} calls")
    print(f"flash: main path ran {len(FLASH_CASES)} ops.flash_attention calls with K3 "
          f"launches={k3_launches}", flush=True)
    k3 = {}
    for (q, k, v), got, case in zip(inputs, outs, FLASH_CASES):
        name, b, s, h, kvh, hd, causal, window, dt = case
        want = flash.flash_attention_plain(q, k, v, causal=causal, window=window)
        err, rel = compare(got, want, dt, f"K3 {name}")
        faults = [("zeros", torch.zeros_like(want))]
        if window:
            faults.append(("window ignored", flash.flash_attention_plain(
                q, k, v, causal=causal, window=0)))
        elif causal:
            faults.append(("causal mask ignored", flash.flash_attention_plain(
                q, k, v, causal=False)))
        rejected = rejects(faults, want, dt, f"K3 {name}")
        del want, faults

        def run(q=q, k=k, v=v, causal=causal, window=window):
            return ops.flash_attention(q, k, v, causal=causal, window=window)

        def plain(q=q, k=k, v=v, causal=causal, window=window):
            return flash.flash_attention_plain(q, k, v, causal=causal, window=window)

        mask = None
        if window:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def library(q=q, k=k, v=v, mask=mask, causal=causal):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        ms = kernel_ms(run, KERNEL_REPS, name=flash.k3_instance(q.dtype, hd)[0])
        call, plain_ms = cuda_ms(run, KERNEL_REPS), cuda_ms(plain, PLAIN_REPS)
        lib_ms = cuda_ms(library, KERNEL_REPS)
        pairs = admitted_pairs(s, causal, window)
        nbytes = q.element_size() * 2 * b * s * (h + kvh) * hd       # q, k, v read; out written
        bound, bound_by = attention_bound_ms(4 * b * h * hd * pairs, nbytes, dt)
        k3[name] = dict(err=err, ms=ms, plain=plain_ms, library=lib_ms, bound=bound,
                        bound_by=bound_by)
        print(f"flash: K3 {name}: {4 * b * h * hd * pairs / ms / 1e9:.1f} TFLOP/s "
              f"({bound / ms:.1%} of the bound; SDPA "
              f"{4 * b * h * hd * pairs / lib_ms / 1e9:.1f} TFLOP/s) [{smi}]", flush=True)
        print(f"flash: K3 {name}: B={b} S={s} H={h} KVH={kvh} hd={hd} causal={causal} "
              f"window={window}: close=True max_abs_err={err:.3e} max_row_rel_err={rel:.3e} "
              f"(planted faults rejected: {rejected}) kernel_ms={ms:.4f} "
              f"call_ms={call:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={bound:.4f} ({bound_by}; {4 * b * h * hd * pairs / 1e9:.2f} GFLOP) "
              f"[{smi}]", flush=True)
    del inputs, outs
    tc_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for edges, g in ((FLASH_EDGES, gen), (FLASH_TC_EDGES, tc_gen)):
        for name, b, s, h, kvh, hd, causal, window, dt in edges:
            q, k, v = qkv((b, s, h, hd), (b, s, kvh, hd), dt, g)
            err, rel = compare(
                flash.flash_attention(q, k, v, causal=causal, window=window),
                flash.flash_attention_plain(q, k, v, causal=causal, window=window),
                dt, f"K3 {name}")
            print(f"flash: K3 edge {name}: B={b} S={s} H={h} KVH={kvh} hd={hd} "
                  f"causal={causal} window={window}: close=True max_abs_err={err:.3e} "
                  f"max_row_rel_err={rel:.3e}", flush=True)
    print(f"flash: phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 10. K4 through the ops entry point: the main path, counted
    t_phase = time.perf_counter()
    inputs = []
    for _, b, s, h, kvh, hd, lens, dt in DECODE_CASES:
        if lens is None:          # ragged, with one sequence full and one of length 1
            lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
            lengths[0], lengths[1] = s, 1
        else:
            lengths = torch.tensor(lens, device=dev)
        inputs.append(qkv((b, h, hd), (b, s, kvh, hd), dt) + (lengths.to(torch.int32),))
    torch.cuda.synchronize()
    decode.decode_launches = 0
    outs = [ops.decode_attention(*args) for args in inputs]
    torch.cuda.synchronize()
    k4_launches = decode.decode_launches
    check(k4_launches == 2 * len(DECODE_CASES),
          f"decode: K4 launched {k4_launches} times for {len(DECODE_CASES)} calls")
    print(f"decode: main path ran {len(DECODE_CASES)} ops.decode_attention calls with K4 "
          f"launches={k4_launches} (split pass and merge)", flush=True)
    k4 = {}
    for args, got, case in zip(inputs, outs, DECODE_CASES):
        name, b, s, h, kvh, hd, lens, dt = case
        q, kc, vc, lengths = args
        want = decode.decode_attention_plain(*args)
        err, rel = compare(got, want, dt, f"K4 {name}")
        empty = (lengths <= 0).nonzero().flatten().tolist()
        check(all(not got[i].any() for i in empty), f"K4 {name}: a length-0 row is not zero")
        rejected = rejects(
            [("zeros", torch.zeros_like(want)),
             ("second half of each sequence dropped",
              decode.decode_attention_plain(q, kc, vc, (lengths + 1) // 2))],
            want, dt, f"K4 {name}")
        del want
        valid = int(lengths.clamp(0, s).sum())
        mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

        def library(q=q, kc=kc, vc=vc, mask=mask):
            return F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
                enable_gqa=True)

        def run(args=args):
            return ops.decode_attention(*args)

        ms = kernel_ms(run, KERNEL_REPS, name=("decode_split", "decode_combine_kernel"))
        call = cuda_ms(run, KERNEL_REPS)
        plain_ms = cuda_ms(lambda args=args: decode.decode_attention_plain(*args), PLAIN_REPS)
        lib_ms = cuda_ms(library, KERNEL_REPS)
        nbytes = (q.element_size() * (2 * valid * kvh * hd + 2 * b * h * hd)  # cache rows, q, out
                  + 4 * b)
        bound, bound_by = attention_bound_ms(4 * h * hd * valid, nbytes, dt)
        k4[name] = dict(err=err, ms=ms, plain=plain_ms, library=lib_ms, bound=bound,
                        bound_by=bound_by)
        print(f"decode: K4 {name}: {nbytes / ms / 1e9:.3f} TB/s ({bound / ms:.1%} of the "
              f"bound; SDPA {nbytes / lib_ms / 1e9:.3f} TB/s) [{smi}]", flush=True)
        n_split, chunk = decode.splits(b, kvh, s, torch.cuda.get_device_properties(dev)
                                       .multi_processor_count)
        print(f"decode: K4 {name}: B={b} S={s} H={h} KVH={kvh} hd={hd} valid "
              f"positions={valid} (rows of length 0: {empty}) splits={n_split}x{chunk}: "
              f"close=True max_abs_err={err:.3e} max_row_rel_err={rel:.3e} (planted faults "
              f"rejected: {rejected}) kernel_ms={ms:.4f} call_ms={call:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
              f"({bound_by}; {nbytes / 1e9:.3f} GB) [{smi}]", flush=True)
    del inputs, outs
    for name, b, s, h, kvh, hd, lens, dt in DECODE_EDGES:
        args = qkv((b, h, hd), (b, s, kvh, hd), dt) + (torch.tensor(lens, device=dev),)
        got = decode.decode_attention(*args)
        err, rel = compare(got, decode.decode_attention_plain(*args), dt, f"K4 {name}")
        check(all(not got[i].any() for i, n in enumerate(lens) if n <= 0),
              f"K4 {name}: a row of length <= 0 is not zero")
        print(f"decode: K4 edge {name}: B={b} S={s} H={h} KVH={kvh} hd={hd} lengths={lens}: "
              f"close=True max_abs_err={err:.3e} max_row_rel_err={rel:.3e}", flush=True)
    print(f"decode: phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    def entry(name, source, replaces, launches, cases, headline):
        one = cases[headline]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max(c["err"] for c in cases.values()),
                "ms": one["ms"], "plain_ms": one["plain"], "bound_ms": one["bound"],
                "bound_by": one["bound_by"], "library_ms": one["library"]}

    return [entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:94", k3_launches, k3,
                  FLASH_CASES[0][0]),
            entry("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                  "src/repro/kernels/decode_attention.py:78", k4_launches, k4,
                  DECODE_CASES[0][0])]


EVAL_SLACK = 6                   # phase 11 (d): the deferral check's slack
EVAL_KINDS = (("policy", "eval/policy_block"), ("typed", "eval/typed_cell"),
              ("deferral", "eval/deferral_cell"), ("offline", "eval/offline_baseline"))


def eval_phase(smi, counted, ab, dev):
    """Phase 11: the competitive-ratio eval on the card — the smoke grid
    held to ``BENCH_provision.json`` where it draws nothing, the full grid
    through the CLI's gates, K2's launches per ``evaluate``, the wall time
    of each block kind and the deferral layer's share, then deferred
    ``provision()`` against its plain route.  Returns K2's launches on the
    eval's main path (both grids)."""
    import dataclasses

    import torch

    from repro_torch import PAPER_COSTS, DeferralSpec, PolicySpec, ProvisionSpec, Workload
    from repro_torch.eval import evaluate, harness
    from repro_torch.eval.__main__ import FULL_GRID, SMOKE_GRID, check_gates
    from repro_torch.kernels import provision_scan as kernels
    from repro_torch.obs import telemetry_session
    from repro_torch.scenarios import generate

    provision_module = importlib.import_module("repro_torch.core.provision")
    t_phase = time.perf_counter()

    def key(c):
        return (c["policy"], c["scenario"], c["noise_std"], c["window"], c["slack"], c["rule"])

    def run(name, grid):
        """``evaluate(grid)`` on the card, counted and traced: the report, the
        K2 launches, and the summed wall ms of each block kind's spans."""
        with telemetry_session() as tel:
            report, n1, n2 = counted(lambda: evaluate(grid))
        k2_counter = tel.counter_value("kernels/provision_scan_stream_launches")
        spans = {r["name"]: r["sum"] for r in tel.metrics_records() if r["type"] == "histogram"}
        n_blocks = len(grid.policies) * len(grid.scenarios)
        n_typed = len(grid.typed_policies) * len(grid.scenarios)
        n_deferral = len(grid.deferral_policies) * len(grid.scenarios) * len(grid.deferral_slacks)
        want = n_blocks + n_typed + n_deferral
        check(n1 == 0 and n2 == want and int(k2_counter) == want,
              f"eval {name}: K2 launched {n2} times (counter {k2_counter}) and K1 {n1}, "
              f"expected {want} and 0: one per online block, typed cell and deferral cell")
        check(report.backend == "cuda", f"eval {name}: backend {report.backend}")
        check_gates(report)
        kinds = {kind: spans.get(f"span/{label}", 0.0) for kind, label in EVAL_KINDS}
        # the deferral layer's spans nest inside the deferral cells' spans of
        # this same run (the offline baselines call DeferralSpec.apply outside
        # provision(), so outside these spans)
        layer = sum(spans.get(f"span/provision/deferral_{part}", 0.0)
                    for part in ("apply", "metrics"))
        check(0.0 < layer <= kinds["deferral"],
              f"eval {name}: deferral layer {layer} ms against the cells' {kinds['deferral']}")
        rest = report.elapsed_s * 1e3 - sum(kinds.values())
        print(f"eval: {name} grid, {len(report.cells)} cells in {report.elapsed_s:.2f} s: K2 "
              f"launches={n2} ({n_blocks} policy blocks, {n_typed} typed, {n_deferral} deferral "
              f"cells) and K1 0; every cell bound_ok, every deferral cell slo_ok, the CLI's "
              f"gates pass; wall ms by block kind: "
              + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items())
              + f", in no block {rest:.1f}; the deferral layer (DeferralSpec.apply and "
              f".metrics in provision()) {layer:.1f} of the deferral cells' "
              f"{kinds['deferral']:.1f} ({100 * layer / kinds['deferral']:.1f}%) [{smi}]",
              flush=True)
        return report, n2

    fields = ("x", "cost", "energy", "toggle_cost", "level_cost", "group_cost", "backlog",
              "max_delay", "p99_delay", "deadline_misses", "unserved")

    def same(what, make):
        """``make()``'s spec through K2 and through the plain route: every leaf
        equal; returns K2's result."""
        got = provision_module._provision(make(), record_decisions=False, kernel=True)
        want = provision_module._provision(make(), record_decisions=False, kernel=False)
        for f in fields:
            a, b = getattr(got, f), getattr(want, f)
            check((a is None and b is None)
                  or (a is not None and b is not None and torch.equal(a, b)),
                  f"{what}: {f} differs between K2 and the plain route")
        return got

    def hold(name, grid, report):
        """One online block per policy, one typed AQ-rand cell and the widest
        slack's deferral cell of ``grid``, rebuilt by the eval's own spec
        builders from the grid's seed (so with the same draws): K2 must equal
        the plain route on every leaf, and K2's mean costs the report's, which
        makes them the cells the eval ran."""
        device = torch.device(grid.device)
        labels = harness._scenario_labels(grid.scenarios)
        demands = [generate(sc, grid.n_traces, grid.n_slots) for sc in grid.scenarios]
        n_levels = report.grid["n_levels"]
        shape = (grid.n_traces, grid.n_slots)
        means = {key(dataclasses.asdict(c)): c.mean_cost for c in report.cells}

        def on_card(si):
            return torch.as_tensor(demands[si], device=device).to(torch.int32)

        def mean_is(k, cost):
            check(means[k] == float(cost.mean()),
                  f"eval {name}: cell {k} rebuilt costs {float(cost.mean())}, the report "
                  f"{means[k]}")

        held = []
        for pi, policy in enumerate(grid.policies):
            si = pi % len(grid.scenarios)
            got = same(f"eval {name} {policy} block on {labels[si]}",
                       lambda pi=pi, si=si: harness._block_spec(
                           grid, None, device, pi, on_card(si),
                           harness._noise(grid, None, device, si, shape), n_levels))
            for s, std in enumerate(grid.noise_stds):
                for w, window in enumerate(grid.windows):
                    mean_is((policy, labels[si], std, window, None, None),
                            harness._numpy(got.cost)[s, w])
            held.append(f"{policy} on {labels[si]} (G={got.cost.numel()}, N={n_levels})")
        pi, si = grid.typed_policies.index("AQ-rand"), 3 % len(grid.scenarios)
        got = same(f"eval {name} typed AQ-rand on {labels[si]}",
                   lambda: harness._typed_spec(grid, None, device, pi, demands[si]))
        mean_is(("AQ-rand", labels[si], 0.0, 0, None, None),
                harness._numpy(got.group_cost).sum(axis=-1))
        held.append(f"AQ-rand on {labels[si]} (N={got.level_cost.shape[-1]})")
        slack, si = max(grid.deferral_slacks), 4 % len(grid.scenarios)
        policy = grid.deferral_policies[0]
        got = same(f"eval {name} deferral {policy} on {labels[si]} at slack {slack}",
                   lambda: harness._deferral_spec(grid, None, device, 0, on_card(si), slack,
                                                  n_levels))
        mean_is((policy, labels[si], 0.0, 0, slack, grid.deferral_rule), harness._numpy(got.cost))
        held.append(f"deferral {policy} on {labels[si]} at slack {slack}")
        print(f"eval: {name} grid: K2 equals the plain route on every leaf, and the report's "
              f"mean costs, for " + "; ".join(held), flush=True)

    # (a) the smoke grid, held to the checked-in report where nothing is drawn
    smoke_grid = dataclasses.replace(SMOKE_GRID, device="cuda")
    smoke, n_smoke = run("smoke", smoke_grid)
    hold("smoke", smoke_grid, smoke)
    with open(os.path.join(ROOT, "BENCH_provision.json")) as f:
        stored = {key(c): c for c in json.load(f)["cells"]}
    ours = {key(c): c for c in (dataclasses.asdict(c) for c in smoke.cells)}
    check(len(ours) == len(smoke.cells) == len(stored) == 144 and ours.keys() == stored.keys(),
          f"eval smoke: {len(ours)} cells against the stored {len(stored)}")
    drawfree = [k for k, c in stored.items()
                if (c["policy"] == "A1" and c["noise_std"] == 0.0) or c["policy"] == "AQ-det"]
    check(len(drawfree) == 48, f"eval smoke: {len(drawfree)} draw-free cells, expected 48")
    for k in drawfree:
        got, want = dict(ours[k]), dict(stored[k])
        for d in (got, want):
            d.pop("wall_ms")
            d.pop("compiles")
        diff = {f: (got[f], want[f]) for f in want if got[f] != want[f]}
        check(not diff, f"eval smoke: cell {k} differs from BENCH_provision.json: {diff}")
    also = sum(1 for k in stored if k not in drawfree
               and {f: v for f, v in ours[k].items() if f not in ("wall_ms", "compiles")}
               == {f: v for f, v in stored[k].items() if f not in ("wall_ms", "compiles")})
    print(f"eval: smoke grid: the 48 cells that draw nothing (A1 at noise 0, AQ-det, deferral "
          f"A1) equal BENCH_provision.json on every field but wall_ms and compiles; "
          f"{also} of the other 96 equal it too (not required: their draws are the card's)",
          flush=True)

    # (b) and (c) the full grid
    full_grid = dataclasses.replace(FULL_GRID, device="cuda")
    full, n_full = run("full", full_grid)
    hold("full", full_grid, full)

    # (d) deferred provision() on the card against its plain route, every leaf
    for p in ("A1", "A2"):
        def spec(p=p):
            return ProvisionSpec(
                costs=PAPER_COSTS,
                workload=Workload(demand=ab, deferral=DeferralSpec(slack=EVAL_SLACK)),
                policy=PolicySpec(p, windows=WINDOWS,
                                  generator=torch.Generator(device=dev).manual_seed(SEED)),
                n_levels=N_LEVELS, device=dev,
            )
        got, n1, n2 = counted(lambda: provision_module.provision(spec()))
        check((n1, n2) == (0, 1), f"deferred provision {p}: K1 {n1} and K2 {n2} launches")
        want = provision_module._provision(spec(), record_decisions=False, kernel=False)
        for f in fields:
            a, b = getattr(got, f), getattr(want, f)
            check((a is None and b is None and f == "group_cost")
                  or (a is not None and b is not None and torch.equal(a, b)),
                  f"deferred provision {p}: {f} differs from the plain route's")
        check(int(got.unserved.sum()) == 0 and int(got.deadline_misses.sum()) == 0,
              f"deferred provision {p}: work unserved or deadlines missed")
        print(f"eval: provision({p}) with DeferralSpec(slack={EVAL_SLACK}) at N={N_LEVELS}, "
              f"T={N_SLOTS}, B={N_TRACES}, windows 0..5: one K2 launch, and every leaf (x, "
              f"costs, backlog, max_delay, p99_delay, deadline_misses, unserved) equals the "
              f"plain route's; p99 delay {int(got.p99_delay.max())} slots", flush=True)
    print(f"eval: phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return n_smoke + n_full


STEP_CHUNKS = (1, 64, 1024)      # phase 12: the serving loop's chunk sizes
# phase 12: (policy, window, deferral slack or None); the stepper steps one
# fleet of N replicas, the first trace of phase 4's demand capped at N (its
# peak is 4742, and a planner rejects demand above its fleet)
STEP_CASES = (("A1", 2, None), ("A2", 2, None), ("delayedoff", 0, None),
              ("AQ-rand", 0, None), ("A1", 0, EVAL_SLACK))
STEP_PROFILE_REPS = 10


def stepper_phase(smi, counted, row, dev):
    """Phase 12: the serving stepper ``FleetProvisioner.advance()`` on the
    card over one week of the smoke fleet's first trace at each chunk size:
    K2 against the plain route on every leaf and on the carry, one K2
    launch per call and no build in any loop, chunk invariance of the
    no-peek policies, one-shot ``advance`` against ``plan()``, the plan
    latency and K2's share of it, then the eval's ``streaming`` section.
    Returns K2's launches on the stepper's main path."""
    import numpy as np
    import torch

    from repro_torch import PAPER_COSTS, DeferralSpec
    from repro_torch.core.torch_provision import KEYED
    from repro_torch.deferral import defer_stream, defer_stream_init
    from repro_torch.eval.__main__ import streaming_latency
    from repro_torch.kernels._build import load_provision_scan
    from repro_torch.lint import tracer_sanitizer
    from repro_torch.serving import FleetProvisioner, stepper_chunk
    from repro_torch.serving.stepper import slot_uniforms

    t_phase = time.perf_counter()
    row = np.minimum(row, N_LEVELS)
    fields = ("x", "cost", "energy", "toggle_cost", "level_cost", "group_cost", "backlog",
              "max_delay", "p99_delay", "deadline_misses", "unserved")

    def planner(policy, window, slack):
        keyed = policy in KEYED
        return FleetProvisioner(
            PAPER_COSTS, policy=policy, window=window, max_replicas=N_LEVELS,
            generator=torch.Generator(device=dev).manual_seed(SEED) if keyed else None,
            deferral=None if slack is None else DeferralSpec(slack=slack), device=dev)

    def same_state(a, b):
        if a is None or b is None:
            return a is None and b is None
        return all(torch.equal(a[k], b[k]) for k in a)

    launches = 0
    xs, rows = {}, []
    for policy, window, slack in STEP_CASES:
        name = f"{policy} w={window}" + ("" if slack is None else f" slack={slack}")
        for t_chunk in STEP_CHUNKS:
            t_loop = time.perf_counter()
            prov, oracle = planner(policy, window, slack), planner(policy, window, slack)
            outs = []
            with tracer_sanitizer(fns=(load_provision_scan,)) as watch:
                for t0 in range(0, N_SLOTS, t_chunk):
                    chunk = row[t0:t0 + t_chunk]
                    x, n1, n2 = counted(lambda: prov.advance(chunk))
                    check((n1, n2) == (0, 1), f"stepper {name} t_chunk={t_chunk} slot {t0}: "
                          f"K1 launched {n1} times and K2 {n2}, expected 0 and 1")
                    launches += n2
                    want = oracle._advance(chunk, kernel=False)
                    check(np.array_equal(x, want),
                          f"stepper {name} t_chunk={t_chunk} slot {t0}: x differs from the "
                          "plain route's")
                    for f in fields:
                        a, b = getattr(prov.last_plan, f), getattr(oracle.last_plan, f)
                        check((a is None and b is None)
                              or (a is not None and b is not None and torch.equal(a, b)),
                              f"stepper {name} t_chunk={t_chunk} slot {t0}: last_plan.{f} "
                              "differs from the plain route's")
                    st, so = prov.state, oracle.state
                    check(st.t == so.t and all(torch.equal(getattr(st, k), getattr(so, k))
                                               for k in ("r", "on", "wait"))
                          and same_state(st.defer, so.defer) and same_state(st.queue, so.queue),
                          f"stepper {name} t_chunk={t_chunk} slot {t0}: the carry differs "
                          "from the plain route's")
                    outs.append(x)
            check(watch.added == 0, f"stepper {name} t_chunk={t_chunk}: {watch.added} builds")
            xs[name, t_chunk] = np.concatenate(outs)
            check(xs[name, t_chunk].shape == (N_SLOTS,)
                  and (slack is not None or bool((xs[name, t_chunk] >= row).all())),
                  f"stepper {name} t_chunk={t_chunk}: x does not cover the demand")
            p50, p99 = prov.metrics.latency_quantile(0.5), prov.metrics.latency_quantile(0.99)
            t_loop = time.perf_counter() - t_loop
            # K2's device time for the first chunk's step, as the advance()
            # that served it launched it (its served demand, its draws), from
            # the profiler's records of the step alone: an advance() holds
            # hundreds of host operations per slot under deferral or draws
            first = torch.as_tensor(row[:t_chunk], device=dev).to(torch.int32)
            if slack is not None:
                first, _ = defer_stream(first, defer_stream_init(slack, device=dev),
                                        slack=slack, cap=N_LEVELS)
            draws = (slot_uniforms(prov.policy.generator, N_LEVELS, dev)(0, first.shape[0])
                     if policy in KEYED else None)
            st = prov.state
            k2 = kernel_ms(lambda: stepper_chunk(
                first, 0, st.r, st.on, st.wait, PAPER_COSTS.delta, policy=policy,
                n_levels=N_LEVELS, max_h=PAPER_COSTS.delta_slots(), window=window,
                uniforms=draws), STEP_PROFILE_REPS, name="stream_scan_kernel")
            rows.append((name, t_chunk, len(outs), p50, p99, k2))
            print(f"stepper: {name} t_chunk={t_chunk}: {len(outs)} advance() calls, one K2 "
                  f"launch each, 0 builds; x, every last_plan leaf and the carry equal the "
                  f"plain route's after every call ({t_loop:.1f} s with the plain route and "
                  f"the checks); plan latency p50={p50:.4f} ms p99={p99:.4f} ms, K2 device "
                  f"{k2:.4f} ms for the first chunk ({100 * k2 / p50:.1f}% of p50) [{smi}]",
                  flush=True)

    # the no-peek policies draw nothing past the chunk: any cut, one schedule
    for name in ("delayedoff w=0", "AQ-rand w=0"):
        check(all(np.array_equal(xs[name, t], xs[name, STEP_CHUNKS[0]]) for t in STEP_CHUNKS),
              f"stepper {name}: x differs between the chunk sizes {STEP_CHUNKS}")
    # one chunk of 1024 slots holds the whole week: advance() is plan()
    one_shot = STEP_CHUNKS[-1]
    for policy, window in (("A1", 2), ("delayedoff", 0)):
        name = f"{policy} w={window}"
        prov = planner(policy, window, None)
        prov.advance(row)
        res, n1, n2 = counted(lambda: planner(policy, window, None).plan(row))
        check((n1, n2) == (0, 1), f"plan({name}): K1 {n1} and K2 {n2} launches")
        launches += n2
        check(np.array_equal(xs[name, one_shot], res.x.cpu().numpy()),
              f"stepper {name}: one-shot advance() differs from plan()")
        final_off = int((prov.state.on.cpu().numpy() & ~(row[-1] > np.arange(N_LEVELS))).sum())
        total = float(prov.last_plan.cost) + PAPER_COSTS.beta_off * final_off
        check(abs(total - float(res.cost)) <= 1e-6 * abs(float(res.cost)),
              f"stepper {name}: chunk cost {float(prov.last_plan.cost)} + final off "
              f"{final_off} x {PAPER_COSTS.beta_off} against plan() {float(res.cost)}")
        print(f"stepper: {name}: one-shot advance() equals plan() (provision() through K2), "
              f"and its cost plus the {final_off} final offs equals plan().cost = "
              f"{float(res.cost)}", flush=True)
    print("stepper: delayedoff and AQ-rand give one schedule at t_chunk "
          + ", ".join(map(str, STEP_CHUNKS)), flush=True)

    # the eval's streaming section, held to the checked-in report's shape
    stream, n1, n2 = counted(lambda: streaming_latency(True, "cuda"))
    with open(os.path.join(ROOT, "BENCH_provision.json")) as f:
        stored = json.load(f)["streaming"]
    keys = ("policy", "t_chunk", "chunks", "slots")
    check([[getattr(r, k) for k in keys] for r in stream] == [[r[k] for k in keys]
                                                             for r in stored],
          f"streaming rows {stream} against BENCH_provision.json's {stored}")
    check(all(r.compiles == 0 for r in stream), f"streaming rows built kernels: {stream}")
    want = sum(r.chunks + 1 for r in stream)                     # + one warmup each
    check((n1, n2) == (0, want), f"streaming: K1 {n1} and K2 {n2} launches, expected 0 and "
          f"{want}")
    launches += n2
    print("stepper: streaming section " + "; ".join(
        f"t_chunk={r.t_chunk} chunks={r.chunks} slots={r.slots} p50={r.p50_ms:.4f} ms "
        f"p99={r.p99_ms:.4f} ms compiles={r.compiles}" for r in stream)
        + f"; chunks and slots equal BENCH_provision.json's [{smi}]", flush=True)
    print(f"stepper: phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


SERVE_ARCH = "llama3.2-1b"       # phase 13: the serving path at this model's full width
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_SEQ = 4, 192, 64, 256   # the engine bench
COMPARE_STEPS = 8                # decode steps whose logits are held to the plain route
# whole-model logits, per row, of the row's largest |logit|: float32 compute
# as the CPU parity tests hold the port to the reference; in bf16 two routes
# that round at other places part by as much as each is from the float32
# model (2.1e-2 and 2.3 to 2.5e-2 over 16 layers, on the card), so there the
# kernel route must be no farther from the float32 model than the plain
# route, within BF16_SLACK, and the tolerance sets the greedy-token margin
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BF16_SLACK = 1.25
CLUSTER_SEQ = 96                 # the launcher's engines: max_batch 1, max_seq 96
# K3 and K4 at the path's shapes: (B, S) of a prefill; (B, cache slots, lengths) of a decode
SERVE_FLASH = ((SERVE_BATCH, SERVE_PROMPT), (1, 1), (1, 7), (1, 17), (1, 32))
SERVE_DECODE = ((SERVE_BATCH, SERVE_SEQ, (SERVE_PROMPT + 1,) * SERVE_BATCH),
                (SERVE_BATCH, SERVE_SEQ, (SERVE_SEQ,) * SERVE_BATCH),
                (1, CLUSTER_SEQ, (1,)), (1, CLUSTER_SEQ, (33,)), (1, CLUSTER_SEQ, (47,)))
SERVE_PROFILE_STEPS = 8


def device_window(fn, reps):
    """``fn()`` run ``reps`` times under ``torch.profiler``, after a warm-up
    run: per run, the wall ms (host clock, ending in a device sync), the
    device busy ms (every kernel, copy and fill the profiler saw on the
    card), the device launches, and the device ms by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    by_name = {e.key: e.self_device_time_total / 1e3 / reps for e in events}
    launches = sum(e.count for e in events) / reps - 1.0 / reps   # less the one fill
    return wall, sum(by_name.values()), launches, by_name


def serving_phase(smi):
    """Phase 13: the serving path with real tokens at llama3.2-1b's full
    width on the card — K3 and K4 at the path's shapes against their plain
    versions, the engine's kernel route against its plain route, the launch
    counts of the main path, the engine bench and ``run_cluster`` with
    engines.  Returns K3's and K4's launches on the main path."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import CostModel
    from repro_torch.data import generate_sessions
    from repro_torch.models import attention, init_params, param_count
    from repro_torch.models.layers import apply_rope, embed_tokens, rms_norm
    from repro_torch.serving import InferenceEngine, make_window_max_predictor, run_cluster
    from repro_torch.serving.engine import serving_params

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    # the model's float32 products (the unembedding) and the plain versions
    # stay out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()          # what earlier phases still hold

    # 1. sizes: the full-width model from the port's own init
    cfg = get_config(SERVE_ARCH)
    cd = cfg.compute_dtype
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    shared = serving_params(params, cfg, dev)
    torch.cuda.synchronize()
    n_params = param_count(cfg)
    leaves = [params["embed"], params["final_ln"]]
    for layer in params["blocks"]:
        for v in layer.values():
            leaves += list(v.values()) if isinstance(v, dict) else [v]
    check(sum(t.numel() for t in leaves) == n_params, "serve: parameter count")
    f32_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"serve: {SERVE_ARCH} full width (layers={cfg.n_layers} d={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size}): {n_params:,} parameters, {f32_bytes / 1e9:.3f} GB in "
          f"float32, drawn and cast to {str(cd).split('.')[1]} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 2. K3 and K4 at the path's shapes, on layer 0's own projections
    rng = np.random.default_rng(SEED)
    p0 = shared["blocks"][0]["attn"]

    def projections(b, s):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)), device=dev)
        h = rms_norm(embed_tokens(tokens, shared["embed"], cd), shared["blocks"][0]["ln1"],
                     cfg.norm_eps)
        q, k, v = attention._qkv(h, p0, cd)
        pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
        return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), v

    measured, errs = {}, {"K3": 0.0, "K4": 0.0}
    for b, s in SERVE_FLASH:
        q, k, v = projections(b, s)
        got = flash.flash_attention(q, k, v, causal=True, block_q=s, block_k=s)
        want = flash.flash_attention_plain(q, k, v, causal=True)
        err, rel = compare(got, want, "bfloat16", f"serve K3 B={b} S={s}")
        errs["K3"] = max(errs["K3"], err)
        line = (f"serve: K3 prefill B={b} S={s} H={cfg.n_heads} KVH={cfg.n_kv_heads} "
                f"hd={cfg.head_dim}: close=True max_abs_err={err:.3e} max_row_rel_err={rel:.3e}")
        if (b, s) == SERVE_FLASH[0]:
            def run(q=q, k=k, v=v, s=s):
                return flash.flash_attention(q, k, v, causal=True, block_q=s, block_k=s)

            def library(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                    enable_gqa=True)

            flops = 4 * b * cfg.n_heads * cfg.head_dim * admitted_pairs(s, True, 0)
            nbytes = q.element_size() * 2 * b * s * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim
            bound, bound_by = attention_bound_ms(flops, nbytes, "bfloat16")
            ms = kernel_ms(run, KERNEL_REPS, name=flash.k3_instance(q.dtype, cfg.head_dim)[0])
            measured["K3"] = dict(err=err, ms=ms, call=cuda_ms(run, KERNEL_REPS),
                                  plain=cuda_ms(lambda q=q, k=k, v=v: flash.flash_attention_plain(
                                      q, k, v, causal=True), PLAIN_REPS),
                                  library=cuda_ms(library, KERNEL_REPS), bound=bound,
                                  bound_by=bound_by)
            line += (" kernel_ms={ms:.4f} call_ms={call:.4f} plain_ms={plain:.4f} "
                     "library_ms={library:.4f} bound_ms={bound:.4f} ({bound_by})"
                     .format(**measured["K3"]))
        print(line + f" [{smi}]", flush=True)
    for b, slots, lens in SERVE_DECODE:
        q, k, v = projections(b, slots)
        q = q[:, -1].contiguous()                     # the last position's query
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = decode.decode_attention(q, k, v, lengths, block_k=slots)
        want = decode.decode_attention_plain(q, k, v, lengths)
        err, rel = compare(got, want, "bfloat16", f"serve K4 B={b} slots={slots} {lens}")
        errs["K4"] = max(errs["K4"], err)
        n_split, chunk = decode.splits(b, cfg.n_kv_heads, slots, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        line = (f"serve: K4 decode B={b} slots={slots} lengths={sorted(set(lens))} "
                f"group={cfg.n_heads // cfg.n_kv_heads} splits={n_split}x{chunk}: close=True "
                f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e}")
        if lens == SERVE_DECODE[0][2]:
            mask = (torch.arange(slots, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

            def run(q=q, k=k, v=v, lengths=lengths, slots=slots):
                return decode.decode_attention(q, k, v, lengths, block_k=slots)

            def library(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                    enable_gqa=True)

            valid = int(lengths.sum())
            nbytes = q.element_size() * (2 * valid * cfg.n_kv_heads * cfg.head_dim
                                         + 2 * b * cfg.n_heads * cfg.head_dim) + 4 * b
            bound, bound_by = attention_bound_ms(4 * cfg.n_heads * cfg.head_dim * valid, nbytes,
                                                 "bfloat16")
            ms = kernel_ms(run, KERNEL_REPS, name=("decode_split", "decode_combine_kernel"))
            measured["K4"] = dict(err=err, ms=ms, call=cuda_ms(run, KERNEL_REPS),
                                  plain=cuda_ms(lambda q=q, k=k, v=v, lengths=lengths:
                                                decode.decode_attention_plain(q, k, v, lengths),
                                                PLAIN_REPS),
                                  library=cuda_ms(library, KERNEL_REPS), bound=bound,
                                  bound_by=bound_by)
            line += (" kernel_ms={ms:.4f} call_ms={call:.4f} plain_ms={plain:.4f} "
                     "library_ms={library:.4f} bound_ms={bound:.4f} ({bound_by})"
                     .format(**measured["K4"]))
        print(line + f" [{smi}]", flush=True)

    # 3. the whole model, every route fed the same tokens (the float32
    # model's greedy picks): in float32, the kernel route (K3's and K4's
    # float32 instances) against the plain route; in bf16, the served
    # config, both routes against each other and against the float32 model
    engine = InferenceEngine(cfg, shared, max_batch=SERVE_BATCH, max_seq=SERVE_SEQ, device=dev)
    check(engine.params["embed"].data_ptr() == params["embed"].data_ptr(),
          "serve: the engines copied the weights")
    prompt = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    f32_cfg = cfg.replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32)

    def route(route_cfg, weights, kernel, forced=None):
        return InferenceEngine(route_cfg, weights, max_batch=SERVE_BATCH, max_seq=SERVE_SEQ,
                               device=dev, kernel=kernel)._generate(
            prompt, COMPARE_STEPS + 1, forced=forced, keep_logits=True)

    picks, exact = route(f32_cfg, params, False)
    k32_picks, k32 = route(f32_cfg, params, True, picks)
    tol = LOGIT_TOL["float32"]
    shape = (SERVE_BATCH, cfg.vocab_size)
    f32_err, agreed, decided = logits_held(k32, k32_picks, exact, picks, tol, tol, shape,
                                           "serve: float32")
    print(f"serve: float32 model, kernel route == plain route: prefill + {COMPARE_STEPS} decode "
          f"steps x {SERVE_BATCH} rows, max_row_rel_err={f32_err:.3e} (tol {tol}); greedy "
          f"tokens agree in {agreed} of {SERVE_BATCH * (COMPARE_STEPS + 1)} picks, all "
          f"{decided} whose top-2 margin exceeds the tolerance [{smi}]", flush=True)
    plain_picks, plain = route(cfg, shared, False, picks)
    kernel_picks, kernel = route(cfg, shared, True, picks)
    tol = LOGIT_TOL["bfloat16"]
    to_f32 = [max(float(row_err(x, ref).max()) for x, ref in zip(logits, exact))
              for logits in (kernel, plain)]
    check(to_f32[0] <= BF16_SLACK * to_f32[1],
          f"serve: bf16 kernel route {to_f32[0]:.3e} from the float32 model, the plain route "
          f"{to_f32[1]:.3e}: more than {BF16_SLACK} times as far")
    bf16_err, agreed, decided = logits_held(kernel, kernel_picks, plain, plain_picks, math.inf,
                                            tol, shape, "serve: bf16")
    print(f"serve: bf16 model (served): kernel route vs plain route max_row_rel_err="
          f"{bf16_err:.3e}; from the float32 model: kernel route {to_f32[0]:.3e}, plain route "
          f"{to_f32[1]:.3e} (held: kernel <= {BF16_SLACK} x plain); greedy tokens agree in "
          f"{agreed} of {SERVE_BATCH * (COMPARE_STEPS + 1)} picks, all {decided} whose plain "
          f"top-2 margin exceeds {tol} of the row's largest logit [{smi}]", flush=True)
    del exact, k32, plain, kernel

    # 4 and 5. the main path, counted: generate() through the kernels
    torch.cuda.synchronize()
    flash.flash_launches = decode.decode_launches = 0
    t0 = time.perf_counter()
    res = engine.generate(prompt, SERVE_NEW)
    wall = time.perf_counter() - t0
    k3_bench, k4_bench = flash.flash_launches, decode.decode_launches
    check(res.tokens.shape == (SERVE_BATCH, SERVE_NEW), "serve: generate's tokens")
    check(k3_bench == cfg.n_layers, f"serve: K3 launched {k3_bench} times in one prefill "
          f"of {cfg.n_layers} layers")
    check(k4_bench == 2 * cfg.n_layers * (SERVE_NEW - 1),
          f"serve: K4 launched {k4_bench} times in {SERVE_NEW - 1} decode steps of "
          f"{cfg.n_layers} layers")
    print(f"serve: main path generate(B={SERVE_BATCH}, prompt={SERVE_PROMPT}, "
          f"new={SERVE_NEW}): K3 launches={k3_bench} ({k3_bench} per prefill), K4 "
          f"launches={k4_bench} ({k4_bench // (SERVE_NEW - 1)} per decode step); "
          f"{SERVE_BATCH * SERVE_NEW / wall:.1f} tokens/s, wall {wall * 1e3:.1f} ms [{smi}]",
          flush=True)

    batch = {"tokens": torch.as_tensor(prompt, device=dev)}
    tok = torch.as_tensor(res.tokens[:, 0], device=dev)

    def prefill(cache=None):
        return engine._prefill(engine.params, batch,
                               engine_cache(engine, SERVE_BATCH) if cache is None else cache)

    with torch.inference_mode():
        prefill_ms = []
        for cache in [engine_cache(engine, SERVE_BATCH) for _ in range(5)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(cache)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms = []
        for i in range(SERVE_NEW - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = engine._decode(engine.params, tok, SERVE_PROMPT + i, cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms.sort()
    p50, p99 = statistics.median(step_ms), step_ms[min(len(step_ms) - 1,
                                                       int(0.99 * len(step_ms)))]
    tok = torch.as_tensor(res.tokens[:, 0], device=dev)

    pre_wall, pre_busy, pre_launches, pre_names = device_window(
        torch.inference_mode()(prefill), 3)
    with torch.inference_mode():
        _, cache = prefill()

    def decode_steps():
        with torch.inference_mode():
            t = tok
            for i in range(SERVE_PROFILE_STEPS):
                logits, _ = engine._decode(engine.params, t, SERVE_PROMPT + i, cache)
                t = torch.argmax(logits, dim=-1).to(torch.int32)

    dec_wall, dec_busy, dec_launches, dec_names = device_window(decode_steps, 1)
    n = SERVE_PROFILE_STEPS
    k3_pre = sum(ms for name, ms in pre_names.items() if "flash" in name)
    k4_dec = sum(ms for name, ms in dec_names.items() if "decode_split" in name
                 or "decode_combine" in name) / n
    top = sorted(dec_names.items(), key=lambda kv: -kv[1])[:4]
    print(f"serve: bench B={SERVE_BATCH} prompt={SERVE_PROMPT} new={SERVE_NEW} "
          f"max_seq={SERVE_SEQ}: prefill_ms={statistics.median(prefill_ms):.3f} decode step "
          f"p50_ms={p50:.3f} p99_ms={p99:.3f} ({SERVE_BATCH / p50 * 1e3:.1f} tokens/s at p50) "
          f"[{smi}]", flush=True)
    print(f"serve: profiler: prefill wall {pre_wall:.3f} ms, device busy {pre_busy:.3f} ms "
          f"({pre_busy / pre_wall:.1%}), {pre_launches:.0f} device launches, K3 {k3_pre:.4f} ms "
          f"({k3_pre / pre_busy:.1%} of busy); decode step wall {dec_wall / n:.3f} ms, device "
          f"busy {dec_busy / n:.3f} ms ({dec_busy / dec_wall:.1%}), "
          f"{dec_launches / n:.0f} device launches, K4 {k4_dec:.4f} ms "
          f"({k4_dec * n / dec_busy:.1%} of busy, {k4_dec * n / dec_wall:.1%} of wall); "
          "most device time per step: "
          + ", ".join(f"{name[:48]} {ms / n:.4f} ms" for name, ms in top) + f" [{smi}]",
          flush=True)
    del cache

    # 6. the cluster, with the launcher's defaults and full-width engines
    costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
    trace = generate_sessions(np.random.default_rng(0), n_slots=60, mean_concurrency=4.0)

    def cluster(factory):
        return run_cluster(trace, costs, policy="A1", alpha=0.5,
                           predictor=make_window_max_predictor(trace), engine_factory=factory,
                           rng=np.random.default_rng(1))

    want = cluster(None)
    engines = []

    def factory():
        engines.append(InferenceEngine(cfg, shared, max_batch=1, max_seq=CLUSTER_SEQ,
                                       device=dev))
        return engines[-1]

    torch.cuda.synchronize()
    flash.flash_launches = decode.decode_launches = 0
    t0 = time.perf_counter()
    got = cluster(factory)
    cluster_s = time.perf_counter() - t0
    k3_cluster, k4_cluster = flash.flash_launches, decode.decode_launches
    sessions = len(trace.sessions)
    check(got.sessions_served == sessions, "serve: a session was not served")
    check(got.tokens_generated > 0, "serve: the cluster generated no token")
    check((got.total_cost, got.static_cost, got.reduction, got.peak_concurrency, got.scaler)
          == (want.total_cost, want.static_cost, want.reduction, want.peak_concurrency,
              want.scaler), "serve: the engines changed the cluster's schedule")
    check(k3_cluster == cfg.n_layers * sessions, f"serve: cluster K3 launches {k3_cluster}")
    check(k4_cluster == 2 * cfg.n_layers * (got.tokens_generated - sessions),
          f"serve: cluster K4 launches {k4_cluster}")
    print(f"serve: run_cluster A1 alpha=0.5 (launcher defaults, {sessions} sessions, "
          f"{len(engines)} engines of max_seq {CLUSTER_SEQ}): report == run without engines "
          f"(cost={got.total_cost:.1f} static={got.static_cost:.0f} "
          f"reduction={got.reduction:.1%}); tokens_generated={got.tokens_generated} in "
          f"{cluster_s:.2f} s ({got.tokens_generated / cluster_s:.1f} tokens/s); K3 "
          f"launches={k3_cluster} K4 launches={k4_cluster} [{smi}]", flush=True)
    print(f"serve: peak device memory of phase 13 "
          f"{(torch.cuda.max_memory_allocated() - resident) / 1e9:.2f} GB (above the "
          f"{resident / 1e9:.2f} GB earlier phases hold); phase 13 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del params, shared, engine, engines
    torch.cuda.empty_cache()
    return {"k3_launches": k3_bench + k3_cluster, "k4_launches": k4_bench + k4_cluster,
            "errs": errs, "measured": measured, "cluster": (trace, costs, got)}


TRAIN_ARCH = "llama3.2-1b"       # phase 14: training at this model's full width
TRAIN_BATCH, TRAIN_SEQ = 4, 128  # the reference launcher's defaults
TRAIN_STEPS, TRAIN_WARMUP = 20, 5
TRAIN_PROFILE_STEPS = 3
# the loss through K3 (no grad) against the einsum route, relative: float32
# compute as the CPU parity tests hold the port; bf16 rounds at other places
# on each route
TRAIN_LOSS_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# crash and resume: layers of the full width, steps, checkpoint period, crash step
RESUME_LAYERS, RESUME_STEPS, RESUME_EVERY, RESUME_CRASH = 2, 5, 3, 4
# offline provision() against the DP oracle: (P, beta_on, beta_off), traces of 3 x 30 slots
DP_COSTS = ((1.0, 3.0, 3.0), (2.0, 3.0, 2.0), (1.5, 0.7, 4.1))
DP_TRACES = 4
IDLE_SAMPLES = 10


def nvidia_smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def train_phase(smi, cluster, build_s):
    """Phase 14: training at llama3.2-1b's full width on the card — K3 and
    K4 refuse autograd, K3 inside ``lm_loss`` under ``no_grad`` against the
    einsum route, the ``Trainer`` (the gradients of the first backward
    pass, the loss over the steps, step times, memory, busy share), crash
    and resume, the port's oracles (the DP optimum, phase 13's cluster
    against the brick simulator) and the idle power draw.  Returns K3's
    launches on the path (the no-grad losses)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.core import (
        A1Deterministic,
        CostModel,
        PolicySpec,
        ProvisionSpec,
        Workload,
        a0_cost,
        dp_optimal_cost,
        provision,
        simulate,
    )
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, loss_fn, param_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.serving import replica_cost_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.utils.tree import tree_leaves

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()          # what earlier phases still hold
    cfg = get_config(TRAIN_ARCH).replace(remat="full")
    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)

    # (a) K3 and K4 refuse autograd; the same calls run under no_grad
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(1, TRAIN_SEQ, h, cfg.head_dim, generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (cfg.n_heads, cfg.n_kv_heads,
                                                           cfg.n_kv_heads))
    lengths = torch.tensor([TRAIN_SEQ], dtype=torch.int32, device=dev)
    calls = (("K3", "flash_attention", lambda q: ops.flash_attention(q, k, v)),
             ("K4", "decode_attention", lambda q: ops.decode_attention(q[:, -1], k, v, lengths)))
    for name, fn_name, call in calls:
        before = flash.flash_launches, decode.decode_launches
        try:
            call(q.detach().requires_grad_(True))
            raised = ""
        except RuntimeError as err:
            raised = str(err)
        check(name in raised and "no backward" in raised,
              f"train: {name} with an input that requires grad did not refuse autograd")
        check((flash.flash_launches, decode.decode_launches) == before,
              f"train: {name} launched though it refused")
        with torch.no_grad():
            got = call(q.detach().requires_grad_(True))
        want = call(q)
        check((flash.flash_launches, decode.decode_launches) != before,
              f"train: {name} under no_grad did not launch")
        check(torch.equal(got, want) and got.grad_fn is None,
              f"train: {name} under no_grad differs from the call without grad")
        print(f"train: (a) {fn_name} ({name}) with an input that requires grad raises "
              f"RuntimeError ({raised[:60]}...); under no_grad it launches and equals the "
              "call on the same tensors without grad", flush=True)
    del q, k, v

    # (b) K3 inside lm_loss, under no_grad, against the einsum route
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    batch = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, SEED, dev).batch_at(0)
    k3_path = 0
    for dtype, tol in TRAIN_LOSS_TOL.items():
        c = cfg.replace(compute_dtype=getattr(torch, dtype))
        with torch.no_grad():
            torch.cuda.synchronize()
            flash.flash_launches = decode.decode_launches = 0
            got = float(loss_fn(params, c, batch)[0])
            k3, k4 = flash.flash_launches, decode.decode_launches
            want = float(loss_fn(params, c, batch, kernel=False)[0])
            ms = cuda_ms(lambda c=c: loss_fn(params, c, batch), PROVISION_REPS)
            plain_ms = cuda_ms(lambda c=c: loss_fn(params, c, batch, kernel=False),
                               PROVISION_REPS)
        k3_path += k3
        check(k3 == cfg.n_layers and k4 == 0,
              f"train: lm_loss launched K3 {k3} and K4 {k4} times, not {cfg.n_layers} and 0")
        rel = abs(got - want) / abs(want)
        check(math.isfinite(got) and rel <= tol,
              f"train: {dtype} loss through K3 {got} vs the einsum route {want}: {rel:.3e}")
        print(f"train: (b) lm_loss at full width ({param_count(cfg):,} parameters, "
              f"B={TRAIN_BATCH} S={TRAIN_SEQ}) {dtype} compute under no_grad: K3 launches={k3} "
              f"(one per layer), K4 launches={k4}; kernel route {got:.6f} vs einsum route "
              f"{want:.6f}, relative difference {rel:.3e} (tol {tol}); loss ms {ms:.3f} "
              f"(einsum route {plain_ms:.3f}) [{smi}]", flush=True)
    del params

    # (c) the Trainer: the first backward pass, then the main path
    opt = AdamWConfig(warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)

    def train_cfg(name, steps=TRAIN_STEPS, every=10 ** 9):
        return TrainerConfig(total_steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             ckpt_dir=os.path.join(work, name), ckpt_every=every,
                             log_every=1, seed=SEED, opt=opt, device="cuda")

    trainer = Trainer(cfg, train_cfg("main"))
    state = trainer.init_state()
    leaves = tree_leaves(state[0])
    for t in leaves:
        t.requires_grad_(True)
    batch = trainer.pipeline.batch_at(0)
    trainer.train_step(*state, batch)
    norms = torch.stack([t.grad.norm() for t in leaves]).cpu()
    check(bool(torch.isfinite(norms).all()) and bool((norms > 0).all()),
          f"train: {int((norms == 0).sum())} of {len(leaves)} parameters got no gradient")
    print(f"train: (c) first backward pass: all {len(leaves)} parameter tensors have a finite, "
          f"nonzero gradient (smallest norm {float(norms.min()):.3e})", flush=True)
    wall, busy, launches, by_name = device_window(lambda: trainer.train_step(*state, batch),
                                                  TRAIN_PROFILE_STEPS)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    del state, leaves, norms
    torch.cuda.empty_cache()

    stamps = []
    trainer.hooks["on_log"] = lambda step, metrics: stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.flash_launches = decode.decode_launches = 0
    t0 = time.perf_counter()
    out = trainer.run()
    run_s = time.perf_counter() - t0
    check((flash.flash_launches, decode.decode_launches) == (0, 0),
          "train: a training step launched K3 or K4 (the step takes the einsum route)")
    losses = [loss for _, loss in out["history"]]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    step_ms = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    p50 = statistics.median(step_ms)
    p99 = step_ms[min(len(step_ms) - 1, int(0.99 * len(step_ms)))]
    peak = torch.cuda.max_memory_allocated() - resident
    print(f"train: (c) Trainer.run {TRAIN_STEPS} steps (AdamW warmup {TRAIN_WARMUP}, remat "
          f"full, bf16 compute, float32 parameters and moments): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (" + ", ".join(f"{x:.3f}" for x in losses) + f"); step p50_ms="
          f"{p50:.2f} p99_ms={p99:.2f} ({TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.0f} tokens/s at "
          f"p50), run {run_s:.2f} s; peak device memory {peak / 1e9:.2f} GB (above the "
          f"{resident / 1e9:.2f} GB earlier phases hold) [{smi}]", flush=True)
    print(f"train: (c) profiler over {TRAIN_PROFILE_STEPS} steps: wall {wall:.2f} ms per step, "
          f"device busy {busy:.2f} ms ({busy / wall:.1%}), {launches:.0f} device launches per "
          "step; most device time per step: "
          + ", ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in top) + f" [{smi}]", flush=True)
    del out, trainer
    torch.cuda.empty_cache()

    # (d) crash after a checkpoint, resume, and compare with a clean run
    small = cfg.replace(n_layers=RESUME_LAYERS)
    was = torch.are_deterministic_algorithms_enabled()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        crash = train_cfg("crash", RESUME_STEPS, RESUME_EVERY)
        crasher = Trainer(small, crash)
        try:
            crasher.run(fail_at_step=RESUME_CRASH)
            crashed = False
        except RuntimeError as err:
            crashed = "injected failure" in str(err)
        crasher.ckpt.wait()         # the crash comes after the checkpoint is on disk
        check(crashed and latest_step(crash.ckpt_dir) == RESUME_EVERY,
              "train: the crash run did not stop after its checkpoint")
        resumed = Trainer(small, crash).run()
        clean = Trainer(small, train_cfg("clean", RESUME_STEPS)).run()
    finally:
        torch.use_deterministic_algorithms(was)
    diff = max(float((a.detach() - b.detach()).abs().max())
               for a, b in zip(tree_leaves(resumed["params"]), tree_leaves(clean["params"])))
    check(resumed["final_step"] == clean["final_step"] == RESUME_STEPS and diff == 0.0,
          f"train: the resumed run differs from the clean run by {diff:.3e}")
    print(f"train: (d) {RESUME_LAYERS} layers of the full width, crashed at step "
          f"{RESUME_CRASH} after the checkpoint at {RESUME_EVERY}, resumed to "
          f"{RESUME_STEPS}: final parameters equal the clean run's bit for bit (largest "
          f"difference {diff:.1e}; deterministic algorithms on) [{smi}]", flush=True)
    del resumed, clean
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) the port's oracles: offline provision() on the card == the DP
    # optimum; phase 13's cluster against the brick simulator
    worst = 0.0
    for seed in range(DP_TRACES):
        a = np.random.default_rng(seed).integers(0, 6, size=(3, 30))
        for case in DP_COSTS:
            costs = CostModel(*case)
            got = provision(ProvisionSpec(costs=costs, workload=Workload(demand=a),
                                          policy=PolicySpec(name="offline")))
            check(got.cost.device.type == "cuda", "train: provision() left the card")
            want = np.array([dp_optimal_cost(row, costs) for row in a])
            rel = float(np.max(np.abs(got.cost.cpu().numpy() - want) / want))
            check(rel <= 1e-6, f"train: offline cost vs DP optimum {rel:.3e} (seed {seed}, "
                  f"{case})")
            worst = max(worst, rel)
    # the cluster releases the sessions cut at the horizon there and turns
    # their replicas off; the simulator counts them running at T (x(T) =
    # a(T)), so the cluster pays beta_off once more for each of them
    trace, costs, report = cluster
    brick = trace.to_brick()
    opt_cost = a0_cost(brick, costs)
    sim = simulate(brick, A1Deterministic(alpha=0.5), costs).cost
    cut = brick.final_count()
    want = sim + costs.beta_off * cut
    check(abs(report.total_cost - want) <= 1e-6 * want,
          f"train: phase 13's cluster cost {report.total_cost} vs simulate {sim} + "
          f"{cut} x beta_off")
    check(report.total_cost <= 1.5 * opt_cost + 3 * costs.delta + costs.beta_off * cut
          and report.reduction > 0.3,
          "train: phase 13's cluster outside A1's bound or saving too little")
    print(f"train: (e) offline provision() on the card == dp_optimal_cost on {DP_TRACES} x 3 "
          f"traces of 30 slots at {len(DP_COSTS)} cost models (largest relative difference "
          f"{worst:.1e}); phase 13's run_cluster (A1, alpha 0.5) cost {report.total_cost:.1f} "
          f"== the port's simulate {sim:.1f} + beta_off x {cut} sessions cut at the horizon, "
          f"within 1.5 x a0_cost {opt_cost:.1f} + 3 delta (+ the same), reduction "
          f"{report.reduction:.1%}", flush=True)

    # (f) the idle draw, and what replica_cost_model takes from this card
    torch.cuda.synchronize()
    time.sleep(2.0)
    draws = []
    for _ in range(IDLE_SAMPLES):
        draws.append(float(nvidia_smi("power.draw")))
        time.sleep(0.2)
    limit = float(nvidia_smi("power.limit"))
    default = replica_cost_model(weights_bytes_per_device=8e9, n_chips=1)
    print(f"train: (f) idle power.draw median {statistics.median(draws):.2f} W (min "
          f"{min(draws):.2f}, max {max(draws):.2f}, {IDLE_SAMPLES} samples), power.limit "
          f"{limit:.2f} W; cold builds: " + ", ".join(f"{n} {s:.2f} s" for n, s in
                                                         sorted(build_s.items()))
          + f"; replica_cost_model defaults: beta_on {default.beta_on:.4f}, beta_off "
          f"{default.beta_off:.4f} at 8 GB [{smi}]", flush=True)
    print(f"train: phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k3_path


HYBRID_ARCH = "hymba-1.5b"       # phase 15 (a): the hybrid family whole
# (B, prompt, new tokens): the ring full from the first step (and K3's window
# path in every layer); the ring wrapping at position 2048; a prompt past the
# window and not a multiple of it (ROADMAP.md § 3.9)
HYBRID_STREAMS = ((1, 4096, 16), (2, 2040, 16), (1, 2100, 8))
HYBRID_CLUSTER_LAYERS = 4        # phase 15 (d): the cluster's hymba engines cut to this depth
# phase 15 (b): the MoE archs at full width, depth cut to this many layers
MOE_ARCHS = (("qwen3-moe-30b-a3b", 4), ("llama4-scout-17b-a16e", 2))
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 192, 8
XLSTM_ARCH = "xlstm-1.3b"        # phase 15 (c): the ssm family whole
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW = 2, 192, 16
FAMILY_PROFILE_STEPS = 4
# float32 prefill-then-decode against the whole forward: within 1e-4 of a
# row's largest logit, or for xlstm-1.3b's decode steps within this many
# times its prefill's own distance (the forward over the prompt against the
# one over the whole sequence), which its 48 random layers take past 1e-4
# (printed by depth)
CONSISTENCY_SLACK = 2.0
XLSTM_DEPTHS = (2, 16)


def family_weights(cfg, dev, tag="families"):
    """Random float32 weights of ``cfg`` from ``SEED`` on the card and the
    served bf16 copy; prints their size."""
    import torch

    from repro_torch.models import init_params, param_count
    from repro_torch.serving.engine import serving_params

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    shared = serving_params(params, cfg, dev)
    torch.cuda.synchronize()

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        items = tree.values() if isinstance(tree, dict) else tree
        return [x for v in items for x in leaves(v)]

    n = sum(x.numel() for x in leaves(params))
    check(n == param_count(cfg), f"{tag}: {cfg.name} parameter count {n}")
    print(f"{tag}: {cfg.name} (layers={cfg.n_layers} d={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim} d_ff={cfg.d_ff} "
          f"experts={cfg.n_experts} top_k={cfg.top_k} moe_d_ff={cfg.moe_d_ff} "
          f"window={cfg.window} ssm_state={cfg.ssm_state} vocab={cfg.vocab_size}): {n:,} "
          f"parameters, {4 * n / 1e9:.2f} GB in float32, drawn and cast in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return params, shared


def logits_held(got, got_picks, want, want_picks, tol, margin, shape, what):
    """Every step's logits in ``got`` of ``shape`` and finite, each row
    within ``tol`` of its largest |want|, and the greedy picks equal
    wherever ``want``'s top-2 margin exceeds ``margin`` of it; returns the
    largest row error, the picks that agree and those the margin decides."""
    import torch

    worst, decided, agreed = 0.0, 0, 0
    for step, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape == shape and bool(torch.isfinite(g).all()),
              f"{what} step {step} logits")
        rel = float(row_err(g, w).max())
        check(rel <= tol, f"{what} step {step}: a row of logits differs by {rel:.3e} of its "
              f"largest value, above {tol}")
        worst = max(worst, rel)
        top2 = w.topk(2, dim=-1).values
        sure = ((top2[:, 0] - top2[:, 1]) > margin * w.abs().amax(dim=-1)).cpu().numpy()
        same = got_picks[:, step] == want_picks[:, step]
        check(same[sure].all(), f"{what} step {step}: a greedy token differs where the top-2 "
              "margin exceeds the tolerance")
        decided += int(sure.sum())
        agreed += int(same.sum())
    return worst, agreed, decided


class MoeRoutes:
    """The MoE layers' top-k expert sets, recorded while open: one list of
    (B, S, K) sorted index tensors per run, one tensor per layer call, by a
    wrapper around ``blocks.moe_layer`` installed by :meth:`installed`."""

    def __init__(self):
        self.runs, self.on = [], False

    def open(self):
        self.runs.append([])
        self.on = True

    def close(self):
        self.on = False

    def installed(self):
        import contextlib

        import torch

        blocks = importlib.import_module("repro_torch.models.blocks")
        original = blocks.moe_layer

        def recording(x, p, cfg):
            if self.on:
                probs = torch.softmax(torch.matmul(x.float(), p["router"]), dim=-1)
                self.runs[-1].append(torch.topk(probs, cfg.top_k, dim=-1).indices.sort(-1).values)
            return original(x, p, cfg)

        @contextlib.contextmanager
        def patch():
            blocks.moe_layer = recording
            try:
                yield self
            finally:
                blocks.moe_layer = original

        return patch()


def attention_launches(cfg):
    """K3 launches per prefill and K4 launches per decode step of ``cfg``'s
    model: one K3 per attention layer and two K4 (split pass and merge);
    the encoder-decoder's encoder layers run K3 once, its decoder layers
    twice (self- and cross-attention) and K4 twice; xLSTM neither."""
    if cfg.is_encdec:
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers, 4 * cfg.n_dec_layers
    n_attn = cfg.n_layers if cfg.family != "ssm" else 0
    return n_attn, 2 * n_attn


def routes_held(cfg, params, shared, prompt, n_new, dev, smi, what, bf16_held=True,
                routes=None, max_seq=None, frontend=None, tag="families"):
    """Phase 13's rules on one token stream: the float32 kernel route
    against the float32 plain route (every row within 1e-4, the greedy
    tokens equal where decided), then bf16, the served config: each route's
    distance to the float32 model, the kernel route's held to BF16_SLACK
    times the plain route's unless ``bf16_held`` is false.  ``routes`` (a
    :class:`MoeRoutes`) records the bf16 routes' MoE picks.  The engines
    hold ``max_seq`` slots (prompt and new tokens when None) and get
    ``frontend`` for the modality stub (its zeros when None).  Counts the
    launches of the bf16 kernel route, the main path.  Returns (the float32
    picks, the float32 kernel route's logits, K3 launches, K4 launches)."""
    import contextlib

    import torch

    from repro_torch.serving import InferenceEngine

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    B, S = prompt.shape
    f32_cfg = cfg.replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32)

    def route(route_cfg, weights, kernel, forced=None):
        return InferenceEngine(route_cfg, weights, max_batch=B, max_seq=max_seq or S + n_new,
                               device=dev, kernel=kernel)._generate(
            prompt, n_new, forced=forced, keep_logits=True, frontend=frontend)

    @contextlib.contextmanager
    def recorded():
        if routes is not None:
            routes.open()
        yield
        if routes is not None:
            routes.close()

    picks, exact = route(f32_cfg, params, False)
    k32_picks, k32 = route(f32_cfg, params, True, picks)
    tol, shape = LOGIT_TOL["float32"], (B, cfg.vocab_size)
    f32_err, agreed, decided = logits_held(k32, k32_picks, exact, picks, tol, tol, shape,
                                           f"{tag}: {what} float32")
    print(f"{tag}: {what} float32, kernel route == plain route: prefill + {n_new - 1} "
          f"decode steps x {B} rows, max_row_rel_err={f32_err:.3e} (tol {tol}); greedy tokens "
          f"agree in {agreed} of {B * n_new}, all {decided} whose top-2 margin exceeds the "
          f"tolerance [{smi}]", flush=True)
    with recorded():
        plain_picks, plain = route(cfg, shared, False, picks)
    torch.cuda.synchronize()
    flash.flash_launches = decode.decode_launches = 0
    with recorded():
        kernel_picks, kernel = route(cfg, shared, True, picks)
    torch.cuda.synchronize()
    k3, k4 = flash.flash_launches, decode.decode_launches
    per_prefill, per_step = attention_launches(cfg)
    check(k3 == per_prefill and k4 == per_step * (n_new - 1),
          f"{tag}: {what} bf16 main path launched K3 {k3} and K4 {k4} times for one "
          f"prefill and {n_new - 1} decode steps, not {per_prefill} and {per_step} per step")
    to_f32 = [max(float(row_err(x, ref).max()) for x, ref in zip(logits, exact))
              for logits in (kernel, plain)]
    if bf16_held:
        check(to_f32[0] <= BF16_SLACK * to_f32[1],
              f"{tag}: {what} bf16 kernel route {to_f32[0]:.3e} from the float32 model, "
              f"the plain route {to_f32[1]:.3e}: more than {BF16_SLACK} times as far")
    margin = LOGIT_TOL["bfloat16"] if bf16_held else math.inf
    between, agreed, decided = logits_held(kernel, kernel_picks, plain, plain_picks, math.inf,
                                           margin, shape, f"{tag}: {what} bf16")
    rule = (f"held: kernel <= {BF16_SLACK} x plain, tokens equal where the plain top-2 margin "
            f"exceeds {margin}: {decided}" if bf16_held else "printed")
    print(f"{tag}: {what} bf16 (served): kernel route vs plain route max_row_rel_err="
          f"{between:.3e}; from the float32 model: kernel route {to_f32[0]:.3e}, plain route "
          f"{to_f32[1]:.3e} ({rule}); "
          f"greedy tokens agree in {agreed} of {B * n_new}; main path K3 launches={k3} "
          f"({k3} per prefill) K4 launches={k4} ({k4 // max(n_new - 1, 1)} per decode step) "
          f"[{smi}]", flush=True)
    return picks, k32, k3, k4


def routing_flips(served, whole, n_layers):
    """Where a served run's MoE picks (``n_layers`` prefill calls, then
    ``n_layers`` per decode step) differ from a forward's over the whole
    sequence (``n_layers`` calls): a (B, positions) bool tensor, True at
    each token whose expert set differs in any layer."""
    import torch

    L = n_layers
    steps = (len(served) - L) // L
    per_layer = [torch.cat([served[l]] + [served[L * (i + 1) + l] for i in range(steps)], dim=1)
                 for l in range(L)]
    return torch.stack([(a != b).any(-1) for a, b in zip(per_layer, whole)]).any(0)


def consistency_held(cfg, params, prompt, picks, k32, tol, what, routes=None,
                     baseline=False, frontend=None, tag="families"):
    """Prefill-then-decode == one longer forward: each of ``k32``'s logits
    (the float32 kernel route's prefill and decode steps, fed ``picks``)
    against ``logits_fn`` of the whole sequence at the same position, in
    float32; returns (the largest row distance held, rows exempted, the
    baseline or None).  The distance is checked against ``tol`` unless it
    is None.  With ``baseline`` the prefill's own distance (the forward
    over the prompt against the forward over the whole sequence: the same
    function over another length, so other product shapes) is the
    baseline, and the decode steps are held to the larger of ``tol`` and
    ``CONSISTENCY_SLACK`` times it: a float32 model whose logits move by
    more than ``tol`` when only the sequence's length changes is held to
    that, not to ``tol``.  With ``routes``
    (a :class:`MoeRoutes` whose last run holds the served run's picks) a
    row is exempted from the position of its sequence's first token whose
    expert set differs between the two (a top-k near-tie that the two
    orders of summation break apart).  ``frontend`` is the modality stub's
    input of the served run; the vlm's image tokens come before the text,
    so its positions are offset by their number."""
    import numpy as np
    import torch

    from repro_torch.models import logits_fn

    B, S = prompt.shape
    n_new = len(k32)
    f32_cfg = cfg.replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32)
    tokens = torch.as_tensor(np.concatenate([prompt, picks[:, :n_new - 1]], axis=1),
                             device=k32[0].device)
    batch = {"tokens": tokens}
    if frontend is not None:
        batch["frontend"] = frontend
    exempt = torch.zeros((B, n_new), dtype=torch.bool)
    with torch.inference_mode():
        if routes is not None:
            routes.open()
        full = logits_fn(params, f32_cfg, batch)
        if cfg.frontend == "vision_stub":
            full = full[:, frontend.shape[1]:]
        if routes is not None:
            routes.close()
            flips = routing_flips(routes.runs[-2], routes.runs[-1], cfg.n_layers).cpu()
            exempt = flips.cumsum(dim=1)[:, S - 1:] > 0
    base = float(row_err(k32[0], full[:, S - 1]).max()) if baseline else None
    dist = 0.0
    for j in range(1 if baseline else 0, n_new):
        keep = ~exempt[:, j]
        if keep.any():
            keep = keep.to(full.device)
            dist = max(dist, float(row_err(k32[j][keep], full[keep, S - 1 + j]).max()))
    if tol is not None:
        limit = tol if base is None else max(tol, CONSISTENCY_SLACK * base)
        check(dist <= limit, f"{tag}: {what}: prefill-then-decode is {dist:.3e} from the "
              f"forward over the whole sequence, above {limit:.3e}")
    del full
    return dist, int(exempt.sum()), base


def family_bench(cfg, shared, prompt, n_new, dev, smi, what, frontend=None, max_seq=None,
                 tag="families"):
    """The served bf16 engine: prefill ms (median of 3), decode-step p50/p99
    ms and tokens/s over ``n_new - 1`` steps, and under the profiler the
    device busy share and launches of one prefill and of
    ``FAMILY_PROFILE_STEPS`` decode steps.  ``frontend``: the modality
    stub's input, whose image tokens (vlm) the decode positions count."""
    import torch

    from repro_torch.serving import InferenceEngine

    B, S = prompt.shape
    engine = InferenceEngine(cfg, shared, max_batch=B, max_seq=max_seq or S + n_new, device=dev)
    batch = {"tokens": torch.as_tensor(prompt, device=dev)}
    if frontend is not None:
        batch["frontend"] = frontend
        if cfg.frontend == "vision_stub":
            S += frontend.shape[1]          # the decode steps' positions follow the image

    def prefill(cache=None):
        return engine._prefill(engine.params, batch,
                               engine_cache(engine, B, prompt.shape[1]) if cache is None
                               else cache)

    with torch.inference_mode():
        prefill_ms = []
        for _ in range(3):
            cache = engine_cache(engine, B, prompt.shape[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(cache)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        step_ms = []
        for i in range(n_new - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = engine._decode(engine.params, tok, S + i, cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms.sort()
    p50 = statistics.median(step_ms)
    p99 = step_ms[min(len(step_ms) - 1, int(0.99 * len(step_ms)))]
    pre_wall, pre_busy, pre_launches, _ = device_window(torch.inference_mode()(prefill), 1)
    with torch.inference_mode():
        logits, cache = prefill()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    n = min(FAMILY_PROFILE_STEPS, n_new - 1)

    def decode_steps():
        with torch.inference_mode():
            t = tok
            for i in range(n):
                out, _ = engine._decode(engine.params, t, S + i, cache)
                t = torch.argmax(out, dim=-1).to(torch.int32)

    dec_wall, dec_busy, dec_launches, dec_names = device_window(decode_steps, 1)
    top = sorted(dec_names.items(), key=lambda kv: -kv[1])[:3]
    print(f"{tag}: {what} bench B={B} positions={S} new={n_new}: "
          f"prefill_ms={statistics.median(prefill_ms):.3f} decode step p50_ms={p50:.3f} "
          f"p99_ms={p99:.3f} ({B / p50 * 1e3:.1f} tokens/s at p50); profiler: prefill wall "
          f"{pre_wall:.3f} ms, device busy {pre_busy:.3f} ms ({pre_busy / pre_wall:.1%}), "
          f"{pre_launches:.0f} launches; decode step wall {dec_wall / n:.3f} ms, device busy "
          f"{dec_busy / n:.3f} ms ({dec_busy / dec_wall:.1%}), {dec_launches / n:.0f} launches; "
          "most device time per step: "
          + ", ".join(f"{name[:40]} {ms / n:.4f} ms" for name, ms in top) + f" [{smi}]",
          flush=True)
    del cache, engine


def k3_timed(q, k, v, causal, what, smi, tag, window=0):
    """K3 through its wrapper on (q, k, v) (S_kv keys of its own when the
    call is full), held to its plain version at phase 9's limits, and timed
    beside its plain version, SDPA (the window as a boolean mask) and its
    bound; returns (the times, the plain output)."""
    import torch
    import torch.nn.functional as F

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    b, s_q, h, hd = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    dt = str(q.dtype).split(".")[1]

    def run():
        return flash.flash_attention(q, k, v, causal=causal, window=window, block_q=s_q,
                                     block_k=s_kv)

    def plain():
        return flash.flash_attention_plain(q, k, v, causal=causal, window=window)

    mask = None
    if window:
        i = torch.arange(s_q, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def library():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask,
                                              is_causal=causal and mask is None,
                                              enable_gqa=True)

    want = plain()
    err, rel = compare(run(), want, dt, f"{tag}: K3 {what}")
    pairs = admitted_pairs(s_q, causal, window) if s_q == s_kv else s_q * s_kv
    flops = 4 * b * h * hd * pairs
    nbytes = q.element_size() * 2 * b * hd * (s_q * h + s_kv * kvh)   # q, k, v read; out written
    bound, bound_by = attention_bound_ms(flops, nbytes, dt)
    m = dict(err=err, ms=kernel_ms(run, KERNEL_REPS, name=flash.k3_instance(q.dtype, hd)[0]),
             call=cuda_ms(run, KERNEL_REPS), plain=cuda_ms(plain, PLAIN_REPS),
             library=cuda_ms(library, KERNEL_REPS), bound=bound, bound_by=bound_by)
    print(f"{tag}: K3 {what}: B={b} S_q={s_q} S_kv={s_kv} H={h} KVH={kvh} hd={hd} "
          f"causal={causal} window={window}: close=True max_abs_err={err:.3e} "
          f"max_row_rel_err={rel:.3e} "
          "kernel_ms={ms:.4f} call_ms={call:.4f} plain_ms={plain:.4f} library_ms={library:.4f} "
          "bound_ms={bound:.4f} ({bound_by})".format(**m)
          + f" ({flops / 1e9:.2f} GFLOP, {flops / m['ms'] / 1e9:.1f} TFLOP/s; SDPA "
          f"{flops / m['library'] / 1e9:.1f}) [{smi}]", flush=True)
    return m, want


def k4_timed(q, kc, vc, lengths, what, smi, tag):
    """K4 through its wrapper over the caches at ``lengths``, held to its
    plain version and timed as :func:`k3_timed`."""
    import torch
    import torch.nn.functional as F

    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    b, h, hd = q.shape
    slots, kvh = kc.shape[1], kc.shape[2]
    dt = str(q.dtype).split(".")[1]

    def run():
        return decode.decode_attention(q, kc, vc, lengths, block_k=slots)

    mask = (torch.arange(slots, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q[:, :, None], kc.transpose(1, 2),
                                              vc.transpose(1, 2), attn_mask=mask,
                                              enable_gqa=True)

    err, rel = compare(run(), decode.decode_attention_plain(q, kc, vc, lengths), dt,
                       f"{tag}: K4 {what}")
    valid = int(lengths.clamp(0, slots).sum())
    nbytes = q.element_size() * (2 * valid * kvh * hd + 2 * b * h * hd) + 4 * b
    bound, bound_by = attention_bound_ms(4 * h * hd * valid, nbytes, dt)
    m = dict(err=err, ms=kernel_ms(run, KERNEL_REPS, name=("decode_split",
                                                            "decode_combine_kernel")),
             call=cuda_ms(run, KERNEL_REPS),
             plain=cuda_ms(lambda: decode.decode_attention_plain(q, kc, vc, lengths),
                           PLAIN_REPS),
             library=cuda_ms(library, KERNEL_REPS), bound=bound, bound_by=bound_by)
    print(f"{tag}: K4 {what}: B={b} slots={slots} lengths={sorted(set(lengths.tolist()))} "
          f"H={h} KVH={kvh} hd={hd}: close=True max_abs_err={err:.3e} max_row_rel_err={rel:.3e} "
          "kernel_ms={ms:.4f} call_ms={call:.4f} plain_ms={plain:.4f} library_ms={library:.4f} "
          "bound_ms={bound:.4f} ({bound_by})".format(**m)
          + f" ({nbytes / 1e6:.2f} MB) [{smi}]", flush=True)
    return m


def family_kernels(cfg, shared, b, s, slots, lengths, dev, smi, what, out):
    """K3 at a prefill of (b, s) and K4 over ``slots`` cache slots at
    ``lengths``, on layer 0's own projections, against their plain versions
    (bf16), timed beside their bounds, plain versions and SDPA
    (:func:`k3_timed`, :func:`k4_timed`), into ``out["times"][what]``; their
    errors raise ``out["errs"]``."""
    import numpy as np
    import torch

    from repro_torch.models import attention
    from repro_torch.models.blocks import attn_window
    from repro_torch.models.layers import apply_rope, embed_tokens, rms_norm

    cd = cfg.compute_dtype
    rng = np.random.default_rng(SEED)

    def projections(n):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, n)), device=dev)
        h = rms_norm(embed_tokens(tokens, shared["embed"], cd), shared["blocks"][0]["ln1"],
                     cfg.norm_eps)
        q, k, v = attention._qkv(h, shared["blocks"][0]["attn"], cd)
        pos = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
        return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), v

    q, k, v = projections(s)
    measured = {"K3": k3_timed(q, k, v, True, f"{what} prefill", smi, "families",
                               window=attn_window(cfg))[0]}
    q, kc, vc = projections(slots)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    measured["K4"] = k4_timed(q[:, -1].contiguous(), kc, vc, lens, f"{what} decode", smi,
                              "families")
    out["times"][what] = measured
    for kernel, m in measured.items():
        out["errs"][kernel] = max(out["errs"][kernel], m["err"])


def family_start():
    """Free what earlier models left and reset the peak; returns (bytes
    held now, the clock)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), time.perf_counter()


def family_done(what, resident, t0, tag="families"):
    import torch

    print(f"{tag}: {what}: peak device memory "
          f"{(torch.cuda.max_memory_allocated() - resident) / 1e9:.2f} GB above the "
          f"{resident / 1e9:.2f} GB held before, {time.perf_counter() - t0:.1f} s", flush=True)


def hybrid_part(smi, dev, rng, out):
    """Phase 15 (a) and (d): hymba-1.5b whole on ``HYBRID_STREAMS``, its
    bench and kernels, then ``run_cluster`` with hymba engines."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import CostModel
    from repro_torch.data import generate_sessions
    from repro_torch.serving import InferenceEngine, make_window_max_predictor, run_cluster

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    resident, t0 = family_start()
    cfg = get_config(HYBRID_ARCH)
    params, shared = family_weights(cfg, dev)
    tol = LOGIT_TOL["float32"]
    for b, s, n_new in HYBRID_STREAMS:
        what = f"{HYBRID_ARCH} B={b} prompt={s} new={n_new}"
        prompt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        picks, k32, k3, k4 = routes_held(cfg, params, shared, prompt, n_new, dev, smi, what)
        out["launches"]["K3"] += k3
        out["launches"]["K4"] += k4
        fault = s > cfg.window and s % cfg.window
        dist, _, _ = consistency_held(cfg, params, prompt, picks, k32, None if fault else tol,
                                      what)
        print(f"families: {what}: prefill-then-decode vs the forward over the whole sequence "
              f"(float32, kernel route) max_row_rel_err={dist:.3e}"
              + (" (the reference's ring fault, ROADMAP.md § 3.9: not held)" if fault
                 else f" (tol {tol})"), flush=True)
        del k32
    b, s, n_new = HYBRID_STREAMS[0]
    family_bench(cfg, shared, rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32), n_new,
                 dev, smi, HYBRID_ARCH)
    family_kernels(cfg, shared, b, s, cfg.window, (cfg.window,) * b, dev, smi, HYBRID_ARCH, out)

    costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
    trace = generate_sessions(np.random.default_rng(0), n_slots=60, mean_concurrency=4.0)

    def cluster(factory):
        return run_cluster(trace, costs, policy="A1", alpha=0.5,
                           predictor=make_window_max_predictor(trace), engine_factory=factory,
                           rng=np.random.default_rng(1))

    want = cluster(None)
    engines = []
    # the engines at full width, their depth cut: the launch counts scale with it
    cfg = cfg.replace(n_layers=HYBRID_CLUSTER_LAYERS)
    shared = dict(shared, blocks=shared["blocks"][:HYBRID_CLUSTER_LAYERS])

    def factory():
        engines.append(InferenceEngine(cfg, shared, max_batch=1, max_seq=CLUSTER_SEQ,
                                       device=dev))
        return engines[-1]

    torch.cuda.synchronize()
    flash.flash_launches = decode.decode_launches = 0
    t1 = time.perf_counter()
    got = cluster(factory)
    cluster_s = time.perf_counter() - t1
    k3, k4 = flash.flash_launches, decode.decode_launches
    sessions = len(trace.sessions)
    check(got.sessions_served == sessions, "families: cluster: a session was not served")
    check(got.tokens_generated > 0, "families: cluster generated no token")
    check((got.total_cost, got.static_cost, got.reduction, got.peak_concurrency, got.scaler)
          == (want.total_cost, want.static_cost, want.reduction, want.peak_concurrency,
              want.scaler), "families: the hymba engines changed the cluster's schedule")
    check(k3 == cfg.n_layers * sessions, f"families: cluster K3 launches {k3}")
    check(k4 == 2 * cfg.n_layers * (got.tokens_generated - sessions),
          f"families: cluster K4 launches {k4}")
    out["launches"]["K3"] += k3
    out["launches"]["K4"] += k4
    print(f"families: run_cluster A1 alpha=0.5 with {HYBRID_ARCH} engines ({cfg.n_layers} of its "
          f"32 layers; launcher defaults, {sessions} sessions, {len(engines)} engines of max_seq "
          f"{CLUSTER_SEQ}): report == "
          f"run without engines (cost={got.total_cost:.1f} static={got.static_cost:.0f} "
          f"reduction={got.reduction:.1%}); tokens_generated={got.tokens_generated} in "
          f"{cluster_s:.2f} s ({got.tokens_generated / cluster_s:.1f} tokens/s); K3 "
          f"launches={k3} K4 launches={k4} [{smi}]", flush=True)
    family_done(HYBRID_ARCH, resident, t0)


def moe_part(smi, dev, rng, out):
    """Phase 15 (b): the MoE archs at full width, depth cut."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.serving import InferenceEngine

    tol = LOGIT_TOL["float32"]
    for arch, layers in MOE_ARCHS:
        resident, t0 = family_start()
        cfg = get_config(arch).replace(n_layers=layers)
        params, shared = family_weights(cfg, dev)
        prompt = rng.integers(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT)).astype(np.int32)
        what = (f"{arch} ({layers} of {get_config(arch).n_layers} layers) B={MOE_BATCH} "
                f"prompt={MOE_PROMPT} new={MOE_NEW}")
        routes = MoeRoutes()
        with routes.installed():
            picks, _, k3, k4 = routes_held(cfg, params, shared, prompt, MOE_NEW, dev, smi,
                                           what, bf16_held=False, routes=routes)
            flips = sum(int((a != b).any(-1).sum()) for a, b in zip(*routes.runs))
            tokens = sum(a.shape[0] * a.shape[1] for a in routes.runs[0])
            print(f"families: {what} bf16: {flips} of {tokens} (layer, token) routings differ "
                  "between the kernel and the plain route (top-k sets)", flush=True)
            # prefill-then-decode against the whole forward, dropless as the
            # reference's consistency test runs MoE (capacity drops depend on
            # the group's length)
            dropless = cfg.replace(capacity_factor=float(cfg.n_experts))
            f32 = dropless.replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32)
            routes.open()
            _, k32 = InferenceEngine(f32, params, max_batch=MOE_BATCH,
                                     max_seq=MOE_PROMPT + MOE_NEW, device=dev)._generate(
                prompt, MOE_NEW, forced=picks, keep_logits=True)
            routes.close()
            dist, exempt, _ = consistency_held(dropless, params, prompt, picks, k32, tol, what,
                                               routes=routes)
            flips = int(routing_flips(routes.runs[-2], routes.runs[-1], layers).sum())
        out["launches"]["K3"] += k3
        out["launches"]["K4"] += k4
        print(f"families: {what}: prefill-then-decode vs the forward over the whole sequence "
              f"(float32, kernel route, dropless capacity) max_row_rel_err={dist:.3e} (tol "
              f"{tol}) over {MOE_BATCH * MOE_NEW - exempt} of {MOE_BATCH * MOE_NEW} rows; "
              f"{flips} tokens' expert sets differ between the two (near-ties), the "
              f"{exempt} rows from each one's first on not held", flush=True)
        del k32
        family_bench(cfg, shared, prompt, MOE_NEW, dev, smi, arch)
        if arch.startswith("llama4"):
            family_kernels(cfg, shared, MOE_BATCH, MOE_PROMPT, MOE_PROMPT + MOE_NEW,
                           (MOE_PROMPT + 1,) * MOE_BATCH, dev, smi, arch, out)
        family_done(arch, resident, t0)
        del params, shared


def xlstm_part(smi, dev, rng, out):
    """Phase 15 (c): xlstm-1.3b whole, no kernel."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import logits_fn
    from repro_torch.serving import InferenceEngine

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    tol = LOGIT_TOL["float32"]
    resident, t0 = family_start()
    cfg = get_config(XLSTM_ARCH)
    params, shared = family_weights(cfg, dev)
    prompt = rng.integers(0, cfg.vocab_size, (XLSTM_BATCH, XLSTM_PROMPT)).astype(np.int32)
    f32 = cfg.replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32)
    torch.cuda.synchronize()
    flash.flash_launches = decode.decode_launches = 0
    picks, k32 = InferenceEngine(f32, params, max_batch=XLSTM_BATCH,
                                 max_seq=XLSTM_PROMPT + XLSTM_NEW,
                                 device=dev)._generate(prompt, XLSTM_NEW, keep_logits=True)
    dist, _, base = consistency_held(cfg, params, prompt, picks, k32, tol, XLSTM_ARCH,
                                     baseline=True)
    del k32
    # the baseline by depth: the forward over the prompt against the forward
    # over the whole sequence, the first layers only
    tokens = torch.as_tensor(np.concatenate([prompt, picks[:, :-1]], axis=1), device=dev)
    by_depth = []
    for depth in XLSTM_DEPTHS:
        cut = f32.replace(n_layers=depth)
        cut_params = dict(params, blocks=params["blocks"][:depth])
        with torch.inference_mode():
            a = logits_fn(cut_params, cut, {"tokens": tokens[:, :XLSTM_PROMPT]})[:, -1]
            b = logits_fn(cut_params, cut, {"tokens": tokens})[:, XLSTM_PROMPT - 1]
        by_depth.append(f"{depth} layers {float(row_err(a, b).max()):.3e}")
    res = InferenceEngine(cfg, shared, max_batch=XLSTM_BATCH, max_seq=XLSTM_PROMPT + XLSTM_NEW,
                          device=dev).generate(prompt, XLSTM_NEW)
    check(res.tokens.shape == (XLSTM_BATCH, XLSTM_NEW), "families: xlstm generate's tokens")
    family_bench(cfg, shared, prompt, XLSTM_NEW, dev, smi, XLSTM_ARCH)
    torch.cuda.synchronize()
    check(flash.flash_launches == decode.decode_launches == 0,
          f"families: {XLSTM_ARCH} launched K3 {flash.flash_launches} and K4 "
          f"{decode.decode_launches} times")
    print(f"families: {XLSTM_ARCH} B={XLSTM_BATCH} prompt={XLSTM_PROMPT} new={XLSTM_NEW}: "
          f"K3 launches=0 K4 launches=0; prefill-then-decode vs the forward over the whole "
          f"sequence (float32): decode steps max_row_rel_err={dist:.3e}, the prefill (the "
          f"forward over {XLSTM_PROMPT} tokens against the one over "
          f"{XLSTM_PROMPT + XLSTM_NEW - 1}) {base:.3e} (held: steps <= max({tol}, "
          f"{CONSISTENCY_SLACK} x the prefill's)); the prefill's by depth: "
          + ", ".join(by_depth) + f" [{smi}]", flush=True)
    family_done(XLSTM_ARCH, resident, t0)


def families_phase(smi):
    """Phase 15: the hybrid, MoE and xLSTM families on the card — hymba-1.5b
    whole on three token streams through K3's window and K4 over its ring,
    and in ``run_cluster``; the two MoE archs at full width with their
    depth cut; xlstm-1.3b whole without a kernel.  Returns K3's and K4's
    launches on the main path, their largest errors and their times at
    hymba's and llama4-scout's serving shapes."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_phase = time.perf_counter()
    out = {"launches": {"K3": 0, "K4": 0}, "errs": {"K3": 0.0, "K4": 0.0}, "times": {}}
    rng = np.random.default_rng(SEED)
    for part in (hybrid_part, moe_part, xlstm_part):
        part(smi, torch.device("cuda"), rng, out)
    torch.cuda.empty_cache()
    print(f"families: phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


TAG = "vlm_encdec"               # phase 16's lines
VLM_ARCH = "paligemma-3b"        # phase 16 (a): the vlm family whole
# (B, prompt, new tokens, cache slots): 256 image tokens + 192 text = 448
# positions in 512 slots, nothing overflows
VLM_STREAM = (4, 192, 16, 512)
# the launcher's engines (max_batch 1, CLUSTER_SEQ slots): a prompt of 32
# after the 256 image tokens overflows the cache from the prefill on
# (ROADMAP.md § 3.10)
VLM_LAUNCHER_STREAM = (1, 32, 16)
ENCDEC_ARCH = "seamless-m4t-large-v2"   # phase 16 (b): the encoder-decoder whole
ENCDEC_STREAM = (4, 192, 16)     # B, source frames = prompt tokens, new tokens
# phase 16 (c): K3 with a key length of its own, as a bare kernel at
# seamless's heads: (name, B, S_q, S_kv, H, KVH, hd, dtype name)
CROSS_CASES = (
    ("cross 191 over 192, f32", 4, 191, 192, 16, 16, 64, "float32"),
    ("cross 191 over 192, bf16", 4, 191, 192, 16, 16, 64, "bfloat16"),
    ("cross 64 over 1000, f32", 4, 64, 1000, 16, 16, 64, "float32"),
    ("cross 64 over 1000, bf16", 4, 64, 1000, 16, 16, 64, "bfloat16"),
)


def random_qkv(gen, q_shape, kv_shape, dtype):
    """q and k at ``QK_STD``, v at 1, drawn from ``gen`` on its device."""
    import torch

    return tuple((torch.randn(*shape, generator=gen, device=gen.device) * std).to(dtype)
                 for shape, std in ((q_shape, QK_STD), (kv_shape, QK_STD), (kv_shape, 1.0)))


def loss_held(cfg, params, b, seq, dev, smi, out):
    """Phase 16 (d): ``loss_fn`` through K3 under ``no_grad`` against the
    einsum route, on one batch of the token pipeline (random frontend
    embeddings), in float32 and bf16 compute; counts the K3 launches."""
    import numpy as np
    import torch

    from repro_torch.data import make_token_batch
    from repro_torch.models import loss_fn

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    batch = make_token_batch(cfg, np.random.default_rng(SEED), b, seq, dev)
    per_prefill, _ = attention_launches(cfg)
    for dtype, tol in TRAIN_LOSS_TOL.items():
        c = cfg.replace(compute_dtype=getattr(torch, dtype), kv_cache_dtype=getattr(torch, dtype))
        with torch.no_grad():
            torch.cuda.synchronize()
            flash.flash_launches = decode.decode_launches = 0
            got = float(loss_fn(params, c, batch)[0])
            k3, k4 = flash.flash_launches, decode.decode_launches
            want = float(loss_fn(params, c, batch, kernel=False)[0])
        check(k3 == per_prefill and k4 == 0,
              f"{TAG}: {cfg.name} loss_fn launched K3 {k3} and K4 {k4} times, not "
              f"{per_prefill} and 0")
        out["launches"]["K3"] += k3
        rel = abs(got - want) / abs(want)
        check(math.isfinite(got) and rel <= tol,
              f"{TAG}: {cfg.name} {dtype} loss through K3 {got} vs the einsum route {want}: "
              f"{rel:.3e}")
        print(f"{TAG}: (d) {cfg.name} loss_fn B={b} S={seq} {dtype} compute "
              f"under no_grad: K3 launches={k3}, K4 launches={k4}; kernel route {got:.6f} vs "
              f"einsum route {want:.6f}, relative difference {rel:.3e} (tol {tol}) [{smi}]",
              flush=True)


def counted_generate(cfg, shared, prompt, n_new, max_seq, dev, smi, out, what):
    """``InferenceEngine.generate`` on the served weights with the stub's
    zeros, as the launcher runs it: its tokens' shape, and exactly
    :func:`attention_launches` per prefill and decode step."""
    import torch

    from repro_torch.serving import InferenceEngine

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    engine = InferenceEngine(cfg, shared, max_batch=prompt.shape[0], max_seq=max_seq, device=dev)
    torch.cuda.synchronize()
    flash.flash_launches = decode.decode_launches = 0
    t0 = time.perf_counter()
    res = engine.generate(prompt, n_new)
    seconds = time.perf_counter() - t0
    k3, k4 = flash.flash_launches, decode.decode_launches
    per_prefill, per_step = attention_launches(cfg)
    check(res.tokens.shape == (prompt.shape[0], n_new), f"{TAG}: {what} generate's tokens")
    check(k3 == per_prefill and k4 == per_step * (n_new - 1),
          f"{TAG}: {what} generate launched K3 {k3} and K4 {k4} times")
    out["launches"]["K3"] += k3
    out["launches"]["K4"] += k4
    print(f"{TAG}: {what} generate() with the stub's zeros (the launcher's input): "
          f"{res.tokens.size} tokens in {seconds:.2f} s; K3 launches={k3} K4 launches={k4} "
          f"({k4 // max(n_new - 1, 1)} per decode step) [{smi}]", flush=True)


def vlm_part(smi, dev, rng, out):
    """Phase 16 (a): paligemma-3b whole on one stream of 448 positions, its
    loss, the launcher's overflowing 96-slot engine, the bench and K3/K4 at
    its shapes."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    resident, t0 = family_start()
    cfg = get_config(VLM_ARCH)
    params, shared = family_weights(cfg, dev, tag=TAG)
    nf, tol = cfg.n_frontend_tokens, LOGIT_TOL["float32"]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def images(b):
        """Random image embeddings, bf16 (the stub's type): a wrong position
        or a dropped image token shows in them, as it would not in zeros."""
        return torch.randn((b, nf, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)

    b, s, n_new, slots = VLM_STREAM
    prompt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    image = images(b)
    what = f"{VLM_ARCH} B={b} image={nf} prompt={s} new={n_new} slots={slots}"
    picks, k32, k3, k4 = routes_held(cfg, params, shared, prompt, n_new, dev, smi, what,
                                     max_seq=slots, frontend=image, tag=TAG)
    out["launches"]["K3"] += k3
    out["launches"]["K4"] += k4
    dist, _, _ = consistency_held(cfg, params, prompt, picks, k32, tol, what, frontend=image,
                                  tag=TAG)
    print(f"{TAG}: {what}: prefill-then-decode vs the forward over the whole sequence "
          f"(float32, kernel route) max_row_rel_err={dist:.3e} (tol {tol})", flush=True)
    del k32
    lb, ls, ln = VLM_LAUNCHER_STREAM
    lprompt = rng.integers(0, cfg.vocab_size, (lb, ls)).astype(np.int32)
    limage = images(lb)
    lwhat = (f"{VLM_ARCH} launcher engine B={lb} image={nf} prompt={ls} new={ln} "
             f"slots={CLUSTER_SEQ} (overflowing, ROADMAP.md § 3.10)")
    picks, k32, k3, k4 = routes_held(cfg, params, shared, lprompt, ln, dev, smi, lwhat,
                                     max_seq=CLUSTER_SEQ, frontend=limage, tag=TAG)
    out["launches"]["K3"] += k3
    out["launches"]["K4"] += k4
    dist, _, _ = consistency_held(cfg, params, lprompt, picks, k32, None, lwhat,
                                  frontend=limage, tag=TAG)
    print(f"{TAG}: {lwhat}: prefill-then-decode vs the forward over the whole sequence "
          f"(float32, kernel route) max_row_rel_err={dist:.3e} (the reference's fault: not "
          "held)", flush=True)
    del k32
    counted_generate(cfg, shared, lprompt, ln, CLUSTER_SEQ, dev, smi, out, lwhat)
    loss_held(cfg, params, b, nf + s, dev, smi, out)
    family_bench(cfg, shared, prompt, n_new, dev, smi, VLM_ARCH,
                 frontend=torch.zeros_like(image), max_seq=slots, tag=TAG)
    kgen = torch.Generator(device=dev).manual_seed(SEED)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = random_qkv(kgen, (b, nf + s, H, hd), (b, nf + s, KVH, hd), torch.bfloat16)
    k3m, _ = k3_timed(q, k, v, True, f"{VLM_ARCH} prefill", smi, TAG)
    q, kc, vc = random_qkv(kgen, (b, H, hd), (b, slots, KVH, hd), torch.bfloat16)
    lengths = torch.full((b,), nf + s + 1, dtype=torch.int32, device=dev)
    k4m = k4_timed(q, kc, vc, lengths, f"{VLM_ARCH} decode", smi, TAG)
    out["times"][VLM_ARCH] = {"K3": k3m, "K4": k4m}
    for kernel, m in (("K3", k3m), ("K4", k4m)):
        out["errs"][kernel] = max(out["errs"][kernel], m["err"])
    family_done(VLM_ARCH, resident, t0, tag=TAG)


def encdec_part(smi, dev, rng, out):
    """Phase 16 (b): seamless-m4t-large-v2 whole on one stream of 192
    frames and prompt tokens, prefill-then-decode with S - 1 tokens over S
    frames, ``generate`` with zero frames, its loss, the bench and K3/K4 at
    its shapes."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.serving import InferenceEngine

    resident, t0 = family_start()
    cfg = get_config(ENCDEC_ARCH)
    params, shared = family_weights(cfg, dev, tag=TAG)
    tol = LOGIT_TOL["float32"]
    b, s, n_new = ENCDEC_STREAM
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    frames = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    prompt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    what = f"{ENCDEC_ARCH} B={b} frames={s} prompt={s} new={n_new}"
    _, k32, k3, k4 = routes_held(cfg, params, shared, prompt, n_new, dev, smi, what,
                                 frontend=frames, tag=TAG)
    out["launches"]["K3"] += k3
    out["launches"]["K4"] += k4
    del k32
    # prefill-then-decode: S - 1 tokens over S frames, so that every prefill's
    # cross-attention runs K3 at S_q != S_kv inside the model
    f32 = cfg.replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32)
    short = prompt[:, :-1]
    picks, k32 = InferenceEngine(f32, params, max_batch=b, max_seq=s - 1 + n_new,
                                 device=dev)._generate(short, n_new, keep_logits=True,
                                                       frontend=frames)
    swhat = f"{ENCDEC_ARCH} B={b} frames={s} prompt={s - 1} new={n_new}"
    dist, _, _ = consistency_held(cfg, params, short, picks, k32, tol, swhat, frontend=frames,
                                  tag=TAG)
    print(f"{TAG}: {swhat}: prefill-then-decode vs the forward over the whole sequence "
          f"(float32, kernel route: K3 at S_q {s - 1} over S_kv {s} in every cross-attention) "
          f"max_row_rel_err={dist:.3e} (tol {tol})", flush=True)
    del k32
    counted_generate(cfg, shared, prompt, n_new, s + n_new, dev, smi, out, what)
    loss_held(cfg, params, b, s, dev, smi, out)
    family_bench(cfg, shared, prompt, n_new, dev, smi, ENCDEC_ARCH,
                 frontend=torch.zeros_like(frames), tag=TAG)
    kgen = torch.Generator(device=dev).manual_seed(SEED)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    times = {}
    for name, causal in (("encoder", False), ("decoder self-attention", True)):
        q, k, v = random_qkv(kgen, (b, s, H, hd), (b, s, KVH, hd), torch.bfloat16)
        times[f"K3 {name}"], _ = k3_timed(q, k, v, causal, f"{ENCDEC_ARCH} {name} prefill",
                                          smi, TAG)
    for name, slots, length in (("self cache", s + n_new, s + 1), ("cross cache", s, s)):
        q, kc, vc = random_qkv(kgen, (b, H, hd), (b, slots, KVH, hd), torch.bfloat16)
        lengths = torch.full((b,), length, dtype=torch.int32, device=dev)
        times[f"K4 {name}"] = k4_timed(q, kc, vc, lengths, f"{ENCDEC_ARCH} decode, {name}",
                                       smi, TAG)
    out["times"][ENCDEC_ARCH] = times
    for name, m in times.items():
        kernel = name[:2]
        out["errs"][kernel] = max(out["errs"][kernel], m["err"])
    family_done(ENCDEC_ARCH, resident, t0, tag=TAG)


def cross_part(smi, dev, out):
    """Phase 16 (c): K3 at S_q != S_kv as a bare kernel: each case held to
    its plain version, a planted fault rejected (zeros; the keys past S_q
    dropped, what a kernel bounded by S_q would compute), timed; and a
    causal call at unequal lengths refused without a launch."""
    import torch

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    times = {}
    for name, b, s_q, s_kv, h, kvh, hd, dt in CROSS_CASES:
        q, k, v = random_qkv(gen, (b, s_q, h, hd), (b, s_kv, kvh, hd), getattr(torch, dt))
        m, want = k3_timed(q, k, v, False, name, smi, TAG)
        for fault, bad in (("zeros", torch.zeros_like(want)),
                           (f"keys past {s_q} dropped", flash.flash_attention_plain(
                               q, k[:, :s_q], v[:, :s_q], causal=False))):
            try:
                compare(bad, want, dt, f"{TAG}: K3 {name} planted {fault}")
            except SmokeFailure:
                print(f"{TAG}: K3 {name}: planted fault rejected: {fault} "
                      f"({float(row_err(bad, want).max()):.2e})", flush=True)
                continue
            raise SmokeFailure(f"{TAG}: K3 {name}: the check passed a planted fault ({fault})")
        times[name] = m
        out["errs"]["K3"] = max(out["errs"]["K3"], m["err"])
        before = flash.flash_launches
        try:
            flash.flash_attention(q, k, v, causal=True)
        except ValueError as e:
            check(flash.flash_launches == before, f"{TAG}: a refused call launched K3")
            refused = str(e)
        else:
            raise SmokeFailure(f"{TAG}: K3 took a causal call at S_q {s_q} != S_kv {s_kv}")
    print(f"{TAG}: K3 refuses a causal call at unequal lengths without a launch: "
          f"ValueError({refused[:80]}...)", flush=True)
    out["times"]["cross"] = times


def vlm_encdec_phase(smi):
    """Phase 16: the vlm family and the encoder-decoder on the card —
    paligemma-3b and seamless-m4t-large-v2 whole, K3 at S_q != S_kv and
    the losses through K3.  Returns K3's and K4's launches on the main
    path, their largest errors and their times at the two models' shapes."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_phase = time.perf_counter()
    out = {"launches": {"K3": 0, "K4": 0}, "errs": {"K3": 0.0, "K4": 0.0}, "times": {}}
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    cross_part(smi, dev, out)
    vlm_part(smi, dev, rng, out)
    encdec_part(smi, dev, rng, out)
    torch.cuda.empty_cache()
    print(f"{TAG}: phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


MESH_WORLD = 4                   # phase 17 (b): four processes on the one card, over gloo
MESH_LEVELS = 4099               # phase 17 (b): a fleet that does not divide by the world
MESH_SCALE = 1.6                 # (b): demand scaled past the cap (peak about 7,600), so pad lanes would show
MESH_POLICIES = ("A1", "A2", "A3", "delayedoff", "AQ-det", "AQ-rand")     # (a)
MESH_POLICIES_B = ("A1", "A3", "AQ-rand")                                 # (b)
MESH_NOISE = (0.0, 0.25)         # (a): the noise sweep, S = 2
# (b): a typed fleet of three groups of uneven sizes, Δ 2.5, 3.0 and 2.5:
# (servers, P, beta_on, beta_off); 4099 servers in all
MESH_GROUPS = ((1000, 1.0, 1.25, 1.25), (1500, 2.0, 3.0, 3.0), (1599, 1.5, 2.0, 1.75))
MESH_REPS = 5                    # (e): timed calls per route, the same number on every rank
MESH_LEAVES = ("x", "level_cost", "cost", "energy", "toggle_cost", "group_cost")


def mesh_cases(part, dev):
    """Phase 17's cases of part ``"a"`` (phase 4's smoke fleet) or ``"b"`` (the
    fleet of ``MESH_LEVELS`` over scaled demand, untyped and typed), as the
    case dicts of :func:`run_specs`.  Every
    call builds the specs anew, each keyed one with a fresh generator from
    ``SEED``: a rank and the single-device runs then draw the same numbers,
    and a generator serves one call."""
    import numpy as np
    import torch

    from repro_torch import (
        PAPER_COSTS,
        CostModel,
        PolicySpec,
        PredictionNoise,
        ProvisionSpec,
        ServerGroup,
        Workload,
        msr_like_trace,
    )

    demand = np.stack([
        msr_like_trace(np.random.default_rng(SEED + b), n_slots=N_SLOTS,
                       mean_jobs=N_LEVELS / 4.0)
        for b in range(N_TRACES)
    ])
    ab = torch.as_tensor(demand, device=dev).to(torch.int32)

    def spec(policy, costs=PAPER_COSTS, a=ab, n=N_LEVELS, noise=None):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return ProvisionSpec(
            costs=costs,
            workload=Workload(demand=a, noise=None if noise is None else PredictionNoise(
                std_frac=list(noise),
                generator=torch.Generator(device=dev).manual_seed(SEED + 1))),
            policy=PolicySpec(policy, windows=WINDOWS, generator=gen),
            n_levels=n, device=dev,
        )

    cases = []
    if part == "a":
        for p in MESH_POLICIES:
            cases += [dict(name=p, spec=spec(p)), dict(name=f"{p}/stream", spec=spec(p), stream=True)]
        cases += [
            dict(name="A2/noise", spec=spec("A2", noise=MESH_NOISE)),
            dict(name="A2/noise/stream", spec=spec("A2", noise=MESH_NOISE), stream=True),
            dict(name="A1/record", spec=spec("A1"), record_decisions=True),
            dict(name="AQ-rand/record/stream", spec=spec("AQ-rand"), stream=True,
                 record_decisions=True),
        ]
        return cases
    scaled = torch.round(ab.to(torch.float32) * MESH_SCALE).to(torch.int32)
    typed = CostModel.from_groups(*[
        ServerGroup(f"g{i}", n, P=P, beta_on=bon, beta_off=boff)
        for i, (n, P, bon, boff) in enumerate(MESH_GROUPS)])
    for fleet, costs in (("N4099", PAPER_COSTS), ("typed", typed)):
        for p in MESH_POLICIES_B:
            cases += [dict(name=f"{fleet}/{p}", spec=spec(p, costs, scaled, MESH_LEVELS)),
                      dict(name=f"{fleet}/{p}/stream", spec=spec(p, costs, scaled, MESH_LEVELS),
                           stream=True)]
    return cases


#: the result fields a rank returns for each case (``decision_counts`` too, when filled)
RESULT_FIELDS = ("x", "cost", "energy", "toggle_cost", "level_cost", "group_cost",
                 "backlog", "max_delay", "p99_delay", "deadline_misses", "unserved")


def run_specs(mesh, cases):
    """Each case's spec once with ``mesh=mesh``, through ``provision`` or
    (``stream``) ``provision_stream``: ``{name: {field: tensor, ...,
    "decisions", "decision_counts", "launches": {"K1": n, "K2": n}}}``, the
    launches being this rank's kernel launches in that call."""
    import dataclasses

    from repro_torch import provision, provision_stream
    from repro_torch.kernels import provision_scan as kernels

    out = {}
    for case in cases:
        spec = dataclasses.replace(case["spec"], mesh=mesh)
        record = bool(case.get("record_decisions", False))
        k1, k2 = kernels.launches, kernels.stream_launches
        res = (provision_stream(spec, record_decisions=record) if case.get("stream")
               else provision(spec, record_decisions=record))
        row = {f: getattr(res, f) for f in RESULT_FIELDS + ("decisions", "decision_counts")}
        row["launches"] = {"K1": kernels.launches - k1, "K2": kernels.stream_launches - k2}
        out[case["name"]] = row
    return out


def mesh_timed_spec(part, dev):
    """The spec of (e)'s timings: A1 on part ``part``'s fleet."""
    name = "A1" if part == "a" else "N4099/A1"
    return next(c for c in mesh_cases(part, dev) if c["name"] == name)["spec"]


def rank_times(fn, group, reps):
    """This rank's wall ms per ``fn()`` call (median of ``reps``, each call
    between a barrier and a sync), K2's CUPTI ms per call (mean over
    ``reps`` calls under the profiler; None when it kept no record), the
    number of K2 records, and the three host operations of most self time
    under the profiler, with their ms per call.  Every rank makes the same
    calls: each is a collective."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(reps):
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and "stream_scan_kernel" in e.key]
    kept = sum(e.count for e in events)
    k2 = sum(e.self_device_time_total for e in events) / 1e3 / kept if kept else None
    host = sorted(averages, key=lambda e: e.self_cpu_time_total, reverse=True)[:3]
    top = ", ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / reps:.2f}" for e in host)
    return statistics.median(walls), k2, kept, top


def collective_ms(group, n_levels, reps):
    """This rank's wall ms (median of ``reps``, between a barrier and a
    sync) of the mesh route's two collectives alone, on tensors of the
    shapes an A1 call at the smoke grid gives them: x summed (1, W, B, T)
    int32 and the three level terms gathered (3, 1, W, B, lanes) float32."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import torch_provision as engine

    size = dist.get_world_size(group)
    lanes = engine._group_layout(n_levels, None, size)[2] // size
    x = torch.ones((1, len(WINDOWS), N_TRACES, N_SLOTS), dtype=torch.int32, device="cuda")
    terms = torch.ones((3, 1, len(WINDOWS), N_TRACES, lanes), device="cuda")
    walls = []
    for _ in range(reps + 1):                # the first call is a warm-up
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._sum_ranks(x, group)
        engine._gather_levels(terms, group, size)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls[1:])


def mesh_rank(mesh, part):
    """One rank of phase 17 (a :func:`repro_torch.distributed.world.run_world`
    target): part ``part``'s cases on ``mesh`` with this rank's launches per
    call; in (a) ``FleetProvisioner(mesh=)``'s ``plan_sweep``, in (b) the
    planted faults; then (e)'s times."""
    import dataclasses
    import unittest.mock

    import torch
    import torch.distributed as dist

    from repro_torch import PAPER_COSTS, provision, provision_stream
    from repro_torch.kernels import provision_scan as kernels
    from repro_torch.serving import FleetProvisioner

    dev = torch.device("cuda")
    out = {"cases": run_specs(mesh, mesh_cases(part, dev)), "rank": dist.get_rank()}
    if part == "a":
        ab = mesh_cases("a", dev)[0]["spec"].workload.demand
        planner = FleetProvisioner(PAPER_COSTS, policy="A1", max_replicas=N_LEVELS, mesh=mesh,
                                   device=dev)
        k2 = kernels.stream_launches
        out["plan_sweep"] = planner.plan_sweep(torch.clamp(ab, max=N_LEVELS), WINDOWS)
        out["plan_sweep_launches"] = kernels.stream_launches - k2
    else:
        unmasked_from = kernels.provision_scan_stream

        def unmasked(*args, routes, n_levels, **kw):
            # planted: pad lanes routed past the fleet and counted (no lane mask)
            routes = torch.where(routes >= n_levels, n_levels, routes)
            return unmasked_from(*args, routes=routes, n_levels=2**31 - 1, **kw)

        gather_from = dist.all_gather

        def reversed_gather(parts, *args, **kw):
            # planted: the ranks' level blocks gathered in reverse order
            work = gather_from(parts, *args, **kw)
            parts.reverse()
            return work

        faults = {}
        with unittest.mock.patch.object(kernels, "provision_scan_stream", unmasked):
            spec = next(c for c in mesh_cases("b", dev) if c["name"] == "N4099/A1")["spec"]
            faults["pad lanes unmasked"] = provision_stream(dataclasses.replace(spec, mesh=mesh))
        with unittest.mock.patch.object(dist, "all_gather", reversed_gather):
            spec = next(c for c in mesh_cases("b", dev) if c["name"] == "typed/A1")["spec"]
            faults["blocks gathered in reverse"] = provision_stream(
                dataclasses.replace(spec, mesh=mesh))
        out["faults"] = {k: {f: getattr(v, f) for f in MESH_LEAVES} for k, v in faults.items()}
    spec = dataclasses.replace(mesh_timed_spec(part, dev), mesh=mesh)
    out["wall_ms"], out["k2_ms"], out["k2_kept"], out["host_top"] = rank_times(
        lambda: provision(spec), mesh.get_group("data"), MESH_REPS)
    out["comm_ms"] = collective_ms(mesh.get_group("data"), spec.n_levels, MESH_REPS)
    return out


def mesh_phase(smi):
    """Phase 17: the multi-device route.  (a) phase 4's fleet in a world of
    one over NCCL, (b) a fleet of ``MESH_LEVELS`` (untyped and typed) in a
    world of ``MESH_WORLD`` processes on the one card over gloo, each case
    through ``provision(mesh=)`` or ``provision_stream(mesh=)``: every
    rank's every leaf equal to the single-device kernel route's and the
    plain route's, one K2 launch and no K1 launch per rank and call; (c) the
    eval CLI's mesh smoke and ``FleetProvisioner(mesh=).plan_sweep``; (d)
    the planted faults rejected; (e) times; (f) with several cards, (b)
    over NCCL with a card for each rank.  Returns K2's launches on the
    mesh route (every rank's)."""
    import torch

    from repro_torch import PAPER_COSTS, provision, provision_stream
    from repro_torch.distributed.world import run_world
    from repro_torch.eval.__main__ import mesh_smoke
    from repro_torch.serving import FleetProvisioner

    provision_module = importlib.import_module("repro_torch.core.provision")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    def leaves(res):
        return {f: getattr(res, f) for f in MESH_LEAVES}

    def differs(got, want):
        """The first leaf (or decision counter) where ``got`` differs from ``want``, or None."""
        for f in MESH_LEAVES:
            g, w = got[f], want[f]
            if (g is None) != (w is None) or (w is not None and not torch.equal(g.cpu(), w.cpu())):
                return f
        gc, wc = got.get("decision_counts"), want.get("decision_counts")
        if (gc is None) != (wc is None):
            return "decision_counts"
        for k in (wc or {}):
            if not torch.equal(gc[k].cpu(), wc[k].cpu()):
                return f"decision_counts[{k}]"
        return None

    # the single-device kernel route and the plain route of every case (one
    # plain run serves a case and its stream twin: they share the spec)
    single, plain = {}, {}
    for part in "ab":
        for case, twin in zip(mesh_cases(part, dev), mesh_cases(part, dev)):
            name, record = case["name"], case.get("record_decisions", False)
            if case.get("stream"):
                res = provision_stream(case["spec"], record_decisions=record)
            else:
                res = provision(case["spec"], record_decisions=record)
            single[name] = dict(leaves(res), decision_counts=res.decision_counts)
            base = name.replace("/stream", "")
            if base not in plain:
                ref = provision_module._provision(twin["spec"], record_decisions=record,
                                                  kernel=False)
                plain[base] = dict(leaves(ref), decision_counts=ref.decision_counts)
            plain[name] = plain[base]
            where = differs(single[name], plain[name])
            check(where is None, f"mesh: {name}: the single-device kernel route differs from "
                  f"the plain route at {where}")
    torch.cuda.synchronize()
    t_refs = time.perf_counter() - t_phase

    def single_ms(part):
        spec = mesh_timed_spec(part, dev)
        provision(spec)
        walls = []
        for _ in range(MESH_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            provision(spec)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    single_wall = {part: single_ms(part) for part in "ab"}

    # (label, cases, world, backend); (f) only where there are several cards
    runs = [("a", "a", 1, "nccl"), ("b", "b", MESH_WORLD, "gloo")]
    cards = torch.cuda.device_count()
    if cards > 1:
        runs.append(("f", "b", cards, "nccl"))
    worlds, fleet = {}, {}
    for label, part, world, backend in runs:
        t0 = time.perf_counter()
        worlds[label] = run_world("chip_smoke:mesh_rank", world, device="cuda", backend=backend,
                                  payload=part, timeout=240)
        fleet[label] = part
        where = "one card" if backend == "gloo" or world == 1 else "a card each"
        print(f"mesh: ({label}) a world of {world} over {backend} on {where}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = 0
    for part, ranks in worlds.items():
        for out in ranks:
            for name, got in out["cases"].items():
                where = differs(got, single[name])
                check(where is None, f"mesh: ({part}) rank {out['rank']} {name}: {where} "
                      "differs from the single-device kernel route")
                check(differs(got, plain[name]) is None,
                      f"mesh: ({part}) rank {out['rank']} {name}: differs from the plain route")
                check(got["decisions"] is None, f"mesh: {name}: per-slot decisions on the mesh route")
                check(got["launches"] == {"K1": 0, "K2": 1},
                      f"mesh: ({part}) rank {out['rank']} {name}: launches {got['launches']}, "
                      "expected one K2 launch and no K1 launch")
                launches += got["launches"]["K2"]
            for other in ranks:
                for name, got in other["cases"].items():
                    check(differs(got, out["cases"][name]) is None,
                          f"mesh: ({part}) ranks {out['rank']} and {other['rank']} differ on {name}")
        print(f"mesh: ({part}) {len(ranks[0]['cases'])} cases on each of {len(ranks)} rank(s): "
              "x, level_cost, cost, energy, toggle_cost, group_cost and decision_counts equal "
              "the single-device kernel route and the plain route; one K2 launch and no K1 "
              "launch per rank and call", flush=True)

    # (c) FleetProvisioner(mesh=) and the eval CLI's mesh smoke
    a_out = worlds["a"][0]
    ab = mesh_cases("a", dev)[0]["spec"].workload.demand
    want = FleetProvisioner(PAPER_COSTS, policy="A1", max_replicas=N_LEVELS,
                            device=dev).plan_sweep(torch.clamp(ab, max=N_LEVELS), WINDOWS)
    check((a_out["plan_sweep"] == want).all() and a_out["plan_sweep_launches"] == 1,
          "mesh: FleetProvisioner(mesh=).plan_sweep differs from the planner without a mesh "
          f"(or launched K2 {a_out['plan_sweep_launches']} times, expected 1)")
    launches += a_out["plan_sweep_launches"]
    smoke = mesh_smoke("cuda")
    launches += smoke["launches"]
    print(f"mesh: (c) FleetProvisioner(mesh=).plan_sweep == the planner without a mesh "
          f"({tuple(want.shape)}); the eval's mesh smoke: cells equal, "
          f"{smoke['launches']} K2 launch for its one block", flush=True)

    # (d) the planted faults must be rejected by the checks above
    for label in (k for k in worlds if fleet[k] == "b"):
        for out in worlds[label]:
            for fault, got in out["faults"].items():
                want = single["N4099/A1/stream" if "pad" in fault else "typed/A1/stream"]
                check(differs(dict(got, decision_counts=None), dict(want, decision_counts=None))
                      is not None,
                      f"mesh: ({label}) planted fault ({fault}) not rejected on rank {out['rank']}")
        print(f"mesh: (d) planted faults rejected on every rank of ({label}): "
              + ", ".join(worlds[label][0]["faults"]), flush=True)

    # (e) times, printed, not held
    for part, ranks in worlds.items():
        k2 = ", ".join("not measured" if o["k2_ms"] is None else
                       "%.4f (%d records)" % (o["k2_ms"], o["k2_kept"]) for o in ranks)
        walls = ", ".join("%.2f" % o["wall_ms"] for o in ranks)
        comms = ", ".join("%.2f" % o["comm_ms"] for o in ranks)
        print(f"mesh: (e) {smi}: A1 at the ({fleet[part]}) fleet: the mesh route in ({part}), "
              f"a world of {len(ranks)}, {statistics.median(o['wall_ms'] for o in ranks):.2f} ms "
              f"wall (ranks {walls}), the single-device route {single_wall[fleet[part]]:.2f} ms; K2 "
              f"CUPTI ms per call by rank: {k2}; the two collectives alone, ms by rank: {comms}; "
              f"rank 0's host operations of most self ms per call: {ranks[0]['host_top']}",
              flush=True)
    print(f"mesh: phase 17 took {time.perf_counter() - t_phase:.1f} s (the single-device "
          f"references {t_refs:.1f} s)", flush=True)
    return launches


ELASTIC_ARCH = "llama3.2-1b"     # phase 18 (b): restored whole at full width, float32
ELASTIC_WORLD = 4                # (b): four processes on the one card, over gloo
ELASTIC_AXES = ("data", "model")
ELASTIC_MESHES = ((2, 2), (4, 1))   # (b): the meshes it is restored onto, in this order
ELASTIC_STEP = 7
# (a): the production meshes, planned from their shape alone, and the specs on each
RULE_MESHES = {"16x16": ({"data": 16, "model": 16}, ("train", "serving", "fsdp_only")),
               "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("train", "serving"))}
RULE_MODES = {"train": {}, "serving": {"serving": True}, "fsdp_only": {"fsdp_only": True}}
# (b): llama3.2-1b's training layout on a ("data", "model") mesh by leaf (the
# reference's rules for this model written out: each matrix's every dim
# divides by 4), held against what ``reshard_restore`` places on every rank
ELASTIC_LAYOUT = {
    "embed": ("model", "data"), "final_ln": (), "ln1": (), "ln2": (),
    "attn/wq": ("data", "model", None), "attn/wk": ("data", "model", None),
    "attn/wv": ("data", "model", None), "attn/wo": ("model", None, "data"),
    "mlp/wi": ("data", "model"), "mlp/wg": ("data", "model"), "mlp/wo": ("model", "data"),
}


def rules_part(smi):
    """Phase 18 (a): the sharding rules at full width on the production
    meshes, from the shapes alone: every sharded dim divides by its axes,
    and each leaf's per-device bytes times its number of distinct shards sum
    to the whole parameter bytes.  Prints the per-device GB (planning
    figures, not times)."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.distributed.sharding import param_specs, to_placements
    from repro_torch.models import abstract_params
    from repro_torch.utils.tree import tree_leaves

    for arch in list_archs():
        tree = abstract_params(get_config(arch))
        params = tree_leaves(tree)
        check(all(x.is_meta for x in params), f"sharding: {arch}: abstract_params allocated")
        whole = sum(x.numel() * x.element_size() for x in params)
        per_device = {}
        for mesh_name, (sizes, modes) in RULE_MESHES.items():
            for mode in modes:
                specs = tree_leaves(param_specs(tree, sizes, **RULE_MODES[mode]))
                resident = shards_bytes = 0
                for x, spec in zip(params, specs):
                    to_placements(spec, sizes)
                    local, shards = list(x.shape), 1
                    for d, part in enumerate(spec):
                        axes = () if part is None else part if isinstance(part, tuple) else (part,)
                        n = math.prod(sizes[a] for a in axes)
                        check(x.shape[d] % n == 0, f"sharding: {arch} {mesh_name} {mode}: "
                              f"dim {d} of {tuple(x.shape)} does not divide by {axes}")
                        local[d] //= n
                        shards *= n
                    nbytes = math.prod(local) * x.element_size()
                    resident += nbytes
                    shards_bytes += nbytes * shards
                check(shards_bytes == whole, f"sharding: {arch} {mesh_name} {mode}: the shards "
                      f"hold {shards_bytes} bytes of {whole}")
                per_device[f"{mesh_name} {mode}"] = resident / 1e9
        print(f"sharding: (a) {arch}: {whole / 1e9:.3f} GB of float32 parameters, "
              f"{len(params)} leaves; per device (GB, a plan): "
              + ", ".join(f"{k} {v:.4f}" for k, v in per_device.items()), flush=True)


def elastic_held(tree, directory, mesh, step=ELASTIC_STEP):
    """The leaves of ``tree`` where this rank's block differs from the saved
    array's: the placements must be ``ELASTIC_LAYOUT``'s on ``mesh`` and
    ``to_local()`` equal, bit for bit, to the block at this rank's mesh
    coordinate, cut from the file with ``torch.chunk`` (no rule code)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.utils.tree import tree_leaves, tree_paths

    folder = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(folder, "manifest.json")) as f:
        saved = json.load(f)["paths"]
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    bad = []
    for i, (path, leaf) in enumerate(zip(tree_paths(tree), tree_leaves(tree))):
        spec = ELASTIC_LAYOUT["/".join(p for p in path.split("/")[-2:] if not p.isdigit())]
        want = tuple(Shard(spec.index(n)) if n in spec else Replicate() for n in names)
        block = torch.from_numpy(np.load(os.path.join(folder, f"arr_{i}.npy"), mmap_mode="c"))
        for m, (axis, c) in enumerate(zip(names, coord)):
            if axis in spec:
                block = torch.chunk(block, mesh.size(m), dim=spec.index(axis))[c]
        local = leaf.to_local()
        if (saved[i] != path or tuple(leaf.placements) != want or local.shape != block.shape
                or not torch.equal(local.view(torch.int32),
                                   block.to(local.device).view(torch.int32))):
            bad.append(path)
    return bad


def elastic_rank(mesh, payload):
    """One rank of phase 18 (b) or (c) (a ``run_world`` target on a (2, 2)
    mesh): ``reshard_restore`` of the saved model onto each of
    ``ELASTIC_MESHES``, timed and checked; in (b) the two planted faults;
    in (c) a save of the (2, 2)-sharded tree, restored onto (4, 1)."""
    import unittest.mock

    import torch
    import torch.distributed as dist
    import torch.distributed.tensor  # noqa: F401  (loaded before the timed restores)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.distributed.elastic import reshard_restore
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.models import abstract_params
    from repro_torch.utils.tree import tree_leaves

    out = {"rank": dist.get_rank(), "start_s": time.time() - payload["t0"], "restores": {},
           "faults": {}}
    like = abstract_params(get_config(ELASTIC_ARCH))
    meshes = {ELASTIC_MESHES[0]: mesh,
              ELASTIC_MESHES[1]: init_device_mesh("cuda", ELASTIC_MESHES[1],
                                                  mesh_dim_names=ELASTIC_AXES)}
    torch.zeros(1, device="cuda")                   # the card's context, before the timed restores
    torch.cuda.synchronize()
    whole = os.path.join(payload["dir"], "whole")

    def timed_restore(m):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = reshard_restore(whole, ELASTIC_STEP, like, m)
        torch.cuda.synchronize()
        return tree, time.perf_counter() - t0

    for shape, m in meshes.items():
        tree, wall = timed_restore(m)
        if shape == ELASTIC_MESHES[0]:            # once more, warm: the first pays for first use
            del tree
            tree, out["again_s"] = timed_restore(m)
        t1 = time.perf_counter()
        out["restores"][shape] = {
            "wall_s": wall, "bad": elastic_held(tree, whole, m),
            "check_s": time.perf_counter() - t1,
            "resident": sum(x.to_local().numel() * x.to_local().element_size()
                            for x in tree_leaves(tree)),
            "coord": tuple(m.get_coordinate())}
        if shape == ELASTIC_MESHES[0]:
            placed = tree
        del tree
    if payload["save_to"] is None:
        # the planted faults, on layer 0's checkpoint (the same rules and checks)
        layer_dir, layer = os.path.join(payload["dir"], "layer"), like["blocks"][0]
        # planted: wq's two sharded dims swapped in its placements
        shardings = param_shardings(layer, mesh)
        shardings["attn"]["wq"] = (mesh, tuple(reversed(shardings["attn"]["wq"].placements)))
        swapped = restore(layer_dir, ELASTIC_STEP, layer, shardings=shardings)
        out["faults"]["wq dims swapped"] = elastic_held(swapped, layer_dir, mesh)
        # planted: this rank given the next rank's blocks
        after = (dist.get_rank() + 1) % ELASTIC_WORLD
        other = [after // ELASTIC_MESHES[0][1], after % ELASTIC_MESHES[0][1]]
        with unittest.mock.patch.object(mesh, "get_coordinate", return_value=other):
            moved = reshard_restore(layer_dir, ELASTIC_STEP, layer, mesh)
        out["faults"]["another rank's block"] = elastic_held(moved, layer_dir, mesh)
        # the unplanted layer restore passes the same check
        out["faults"]["none"] = elastic_held(reshard_restore(layer_dir, ELASTIC_STEP, layer, mesh),
                                             layer_dir, mesh)
    else:
        # (c): save the (2, 2)-sharded tree (each leaf gathered over NCCL),
        # restore it onto (4, 1) and hold it to the first checkpoint
        save(payload["save_to"], ELASTIC_STEP, placed)
        again = reshard_restore(payload["save_to"], ELASTIC_STEP, like,
                                meshes[ELASTIC_MESHES[1]])
        out["resaved_bad"] = elastic_held(again, whole, meshes[ELASTIC_MESHES[1]])
    return out


def elastic_phase(smi):
    """Phase 18: the sharding rules and elastic restore.  (a) the rules on
    the production meshes for all ten archs; (b) llama3.2-1b at full width
    saved once unsharded and restored by ``reshard_restore`` onto (2, 2)
    and (4, 1) in a world of ``ELASTIC_WORLD`` processes on the one card
    over gloo, every rank holding exactly its blocks, two planted faults
    rejected; (c) with four cards or more, the same over NCCL with a card
    per rank, plus a save of the sharded tree restored onto (4, 1)."""
    import shutil

    import torch

    from repro_torch.checkpoint import save
    from repro_torch.configs import get_config
    from repro_torch.distributed.world import run_world
    from repro_torch.models import init_params, param_count

    t_phase = time.perf_counter()
    rules_part(smi)
    t_rules = time.perf_counter() - t_phase
    dev = torch.device("cuda")
    work = os.path.join(ROOT, "build", "chip_smoke_elastic")
    shutil.rmtree(work, ignore_errors=True)
    try:
        cfg = get_config(ELASTIC_ARCH)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        save(os.path.join(work, "whole"), ELASTIC_STEP, params)
        save(os.path.join(work, "layer"), ELASTIC_STEP, params["blocks"][0])
        whole = 4 * param_count(cfg)
        del params
        torch.cuda.empty_cache()
        print(f"sharding: (b) {ELASTIC_ARCH} full width, {param_count(cfg):,} parameters, "
              f"{whole / 1e9:.3f} GB in float32, drawn on the card and saved unsharded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        runs = [("b", "gloo", None)]
        if torch.cuda.device_count() >= ELASTIC_WORLD:
            runs.append(("c", "nccl", os.path.join(work, "resaved")))
        for label, backend, save_to in runs:
            t0 = time.perf_counter()
            ranks = run_world("chip_smoke:elastic_rank", ELASTIC_WORLD, device="cuda",
                              backend=backend, timeout=240, mesh_shape=ELASTIC_MESHES[0],
                              mesh_dim_names=ELASTIC_AXES,
                              payload={"dir": work, "save_to": save_to, "t0": time.time()})
            world_s = time.perf_counter() - t0
            for shape in ELASTIC_MESHES:
                for out in ranks:
                    got = out["restores"][shape]
                    check(not got["bad"], f"sharding: ({label}) rank {out['rank']} on {shape}: "
                          f"blocks differ from the saved arrays at {got['bad'][:3]}")
                check(sum(o["restores"][shape]["resident"] for o in ranks)
                      >= whole, f"sharding: ({label}) {shape}: the ranks hold less than the model")
                print(f"sharding: ({label}) {smi}: reshard_restore onto {shape} "
                      f"{ELASTIC_AXES} over {backend}, {len(ranks)} ranks: every leaf's "
                      "placements and block equal to the saved array's at the rank's "
                      "coordinate, bit for bit; resident GB by rank "
                      + ", ".join(f"{o['restores'][shape]['resident'] / 1e9:.4f}" for o in ranks)
                      + f" of {whole / 1e9:.4f}; wall s by rank "
                      + ", ".join(f"{o['restores'][shape]['wall_s']:.3f}" for o in ranks)
                      + ("" if shape != ELASTIC_MESHES[0] else " (again, warm: "
                         + ", ".join(f"{o['again_s']:.3f}" for o in ranks) + ")")
                      + "; the check's s by rank "
                      + ", ".join(f"{o['restores'][shape]['check_s']:.3f}" for o in ranks),
                      flush=True)
            if save_to is None:
                faults = [f for f in ranks[0]["faults"] if f != "none"]
                check(not any(o["faults"]["none"] for o in ranks),
                      f"sharding: ({label}) layer 0's restore differs from its checkpoint")
                for fault in faults:
                    check(any(o["faults"][fault] for o in ranks),
                          f"sharding: ({label}) planted fault ({fault}) not rejected")
                print(f"sharding: ({label}) planted faults rejected: " + ", ".join(
                    f"{fault} (on {sum(bool(o['faults'][fault]) for o in ranks)} ranks)"
                    for fault in faults), flush=True)
            else:
                for out in ranks:
                    check(not out["resaved_bad"], f"sharding: ({label}) rank {out['rank']}: "
                          f"the resaved tree differs at {out['resaved_bad'][:3]}")
                print(f"sharding: ({label}) the (2, 2)-sharded tree saved (gathered over "
                      f"{backend}) and restored onto {ELASTIC_MESHES[1]}: equal on every rank",
                      flush=True)
            print(f"sharding: ({label}) the world of {len(ranks)} over {backend} took "
                  f"{world_s:.1f} s, its ranks started in "
                  + ", ".join(f"{o['start_s']:.1f}" for o in ranks) + " s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"sharding: phase 18 took {time.perf_counter() - t_phase:.1f} s (the rules "
          f"{t_rules:.1f} s)", flush=True)


# ---------------------------------------------------------------------------
# Phase 19: the step builders, the dry-run and the sharded steps
# ---------------------------------------------------------------------------

STEPS_ARCH = "llama3.2-1b"       # phase 19 (b), (c): full width and depth, random from SEED
# (e): hymba-1.5b at full width and depth on the same mesh: its 25 query and 5
# KV heads do not divide "model", so attention takes the sequence layout and K3
# runs with the window on each rank's batch rows; its 50 SSM heads do
STEPS_HYBRID = "hymba-1.5b"
STEPS_WORLD, STEPS_MESH, STEPS_AXES = 4, (2, 2), ("data", "model")
STEPS_NEW = 9                    # (b), (e): the prefill's token and 8 decode steps
# per model: the serving stream's (batch, prompt, cache slots) and the float32
# training's (batch, sequence, steps); llama3.2-1b's stream is phase 13's,
# hymba-1.5b's prompt is past its 2048-token window and even, so that its ring
# wraps (K4 over the valid slots gathered to the front, ROADMAP.md § 3.9) and
# the sequence splits over "model"
STEPS_MODELS = {STEPS_ARCH: ((SERVE_BATCH, SERVE_PROMPT, SERVE_SEQ), (4, 128, 2)),
                STEPS_HYBRID: ((2, 2304, 2304 + STEPS_NEW), (2, 128, 1))}
STEPS_TRAIN_TOL = 1e-4           # (b): the loss and every parameter after step 1, relative
STEPS_NOISE_EPS = 100            # (b): clipped gradients below this many AdamW eps are not held
STEPS_CKPT = 3
# (a): the dry-run's cells on the card's host, (arch, shape, multi-pod)
DRYRUN_CELLS = (("llama3.2-1b", "decode_32k", False), ("llama3.2-1b", "prefill_32k", False),
                ("llama3.2-1b", "train_4k", False), ("llama3.2-1b", "train_4k", True),
                ("command-r-plus-104b", "decode_32k", False),
                ("hymba-1.5b", "decode_32k", False), ("hymba-1.5b", "long_500k", False),
                ("hymba-1.5b", "train_4k", False), ("xlstm-1.3b", "decode_32k", False),
                ("xlstm-1.3b", "long_500k", False))

# (c): the three steps traced on a fake world of four at (2, 2) on the card's
# host (a "cuda" mesh, as the real world's), in a subprocess
STEPS_TRACE = """
import dataclasses, json, sys
sys.path.insert(0, "src")
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch.dryrun import StepCounters, argument_bytes, collective_counts, fake_world
from repro_torch.launch import steps
out = {}
with fake_world(WORLD):
    mesh = init_device_mesh("cuda", MESH, mesh_dim_names=AXES)
    for arch, ((B, PROMPT, SLOTS), (TRAIN_B, TRAIN_S, _)) in MODELS.items():
        cfg = get_config(arch).replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32,
                                       remat="none")
        serve = ShapeCell("serve", SLOTS, B, "prefill")
        prompt = torch.empty((B, PROMPT), dtype=torch.int32, device="meta")
        bundles = {
            "prefill": steps.build_prefill_step(cfg, mesh, serve, kernel=False),
            "decode": steps.build_decode_step(cfg, mesh, dataclasses.replace(serve, kind="decode"),
                                              kernel=False),
            "train": steps.build_train_step(cfg, mesh, ShapeCell("train", TRAIN_S, TRAIN_B,
                                                                 "train")),
        }
        b = bundles["prefill"]
        bundles["prefill"] = dataclasses.replace(
            b, abstract_args=(b.abstract_args[0], {"tokens": prompt}, b.abstract_args[2]))
        out[arch] = {}
        for name, b in bundles.items():
            c = StepCounters()
            steps.lower_step(b, mesh, cur_len=PROMPT, observe=lambda args: (c.exclude(args), c)[1])
            out[arch][name] = {"argument": argument_bytes(b),
                               "collectives": collective_counts(c.records)}
print(json.dumps(out))
"""


def dryrun_part(smi):
    """Phase 19 (a): the dry-run's cells traced on the card's host (a fake
    group of 256 or 512 ranks in this process, meta tensors): per cell the
    per-device argument and temp GB, the FLOPs, the collective bytes by
    kind, the three roofline terms with the H100 constants, the wall s."""
    import pathlib
    import tempfile

    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import analyse

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as out_dir:
        for arch, shape, multi_pod in DRYRUN_CELLS:
            t0 = time.perf_counter()
            rep = run_cell(arch, shape, multi_pod, pathlib.Path(out_dir))
            wall = time.perf_counter() - t0
            a, mem = analyse(rep), rep["bytes_per_device"]
            check(rep["hlo_flops_per_device"] > 0 and mem["argument"] > 0,
                  f"dryrun: {arch} x {shape}: an empty trace")
            print(f"dryrun: (a) {arch} x {shape} x {rep['mesh']}: argument "
                  f"{mem['argument'] / 1e9:.4f} GB, temp {mem['temp'] / 1e9:.4f} GB, output "
                  f"{mem['output'] / 1e9:.4f} GB per device; {rep['hlo_flops_per_device']:.4e} "
                  f"FLOPs per device; collectives per device "
                  + (", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in
                               sorted(rep["collective_bytes_per_device"].items())) or "none")
                  + f"; roofline (H100 constants): compute {a['compute_s']:.5f} s, memory "
                  f"{a['memory_s']:.5f} s, collective {a['collective_s']:.5f} s, {a['dominant']}"
                  f"-bound, useful {a['useful_frac']:.2f}; traced in {wall:.1f} s on the host",
                  flush=True)


def steps_cfg(dtype, arch=STEPS_ARCH):
    """Phase 19's model: float32 compute (and cache) or the served bf16; no
    remat (no backward pass pays for one)."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(remat="none")
    if dtype == "float32":
        cfg = cfg.replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32)
    return cfg


def steps_stream(arch=STEPS_ARCH):
    """The model's serving prompts from SEED (llama3.2-1b's: phase 13's
    stream)."""
    import numpy as np

    (b, s, _), _ = STEPS_MODELS[arch]
    vocab = steps_cfg("float32", arch).vocab_size
    return np.random.default_rng(SEED).integers(0, vocab, (b, s), dtype=np.int32)


def steps_train_batch(arch=STEPS_ARCH):
    import numpy as np

    _, (b, s, _) = STEPS_MODELS[arch]
    vocab = steps_cfg("float32", arch).vocab_size
    return np.random.default_rng(SEED + 1).integers(0, vocab, (b, s), dtype=np.int32)


def steps_reference(work, dev, arch=STEPS_ARCH):
    """Phase 19's single-device results for ``arch``, computed before the
    world starts and freed: the float32 plain route's picks and logits over
    the stream, the bf16 plain route's distance to them, the float32 train
    steps' losses, and the weights and the parameters and gradients after
    step 1 saved under ``work/arch``."""
    import torch

    from repro_torch.checkpoint import save
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import AdamWConfig, adamw_update, global_norm, init_adamw
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving.engine import serving_params
    from repro_torch.utils.tree import tree_leaves

    folder = os.path.join(work, arch)
    (b, _, slots), (_, _, n_train) = STEPS_MODELS[arch]
    f32, bf16 = steps_cfg("float32", arch), steps_cfg("bfloat16", arch)
    params = init_params(f32, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    save(os.path.join(folder, "weights"), STEPS_CKPT, params)
    prompt = steps_stream(arch)
    picks, exact = InferenceEngine(f32, params, max_batch=b, max_seq=slots, device=dev,
                                   kernel=False)._generate(prompt, STEPS_NEW, keep_logits=True)
    _, plain = InferenceEngine(bf16, serving_params(params, bf16, dev), max_batch=b,
                               max_seq=slots, device=dev, kernel=False)._generate(
        prompt, STEPS_NEW, forced=picks, keep_logits=True)
    plain_to_f32 = max(float(row_err(x, ref).max()) for x, ref in zip(plain, exact))
    out = {"picks": picks, "exact": [x.cpu() for x in exact], "plain_to_f32": plain_to_f32}
    del plain, exact
    batch = {"tokens": torch.as_tensor(steps_train_batch(arch), device=dev)}
    state, losses = init_adamw(params), []
    leaves = tree_leaves(params)
    for step in range(n_train):
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = loss_fn(params, f32, batch, kernel=False)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        adamw_update(list(grads), state, params, AdamWConfig())
        losses.append(float(loss))
        if step == 0:
            save(os.path.join(folder, "step1"), STEPS_CKPT, params)
            save(os.path.join(folder, "grads1"), STEPS_CKPT, list(grads))
            out_clip = min(1.0, AdamWConfig().clip_norm / float(global_norm(list(grads))))
        del grads, loss
    out["losses"], out["clip"] = losses, out_clip
    del params, state, batch, leaves
    torch.cuda.empty_cache()
    return out


def _resident(args) -> int:
    from repro_torch.distributed.ctx import is_dtensor
    from repro_torch.utils.tree import tree_leaves

    total = 0
    for x in tree_leaves(args):
        local = x.to_local() if is_dtensor(x) else x
        total += local.numel() * local.element_size()
    return total


def steps_sync():
    """Phase 19: wait for this rank's card, then for every rank."""
    import torch
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()


def steps_whole(mesh, x):
    """The ``DTensor`` ``x`` gathered whole on every rank (over gloo its
    collectives through the host)."""
    from repro_torch.distributed.world import host_collectives

    with host_collectives(mesh):
        return x.full_tensor()


def sharded_serve(mesh, cfg, weights, prompt, picks, slots, kernel, n_new, out, counters=None,
                  timed=False):
    """Phase 19: the prefill of ``prompt`` and ``n_new - 1`` decode steps fed
    ``picks`` through the step builders on ``mesh`` (``slots`` cache slots),
    the weights placed as the prefill step's shardings; returns the gathered
    logits of each (on every rank).  ``counters`` ({"prefill", "decode"}
    :class:`StepCounters`) count the prefill and the first decode step,
    whose resident bytes go to ``out["resident"]``; ``timed``: wall ms per
    rank between a barrier and a sync in ``out["times"]``."""
    import contextlib
    import dataclasses
    import statistics as stats

    import torch

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps
    from repro_torch.models import init_cache

    dev = prompt.device
    b, s = prompt.shape
    cell = ShapeCell("serve", slots, b, "prefill")
    prefill = steps.build_prefill_step(cfg, mesh, cell, kernel=kernel)
    decode = steps.build_decode_step(cfg, mesh, dataclasses.replace(cell, kind="decode"),
                                     kernel=kernel)
    params, batch, cache = steps.place(
        (weights, {"tokens": prompt}, init_cache(cfg, b, slots, device=dev)),
        prefill.in_shardings)
    if counters is not None:
        out["resident"]["prefill"] = _resident((params, batch, cache))
    steps_sync()
    t0 = time.perf_counter()
    with counters["prefill"] if counters else contextlib.nullcontext():
        logits, cache = prefill.fn(params, batch, cache)
    steps_sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    seen, step_ms = [steps_whole(mesh, logits)], []
    for i in range(n_new - 1):
        token, cur_len = steps.place(
            (picks[:, i], torch.tensor(s + i, dtype=torch.int32, device=dev)),
            decode.in_shardings[1:3])
        if counters is not None and i == 0:
            out["resident"]["decode"] = _resident((params, token, cur_len, cache))
        steps_sync()
        t0 = time.perf_counter()
        with counters["decode"] if counters and i == 0 else contextlib.nullcontext():
            logits, cache = decode.fn(params, token, cur_len, cache)
        steps_sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        seen.append(steps_whole(mesh, logits))
    if timed:
        out["times"].update(prefill_ms=prefill_ms, decode_p50_ms=stats.median(step_ms),
                            decode_p99_ms=sorted(step_ms)[min(len(step_ms) - 1, int(
                                0.99 * len(step_ms)))])
    return seen


def steps_rank(mesh, payload):
    """One rank of phase 19 (b) (a ``run_world`` target on a (2, 2) mesh):
    the weights restored onto this rank's blocks, the serving steps on the
    stream (float32 kernel and plain routes, bf16 kernel route: the main
    path, counted and timed), two float32 train steps, the planted faults;
    what the checks need comes back (rank 0 also the gathered logits)."""
    import unittest.mock

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.launch.dryrun import StepCounters, collective_counts
    from repro_torch.models import attention
    from repro_torch.serving.engine import serving_params

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode_mod = importlib.import_module("repro_torch.kernels.decode_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    out = {"rank": rank, "start_s": time.time() - payload["t0"], "times": {}, "faults": {},
           "collectives": {}, "resident": {}, "launches": {}}
    work = os.path.join(payload["dir"], STEPS_ARCH)
    picks = torch.as_tensor(payload["picks"], device=dev)
    prompt = torch.as_tensor(steps_stream(), device=dev)
    f32, bf16 = steps_cfg("float32"), steps_cfg("bfloat16")

    def whole(x):
        return steps_whole(mesh, x)

    def serve(cfg, weights, kernel, n_new=STEPS_NEW, counters=None, timed=False):
        return sharded_serve(mesh, cfg, weights, prompt, picks, SERVE_SEQ, kernel, n_new, out,
                             counters, timed)

    weights = steps_weights(mesh, STEPS_ARCH, work, out)

    # float32, kernel route, with its collectives and resident bytes
    kernel_counts = {"prefill": StepCounters(), "decode": StepCounters()}
    k32 = serve(f32, weights, True, counters=kernel_counts)
    out["collectives"]["kernel"] = {k: collective_counts(c.records)
                                    for k, c in kernel_counts.items()}
    # float32, plain route: the collectives (c) holds to the trace
    plain_counts = {"prefill": StepCounters(), "decode": StepCounters()}
    p32 = serve(f32, weights, False, n_new=2, counters=plain_counts)
    out["collectives"]["plain"] = {k: collective_counts(c.records) for k, c in plain_counts.items()}
    # bf16, kernel route: the main path, counted and timed
    shared = serving_params(weights, bf16, dev)
    flash.flash_launches = decode_mod.decode_launches = 0
    kb = serve(bf16, shared, True, timed=True)
    out["launches"] = {"K3": flash.flash_launches, "K4": decode_mod.decode_launches}
    del shared
    if rank == 0:
        out["logits"] = {"k32": [x.cpu() for x in k32], "p32": [x.cpu() for x in p32],
                         "kb": [x.cpu() for x in kb]}

    # planted: this rank's block of layer 0's wq swapped with its neighbour's on "model"
    wq = weights["blocks"][0]["attn"]["wq"]
    model_dim = mesh.mesh_dim_names.index("model")
    n, c = mesh.size(model_dim), mesh.get_coordinate()[model_dim]
    full_wq = whole(wq)
    spec = wq.placements[model_dim]
    swapped = dict(weights)
    swapped["blocks"] = list(weights["blocks"])
    swapped["blocks"][0] = {**weights["blocks"][0],
                            "attn": {**weights["blocks"][0]["attn"],
                                     "wq": type(wq).from_local(
                                         full_wq.chunk(n, dim=spec.dim)[(c + 1) % n].contiguous(),
                                         mesh, wq.placements, run_check=False)}}
    bad = serve(f32, swapped, True, n_new=1)
    out["faults"]["wq block swapped"] = float(row_err(bad[0], k32[0]).max())
    del swapped, full_wq, bad
    # planted: K4 given the next model rank's kv heads
    original = attention._kernel_kv

    def shifted(kc, vc, placements):
        every = tuple(Replicate() if p.is_shard(2) else p for p in placements)
        lk, lv = original(kc, vc, every)
        return (lk.chunk(n, dim=2)[(c + 1) % n].contiguous(),
                lv.chunk(n, dim=2)[(c + 1) % n].contiguous())

    with unittest.mock.patch.object(attention, "_kernel_kv", shifted):
        bad = serve(f32, weights, True, n_new=2)
    out["faults"]["K4 given another rank's kv heads"] = float(row_err(bad[1], k32[1]).max())
    del weights, bad, k32, p32, kb
    torch.cuda.empty_cache()

    sharded_train(mesh, STEPS_ARCH, work, payload["clip"], out)
    return out


def steps_weights(mesh, arch, work, out):
    """Phase 19: ``arch``'s float32 weights restored onto this rank's blocks
    of the serving layout (the checkpointer's sharded restore, no
    collective), timed."""
    from repro_torch.checkpoint import restore
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps
    from repro_torch.models import abstract_params

    (b, _, slots), _ = STEPS_MODELS[arch]
    f32 = steps_cfg("float32", arch)
    t0 = time.perf_counter()
    probe = steps.build_prefill_step(f32, mesh, ShapeCell("serve", slots, b, "prefill"))
    weights = restore(os.path.join(work, "weights"), STEPS_CKPT, abstract_params(f32),
                      shardings=probe.in_shardings[0])
    out["times"]["restore_s"] = time.perf_counter() - t0
    return weights


def sharded_train(mesh, arch, work, clip, out):
    """Phase 19: ``arch``'s float32 train steps (``STEPS_MODELS``) from its
    saved weights in the training layout, timed, the first counted; the
    losses, and on rank 0 the parameters after step 1 held to the saved
    single-device update (:func:`steps_params_held`)."""
    import contextlib

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeCell
    from repro_torch.distributed.elastic import reshard_restore
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import StepCounters, collective_counts
    from repro_torch.models import abstract_params
    from repro_torch.optim import init_adamw
    from repro_torch.utils.tree import tree_leaves, tree_paths

    dev = torch.device("cuda", torch.cuda.current_device())
    _, (b, s, n_steps) = STEPS_MODELS[arch]
    f32 = steps_cfg("float32", arch)
    train = steps.build_train_step(f32, mesh, ShapeCell("train", s, b, "train"))
    params = reshard_restore(os.path.join(work, "weights"), STEPS_CKPT, abstract_params(f32), mesh)
    batch = {"tokens": torch.as_tensor(steps_train_batch(arch), device=dev)}
    params, state, batch = steps.place((params, init_adamw(params), batch), train.in_shardings)
    out["resident"]["train"] = _resident((params, state, batch))
    losses, step_ms, counts = [], [], StepCounters()
    for step in range(n_steps):
        steps_sync()
        t0 = time.perf_counter()
        with counts if step == 0 else contextlib.nullcontext():
            params, state, metrics = train.fn(params, state, batch)
        steps_sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"].to_local()))
        if step == 0:          # each leaf gathered in turn; rank 0 holds it to the saved update
            gathered = ((path, steps_whole(mesh, leaf))
                        for path, leaf in zip(tree_paths(params), tree_leaves(params)))
            if dist.get_rank() == 0:
                out["train_param_err"] = steps_params_held(gathered, work, dev, clip)
            else:
                for _ in gathered:
                    pass
    out["collectives"]["train"] = collective_counts(counts.records)
    out["losses"] = losses
    out["times"]["train_ms"] = step_ms
    del params, state, batch
    torch.cuda.empty_cache()


def hybrid_rank(mesh, payload):
    """One rank of phase 19 (e): hymba-1.5b's weights restored onto this
    rank's blocks, the serving steps on its stream (float32 kernel route,
    float32 plain route with its collectives, bf16 kernel route: the main
    path, counted and timed), the two planted faults, one float32 train
    step."""
    import unittest.mock

    import torch
    import torch.distributed as dist

    from repro_torch.launch.dryrun import StepCounters, collective_counts
    from repro_torch.models import attention
    from repro_torch.serving.engine import serving_params

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode_mod = importlib.import_module("repro_torch.kernels.decode_attention")
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    out = {"rank": rank, "times": {}, "faults": {}, "collectives": {}, "resident": {},
           "launches": {}}
    work = os.path.join(payload["dir"], STEPS_HYBRID)
    picks = torch.as_tensor(payload["picks"], device=dev)
    prompt = torch.as_tensor(steps_stream(STEPS_HYBRID), device=dev)
    (_, _, slots), _ = STEPS_MODELS[STEPS_HYBRID]
    f32, bf16 = steps_cfg("float32", STEPS_HYBRID), steps_cfg("bfloat16", STEPS_HYBRID)

    def serve(cfg, weights, kernel, n_new=STEPS_NEW, counters=None, timed=False):
        return sharded_serve(mesh, cfg, weights, prompt, picks, slots, kernel, n_new, out,
                             counters, timed)

    weights = steps_weights(mesh, STEPS_HYBRID, work, out)
    k32 = serve(f32, weights, True)
    plain_counts = {"prefill": StepCounters(), "decode": StepCounters()}
    p32 = serve(f32, weights, False, n_new=2, counters=plain_counts)
    out["collectives"]["plain"] = {k: collective_counts(c.records) for k, c in plain_counts.items()}
    shared = serving_params(weights, bf16, dev)
    flash.flash_launches = decode_mod.decode_launches = 0
    kb = serve(bf16, shared, True, timed=True)
    out["launches"] = {"K3": flash.flash_launches, "K4": decode_mod.decode_launches}
    del shared
    if rank == 0:
        out["logits"] = {"k32": [x.cpu() for x in k32], "p32": [x.cpu() for x in p32],
                         "kb": [x.cpu() for x in kb]}
    # planted: K3 called on every rank without the layer's window
    real_k3 = attention.ops.flash_attention

    def windowless(q, k, v, **kw):
        return real_k3(q, k, v, **dict(kw, window=0))

    with unittest.mock.patch.object(attention.ops, "flash_attention", windowless):
        bad = serve(f32, weights, True, n_new=1)
    out["faults"]["K3 without its window"] = float(row_err(bad[0], k32[0]).max())
    # planted: K4 reading the ring's first n slots, the valid ones not gathered
    with unittest.mock.patch.object(attention, "_ring_slots",
                                    lambda kc, vc, mask: (kc, vc, int(mask.sum()))):
        bad = serve(f32, weights, True, n_new=2)
    out["faults"]["K4 over the ring's first slots"] = float(row_err(bad[1], k32[1]).max())
    del weights, bad, k32, p32, kb
    torch.cuda.empty_cache()
    sharded_train(mesh, STEPS_HYBRID, work, payload["clip"], out)
    return out


def steps_world(mesh, payload):
    """Phase 19's ``run_world`` target: llama3.2-1b's part (b), then
    hymba-1.5b's (e), on each rank."""
    import torch

    got = {STEPS_ARCH: steps_rank(mesh, dict(payload[STEPS_ARCH], dir=payload["dir"],
                                             t0=payload["t0"]))}
    torch.cuda.empty_cache()
    got[STEPS_HYBRID] = hybrid_rank(mesh, dict(payload[STEPS_HYBRID], dir=payload["dir"]))
    return got


def steps_params_held(got, work, dev, clip):
    """Phase 19 (b): each parameter after the sharded step 1 against the
    single-device update, within STEPS_TRAIN_TOL of the leaf's largest
    value, except the elements whose clipped single-device gradient (``clip``
    times it, AdamW's clipping) is nonzero and below STEPS_NOISE_EPS times
    AdamW's epsilon: the first step's update lr * g / (|g| + eps) maps a difference
    in such a g — the rounding of sums the ranks split, about 1e-5 of a
    leaf's typical gradient — to up to lr / eps times it, so those are
    counted and their worst difference printed, not held.  ``got`` yields
    (path, gathered leaf) pairs, taken one at a time, in the order of the
    saved leaves.  Returns (the worst held error, exempt elements, their
    worst error, all elements)."""
    import numpy as np
    import torch

    from repro_torch.optim import AdamWConfig

    eps = STEPS_NOISE_EPS * AdamWConfig().eps / clip
    folders = [os.path.join(work, name, f"step_{STEPS_CKPT:08d}") for name in ("step1", "grads1")]
    worst = free_worst = 0.0
    exempt = total = 0
    for i, (path, g) in enumerate(got):
        want, grad = (torch.from_numpy(np.load(os.path.join(f, f"arr_{i}.npy"), mmap_mode="c"))
                      .to(dev) for f in folders)
        scale = max(float(want.abs().max()), 1e-30)
        err = (g - want).abs() / scale
        tiny = (grad.abs() < eps) & (grad != 0)
        held = float(err[~tiny].max()) if bool((~tiny).any()) else 0.0
        if held > STEPS_TRAIN_TOL:
            at = int(torch.where(tiny, torch.zeros_like(err), err).argmax())
            flat = [x.reshape(-1)[at].item() for x in (g, want, grad)]
            check(False, f"steps: {path} after step 1 differs from the single-device update by "
                  f"{held:.3e} of its largest value {scale:.3e} in "
                  f"{int(((err > STEPS_TRAIN_TOL) & ~tiny).sum())} of {err.numel()} elements; "
                  f"worst: sharded {flat[0]:.6e}, single device {flat[1]:.6e}, its gradient "
                  f"{flat[2]:.3e}; gradients |g| median {float(grad.abs().median()):.3e}")
        worst = max(worst, held)
        exempt += int(tiny.sum())
        total += tiny.numel()
        if bool(tiny.any()):
            free_worst = max(free_worst, float(err[tiny].max()))
    return worst, exempt, free_worst, total


def steps_phase(smi):
    """Phase 19: the step builders.  (a) the dry-run's cells on the card's
    host; (b) llama3.2-1b's prefill, decode and train steps sharded over
    (2, 2) in four processes on the one card over gloo, every rank's
    weights restored onto its blocks, held to the single-device routes,
    K3 and K4 on each rank's heads, two planted faults, wall times; (e)
    hymba-1.5b's in the same world, K3 with its window and K4 over its ring
    on each rank's batch rows; (c) the same steps traced on a fake world of
    four: the resident bytes and the plain route's collectives equal the
    trace's; (d) with four cards, (b) and (e) over NCCL.  Returns the K3 and
    K4 launches of the main path (rank 0's, the bf16 kernel routes)."""
    import shutil

    import torch

    from repro_torch.distributed.world import run_world
    from repro_torch.models import param_count

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    work = os.path.join(ROOT, "build", "chip_smoke_steps")
    shutil.rmtree(work, ignore_errors=True)
    launches = {"K3": 0, "K4": 0}
    refs = {}
    try:
        for arch, label in ((STEPS_ARCH, "b"), (STEPS_HYBRID, "e")):
            t0 = time.perf_counter()
            refs[arch] = steps_reference(work, dev, arch)
            n_train = STEPS_MODELS[arch][1][2]
            print(f"steps: ({label}) {arch} full width and depth, "
                  f"{param_count(steps_cfg('float32', arch)):,} parameters, random from seed "
                  f"{SEED}, saved; the single-device routes and {n_train} train step(s) in "
                  f"{time.perf_counter() - t0:.1f} s (losses "
                  + ", ".join(f"{x:.6f}" for x in refs[arch]["losses"]) + ")", flush=True)
        # (c)'s trace, in a subprocess while nothing else runs
        t0 = time.perf_counter()
        script = (f"WORLD, MESH, AXES = {STEPS_WORLD}, {STEPS_MESH!r}, {STEPS_AXES!r}\n"
                  f"MODELS = {STEPS_MODELS!r}\n" + STEPS_TRACE)
        proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                              cwd=ROOT, timeout=600)
        check(proc.returncode == 0, f"steps: (c) the trace failed: {proc.stderr[-3000:]}")
        traced = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"steps: (c) the three steps of both models traced on a fake world of "
              f"{STEPS_WORLD} at {STEPS_MESH} in {time.perf_counter() - t0:.1f} s", flush=True)

        runs = [("b", "gloo")]
        if torch.cuda.device_count() >= STEPS_WORLD:
            runs.append(("d", "nccl"))
        for label, backend in runs:
            t0 = time.perf_counter()
            payload = {arch: {"picks": ref["picks"], "clip": ref["clip"]}
                       for arch, ref in refs.items()}
            ranks = run_world("chip_smoke:steps_world", STEPS_WORLD, device="cuda",
                              backend=backend, timeout=900, mesh_shape=STEPS_MESH,
                              mesh_dim_names=STEPS_AXES,
                              payload=dict(payload, dir=work, t0=time.time()))
            world_s = time.perf_counter() - t0
            for arch, part in ((STEPS_ARCH, label), (STEPS_HYBRID, "e" if label == "b" else label)):
                got = [o[arch] for o in ranks]
                steps_held(part, backend, arch, got, refs[arch], traced[arch], smi)
                if label == "b":
                    for k in launches:
                        launches[k] += got[0]["launches"][k]
            print(f"steps: ({label}) the world of {STEPS_WORLD} over {backend} took "
                  f"{world_s:.1f} s, its ranks started in "
                  + ", ".join(f"{o[STEPS_ARCH]['start_s']:.1f}" for o in ranks)
                  + " s; restore s by rank, " + "; ".join(
                      f"{arch}: " + ", ".join(f"{o[arch]['times']['restore_s']:.2f}"
                                              for o in ranks) for arch in refs), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dryrun_part(smi)
    print(f"steps: phase 19 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def steps_held(label, backend, arch, ranks, ref, traced, smi):
    """Phase 19's checks on one model's results from one world (see
    :func:`steps_phase`)."""
    import torch

    cfg = steps_cfg("float32", arch)
    (b, prompt, slots), (train_b, train_s, _) = STEPS_MODELS[arch]
    shape = (b, cfg.vocab_size)
    exact, picks = ref["exact"], ref["picks"]
    got = ranks[0]["logits"]
    tol = LOGIT_TOL["float32"]
    k32_picks = torch.stack([x.argmax(-1) for x in got["k32"]], 1).numpy()
    err, agreed, decided = logits_held(got["k32"], k32_picks, exact, picks, tol, tol, shape,
                                       f"steps: ({label}) {arch} float32 kernel route on "
                                       f"{STEPS_MESH}")
    p32_picks = torch.stack([x.argmax(-1) for x in got["p32"]], 1).numpy()
    perr, _, _ = logits_held(got["p32"], p32_picks, exact[:2], picks[:, :2], tol, tol, shape,
                             f"steps: ({label}) {arch} float32 plain route on {STEPS_MESH}")
    kb_to_f32 = max(float(row_err(x, w).max()) for x, w in zip(got["kb"], exact))
    check(kb_to_f32 <= BF16_SLACK * ref["plain_to_f32"],
          f"steps: ({label}) {arch} bf16 kernel route on {STEPS_MESH} {kb_to_f32:.3e} from the "
          f"float32 model, the single-device plain route {ref['plain_to_f32']:.3e}")
    print(f"steps: ({label}) {arch} on {STEPS_MESH} {STEPS_AXES} over {backend}, "
          f"{len(ranks)} ranks, B={b} prompt={prompt} slots={slots}: float32 kernel route == the "
          f"single-device plain route, prefill + {STEPS_NEW - 1} decode steps, "
          f"max_row_rel_err={err:.3e} (tol {tol}), greedy tokens agree in {agreed} of "
          f"{b * STEPS_NEW}, all {decided} decided; float32 plain route (prefill + 1 step) "
          f"{perr:.3e}; bf16 kernel route {kb_to_f32:.3e} from the float32 model, the "
          f"single-device bf16 plain route {ref['plain_to_f32']:.3e} (held: <= {BF16_SLACK} x) "
          f"[{smi}]", flush=True)
    per_prefill, per_step = attention_launches(cfg)
    for o in ranks:
        check(o["launches"] == {"K3": per_prefill, "K4": per_step * (STEPS_NEW - 1)},
              f"steps: ({label}) {arch} rank {o['rank']} launched {o['launches']} on the bf16 "
              f"kernel route, not {per_prefill} K3 and {per_step} K4 per decode step")
        for fault, e in o["faults"].items():
            check(e > tol, f"steps: ({label}) {arch} rank {o['rank']}: planted fault ({fault}) "
                  f"not rejected ({e:.3e})")
    print(f"steps: ({label}) {arch}: every rank launched K3 {per_prefill} times per prefill and "
          f"K4 {per_step} times per decode step on the bf16 kernel route; planted faults "
          f"rejected on every rank: " + ", ".join(
              f"{f} ({min(o['faults'][f] for o in ranks):.2e} to "
              f"{max(o['faults'][f] for o in ranks):.2e})" for f in ranks[0]["faults"]),
          flush=True)
    # training
    for o in ranks:
        for step, (a, w) in enumerate(zip(o["losses"], ref["losses"], strict=True)):
            check(abs(a - w) <= STEPS_TRAIN_TOL * abs(w), f"steps: ({label}) {arch} rank "
                  f"{o['rank']} train step {step + 1} loss {a:.6f}, single device {w:.6f}")
    o0 = ranks[0]
    held, exempt, free_worst, total = o0["train_param_err"]
    print(f"steps: ({label}) {arch}: {len(o0['losses'])} float32 train step(s), B={train_b} "
          f"S={train_s}: losses " + ", ".join(f"{x:.6f}" for x in o0["losses"])
          + " on every rank (single device " + ", ".join(f"{x:.6f}" for x in ref["losses"])
          + f"; tol {STEPS_TRAIN_TOL} relative); every parameter's full_tensor() after step 1 "
          f"within {held:.3e} of its leaf's largest value of the single-device update (tol "
          f"{STEPS_TRAIN_TOL}), except {exempt} of {total} elements whose clipped single-device "
          f"gradient is nonzero and below {STEPS_NOISE_EPS} x AdamW's eps (worst "
          f"{free_worst:.3e}, not held; clip scale {ref['clip']:.4f}) [{smi}]", flush=True)
    # (c): the trace's prediction against this world
    for o in ranks:
        for step in ("prefill", "decode", "train"):
            check(o["resident"][step] == traced[step]["argument"],
                  f"steps: ({label}) {arch} rank {o['rank']} {step}: {o['resident'][step]} "
                  f"resident bytes, the trace's argument {traced[step]['argument']}")
        real = {"prefill": o["collectives"]["plain"]["prefill"],
                "decode": o["collectives"]["plain"]["decode"], "train": o["collectives"]["train"]}
        for step, kinds in real.items():
            want = {k: tuple(v) for k, v in traced[step]["collectives"].items()}
            have = {k: tuple(v) for k, v in kinds.items()}
            check(have == want, f"steps: ({label}) {arch} rank {o['rank']} {step}: the plain "
                  f"route's collectives {have}, the trace's {want}")

    def fmt(kinds):
        return ", ".join(f"{k} {n} x {b / 1e6:.3f} MB" for k, (n, b) in sorted(kinds.items())) \
            or "none"

    kernel = o0["collectives"].get("kernel")
    print(f"steps: (c) {arch}: every rank's resident bytes == the trace's argument bytes "
          f"(prefill {traced['prefill']['argument'] / 1e9:.4f} GB, decode "
          f"{traced['decode']['argument'] / 1e9:.4f} GB, train "
          f"{traced['train']['argument'] / 1e9:.4f} GB); the plain route's collectives == the "
          f"trace's: prefill {fmt(traced['prefill']['collectives'])}; decode step "
          f"{fmt(traced['decode']['collectives'])}; train step "
          f"{fmt(traced['train']['collectives'])}"
          + (f"; the kernel route's: prefill {fmt(kernel['prefill'])}; decode step "
             f"{fmt(kernel['decode'])}" if kernel else ""), flush=True)
    times = [o["times"] for o in ranks]
    print(f"steps: ({label}) {arch} {smi}: wall ms by rank (host clock between a barrier and a "
          f"sync), bf16 kernel route: prefill " + ", ".join(f"{t['prefill_ms']:.1f}" for t in times)
          + "; decode step p50 " + ", ".join(f"{t['decode_p50_ms']:.1f}" for t in times)
          + ", p99 " + ", ".join(f"{t['decode_p99_ms']:.1f}" for t in times)
          + f" ({STEPS_NEW - 1} steps); float32 train step " + "; ".join(
              ", ".join(f"{x:.1f}" for x in t["train_ms"]) for t in times), flush=True)


TWINS = ("quickstart", "trace_provisioning", "serve_autoscale", "train_lm")   # phase 20
TWIN_RESUME_STEPS = 10           # phase 20: steps the rerun of train_lm adds after its resume
TWIN_BOUND_TOL = 0.05            # phase 20: the eval's tolerance on a drawn number's bound
LINT_TIMEOUT_S = 300


def twin_run(name, argv):
    """Phase 20: ``main(argv)`` of ``examples/<name>_torch.py`` on the card,
    every launch counter set to 0 just before and read just after; returns
    (its standard output, the launches of K1 to K4, its wall seconds)."""
    import contextlib
    import importlib.util
    import io

    import torch

    kernels = importlib.import_module("repro_torch.kernels.provision_scan")
    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", os.path.join(ROOT, "examples", f"{name}_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = twin
    spec.loader.exec_module(twin)
    buf = io.StringIO()
    kernels.launches = kernels.stream_launches = 0
    flash.flash_launches = decode.decode_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = twin.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"K1": kernels.launches, "K2": kernels.stream_launches,
              "K3": flash.flash_launches, "K4": decode.decode_launches}
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"examples: {name}: {line}", flush=True)
    check(rc == 0, f"examples: {name}_torch.py exited {rc}")
    return out, counts, wall


def twin_kernels():
    """Phase 20: K3 and K4 at the serving twin's shapes — its prompts of 32
    tokens and its 96-slot caches, the reduced llama3.2-1b's 4 query and 2
    kv heads at head dim 64, bf16 — held to their plain versions; returns
    their largest absolute errors."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("llama3.2-1b", reduced=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, 64

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    q, k, v = draw(1, 32, h, hd), draw(1, 32, kvh, hd), draw(1, 32, kvh, hd)
    errs = {"K3": compare(flash.flash_attention(q, k, v, block_q=32, block_k=32),
                          flash.flash_attention_plain(q, k, v), "bfloat16",
                          "examples: K3 at the serving twin's prompt")[0]}
    q1, kc, vc = draw(1, h, hd), draw(1, 96, kvh, hd), draw(1, 96, kvh, hd)
    lengths = torch.tensor([47], dtype=torch.int32, device="cuda")
    errs["K4"] = compare(decode.decode_attention(q1, kc, vc, lengths, block_k=96),
                         decode.decode_attention_plain(q1, kc, vc, lengths), "bfloat16",
                         "examples: K4 over the serving twin's cache")[0]
    return errs


def examples_phase(smi):
    """Phase 20: the port's lint over its tree and this script (a
    subprocess, run beside the rest), then the four example twins' ``main``
    on the card at their defaults, each held to the checks of its CPU tests
    against host oracles (the port's fluid model, the plain CPU route, the
    cluster without engines), K3 and K4 at the serving twin's shapes held to
    their plain versions.  Returns the twins' launches of K1 to K4 and the
    largest K3 and K4 errors."""
    import dataclasses
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import (
        PAPER_COSTS,
        CostModel,
        PolicySpec,
        ProvisionSpec,
        Workload,
        fluid_cost,
        msr_like_trace,
        provision,
        theoretical_ratio,
    )
    from repro_torch.core.traces import WEEK_SLOTS
    from repro_torch.data.requests import generate_sessions
    from repro_torch.scenarios import Scenario, generate
    from repro_torch.serving import (
        FleetProvisioner,
        make_window_max_predictor,
        run_cluster,
    )

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    lint = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.lint", "src/repro_torch", "chip_smoke.py",
         "--strict"], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    walls = {}
    try:
        # quickstart: A1's sweep and DELAYEDOFF are one K2 launch each, the
        # offline optimum a closed form; the costs are the fluid model's
        out, counts, walls["quickstart"] = twin_run("quickstart", [])
        check(counts == {"K1": 0, "K2": 2, "K3": 0, "K4": 0},
              f"examples: quickstart launched {counts}, expected 2 of K2")
        costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
        trace = msr_like_trace(np.random.default_rng(0))
        lines = out.splitlines()
        opt = fluid_cost(trace, "offline", costs).cost
        check(f"offline optimal cost     : {opt:,.0f}  " in out,
              "examples: quickstart's offline optimum is not the fluid model's")
        want = [f"{'A1':<12}{w:>7}{fluid_cost(trace, 'A1', costs, window=w).cost:>12,.0f}"
                for w in (0, 2, 4, 5)]
        want.append(f"{'DELAYEDOFF':<12}{'--':>7}"
                    f"{fluid_cost(trace, 'delayedoff', costs).cost:>12,.0f}")
        for prefix in want:
            check(any(line.startswith(prefix) for line in lines),
                  f"examples: quickstart has no line {prefix!r}")
        for k in launches:
            launches[k] += counts[k]

        # trace_provisioning: six K2 launches here (the rank's three are
        # counted by the twin itself); the draw-free numbers are the fluid
        # model's and the plain CPU route's, the drawn ones within bounds
        out, counts, walls["trace_provisioning"] = twin_run("trace_provisioning", [])
        check(counts == {"K1": 0, "K2": 6, "K3": 0, "K4": 0},
              f"examples: trace_provisioning launched {counts}, expected 6 of K2")
        check("sharded over 1 device(s): identical schedule ✓" in out,
              "examples: trace_provisioning's sharded schedule")
        msr = Scenario("msr_diurnal", target_pmr=4.63, mean_jobs=40.0)
        week = generate(msr, 1, WEEK_SLOTS)[0]
        opt = fluid_cost(week, "offline", PAPER_COSTS).cost
        rows = out.split("A3 emp\n")[1].splitlines()[:6]
        for w, row in enumerate(rows):
            alpha, a1_bound, a1_emp, a3_bound, a3_emp = (float(x) for x in row.split())
            a1 = fluid_cost(week, "A1", PAPER_COSTS, window=w).cost / opt
            check(f"{a1_emp:.3f}" == f"{a1:.3f}", f"examples: Fig.3 A1 window {w}")
            check(1.0 <= a3_emp <= a3_bound + TWIN_BOUND_TOL, f"examples: Fig.3 A3 window {w}")
        for target in (2, 4, 6, 8, 10):
            a = generate(dataclasses.replace(msr, target_pmr=float(target)), 1, WEEK_SLOTS)[0]
            red = 1 - fluid_cost(a, "offline", PAPER_COSTS).cost / fluid_cost(
                a, "static", PAPER_COSTS).cost
            check(f"  PMR={target:>2}: reduction {red:6.1%}" in out, f"examples: Fig.4d {target}")
        n_levels = int(week.max()) + 1
        n_base = int(n_levels * 0.5)
        beta = np.where(np.arange(n_levels) < n_base, 4.5, 1.5)
        het = provision(ProvisionSpec(costs=CostModel(P=1.0, beta_on=beta, beta_off=beta),
                                      workload=Workload(demand=week),
                                      policy=PolicySpec("A1", window=2), device="cpu"))
        check(f"  total={float(het.cost):,.0f}  energy={float(het.energy):,.0f} "
              f"toggles={float(het.toggle_cost):,.0f}" in out,
              "examples: the heterogeneous fleet differs from the plain CPU route")
        bound = theoretical_ratio("A1", 3 / PAPER_COSTS.delta)
        for line in out.split("(PredictionNoise sweep axis):\n")[1].splitlines()[:3]:
            cr = float(line.split("mean CR ")[1].split()[0])
            check(1.0 <= cr <= bound + TWIN_BOUND_TOL, f"examples: flash crowd {line!r}")
        for k in launches:
            launches[k] += counts[k]

        # serve_autoscale: K2 for the two sweeps and four plans; K3 per
        # layer and prefill, K4 twice per layer and decode step
        out, counts, walls["serve_autoscale"] = twin_run("serve_autoscale", [])
        sessions = generate_sessions(np.random.default_rng(0), n_slots=40,
                                     mean_concurrency=2.5)
        layers = get_config("llama3.2-1b", reduced=True).n_layers
        n_new = [min(s.max_new_tokens, 16) for s in sessions.sessions]
        want = {"K1": 0, "K2": 6, "K3": layers * len(n_new),
                "K4": 2 * layers * sum(n - 1 for n in n_new)}
        check(counts == want, f"examples: serve_autoscale launched {counts}, expected {want}")
        serve = importlib.import_module("serve_autoscale_torch")
        demand = serve.slot_concurrency(sessions, 40)
        plan = FleetProvisioner(costs, policy="A1", max_replicas=int(demand.max()) + 1,
                                device="cpu").sweep_costs(demand, np.arange(6))
        check("  A1: " + " ".join(f"w={w}:{c:,.0f}" for w, c in enumerate(plan)) in out,
              "examples: serve_autoscale's A1 sweep differs from the plain CPU route")
        pred = make_window_max_predictor(sessions)
        for alpha in (0.0, 0.5, 1.0):
            rep = run_cluster(sessions, costs, policy="A1", alpha=alpha, predictor=pred)
            check(f"A1(alpha={alpha:.2f}): cost={rep.total_cost:,.1f} "
                  f"static={rep.static_cost:,.0f} reduction={rep.reduction:.1%}" in out,
                  f"examples: serve_autoscale's cluster at alpha {alpha}")
        rep = run_cluster(sessions, costs, policy="A1", alpha=0.5, predictor=pred)
        check(f"A1(alpha=0.50) + real generation: cost={rep.total_cost:,.1f} " in out
              and out.rstrip().endswith(f"tokens={sum(n_new)}"),
              "examples: serve_autoscale's engines: cost or tokens")
        for k in launches:
            launches[k] += counts[k]

        errs = twin_kernels()

        # train_lm: the reduced model at the twin's defaults, then a rerun
        # that resumes from its last checkpoint; training runs no kernel
        work = os.path.join(ROOT, "build", "chip_smoke_train_lm")
        shutil.rmtree(work, ignore_errors=True)
        try:
            out, counts, walls["train_lm"] = twin_run("train_lm", ["--ckpt-dir", work])
            first, last = (float(x) for x in out.split("loss ")[-1].split(" -> "))
            check("to step 300:" in out and last < first,
                  f"examples: train_lm's loss {first} -> {last} over 300 steps")
            out, resumed, walls["train_lm resumed"] = twin_run(
                "train_lm", ["--ckpt-dir", work, "--steps", str(300 + TWIN_RESUME_STEPS)])
            check(f"to step {300 + TWIN_RESUME_STEPS}:" in out, "examples: train_lm's rerun")
            check(counts == resumed == {"K1": 0, "K2": 0, "K3": 0, "K4": 0},
                  f"examples: train_lm launched {counts} and {resumed}")
        finally:
            shutil.rmtree(work, ignore_errors=True)

        lint_out, lint_err = lint.communicate(timeout=LINT_TIMEOUT_S)
    finally:
        if lint.poll() is None:
            lint.kill()
            lint.wait()
    check(lint.returncode == 0, f"examples: the port's lint exited {lint.returncode}:\n"
          f"{lint_out[-3000:]}{lint_err[-3000:]}")
    print(f"examples: python -m repro_torch.lint src/repro_torch chip_smoke.py --strict: "
          f"exit 0 ({lint_err.strip()})", flush=True)
    print("examples: wall s " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
          + f"; launches {launches}; K3 err {errs['K3']:.3e}, K4 err {errs['K4']:.3e} [{smi}]",
          flush=True)
    print(f"examples: phase 20 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launches, "errs": errs}


def engine_cache(engine, batch, src_len=0):
    """A fresh cache for ``engine``, as its ``generate`` makes one for a
    prompt of ``src_len`` tokens (the encoder-decoder's source frames)."""
    from repro_torch.models import init_cache

    return init_cache(engine.cfg, batch, engine.max_seq, src_len=src_len, device=engine.device)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import (
        PAPER_COSTS,
        CostModel,
        PolicySpec,
        ProvisionSpec,
        ServerGroup,
        Workload,
        msr_like_trace,
        provision,
        provision_stream,
    )
    from repro_torch.core import torch_provision as engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import provision_scan as kernels
    from repro_torch.kernels._build import load_attention, load_provision_scan

    provision_module = importlib.import_module("repro_torch.core.provision")
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    # 2. build: both libraries at once, each one nvcc per source
    build_s = {}
    _build.build_listeners.append(lambda name, seconds: build_s.setdefault(name, seconds))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for build in [pool.submit(load_provision_scan), pool.submit(load_attention)]:
            build.result()
    print(f"build: K1 and K2, and K3 and K4, built from source in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    n_flash, n_split = sass_check(load_attention()._name)
    print(f"build: SASS holds HGMMA and an asynchronous load in all {n_flash} instances of "
          f"K3's flash_wgmma_kernel, and an asynchronous load in all {n_split} of K4's split "
          "pass", flush=True)

    demand = np.stack([
        msr_like_trace(np.random.default_rng(SEED + b), n_slots=N_SLOTS,
                       mean_jobs=N_LEVELS / 4.0)
        for b in range(N_TRACES)
    ])
    ab = torch.as_tensor(demand, device=dev).to(torch.int32)
    straddle = torch.as_tensor(straddle_demand(), device=dev)

    def grid_inputs(policy, costs=PAPER_COSTS, a=ab, uniform_waits=False, windows=WINDOWS):
        delta = torch.as_tensor(costs.delta, dtype=torch.float32,
                                device=dev).broadcast_to((N_LEVELS,))
        uniforms = None
        if policy in engine.KEYED:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            uniforms = engine._uniforms(gen, a.shape[0], a.shape[1], N_LEVELS, dev)
        inputs, _ = engine._grid_inputs(
            a, a[None], windows, delta, uniforms, n_levels=N_LEVELS,
            max_h=costs.delta_slots(), policy=policy, uniform_waits=uniform_waits,
        )
        return inputs

    def new_paths():
        return torch.zeros(3, dtype=torch.int32, device=dev)

    # 3. kernel against plain version
    typed = CostModel.from_groups(
        ServerGroup("efficient", N_LEVELS // 2, P=1.0, beta_on=1.25, beta_off=1.25),
        ServerGroup("legacy", N_LEVELS // 2, P=2.0, beta_on=3.0, beta_off=3.0),
    )
    # (name, policy, costs, record, demand); record also asks K1 for the codes
    cases = [
        ("A1", "A1", PAPER_COSTS, False, ab),
        ("A2", "A2", PAPER_COSTS, False, ab),
        ("A3", "A3", PAPER_COSTS, False, ab),
        ("delayedoff", "delayedoff", PAPER_COSTS, False, ab),
        ("A2+record", "A2", PAPER_COSTS, True, ab),
        ("typed A1, Δ 2.5/3.0", "A1", typed, False, ab),
        ("straddle A1", "A1", PAPER_COSTS, False, straddle),
        ("straddle A2+record", "A2", PAPER_COSTS, True, straddle),
    ]
    measured = {}
    max_err = 0
    plain_ons = {}              # the plain on-matrices, for the bounds of phase 6
    for name, policy, costs, record, a in cases:
        inputs = grid_inputs(policy, costs, a)
        launched_before = kernels.launches
        paths = new_paths()
        got = kernels.provision_scan_grid(**inputs, record=record, codes=record, paths=paths)
        want = kernels.provision_scan_grid_ref(**inputs, record=record, codes=record)
        torch.cuda.synchronize()
        got, want = (got, want) if record else ((got,), (want,))
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"K1 {name}: shape/dtype differ")
            max_err = max(max_err, int((g.to(torch.int32) - w.to(torch.int32)).abs().max()))
            check(torch.equal(g, w), f"K1 {name}: kernel and plain version differ")
        check(got[0].any() and not got[0].all(), f"K1 {name}: degenerate on-matrix")
        G, T, N = got[0].shape
        plain_ons[name] = want[0]
        if a is straddle:       # the edges of both skips: each path taken, nothing timed
            check(all(int(v) > 0 for v in paths.tolist()),
                  f"K1 {name}: a path of the slot loop was never taken ({paths.tolist()})")
            print(f"kernel: K1 {name}: G={G} T={T} N={N} equal=True; {path_shares(paths)}",
                  flush=True)
            continue

        def k1(inputs=inputs, record=record):
            return kernels.provision_scan_grid(**inputs, record=record, codes=record)

        ms = kernel_ms(k1, KERNEL_REPS)
        call = cuda_ms(k1, KERNEL_REPS)
        plain = cuda_ms(lambda: kernels.provision_scan_grid_ref(
            **inputs, record=record, codes=record), PLAIN_REPS)
        bound, bound_by, bound_old = bound_ms(inputs, record, want[0])
        measured[name] = (ms, plain, bound, bound_by)
        print(f"kernel: K1 {name}: G={G} T={T} N={N} horizon={inputs['horizon']} "
              f"codes={record} equal=True kernel_ms={ms:.4f} call_ms={call:.4f} "
              f"plain_ms={plain:.2f} bound_ms={bound:.4f} ({bound_by}; {bound_old:.4f} "
              f"counting every update) launches={kernels.launches - launched_before} "
              f"(check and timing); {path_shares(paths)} [{smi}]", flush=True)
        del got, want

    # peeks the loop does not tabulate (the window walked, waits loaded on
    # the chain): a horizon past its 64-slot table, and the longest horizon
    # the card takes, held to the plain version peeking the rest of the
    # trace (past T the peek reads 0, so the two agree)
    long_costs = CostModel(P=1.0, beta_on=50.0, beta_off=50.0)         # Δ = 100 slots
    scan_lib = load_provision_scan()

    def whole_trace(inputs, horizon):
        """``inputs`` with every level peeking ``horizon`` slots, and the same
        inputs peeking exactly the rest of the trace."""
        far, whole = dict(inputs), dict(inputs)
        for d, h in ((far, horizon), (whole, inputs["traces"].shape[1])):
            d["horizon"] = h
            d["level_horizon"] = torch.full_like(inputs["level_horizon"], float(h))
            if "delta" in inputs:
                d["delta"] = h
        return far, whole

    k1_limit = scan_lib.repro_provision_scan_max_horizon()
    long_inputs = grid_inputs("A2", long_costs, ab[:, :LONG_SLOTS], windows=LONG_WINDOWS)
    far, whole = whole_trace(grid_inputs("A2", a=ab[:2, :LIMIT_SLOTS]), k1_limit)
    for name, got_in, want_in in (("peek 100 A2+record", long_inputs, long_inputs),
                                  ("peek at the limit A2+record", far, whole)):
        got = kernels.provision_scan_grid(**got_in, record=True, codes=True)
        want = kernels.provision_scan_grid_ref(**want_in, record=True, codes=True)
        for g, w in zip(got, want):
            max_err = max(max_err, int((g.to(torch.int32) - w.to(torch.int32)).abs().max()))
            check(torch.equal(g, w), f"K1 {name}: kernel and plain version differ")
        check(bool((got[2] & 4).any()), f"K1 {name}: no peek fired")
        print(f"kernel: K1 {name}: G={got[0].shape[0]} T={got[0].shape[1]} "
              f"horizon={got_in['horizon']} equal=True", flush=True)
    try:
        kernels.provision_scan_grid(**whole_trace(far, k1_limit + 1)[0])
    except ValueError:
        print(f"kernel: K1 takes peeks of up to {k1_limit} slots and refuses "
              f"{k1_limit + 1}", flush=True)
    else:
        raise SmokeFailure(f"K1 took a horizon of {k1_limit + 1}, past its limit")
    del long_inputs, far, whole, got, want

    # 4. provision() end to end: the main path, counted call by call
    def spec(policy):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return ProvisionSpec(
            costs=PAPER_COSTS, workload=Workload(demand=ab),
            policy=PolicySpec(policy, windows=WINDOWS, generator=gen),
            n_levels=N_LEVELS, device=dev,
        )

    def counted(fn):
        """``fn()`` with the launch counters set to 0 just before it and read
        just after: its result, K1's launches and K2's."""
        torch.cuda.synchronize()
        kernels.launches = kernels.stream_launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, kernels.launches, kernels.stream_launches

    policies = ("A1", "A2", "offline")
    results = {}
    main_k2 = 0
    for p in policies:
        results[p], n1, n2 = counted(lambda p=p: provision(spec(p)))
        want = (0, 0) if p == "offline" else (0, 1)
        check((n1, n2) == want, f"provision({p}): K1 launched {n1} times and K2 {n2}, "
              f"expected {want[0]} and {want[1]}")
        main_k2 += n2
    recorded, main_k1, n2 = counted(lambda: provision(spec("A2"), record_decisions=True))
    check((main_k1, n2) == (1, 0), f"provision(A2, record_decisions=True): K1 launched "
          f"{main_k1} times and K2 {n2}, expected 1 and 0")
    print(f"provision: main path ran A1, A2, offline with K2 launches={main_k2} (1 per "
          f"online call) and K1 launches=0; A2 with record_decisions with K1 "
          f"launches={main_k1} and K2 launches=0", flush=True)

    W, B = len(WINDOWS), N_TRACES
    plain_results = {}
    for p in policies:
        res = results[p]
        plain = provision_module._provision(spec(p), record_decisions=False, kernel=False)
        plain_results[p] = plain
        check(tuple(res.x.shape) == (W, B, N_SLOTS) and res.x.dtype == torch.int32,
              f"provision {p}: x shape {tuple(res.x.shape)}")
        check(bool(torch.isfinite(res.cost).all()), f"provision {p}: cost not finite")
        for field in ("x", "level_cost", "cost"):
            check(torch.equal(getattr(res, field), getattr(plain, field)),
                  f"provision {p}: {field} differs from plain route")
    plain_rec = provision_module._provision(spec("A2"), record_decisions=True, kernel=False)
    check(recorded.decisions is not None and recorded.decisions.dtype == torch.uint8
          and tuple(recorded.decisions.shape) == (W, B, N_SLOTS, N_LEVELS),
          "provision(record_decisions=True): no (W, B, T, N) uint8 decisions on the card")
    check(torch.equal(recorded.decisions, plain_rec.decisions),
          "provision(record_decisions=True): decisions differ from the plain route's")
    for k, v in plain_rec.decision_counts.items():
        check(torch.equal(recorded.decision_counts[k], v),
              f"provision(record_decisions=True): decision_counts[{k}] differs")
    for field in ("x", "level_cost", "cost"):
        check(torch.equal(getattr(recorded, field), getattr(plain_rec, field))
              and torch.equal(getattr(recorded, field), getattr(results["A2"], field)),
              f"provision(A2, record_decisions=True): {field} differs from the plain "
              "route's or from the K2 route's")
    print(f"provision: x, level_cost and cost equal the plain route's bit for bit for A1, "
          f"A2, offline; A2 with record_decisions: decisions "
          f"({int((recorded.decisions != 0).sum())} nonzero codes) and decision_counts "
          "equal the plain route's too", flush=True)
    del plain_rec
    off = results["offline"].cost
    for p in ("A1", "A2"):
        check(bool((off <= results[p].cost).all()),
              f"provision: offline costs more than {p} somewhere")

    def wall_ms(fn):
        fn()
        walls = []
        for _ in range(PROVISION_REPS):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    for p in policies:
        wall = wall_ms(lambda p=p: provision(spec(p)).x.sum().item())
        print(f"provision: {p} median wall_ms={wall:.2f} per call (G={W * B} cells) [{smi}]",
              flush=True)
    wall = wall_ms(lambda: provision(spec("A2"), record_decisions=True).x.sum().item())
    print(f"provision: A2 record_decisions median wall_ms={wall:.2f} per call [{smi}]",
          flush=True)

    # 5. where the time goes in one provision() call (torch.profiler)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def breakdown(label, fn):
        fn()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      key=lambda e: -e.self_device_time_total)
        if not rows:
            print(f"breakdown: {label} device time not measured (the profiler saw no "
                  "device events)", flush=True)
            return
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        k1_ms = sum(e.self_device_time_total for e in rows if "grid_scan" in e.key) / 1e3
        k2_ms = sum(e.self_device_time_total for e in rows if "stream_scan" in e.key) / 1e3
        print(f"breakdown: {label} device busy {busy:.3f} ms in {len(rows)} kernels, "
              f"K1 {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms [{smi}]", flush=True)
        for e in rows[:6]:
            print(f"breakdown: {label}   {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:80]}", flush=True)

    for p in ("A1", "A2"):
        breakdown(f"provision {p}", lambda p=p: provision(spec(p)).x.sum().item())
    breakdown("provision A2 record_decisions",
              lambda: provision(spec("A2"), record_decisions=True).x.sum().item())

    delta = float(PAPER_COSTS.delta)
    for p, bound_of in (("A1", lambda a: 2.0 - a), ("A2", lambda a: (math.e - a) / (math.e - 1))):
        cr = (results[p].cost / off).cpu().numpy()                   # (W, B)
        for i, w in enumerate(WINDOWS):
            alpha = min(1.0, (w + 1) / delta)
            bound = bound_of(alpha)
            mean = float(cr[i].mean())
            print(f"provision: {p} window={w} mean_cr={mean:.4f} max_cr={cr[i].max():.4f} "
                  f"bound={bound:.4f}", flush=True)
            check(mean <= bound + 0.05, f"provision {p} window {w}: mean CR above bound")
            if p == "A1":     # deterministic: the bound holds trace by trace
                check(bool((cr[i] <= bound + 1e-6).all()), f"A1 window {w}: CR above bound")

    # 6. K2 against its plain version on the card
    # first the uniforms route's arithmetic: its waits against the table
    # route's (PyTorch's log1p) on every entry of the smoke tables
    gen = torch.Generator(device=dev).manual_seed(SEED)
    u0, u = engine._uniforms(gen, N_TRACES, N_SLOTS, N_LEVELS, dev)
    delta_lv = torch.as_tensor(PAPER_COSTS.delta, dtype=torch.float32,
                               device=dev).broadcast_to((N_LEVELS,))
    entries = differ = 0
    for policy in ("A2", "A3", "AQ-rand"):
        span, p0 = engine._wait_rows(policy, [0] if policy == "AQ-rand" else WINDOWS, delta_lv)
        for k in range(span.shape[0]):
            row0 = None if p0 is None else p0[k]
            want = engine._waits(u0 if p0 is not None else None, u, span[k], row0)
            got = kernels._uniform_waits_probe(u0 if p0 is not None else None, u, span[k],
                                               row0)
            torch.cuda.synchronize()
            entries += want.numel()
            differ += int((got.view(torch.int32) != want.view(torch.int32)).sum())
    del got, want, u0, u
    print(f"stream kernel: uniforms route: {entries} wait entries of the A2, A3 and AQ-rand "
          f"tables, {differ} differ in any bit from PyTorch's log1p route", flush=True)
    check(differ == 0, "the uniforms route's waits differ from the table route's")

    def stream_inputs(policy, costs=PAPER_COSTS, a=ab, uniform_waits=False, windows=WINDOWS):
        inputs = grid_inputs(policy, costs, a, uniform_waits, windows)
        del inputs["delta"]                 # K2 examines `horizon` slots, no more
        return inputs

    def stream_diff(got, want, what):
        """Largest difference of K2's outputs from the plain version's; they
        must be equal."""
        (gx, gacc, gcarry), (wx, wacc, wcarry) = got, want
        pairs = [("x", gx, wx)] + [(k, gacc[k], wacc[k]) for k in wacc] \
            + [(k, gcarry[k], wcarry[k]) for k in wcarry]
        err = 0.0
        for k, g, w in pairs:
            check(g.shape == w.shape and g.dtype == w.dtype, f"K2 {what}: {k} shape/dtype")
            err = max(err, float((g.to(torch.float64) - w.to(torch.float64)).abs().max()))
            check(torch.equal(g, w), f"K2 {what}: {k} differs from the plain version")
        return err

    def timed(fn):
        """``fn()`` and its milliseconds between two CUDA events."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    k2_err = 0.0
    k2_measured = {}
    stream_cases = cases[:6] + [("AQ-rand", "AQ-rand", PAPER_COSTS, False, ab)] + cases[6:]
    for name, policy, costs, record, a in stream_cases:
        table = stream_inputs(policy, costs, a)
        # the route the main path takes: the uniforms route for the keyed policies
        drawn = stream_inputs(policy, costs, a, uniform_waits=True) \
            if policy in engine.KEYED else table
        launched_before = kernels.stream_launches
        ons = plain_ons.get(name)
        if ons is None:
            ons = kernels.provision_scan_grid_ref(**grid_inputs(policy, costs, a))
        for t_chunk in (STREAM_T_CHUNK, N_SLOTS):
            def k2(route=drawn, t_chunk=t_chunk, paths=None):
                return kernels.provision_scan_stream(**route, t_chunk=t_chunk, record=record,
                                                     paths=paths)
            want, plain = timed(lambda: kernels.provision_scan_stream_ref(
                **table, t_chunk=t_chunk, record=record))
            paths = new_paths()
            k2_err = max(k2_err, stream_diff(k2(paths=paths), want,
                                             f"{name} t_chunk={t_chunk}"))
            if drawn is not table:
                k2_err = max(k2_err, stream_diff(k2(route=table), want,
                                                 f"{name} table route t_chunk={t_chunk}"))
            check(want[1]["up"].sum() > 0 and want[1]["down"].sum() > 0,
                  f"K2 {name}: no level toggled")
            if a is straddle:
                check(all(int(v) > 0 for v in paths.tolist()),
                      f"K2 {name}: a path of the slot loop was never taken ({paths.tolist()})")
                print(f"stream kernel: K2 {name} t_chunk={t_chunk}: equal=True; "
                      f"{path_shares(paths)}", flush=True)
                continue
            ms = kernel_ms(k2, KERNEL_REPS, name="stream_scan_kernel")
            extra = ""          # the table route to the same waits, timed beside it
            if drawn is not table:
                table_ms = kernel_ms(lambda: k2(table), KERNEL_REPS, name="stream_scan_kernel")
                extra = f" table_route_ms={table_ms:.4f}"
            call = cuda_ms(k2, KERNEL_REPS)
            bound, bound_by, bound_old = bound_ms(drawn, record, ons, stream=True)
            if t_chunk == STREAM_T_CHUNK:
                k2_measured[name] = (ms, plain, bound, bound_by)
            route = "uniforms" if drawn is not table else "table" \
                if table["thresholds"].shape[1] != 1 else "constant row"
            print(f"stream kernel: K2 {name} t_chunk={t_chunk} ({route} route): "
                  f"G={want[0].shape[0]} T={N_SLOTS} N={N_LEVELS} horizon={table['horizon']} "
                  f"equal=True kernel_ms={ms:.4f}{extra} call_ms={call:.4f} "
                  f"plain_ms={plain:.2f} bound_ms={bound:.4f} ({bound_by}; {bound_old:.4f} "
                  f"counting every update); {path_shares(paths)} [{smi}]", flush=True)
        print(f"stream kernel: K2 {name}: launches={kernels.stream_launches - launched_before} "
              "(check and timing)", flush=True)
        del table, drawn, ons, want
    del plain_ons

    # the chained case: a trace cut mid-tile and mid-wait, the carry threaded
    inputs = stream_inputs("A2")

    def halves(sl):
        part = dict(inputs)
        for k in ("traces", "predicted", "thresholds"):
            part[k] = inputs[k][:, sl]
        return part

    first, second = halves(slice(None, CUT)), halves(slice(CUT, None))
    chained = {}
    for route, fn in (("kernel", kernels.provision_scan_stream),
                      ("plain", kernels.provision_scan_stream_ref)):
        one = fn(**first, t_chunk=STREAM_T_CHUNK, record=True)
        two = fn(**second, t_chunk=STREAM_T_CHUNK, record=True, carry=one[2])
        chained[route] = (one, two)
    k2_err = max(k2_err, stream_diff(chained["kernel"][0], chained["plain"][0],
                                     f"chained first {CUT} slots"))
    k2_err = max(k2_err, stream_diff(chained["kernel"][1], chained["plain"][1],
                                     "chained rest"))
    mid = chained["kernel"][0][2]
    mid_wait = int((mid["on"] & (mid["r"] > 0)).sum())
    check(mid_wait > 0, "K2 chained: no lane is mid-wait at the cut")
    print(f"stream kernel: K2 A2+record cut at slot {CUT} (t_chunk={STREAM_T_CHUNK}), "
          f"carry threaded: equal=True, {mid_wait} lanes mid-wait at the cut", flush=True)

    # phase 3's untabulated peeks, on A3's uniforms route (two rings when
    # tabulated); the longest horizon is the largest with a tile of 1 slot
    lo, hi = 0, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = scan_lib.repro_provision_scan_stream_max_tile(mid, 3) >= 1
        lo, hi = (mid, hi) if fits else (lo, mid)
    k2_limit = lo
    long_drawn = stream_inputs("A3", long_costs, ab[:, :LONG_SLOTS], uniform_waits=True,
                               windows=LONG_WINDOWS)
    far, whole = whole_trace(stream_inputs("A3", a=ab[:2, :LIMIT_SLOTS], uniform_waits=True),
                             k2_limit)
    for name, got_in, want_in, t_chunk in (
            ("peek 100 A3+record", long_drawn, long_drawn, 128),
            ("peek at the limit A3+record", far, whole, LIMIT_SLOTS)):
        want = kernels.provision_scan_stream_ref(**want_in, t_chunk=t_chunk, record=True)
        k2_err = max(k2_err, stream_diff(
            kernels.provision_scan_stream(**got_in, t_chunk=t_chunk, record=True), want,
            f"{name} t_chunk={t_chunk}"))
        check(int(want[1]["peek_fired"].sum()) > 0, f"K2 {name}: no peek fired")
        print(f"stream kernel: K2 {name} t_chunk={t_chunk}: G={want[0].shape[0]} "
              f"T={want[0].shape[1]} horizon={got_in['horizon']} equal=True", flush=True)
    try:
        kernels.provision_scan_stream(**whole_trace(far, k2_limit + 1)[0])
    except ValueError:
        print(f"stream kernel: K2 takes peeks of up to {k2_limit} slots on A3's uniforms "
              f"route and refuses {k2_limit + 1}", flush=True)
    else:
        raise SmokeFailure(f"K2 took a horizon of {k2_limit + 1}, past its limit")
    del long_drawn, far, whole, want

    # 7. provision_stream() end to end: the main path, counted
    stream_runs = (("A1", False), ("A2", False), ("A2", True))
    want = {(p, rec): provision(spec(p), record_decisions=rec) for p, rec in stream_runs}
    got, k1_in_stream, stream_main_launches = counted(
        lambda: {(p, rec): provision_stream(spec(p), record_decisions=rec)
                 for p, rec in stream_runs})
    check(stream_main_launches == len(stream_runs) and k1_in_stream == 0,
          f"provision_stream(): K2 launched {stream_main_launches} times and K1 "
          f"{k1_in_stream}, expected {len(stream_runs)} and 0")
    print(f"provision_stream: main path ran A1, A2, A2+record with K2 launches="
          f"{stream_main_launches}, K1 launches={k1_in_stream}", flush=True)
    for (p, rec), res in got.items():
        for ref_res, what in ((want[(p, rec)], "provision()"),
                              (plain_results[p], "the plain route")):
            for field in ("x", "level_cost", "cost"):
                check(torch.equal(getattr(res, field), getattr(ref_res, field)),
                      f"provision_stream {p}: {field} differs from {what}")
        if rec:
            for k, v in want[(p, rec)].decision_counts.items():
                check(torch.equal(res.decision_counts[k], v),
                      f"provision_stream {p}: decision_counts[{k}] differs from provision()")
    print("provision_stream: x, level_cost, cost and decision_counts equal provision()'s "
          "(K1's with record_decisions) bit for bit, and x, level_cost and cost the plain "
          "route's", flush=True)

    for p in ("A1", "A2"):
        wall = wall_ms(lambda p=p: provision_stream(spec(p)).x.sum().item())
        print(f"provision_stream: {p} median wall_ms={wall:.2f} per call (G={W * B} cells) "
              f"[{smi}]", flush=True)
        breakdown(f"provision_stream {p}", lambda p=p: provision_stream(spec(p)).x.sum().item())

    # 8. a year of ten-minute slots through provision_stream()
    del want, got, results, plain_results, chained, first, second, inputs, recorded
    year = torch.as_tensor(np.stack([
        msr_like_trace(np.random.default_rng(SEED + b), n_slots=YEAR_SLOTS,
                       mean_jobs=N_LEVELS / 4.0)
        for b in range(N_TRACES)
    ]), device=dev).to(torch.int32)

    def year_spec(policy, demand, **pol):
        return ProvisionSpec(costs=PAPER_COSTS, workload=Workload(demand=demand),
                             policy=PolicySpec(policy, **pol), n_levels=N_LEVELS,
                             device=dev)

    year_res = {}
    for p in ("A1", "delayedoff", "A2"):
        if p == "A2":       # drawn here, so that the runs before do not hold them
            gen = torch.Generator(device=dev).manual_seed(SEED)
            u_year = engine._uniforms(gen, N_TRACES, YEAR_SLOTS, N_LEVELS, dev)
            sp = year_spec(p, year, windows=WINDOWS, uniforms=u_year)
        else:
            sp = year_spec(p, year, windows=WINDOWS)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, n1, n2 = counted(lambda sp=sp: provision_stream(sp))
        wall = time.perf_counter() - t0
        check(n2 == 1 and n1 == 0, f"year {p}: K2 launched {n2} times, K1 {n1}")
        check(bool(torch.isfinite(res.cost).all()) and res.x.shape[-1] == YEAR_SLOTS,
              f"year {p}: bad result")
        year_res[p] = res
        n_cells = N_TRACES * (1 if p == "delayedoff" else len(WINDOWS))
        print(f"year: {p} T={YEAR_SLOTS} B={N_TRACES} G={n_cells} N={N_LEVELS}: "
              f"wall_s={wall:.3f} K2 launches={n2} "
              f"max_memory_allocated_GB={torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"(of which held before the call: {held / 1e9:.2f}) [{smi}]",
              flush=True)

    # the uniforms route against the table route over the year, on the
    # traces whose (W*B, T, N) wait tables fit
    part = year[:YEAR_TABLE_TRACES]
    args = dict(delta=delta_lv, uniforms=tuple(v[:YEAR_TABLE_TRACES] for v in u_year),
                n_levels=N_LEVELS, max_h=PAPER_COSTS.delta_slots(), policy="A2")
    runs = {}
    for route in (True, False):
        inputs, _ = engine._grid_inputs(part, part[None], WINDOWS, args["delta"],
                                        args["uniforms"], n_levels=N_LEVELS,
                                        max_h=args["max_h"], policy="A2", uniform_waits=route)
        del inputs["delta"]
        paths = new_paths()
        runs[route] = kernels.provision_scan_stream(**inputs, t_chunk=STREAM_T_CHUNK,
                                                    record=True, paths=paths)
        torch.cuda.synchronize()
        if route:
            shares = path_shares(paths)
        del inputs
    k2_err = max(k2_err, stream_diff(runs[True], runs[False], "year, uniforms route"))
    print(f"year: A2 B={YEAR_TABLE_TRACES}: the uniforms route equals the table route bit for "
          f"bit (x, every total, the carry); {shares}", flush=True)
    del runs
    torch.cuda.empty_cache()

    # three cells held to provision() run on that cell alone
    cells = (("A1", 0, 0, {}), ("A1", len(WINDOWS) - 1, N_TRACES - 1, {}),
             ("A2", 3, 1, {"uniforms": tuple(u[1] for u in u_year)}))
    for p, w, b, pol in cells:
        one = provision(year_spec(p, year[b], window=WINDOWS[w], **pol))
        res = year_res[p]
        check(torch.equal(one.x, res.x[w, b]) and torch.equal(one.level_cost,
                                                              res.level_cost[w, b]),
              f"year {p} window {WINDOWS[w]} trace {b}: differs from provision() on the cell")
        print(f"year: {p} window={WINDOWS[w]} trace={b}: x and level_cost equal "
              f"provision() on that cell alone", flush=True)
    off = torch.stack([provision(year_spec("offline", year[b])).cost
                       for b in range(N_TRACES)])                 # (B,)
    cr = (year_res["A1"].cost / off).cpu().numpy()                # (W, B)
    for i, w in enumerate(WINDOWS):
        bound = 2.0 - min(1.0, (w + 1) / float(PAPER_COSTS.delta))
        check(bool((cr[i] <= bound + 1e-6).all()), f"year A1 window {w}: CR above 2 - alpha")
        print(f"year: A1 window={w} max_cr={cr[i].max():.4f} bound={bound:.4f}", flush=True)
    cr = (year_res["A2"].cost / off).cpu().numpy()
    for i, w in enumerate(WINDOWS):
        bound = (math.e - min(1.0, (w + 1) / float(PAPER_COSTS.delta))) / (math.e - 1)
        print(f"year: A2 window={w} mean_cr={cr[i].mean():.4f} bound={bound:.4f}", flush=True)
        check(float(cr[i].mean()) <= bound + 0.05, f"year A2 window {w}: mean CR above bound")
    del year_res, u_year, year
    torch.cuda.empty_cache()

    # 11. the competitive-ratio eval (after phase 8, before the attention phases)
    eval_launches = eval_phase(smi, counted, ab, dev)

    # 12. the serving stepper (after phase 11, before the attention phases)
    stepper_launches = stepper_phase(smi, counted, demand[0], dev)

    # 13. the serving path with real tokens (after phase 12, before the attention phases)
    serving = serving_phase(smi)

    # 14. training (after phase 13, before the attention phases)
    train_k3 = train_phase(smi, serving["cluster"], build_s)

    # 15. the hybrid, MoE and xLSTM families (after phase 14, before the attention phases)
    families = families_phase(smi)

    # 16. the vlm family and the encoder-decoder (after phase 15, before the attention phases)
    vlm_encdec = vlm_encdec_phase(smi)

    # 17. the multi-device route (after phase 16, before the attention phases)
    mesh_launches = mesh_phase(smi)

    # 18. the sharding rules and elastic restore (after phase 17, before the attention phases)
    elastic_phase(smi)

    # 19. the step builders, the dry-run and the sharded steps (after phase 18)
    steps_launches = steps_phase(smi)

    # 20. the port's lint and the example twins (after phase 19)
    twins = examples_phase(smi)

    # 9 and 10. the attention kernels K3 and K4
    attention_entries = attention_phases(smi)
    for entry, kernel in zip(attention_entries, ("K3", "K4")):
        entry["launches"] += serving[f"{kernel.lower()}_launches"]
        entry["launches"] += train_k3 if kernel == "K3" else 0
        entry["launches"] += families["launches"][kernel] + vlm_encdec["launches"][kernel]
        entry["launches"] += steps_launches[kernel] + twins["launches"][kernel]
        entry["max_abs_err"] = max(entry["max_abs_err"], serving["errs"][kernel],
                                   families["errs"][kernel], vlm_encdec["errs"][kernel],
                                   twins["errs"][kernel])

    ms, plain, bound, bound_by = measured["A2+record"]
    k2_ms_a2, k2_plain, k2_bound, k2_bound_by = k2_measured["A2"]
    print(f"device: {smi}")
    print(json.dumps({"kernels": [{
        "name": "provision_scan_grid",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/provision_scan.cu",
        "replaces": "src/repro/kernels/provision_scan.py:184",
        "launches": main_k1,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "provision_scan_stream",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/provision_scan_stream.cu",
        "replaces": "src/repro/kernels/provision_scan.py:460",
        "launches": (main_k2 + stream_main_launches + eval_launches + stepper_launches
                     + mesh_launches + twins["launches"]["K2"]),
        "max_abs_err": k2_err,
        "ms": k2_ms_a2,
        "plain_ms": k2_plain,
        "bound_ms": k2_bound,
        "bound_by": k2_bound_by,
        "library_ms": None,
    }] + attention_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
