#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the repository root, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is allowed to carry on past a
failure):

1. probe     - torch / CUDA versions, the card, its power limit;
2. build     - every kernel of ``src/repro_torch/csrc`` with nvcc, in
               parallel;
3. kernels   - each kernel against its plain PyTorch version on the card,
               at the main paths' shapes and at edge cases (fp32
               rtol=atol=1e-5, bf16 3e-2, argmax exact; flash in fp32 and
               bf16 at ragged kv_valid with a 0 row (exactly 0), causal
               and not, q_offset with Sq < Sk, every head dim (80 on
               every tile pair), many kv tiles, BSHD views at qwen2's,
               zamba2's, stablelm-3b's (32 heads of 80, timed beside
               SDPA) and mistral-large-123b's (G 12, Dh 128, timed with
               its bound, as are #2 and #3 at its heads and #3 at
               stablelm-3b's) shapes, and
               beside SDPA's flash backend on full-length rows; argmax with
               ties
               and NaN either side of its split boundaries, views from
               column 1, V = 32000, B = 1 and 64; both paged kernels
               across their cluster split (a row of 38 pages, rows
               shorter than the cluster, G = 32 at Dh 128, G = 1 at Dh 80,
               G = 12 at Dh 128, pages of 8 and 32, the scheduler's
               64-page table, stablelm-3b's decode (timed); a row of no
               past token exactly v_new), the fp kernel in fp32, bf16 and
               with fp32 pages under a bf16 query; the SSD
               scan, a reordered sum, at fp32 rtol=2e-4, atol=2e-5 (C and
               n at that tolerance for bf16 inputs too): ragged S, S <
               chunk, dv over two tiles, normalize, a carried state, log_f
               = -30, mLSTM's dk = dv = 512, xlstm-350m's prefill call
               ([8,512,4,512,512], normalize, a carried state, fp32 and
               bf16), the bf16 route's edges (4-byte
               rows, chunk 1024), the flat [512,512,64] layout, the
               scheduler's one-row admissions (B = 1, S = 64, 300, 512,
               timed) and zamba2's generate call, with the device time of
               the bf16 route's three passes; a bf16 call must run those
               three ``__global__`` functions and an fp32 call the CUDA-core
               one, by name under ``torch.profiler``); median
               times of the kernel, the plain version and, where one
               PyTorch call computes the same function, that call
               (``library_ms``; the port never calls it); the host's
               microseconds a call for flash and argmax beside their
               library calls, and for both paged wrappers with their
               split; the training attention's kernels
               (``csrc/flash_attention_train.cu``: forward, dQ, dK/dV)
               against their fp32 plain twin at the benchmark cell's
               [10, 2048, 14/2, 64], at Dh 80 and 128 and on strided
               views, causal and not (each output to its own limit,
               ``FLASH_TRAIN_TOL``: out and the gradients a row at a
               time, lse to 1e-5; the naive bf16 route they replace
               printed beside), one launch of each kernel a call, and at
               the cell's shape each kernel's device time beside the
               FLOP bound, and the plain twin's, the naive route's and
               SDPA's forward and backward (all under the profiler);
4. generate  - qwen2-0.5b at full width (24 layers, bf16, random weights
               from seed 0) serving 8 ragged prompts through
               ``Engine.generate`` with a paged KV cache, greedy, 32 new
               tokens;
5. scheduler - the same model behind ``BatchScheduler`` (8 slots, int8
               pages of 16 tokens, the prefix cache on): 32 requests
               sharing a 256-token prefix, ragged suffixes and budgets,
               priorities 0,1,1,2; every request completes, one host sync
               per segment, ``KVPool.check()`` and ``scheduler.check()``
               pass, tokens/s, mean TTFT and segments are printed;
6. tokens    - fp32, full width, 2 layers: the paged engine on the card
               (kernels), the dense engine on the card and the paged engine
               on the CPU (plain versions) must emit the same greedy tokens,
               and the card's prefill logits must match the CPU's within
               max|d| / max|logit| <= 1e-4;
7. sched fp32 - the same 2-layer model: the card's scheduler (paged, model-
               dtype pages, a fork inside a shared page) must give the
               card's ``Engine.generate`` tokens and the CPU scheduler's;
               int8 decode-step logits, card against CPU, within
               max|d| / max|logit| <= 1e-2 (a code can flip by one where
               the two devices round K differently);
8. zamba2 generate - zamba2-1.2b at full width and depth (38 Mamba2
               layers, the shared block at 7 points, bf16, random weights
               from seed 0): 8 prompts of 512 tokens through
               ``Engine.generate`` with dense KV, 32 greedy tokens; the SSD
               kernel launches 38 times, flash 7;
9. zamba2 scheduler - the same model behind ``BatchScheduler`` (6 slots,
               dense KV, max_seq 1024): 8 requests of 64-512-token
               prompts, budgets 16-48 (two wait in the queue for a slot
               a retired request frees mid-decode); every request completes, one host
               sync per segment, ``scheduler.check()`` passes, tokens/s and
               mean TTFT are printed;
10. zamba2 tokens - fp32, full width, 7 layers (two groups, the second
               partial): greedy tokens on the card (kernels) equal the
               CPU's (plain versions) on 300-token prompts, and prefill
               logits agree within max|d| / max|logit| <= 1e-4;
11. case kernels - the tool layer's case-study kernels against their plain
               versions (fp32 rtol=atol=1e-5, bf16 3e-2): STREAM triad at
               N = 128, 4096, 128*513 and 2^27, fp32 and bf16, one CTA at
               the small N, unaligned views, bit-equal across block_rows
               and one CTA; Jacobi-7 at T = 1..4 on (10,18,130),
               (16,26,130), (37,45,99) (ragged edge columns, bit-equal
               across tiles and streamed x extents; also T = 6 and 8, and
               T = 9 refused) and 512^3 (bit-equal
               across 16- and 4-byte copies and tiles); times as in phase
               3 (``library_ms``: ``torch.add(b, c, alpha=s, out=a)`` for
               the triad, also printed in bf16; a ``conv3d`` with the
               6-neighbour filter, cuDNN's TF32 off, is timed beside one
               naive sweep; the T = 4 wavefront against 4 naive sweeps in
               ms, MLUPS and declared GB/s);
12. perfctr  - the case studies at full size (triad 2^27 fp32, 100
               samples; Jacobi 512^3, 4 naive sweeps against one T=4
               wavefront) through ``PerfCtr`` marker regions with the HBM
               and ROOFLINE groups, then the bandwidth map (16 KiB .. 2
               GiB); fails if a region records no launch, if its
               ``LAUNCHES`` differ from the wrapper counters, or if a
               working set over 4x L2 reads above 105% of the data-sheet
               HBM bandwidth;
13. sampled  - qwen2-0.5b at full width and depth (bf16, the embedding
               scaled by 0.1 as in phase 6, pages of 16, the 8 ragged
               prompts of phase 4, 32 new tokens) through
               ``Engine.generate`` at temperature 0.7 with top_k 50, then
               top_p 0.9: the same seed twice gives the same tokens, one
               host sync a call (the draws must move a first step whose
               mean top-1 probability is under 0.5), and #4 launches 32
               times a call, #1 24 and #2 744; one step's #4 launch equals
               its plain twin over the same Gumbel-shifted logits (a
               top_k row is -inf outside its 50 tokens, and one row has a
               single finite entry); tokens/s;
14. speculative - K = 4 with a 2-layer draft sharing the target's
               embedding, final norm, head and first two blocks: in fp32
               (the embedding scaled by 0.1, as in phase 6) spec greedy
               tokens equal target-only greedy tokens, fused and streamed;
               in bf16 (phase 13's model) the accept rate, rounds, host
               syncs and tokens/s
               beside target-only's; then a ``BatchScheduler`` (6 slots,
               bf16 pages of 16, 8 requests, half with ``spec=True``; two
               wait in the queue):
               every request completes, one host sync a segment,
               ``KVPool.check()`` and ``scheduler.check()`` pass.  Each run
               must launch #1 once a layer of each prefill, #2 (K+1) x 2
               times a round and #4 K+3 times a round (``y``, the K+1 draft
               samples, the verify's argmax);
15. snapshots and chaos - (a) fp32, full width, 2 layers (phase 7's
               model, the embedding scaled by 0.1), fp32 pages of 16, the
               prefix cache on: a ``BatchScheduler`` with a snapshot every
               segment is stopped after 2 segments, a FRESH ``Engine``
               restores the newest snapshot and runs to the end; every
               request's tokens must equal an uninterrupted card run's and
               the restore must use the page index (#1, #2, #4 launch).
               (b) phase 5's model and traffic at full width and depth
               (bf16, the embedding scaled by 0.1 as in phases 13-14, int8
               pages): tokens/s with snapshots every 0 and every 1
               segment, one turn each (the tokens must not move),
               then ``ChaosSchedule.smoke()`` with a snapshot every 2
               segments, killed after 8 and restored on a fresh engine:
               every event applied (flap and death skipped on one card),
               ``KVPool.check()`` and ``scheduler.check()`` after every
               event, the corrupted snapshot refused by the loader and by
               ``Engine.restore``, every request terminal, #1, #3 and #4
               launched.  Host syncs = segments + snapshots that carry an
               index on every snapshot run.  Snapshot bytes and write ms,
               index pages, restore ms, tokens/s and the share of
               restored tokens equal to the uninterrupted run are printed
               beside the card's name and power limit;
16. serving benches - ``repro_torch.bench``'s ``bench_serve``,
               ``bench_paged_decode``, ``bench_flash_prefill`` and
               ``bench_spec`` (``run()`` at the JAX benches' default
               sizes), then ``bench_serve`` and ``bench_spec`` at
               qwen2-0.5b's full width (``--smoke`` reps and lengths):
               every correctness claim must hold (a failed claim raises);
               each speed bar's value and met/unmet is printed beside the
               card's name and power limit (a missed bar is printed, not
               fatal); each run must launch the kernels it serves through;
17. tool layer and registry - ``topology.probe()`` reads the real card
               (not synthetic, 1 chip, 132 SMs, L2 50 MiB, memory within
               10%, ``check_device`` empty, the name ``nvidia-smi``
               gives), ``python -m repro_torch.launch.topology -g --json``
               reads 1 chip, ``launch.pin --compare`` and ``launch.features
               --set ... --export --torch-settings`` run; qwen2-0.5b at full
               width and depth in fp32 (the embedding scaled by 0.1), pages
               of 16, 4 prompts, 16 greedy tokens: the default kernels
               (#1 24, #2 360, #4 16 launches) and the torch pins
               (``attention=torch_flash,paged_decode=torch_paged``) set
               through ``ServeConfig.impls``, ``REPRO_IMPL`` and the
               launcher's ``--impl`` (its own fp32 model) give equal
               tokens, the pinned runs launch #1 and #2 zero times; the
               int8 scheduler with ``paged_decode=torch_paged_q8`` gives
               the default's tokens with #3 launched 0 times;
               ``registry.run`` of ``ssd_scan`` (fp32 and bf16, a carried
               state), ``stream_triad`` and ``jacobi7`` (wavefront and
               naive), each kernel impl against the plain one within
               phases 3 and 11's tolerances; the host microseconds a paged
               decode call costs through ``registry.run`` beside the direct
               wrapper; ``python -m repro_torch.bench --only
               marker_overhead,perfctr,stream_pinning`` (both overhead
               cases printed beside the card's name and power limit);
18. tune half - the kernel registry's autotuner: (a) ``run_tune_suite``
               over ``perf_report.CARD_SUITE`` (every tunable family at the
               serving paths' shapes: qwen2 prefill and int8 / bf16 paged
               decode, argmax over 151936 logits, zamba2's SSD call, the
               triad at 2^27, Jacobi 512^3 at T = 4), cold in a fresh
               cache root and a fresh process (``bench_autotune --suite
               card``); each family's per-candidate device us, winner and
               default printed, and every measured candidate held to its
               plain version at phase 3's tolerances; (b) the same suite
               in another fresh process on that root: 0 sweeps, 0 timed
               probes, equal choices; (c) ``python -m
               repro_torch.launch.serve --arch qwen2-0.5b --page-size 16
               --kv-dtype int8 --tune`` at full width, bf16, cold then warm
               (0 timed probes), printing where each served call's tile
               came from; (d) fp32 qwen2-0.5b greedy (4 prompts, 16
               tokens) on the default tiles, then every call site it
               resolved autotuned at its own facts, then on the tuned
               tiles: equal tokens and launch counts, logits within phase
               6's bound.  Phases 1-17 run with ``REPRO_CACHE_DIR`` set to
               a fresh temporary root, so no earlier tune record moves
               their tiles;
19. xlstm    - xlstm-350m at full width and depth (12 mLSTM/sLSTM pairs,
               d_model 1024, 4 heads of 512, vocab 50304, bf16, random
               weights from seed 0, dense state): (a) ``Engine.generate``
               on 8 prompts of 512 tokens, 32 greedy tokens, #5 launched 12
               times (once a pair) for the prefill and #4 32 times; (b)
               ``BatchScheduler``, 4 requests of 64-512 tokens, budgets
               16-48, 3 slots (one waits in the queue), #5 launched 12
               times an admission; prefill
               ms, decode tokens/s and segments printed; (c) fp32 at 4 of
               24 layers: greedy tokens card (#5 in fp32) against CPU
               equal, prefill logits within 1e-4 of max|logit|;
20. dense configs - bf16, pages of 16: qwen1.5-0.5b and stablelm-3b
               (LayerNorm, Dh 80) at full width and depth, phase 4's
               prompts and 32 new tokens through ``Engine.generate``, then
               the int8 scheduler on phase 5's traffic cut to 8 requests;
               mistral-large-123b at full width and 2 of its 88 layers (G
               12), 4 prompts, 16 new tokens; each run launching #1 once a
               layer of each prefill, #2 (#3 under int8) once a layer a
               step and #4 once a step; (d) fp32 stablelm-3b at 2 layers,
               greedy tokens card against CPU equal, logits within 1e-4 of
               max|logit|; (e) ``python -m repro_torch.launch.perf_report``
               cold and warm in a fresh cache root, its report re-gated
               against the baseline it wrote and against the committed
               ``PERF_BASELINE.json`` (not comparable, unchanged), and
               ``examples/serve_batched_torch.py``;
21. moe       - bf16, pages of 16: (a) qwen2-moe-a2.7b at full width and
               depth (60 experts, top-4, a shared expert; random weights
               from seed 0), phase 4's prompts, 32 new tokens through
               ``Engine.generate``: one host sync, #1 24 times, #2 24 x
               31, #4 32, then one decode step under
               ``torch.cuda.set_sync_debug_mode("error")``; (b) its int8
               scheduler with the prefix cache on phase 5's traffic cut
               to 8 requests; (c) qwen3-moe-235b-a22b at full width and
               2 of its 94 layers (128 experts, top-8; G 16), 4 prompts,
               16 new tokens; (d) fp32 qwen2-moe-a2.7b at 2 layers, 4
               ragged prompts of at most 64 tokens, 16 greedy tokens card
               against CPU equal, every step's logits within 1e-4 of
               max|logit|, the router's smallest top-k margin printed.
               Phase 3 holds #1-#3 at these paths' shapes (Dh 128 at G 1
               and G 16);
22. vlm, encdec - bf16: (a) qwen2-vl-7b at full width and depth (28
               layers, 28 heads over 4 of 128, M-RoPE; random weights
               from seed 0), pages of 16: 8 prompts of 512-288 tokens
               with patch embeddings [8, 256, 3584] from a seeded
               generator, 32 new tokens through ``Engine.generate``: one
               host sync, #1 28 times, #2 28 x 31, #4 32; then its int8
               scheduler with the prefix cache on phase 5's traffic cut
               to 8 requests (text-only admissions, as the JAX
               scheduler's); (b) seamless-m4t-medium at full width and
               depth (12 encoder + 12 decoder layers, vocab 256206),
               dense KV: 8 prompts of 256 tokens with source embeddings
               [8, 64, 1024], 32 new tokens: #1 24 times (12 encoder
               launches, not causal; 12 decoder prefills), #4 32; (c)
               fp32, greedy tokens card against CPU equal and every
               sampled step's logits within 1e-5 of max|logit|:
               qwen2-vl-7b at 2 of its 28 layers on 3 prompts of 260-300
               tokens with patch embeddings, seamless-m4t-medium at full
               depth on 3 prompts of 256 tokens.  Phase 3 holds #1-#3
               at qwen2-vl's shapes, #1 at seamless's encoder (not
               causal, 64 positions) and decoder, and #4 at 8 x 256206,
               each bf16 one timed with its bound.
23. train     - (a) qwen2-0.5b at full width and depth (weights drawn on
               the host), bf16 compute
               over fp32 masters, remat ``dots_no_batch``, AdamW with
               clipping, warmup then cosine, 8 x 512 synthetic tokens a
               step: 8 steps through ``Trainer`` (one checkpoint, at 4),
               2 with ``accum_steps=2``; step ms (median after 3 warm-up
               steps), tokens/s, model FLOPs a step, MFU against 989
               TFLOP/s, peak ``max_memory_allocated``, launches a step
               and the device's idle share over two profiled steps, each
               beside the card's name and power limit; a fresh
               ``Trainer`` resumed from step 4 to 8, its losses within
               1e-2 of the uninterrupted run's; (b) fp32 card against
               CPU, qwen2-0.5b at full width and 2 of 24 layers, 3
               steps: every gradient finite and within 1e-4 (plus 1e-6
               of the largest), the loss, grad norm and rate within
               1e-5, every parameter after each step within Adam's
               bound and 1e-2 of a step on average; (c) one fp32 train
               step of each family at its SMOKE config, card against CPU,
               the same checks; kernels #1-#7 launch no time over
               (a)-(c): training runs the differentiable twins, as the
               reference's runs no Pallas kernel, and (a)'s bf16 steps
               the training attention's kernels (2L forward launches and
               L of each backward kernel a step under remat
               ``dots_no_batch``, counted over the two profiled steps);
               (d) ``python -m
               repro_torch.launch.serve --ckpt-dir`` on (a)'s
               checkpoints in a subprocess (it serves while (b) and (c)
               run): its restore gives (a)'s final weights bit for bit,
               its greedy tokens, admissions and segments equal a
               scheduler's on (a)'s in-memory weights, and it launches #1
               once a layer of each admission, #2 once a layer of each
               decode step and #4 once a decode step.  Phase 26 (b)'s
               ranks run beside (b)-(d), which time nothing.
24. mesh      - sharded serving (``Engine(mesh=ServeMesh)``) and its
               fault tolerance: (a) qwen2-0.5b at full width and depth,
               bf16, behind ``BatchScheduler`` (6 slots, model-dtype pages
               of 16, the prefix cache off, 8 requests with ragged
               prompts and budgets, two waiting in the queue) through a (1, 1) ``ServeMesh`` over
               NCCL (a world of one), ``ft_confirm=2``, a chaos schedule
               with one ``heartbeat_flap`` and one ``device_death``; the
               sharded engine takes the full model as a host copy on the
               CPU and allocates the card's blocks only (its card bytes
               are its shard's, checked): tokens equal the unsharded
               scheduler's; #1 launches L x
               admissions, #2 L x decode steps and #4 once a decode step
               in both runs, #3 never; the flap is applied and absorbed
               (0 re-meshes), the death skipped as "would kill the last
               device"; ``mesh_facts`` (1, 1) / model / 2; tokens/s
               beside the unsharded run's.  (b) three spawned ranks on
               ``cuda:0`` (gloo; its collectives on CUDA tensors are
               staged through host copies), qwen2-0.5b at full width and
               4 of 24 layers, fp32, a (1, 2) mesh plus one spare (1 kv
               head, 7 query heads a rank), each rank's full model a host
               copy on the CPU once the unsharded runs are done, so the
               card holds its blocks only (its allocated bytes checked
               against the model's half): ``Engine.generate`` and
               ``BatchScheduler`` tokens equal the unsharded engine's on
               fp32 and int8 pages, each mesh rank's #1 and #2 (#3 on
               int8) launching as the run implies at 1 kv head, the spare
               none; ``inject_failure(device_ids[1], at_segment=1)``: one
               re-mesh onto the spare ([0, 2]), the tokens after equal,
               the spare's decode launches taking over the dead rank's,
               ``remesh_latency_s`` printed.  (c) #2 and #3 at the
               per-device shape (KVH 1, G 7, Dh 64, 8 rows, bf16) against
               their plain versions, timed beside their bounds.  No NCCL
               or NVLink collective across cards is measured: (a) is a
               world of one and (b)'s collectives go through the host.
25. mesh train, moe mesh - (a) qwen2-0.5b at full width and depth,
               bf16 over fp32 masters, 8 x 512 synthetic tokens a step:
               6 steps through ``Trainer(mesh=, state_shardings=
               train_state_pspecs(...))`` on a (1, 1) mesh over NCCL (a
               world of one; the full model a host copy on the CPU) from
               phase 23 (a)'s host draw, held to phase 23 (a)'s first 6
               steps: losses and grad norms equal within 1e-3 relative,
               step ms side by side, the state's card bytes its tensors'
               beside the unsharded state's.  (b)
               four spawned ranks on ``cuda:0`` (gloo), qwen2-0.5b at full
               width and 2 of 24 layers, fp32, 4 x 128 tokens a step,
               the unsharded runs made once on the card beside them:
               ``Trainer(mesh=)`` for 3 steps on (2, 2), on (2, 1) with 2
               microbatches and on (1, 2) with int8 error feedback; each
               rank holds its losses and grad norms to the unsharded
               run's (1e-5 relative; 1e-4 with int8) and its slices of
               the parameters to the unsharded run's as phase 23 (b)
               holds the card's to the CPU's, and its card bytes to its
               slices' (FSDP's d_model halves on a data axis of 2); the
               (2, 2) run's checkpoint (whole leaves, written by its
               first rank) resumed on (1, 2) for 2 steps, equal to the
               unsharded run's.  (c) two spawned ranks on ``cuda:0``
               (gloo), qwen2-moe-a2.7b at full width and 2 of 24 layers,
               fp32, a (1, 2) mesh (30 experts and 8 kv heads a rank; the
               router whole): ``Engine.generate`` and ``BatchScheduler``
               tokens equal the unsharded engine's on fp32 and int8
               pages, each rank's #1, #2 (#3 on int8) and #4 launching as
               the run implies, the card's bytes the shard's.  (d) #1 at
               qwen2-moe's per-device prefill [8, 8, 512, 128] (SDPA with
               the mask beside it) and #2 and #3 at its per-device decode
               (KVH 8, G 1, Dh 128, 8 rows), bf16, against their plain
               versions, timed beside their bounds.
26. family mesh - (a) zamba2-1.2b and xlstm-350m at full width and
               depth, seamless-m4t-medium at 12 + 12 layers, bf16, each
               through a (1, 1) ``ServeMesh`` over NCCL (a world of one;
               the full model a host copy on the CPU, the card's bytes
               its shard's) beside the unsharded engine: 4 equal-length
               prompts of 64 tokens (seamless with source frames), 8
               greedy tokens, and 6 ragged scheduler requests for the
               hybrid and xlstm (the scheduler refuses encdec in both
               packages): tokens and launches equal; zamba2-1.2b at full
               width and 8 layers (two applications of the shared block)
               through ``Trainer(mesh=)`` on (1, 1) beside the unsharded
               ``Trainer``, 3 steps of 4 x 128 tokens, bf16 over fp32
               masters: losses and grad norms within 1e-3 relative, no
               kernel launched.  (b) three spawned ranks on ``cuda:0``
               (gloo, host-staged), fp32, full width: zamba2 at 8
               layers, xlstm at 2 pairs, seamless at 2 + 2, each on a
               (1, 2) mesh plus a spare: ``generate`` (and the hybrid's
               and xlstm's scheduler) tokens equal the unsharded engine's
               on the card; a kill of rank 1 in the hybrid's scheduler
               re-meshed onto the spare ([0, 2]), tokens equal; one
               training step of each family on (1, 2): loss and grad norm
               within 1e-5 relative (xlstm 1e-3); each rank's card bytes
               against its shard's (half of the split weights plus the
               leaves its layout keeps whole).  (b)'s ranks run beside
               phase 23 (b)-(d), which time nothing, and are joined
               before phase 24; their unsharded runs and the checks are
               here.  (c) #5 at zamba2's (1, 2) prefill (32 of 64
               heads, P = N = 64, 8 x 512) and xlstm's (2 of 4 heads, dk
               = dv = 512), #1 at zamba2's shared block (16 of 32 heads,
               Dh 64, causal) and seamless's encoder (8 of 16 heads, Dh
               64, not causal, 64 frames), bf16, against their plain
               versions, timed beside their bounds and #1 beside SDPA;
               each row's launches a rank from (b).  (d) last, alone:
               the perfctr CLI's ``main`` in this process, ``-g ROOFLINE
               --arch zamba2-1.2b --shape decode_32k --execute``: the dry
               run's record (one rank of the 16 x 16 mesh walked on
               ``meta``) with status ``ok``, the SMOKE loss timed on the
               card.
27. layouts - the reference's decode-state layout and sequence
               parallelism.  (a) qwen2-vl-7b at full width and 2 of 28
               layers, fp32, one train step of 2 x 384 tokens (its 256
               patch positions first) through ``Trainer(mesh=)`` on a
               (1, 2) mesh of two spawned ranks on ``cuda:0`` (gloo),
               without and with ``act_seq -> model``: loss and grad norm
               within 1e-5 relative of the unsharded step on the card;
               each rank's peak allocated bytes printed both ways.  (b)
               on the same ranks, qwen2-0.5b at full width and depth,
               fp32: 8 prompts of 32 tokens prefilled on the card
               (kernel #1), the cache cut into two sequence slices by
               ``LM.state_pspecs``, then into ``kv_shard="headdim"``'s
               head-dim halves, 16 greedy tokens (kernel #4) from each
               cut: tokens equal
               ``Engine.generate``'s unsharded, logits within 1e-4 of
               max|logit|, each rank's KV bytes half the whole state's.
               (c) the dry run's ``qwen2-0.5b/decode_32k/16x16`` and
               ``zamba2-1.2b/long_500k/16x16`` walked in this process:
               their KV cache a rank.  The ranks run beside phase 23
               (b)-(d), which time nothing; the unsharded runs and the
               checks are here.

Phases 4, 5, 8, 9, 12, 13, 14, 15, each run of 16, 17's serving runs,
18's suite (its launches counted in its process) and tuned generate, the
serving runs of 19, 20, 21, 22 and 23's served checkpoint, 24's mesh
runs, 25's moe mesh runs, 26's serving runs and 27's prefill and
decodes are the main paths: each
is run with its kernels' launch counters set to 0 just before it and
read just after, and fails if one of its kernels never launched (or, on
the serving paths, launched another number of times than the path
implies); the training runs of 23, 25 and 26 (a) go the other way
round: they fail if any of #1-#7 launched.  The last two lines of stdout are the kernel table as JSON (``launches`` from the path
that carries each kernel, ``launches_by_path`` from every path that runs
it) and the result line ``{"ok": true, "device": {...}}``.  It never
imports JAX or the JAX package.

On a host with four cards,

    python3 chip_smoke.py --train-mesh-four-cards

runs only phase 25 (b)'s rank body, one rank a card over NCCL:
qwen2-0.5b at full depth, phase 23's 8 x 512 tokens, 6 steps on (2, 2),
in bf16 over fp32 masters and in fp32, beside the unsharded runs on one
card (their step ms); fp32 losses and grad norms within 1e-4 relative,
bf16 losses within 1e-2 (each rank rounds its partial sums to bf16
before the reduce), bf16 grad norms' gaps printed; and the fp32 run
again under sequence parallelism (``act_seq -> model``: NCCL's
``reduce_scatter_tensor`` out of each row-parallel product), held to the
same unsharded fp32 run within 1e-4.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
#: this run's temporary directory (artifact-cache roots), removed at exit
TMP_ROOT = None

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense tensor-core bf16 peak
F32_FLOPS = 67e12                # fp32 on CUDA cores (triad, stencil)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
#: fp32 logits that went through a whole model, held to each other:
#: max|d| / max|logit| (phases 6 and 17); over int8 pages (phases 7 and
#: 17) a difference in the last bit can move a quantized code by one
LOGITS_REL_TOL = 1e-4
LOGITS_REL_TOL_INT8 = 1e-2
PROMPT_LENS = [512, 384, 301, 256, 129, 64, 17, 1]
MAX_NEW = 32
PAGE_SIZE = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def gpu_name_and_limit() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class Timer:
    """Median per-launch device time with CUDA events; the 50 MB L2 cache
    is flushed before every launch."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps: int = 25) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    device runs behind): what a call costs a host-bound decode step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_bound(q, k, lens, causal=True):
    """A ragged prefill's bound: q read whole and the output written
    whole (a row past its prompt still attends to the prompt's keys, so
    its output depends on its q), only each row's ``lens`` valid keys and
    values read, ``kv_valid``'s int32s; 4 Dh FLOPs a (query, key) pair a
    head that the mask keeps."""
    b, h, sq, dh = q.shape
    nbytes = (q.element_size() * (2 * q.numel() + 2 * sum(lens) * k.shape[1]
                                  * dh) + 4 * b)
    pairs = sum(min(i + 1, n) if causal else n for n in lens
                for i in range(sq))
    return bound_ms(nbytes, 4.0 * dh * h * pairs)


def close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    tol = TOL[want.dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    err = (got.float() - want.float()).abs().max().item()
    log(f"  ok {name}: max|err| {err:.3g} (rtol=atol={tol['rtol']})")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def check_flash(dev, timer):
    from repro_torch.kernels.flash_attention import (FLASH_PAIRS,
                                                     flash_attention_bhsd,
                                                     flash_attention_plain)
    rng = np.random.default_rng(0)

    def case(b, h, kvh, sq, sk, dh, dtype, causal, q_offset, kv_valid,
             bshd=False):
        """Every (bq, bk) pair the kernel builds for ``dtype`` against the
        plain version (the tuner may serve any of them); returns the
        default pair's max|err|."""
        def rnd(n, s):              # BSHD transposed to BHSD, as the model
            if bshd:
                return torch.from_numpy(rng.standard_normal(
                    (b, s, n, dh), np.float32)).to(dev, dtype).transpose(1, 2)
            return torch.from_numpy(rng.standard_normal(
                (b, n, s, dh), np.float32)).to(dev, dtype)

        q, k, v = rnd(h, sq), rnd(kvh, sk), rnd(kvh, sk)
        kvv = torch.tensor(kv_valid, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, q_offset=q_offset, kv_valid=kvv)
        want = flash_attention_plain(q, k, v, **kw)
        errs = []
        for bq, bk in FLASH_PAIRS[dtype]:
            got = flash_attention_bhsd(q, k, v, bq=bq, bk=bk, **kw)
            torch.cuda.synchronize()
            name = (f"flash ({bq}, {bk}) b{b} h{h}/{kvh} sq{sq} sk{sk} "
                    f"dh{dh} {str(dtype)[6:]} causal={causal} "
                    f"q_offset={q_offset} kv_valid={kv_valid}"
                    f"{' bshd views' if bshd else ''}")
            for i, n in enumerate(kv_valid):
                if n == 0 and got[i].any():
                    fail(f"{name}: row {i} has no live key but is not 0")
            errs.append(close(name, got, want))
        return errs[0], (q, k, v, kw)

    # edge cases, in fp32 (CUDA cores) and bf16 (tensor cores), each at
    # every (bq, bk) pair: ragged kv_valid including 0, S not a multiple
    # of any tile, causal and not, q_offset > 0 with Sq < Sk, every head
    # dim, many kv tiles through the two-stage ring
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            case(3, 4, 2, 100, 100, 64, dtype, causal, 0, [100, 0, 37])
        case(3, 4, 2, 45, 130, 64, dtype, True, 85, [130, 90, 120])
        case(2, 4, 2, 70, 70, 16, dtype, True, 0, [70, 0])
        case(2, 6, 2, 70, 70, 32, dtype, True, 0, [70, 5])
        case(2, 4, 1, 33, 33, 128, dtype, False, 0, [33, 20])
        # stablelm-3b's head dim 80 (10 16-byte chunks a row, the last 2
        # outside the bf16 swizzle): ragged with a 0 row, causal and not,
        # q_offset with Sq < Sk, S off every tile
        for causal in (True, False):
            case(3, 4, 2, 100, 100, 80, dtype, causal, 0, [100, 0, 37])
        case(3, 4, 4, 45, 130, 80, dtype, True, 85, [130, 90, 120])
    case(1, 4, 2, 1000, 1000, 64, torch.bfloat16, True, 0, [1000])
    case(2, 2, 1, 200, 1500, 128, torch.bfloat16, False, 0, [1500, 1399])
    # the main paths' prefill shapes: qwen2-0.5b (14 q heads over 2 kv
    # heads) and zamba2-1.2b's shared block (32 heads, G = 1), as the
    # model passes them (BSHD views)
    s = max(PROMPT_LENS)
    case(8, 14, 2, s, s, 64, torch.bfloat16, True, 0, PROMPT_LENS, bshd=True)
    case(ZAMBA_PROMPTS, 32, 32, ZAMBA_PROMPT_LEN, ZAMBA_PROMPT_LEN, 64,
         torch.bfloat16, True, 0, [ZAMBA_PROMPT_LEN] * ZAMBA_PROMPTS,
         bshd=True)
    case(8, 14, 2, s, s, 64, torch.float32, True, 0, PROMPT_LENS)
    # the dense configs' prefill shapes: stablelm-3b (32 heads of 80, G =
    # 1) and mistral-large-123b (96 heads over 8 of 128, G = 12)
    _, (q80, k80, v80, kw80) = case(8, 32, 32, s, s, 80, torch.bfloat16,
                                    True, 0, PROMPT_LENS, bshd=True)
    case(8, 32, 32, s, s, 80, torch.float32, True, 0, PROMPT_LENS)
    case(4, 96, 8, 256, 256, 128, torch.bfloat16, True, 0, [256, 200, 77, 9],
         bshd=True)
    # phase 20's prefills at their own shapes: qwen1.5-0.5b (16 heads of
    # 64, G 1) on phase 4's prompts, mistral-large-123b on its 4 prompts
    h, kvh, dh = attn_shape("qwen1.5-0.5b")
    case(8, h, kvh, s, s, dh, torch.bfloat16, True, 0, PROMPT_LENS, bshd=True)
    h, kvh, dh = attn_shape("mistral-large-123b")
    sm = max(MISTRAL_PROMPT_LENS)
    _, mistral_args = case(MISTRAL_PROMPTS, h, kvh, sm, sm, dh,
                           torch.bfloat16, True, 0, MISTRAL_PROMPT_LENS,
                           bshd=True)
    # phase 21's prefills at their own shapes: qwen2-moe-a2.7b (16 heads
    # of 128, G 1) on phase 4's prompts in bf16 and on (d)'s prompts in
    # fp32, qwen3-moe-235b-a22b (64 heads over 4 of 128, G 16) on its 4
    # prompts; the bf16 ones timed, with phase 20's mistral-large-123b
    h, kvh, dh = attn_shape("qwen2-moe-a2.7b")
    _, moe_args = case(8, h, kvh, s, s, dh, torch.bfloat16, True, 0,
                       PROMPT_LENS, bshd=True)
    sf = max(MOE_FP32_PROMPT_LENS)
    case(len(MOE_FP32_PROMPT_LENS), h, kvh, sf, sf, dh, torch.float32, True,
         0, list(MOE_FP32_PROMPT_LENS), bshd=True)
    h, kvh, dh = attn_shape("qwen3-moe-235b-a22b")
    s3 = max(QWEN3_PROMPT_LENS)
    _, q3_args = case(QWEN3_PROMPTS, h, kvh, s3, s3, dh, torch.bfloat16,
                      True, 0, QWEN3_PROMPT_LENS, bshd=True)
    for what, (qm, km, vm, kwm), lens in (
            ("qwen2-moe-a2.7b's prefill [8,16,512,128] G 1", moe_args,
             PROMPT_LENS),
            ("qwen3-moe-235b-a22b's prefill [4,64,384,128] G 16", q3_args,
             QWEN3_PROMPT_LENS),
            ("mistral-large-123b's prefill [4,96,384,128] G 12",
             mistral_args, MISTRAL_PROMPT_LENS)):
        msm = timer.ms(lambda: flash_attention_bhsd(qm, km, vm, **kwm))
        bd = flash_bound(qm, km, lens)
        log(f"  flash bf16 at {what} ragged: kernel {msm:.4f} ms, bound "
            f"{bd[0]:.5f} ms by {bd[1]}")
    del moe_args, q3_args, mistral_args
    # phase 22's prefills at their own shapes: qwen2-vl-7b (28 heads over
    # 4 of 128, G 7; M-RoPE'd q and k are inputs like any other) on its 8
    # prompts in bf16 and on (c)'s prompts in fp32; seamless-m4t-medium
    # (16 heads of 64, G 1): the encoder, not causal, over the 64 source
    # positions and the decoder, causal, over the 256 target tokens, in
    # bf16 (8 rows) and fp32 (3 rows); the bf16 ones timed
    from repro_torch.bench.profile_generate import VLM_LENS
    from repro_torch.configs import get_arch
    h, kvh, dh = attn_shape("qwen2-vl-7b")
    sv = max(VLM_LENS)
    _, vlm_args = case(len(VLM_LENS), h, kvh, sv, sv, dh, torch.bfloat16,
                       True, 0, list(VLM_LENS), bshd=True)
    sf = max(VLM_FP32_PROMPT_LENS)
    case(len(VLM_FP32_PROMPT_LENS), h, kvh, sf, sf, dh, torch.float32, True,
         0, list(VLM_FP32_PROMPT_LENS), bshd=True)
    h, kvh, dh = attn_shape("seamless-m4t-medium")
    ss = ENCDEC_PROMPT_LEN // get_arch("seamless-m4t-medium").config.src_ratio
    st = ENCDEC_PROMPT_LEN
    timed = [("qwen2-vl-7b's prefill [8,28,512,128] G 7 ragged", vlm_args,
              VLM_LENS, True)]
    for b, dtype in ((ENCDEC_PROMPTS, torch.bfloat16),
                     (ENCDEC_FP32_PROMPTS, torch.float32)):
        _, enc_args = case(b, h, kvh, ss, ss, dh, dtype, False, 0, [ss] * b,
                           bshd=True)
        _, dec_args = case(b, h, kvh, st, st, dh, dtype, True, 0, [st] * b,
                           bshd=True)
        if dtype == torch.bfloat16:
            timed += [(f"seamless-m4t-medium's encoder [8,16,{ss},64] not "
                       f"causal", enc_args, [ss] * b, False),
                      (f"seamless-m4t-medium's decoder prefill "
                       f"[8,16,{st},64] causal", dec_args, [st] * b, True)]
    for what, (qm, km, vm, kwm), lens, causal in timed:
        msm = timer.ms(lambda: flash_attention_bhsd(qm, km, vm, **kwm))
        bd = flash_bound(qm, km, lens, causal)
        log(f"  flash bf16 at {what}: kernel {msm:.4f} ms, bound "
            f"{bd[0]:.5f} ms by {bd[1]}")
    del vlm_args, enc_args, dec_args, timed
    ke80, ve80 = k80.contiguous(), v80.contiguous()
    kpos = torch.arange(s, device=dev)
    mask80 = ((kpos[None, :] <= kpos[:, None])[None, None]
              & (kpos[None, None, None, :]
                 < kw80["kv_valid"][:, None, None, None]))
    q80c = q80.contiguous()
    ms80 = timer.ms(lambda: flash_attention_bhsd(q80, k80, v80, **kw80))
    sdpa80 = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q80c, ke80, ve80, attn_mask=mask80))
    b80 = flash_bound(q80, k80, PROMPT_LENS)
    log(f"  flash bf16 at stablelm-3b's prefill [8,32,512,80] ragged: "
        f"kernel {ms80:.4f} ms, SDPA with the mask {sdpa80:.4f} ms, bound "
        f"{b80[0]:.5f} ms by {b80[1]}")
    del q80, k80, v80, ke80, ve80, q80c, mask80
    err, (q, k, v, kw) = case(8, 14, 2, s, s, 64, torch.bfloat16, True, 0,
                              PROMPT_LENS)

    ms = timer.ms(lambda: flash_attention_bhsd(q, k, v, **kw))
    plain_ms = timer.ms(lambda: flash_attention_plain(q, k, v, **kw))
    g = q.shape[1] // k.shape[1]
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    kpos = torch.arange(s, device=dev)
    kvv = kw["kv_valid"]
    mask = ((kpos[None, :] <= kpos[:, None])[None, None]
            & (kpos[None, None, None, :] < kvv[:, None, None, None]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timer.ms(lambda: sdpa(q, ke, ve, attn_mask=mask))
    # the yardstick above takes SDPA off its flash backend (a boolean
    # mask); beside it, SDPA's flash backend on full-length causal rows
    from torch.nn.attention import SDPBackend, sdpa_kernel
    full = dict(causal=True, kv_valid=torch.full_like(kvv, s))
    full_ms = timer.ms(lambda: flash_attention_bhsd(q, k, v, **full))
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            t = timer.ms(lambda: sdpa(q, ke, ve, is_causal=True))
        sdpa_flash_ms = f"{t:.4f} ms"
    except RuntimeError as e:       # a yardstick only: say why it is missing
        sdpa_flash_ms = f"not available ({str(e).splitlines()[0]})"
    log(f"  flash bf16 [8,14,512,64] full-length causal rows: kernel "
        f"{full_ms:.4f} ms, SDPA flash backend (is_causal) {sdpa_flash_ms}")
    log(f"  flash host us a call: wrapper "
        f"{host_us(lambda: flash_attention_bhsd(q, k, v, **kw)):.2f}, SDPA "
        f"with the mask {host_us(lambda: sdpa(q, ke, ve, attn_mask=mask)):.2f}")
    bms, by = flash_bound(q, k, PROMPT_LENS)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:46",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


#: the training kernels' cases (B, S, H, KVH, Dh), each causal and not:
#: the benchmark cell's qwen2-0.5b at 10 x 2048 tokens (G 7, Dh 64), one
#: query tile short of a full one, stablelm-3b's Dh 80 (G 1) and
#: qwen2-vl-7b's Dh 128 (G 7) at S off every tile, and q, k, v as strided
#: views of wider tensors
FLASH_TRAIN_CELL = (10, 2048, 14, 2, 64)
FLASH_TRAIN_CASES = (FLASH_TRAIN_CELL, (1, 100, 4, 2, 64),
                     (2, 1000, 32, 32, 80), (2, 777, 28, 4, 128))
#: the kernels against the fp32 plain twin on the same bf16 inputs.  out,
#: dq, dk, dv: the worst row of ``flash_train_row_err`` (a row's error over
#: its own norm), the backward's twin given the kernel's own bf16 out (D =
#: rowsum(dO * O) of an early causal row, over few keys, cancels against
#: dP, and the out's own rounding is out's to answer for).  The kernels
#: round out, dq, dk, dv to bf16 (2^-9 relative) and P and dS to bf16
#: before their products; a CPU emulation of those roundings at [1, 2048,
#: 7/1, 64] reads 0.0031-0.0044 a row, and the H100 at every case out
#: 0.0029-0.0035, dq 0.0037-0.0048, dk 0.0034-0.0044, dv 0.0031-0.0039, so
#: 0.03 leaves 6x above the worst; a 64-key tile left out of one 64-row
#: query tile reads 0.56-0.69 in out and dq, of a key tile's queries
#: 0.89-1.05 in dk (19x or more below).  lse: max|got - want| / max|want|,
#: read 1.7e-7 to 2.2e-7 on the H100 (1e-5: 45x above); the same missing
#: tile moves it by 7e-3 to 1.3e-2 (700x below)
FLASH_TRAIN_TOL = dict(out=0.03, lse=1e-5, dq=0.03, dk=0.03, dv=0.03)


def flash_train_row_err(got, want, floor=1e-2):
    """The worst row's ``|got - want| / (|want| + floor * rms|want|)``
    over the last dim (a row: one position and head); ``floor`` keeps a
    row whose gradient is near zero from dividing by it."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    n = w.norm(dim=-1)
    rms = n.square().mean().sqrt()
    return ((g - w).norm(dim=-1) / (n + floor * rms)).max().item()


def flash_train_flops(b, s, h, dh, causal, backward=False):
    """FLOPs the attention needs: two products (QK^T, PV) forward, five
    backward (S, dP, dV, dK, dQ), 2 Dh a (query, key) pair the mask keeps
    and a head."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return (10.0 if backward else 4.0) * b * h * dh * pairs


def check_flash_train(dev):
    """Phase 3's training kernels (``csrc/flash_attention_train.cu``):
    forward and backward against the fp32 plain twin at
    :data:`FLASH_TRAIN_CASES`, each output to its own limit in
    :data:`FLASH_TRAIN_TOL`, and beside them the route they replace (the
    naive path in bf16 under autograd) against the same twin; one launch
    of each kernel a call.  Then, at the cell's shape, causal, the device
    ms (profiler, every kernel a call launched) of the kernels beside the
    FLOP bound, of the plain twin, the naive route and SDPA's forward and
    backward (``library_ms``; the port never calls it)."""
    from repro_torch.bench.profile_generate import _profiled
    from repro_torch.core.devtime import device_time_us
    from repro_torch.kernels import flash_attention_train as ft
    from repro_torch.models.attention import _full_attention_offset
    rng = np.random.default_rng(5)
    worst = 0.0

    def rnd(b, s, n, dh, pad=0):
        x = torch.from_numpy(rng.standard_normal(
            (b, s, n + pad, dh), np.float32)).to(dev, torch.bfloat16)
        return x[:, :, pad:] if pad else x

    def errs(names, got, want):
        return {n: (((g.float() - w).abs().max() / w.abs().max()).item()
                    if n == "lse" else flash_train_row_err(g, w))
                for n, g, w in zip(names, got, want)}

    for b, s, h, kvh, dh in FLASH_TRAIN_CASES:
        pad = 2 if (b, s) == (1, 100) else 0
        for causal in (True, False):
            q, k, v = rnd(b, s, h, dh, pad), rnd(b, s, kvh, dh, pad), \
                rnd(b, s, kvh, dh, pad)
            do = rnd(b, s, h, dh)
            before = dict(ft.LAUNCHES)
            out, lse = ft.flash_train_forward(q, k, v, causal=causal)
            grads = ft.flash_train_backward(q, k, v, out, lse, do,
                                            causal=causal)
            torch.cuda.synchronize()
            launched = {n: ft.LAUNCHES[n] - before[n] for n in before}
            if launched != {"fwd": 1, "bwd_dq": 1, "bwd_dkdv": 1}:
                fail(f"flash_train launches {launched}")
            f32 = [t.float() for t in (q, k, v)]
            w_out, w_lse = ft.flash_train_plain_forward(*f32, causal=causal)
            want = (w_out, w_lse) + ft.flash_train_plain_backward(
                *f32, out.float(), w_lse, do.float(), causal=causal)
            got = errs(("out", "lse", "dq", "dk", "dv"), (out, lse) + grads,
                       want)
            # the route the training step took before: the naive path's
            # bf16 ops under autograd, against the same twin
            qn, kn, vn = (t.detach().clone().requires_grad_(True)
                          for t in (q, k, v))
            on = _full_attention_offset(qn, kn, vn, 0, causal, None, "naive")
            gn = torch.autograd.grad(on, (qn, kn, vn), do)
            naive = errs(("out", "dq", "dk", "dv"), (on,) + gn,
                         want[:1] + want[2:])
            del on, gn, qn, kn, vn
            name = (f"flash_train b{b} s{s} h{h}/{kvh} dh{dh} "
                    f"causal={causal}{' strided views' if pad else ''}")
            log(f"  {name}: worst row's error (lse: max|err| / max|want|) "
                + ", ".join(f"{n} {e:.3g}" for n, e in got.items())
                + "; the naive bf16 path "
                + ", ".join(f"{n} {e:.3g}" for n, e in naive.items()))
            bad = {n: e for n, e in got.items()
                   if not e <= FLASH_TRAIN_TOL[n]}
            if bad:
                fail(f"{name}: over {FLASH_TRAIN_TOL}: {bad}")
            worst = max(worst, *got.values())
            del want, w_out, w_lse, out, lse, grads
            torch.cuda.empty_cache()

    # the cell's shape, causal: device ms a call, every kernel it launched
    b, s, h, kvh, dh = FLASH_TRAIN_CELL
    q, k, v, do = rnd(b, s, h, dh), rnd(b, s, kvh, dh), rnd(b, s, kvh, dh), \
        rnd(b, s, h, dh)
    reps = 5

    def device_ms(fn):
        """(device ms a call of ``fn``, each kernel's device ms a call)"""
        fn()
        torch.cuda.synchronize()
        _, avgs = _profiled(lambda: [fn() for _ in range(reps)])
        each = {a.key: device_time_us(a) / reps / 1e3 for a in avgs}
        return sum(each.values()), each

    def kernels():
        o, l_ = ft.flash_train_forward(q, k, v, causal=True)
        ft.flash_train_backward(q, k, v, o, l_, do, causal=True)

    ms, each = device_ms(kernels)
    dev_ms = {n: sum(t for key, t in each.items()
                     if f"flash_train_{n}_kernel" in key)
              for n in ("fwd", "bwd_dq", "bwd_dkdv")}
    out, lse = ft.flash_train_forward(q, k, v, causal=True)
    f_fwd = flash_train_flops(b, s, h, dh, True)
    f_bwd = flash_train_flops(b, s, h, dh, True, backward=True)
    io = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
    fb, fby = bound_ms(io, f_fwd)
    bb, bby = bound_ms(2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
                       f_bwd)
    pf = [t.float() for t in (q, k, v)]

    def plain():
        po, pl = ft.flash_train_plain_forward(*pf)
        ft.flash_train_plain_backward(*pf, po, pl, do.float())

    plain_ms, _ = device_ms(plain)
    del pf
    torch.cuda.empty_cache()
    qn, kn, vn = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def naive():
        on = _full_attention_offset(qn, kn, vn, 0, True, None, "naive")
        torch.autograd.grad(on, (qn, kn, vn), do)

    naive_ms, _ = device_ms(naive)
    del qn, kn, vn
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))

    def library():
        lo = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
        torch.autograd.grad(lo, (qs, ks, vs), do.transpose(1, 2))

    try:
        library_ms, _ = device_ms(library)
        lib = f"SDPA {library_ms:.4f} ms"
    except (RuntimeError, TypeError) as e:  # a yardstick only: say why
        library_ms = None
        lib = f"SDPA not available ({str(e).splitlines()[0]})"
    log(f"  flash_train [{b}, {s}, {h}/{kvh}, {dh}] causal: device ms "
        + ", ".join(f"{n} {t:.4f}" for n, t in dev_ms.items())
        + f"; every kernel of a forward and backward {ms:.4f}")
    fwd_dev = dev_ms["fwd"]
    bwd_dev = dev_ms["bwd_dq"] + dev_ms["bwd_dkdv"]
    log(f"  bound: forward {fb:.4f} ms ({f_fwd / 1e9:.1f} GFLOP, by {fby}),"
        f" backward {bb:.4f} ms ({f_bwd / 1e9:.1f} GFLOP, by {bby}); "
        f"share of the bound: forward {fb / fwd_dev:.3f}, backward "
        f"{bb / bwd_dev:.3f} [{gpu_name_and_limit()}]")
    log(f"  yardsticks, forward + backward, device ms: plain twin fp32 "
        f"{plain_ms:.4f}, the naive bf16 route {naive_ms:.4f}, {lib}")
    log(f"  host us a call: forward wrapper "
        f"{host_us(lambda: ft.flash_train_forward(q, k, v), n=50):.2f}, "
        f"backward wrapper (two launches) "
        f"{host_us(lambda: ft.flash_train_backward(q, k, v, out, lse, do), n=50):.2f}")
    return dict(name="flash_attention_train", route="cuda",
                source="src/repro_torch/csrc/flash_attention_train.cu",
                replaces="none (the JAX package trains through plain ops)",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=fb + bb, bound_by=fby, library_ms=library_ms)


def plan_table(lens, extra, ps, rng=None, width=None):
    """Row-major page table as Engine._page_plan lays it out (optionally
    with shuffled physical ids and garbage past the live pages, and
    widened to ``width`` pages a row, as the scheduler's pool tables)."""
    per_row = [-(-(n + extra) // ps) for n in lens]
    width = max(max(per_row), width or 0)
    num_pages = -(-(1 + sum(per_row)) // 16) * 16
    table = np.zeros((len(lens), width), np.int32)
    ids = np.arange(1, 1 + sum(per_row))
    if rng is not None:
        ids = rng.permutation(ids)
    nxt = 0
    for i, npg in enumerate(per_row):
        table[i, :npg] = ids[nxt:nxt + npg]
        nxt += npg
        if rng is not None:          # dead entries: in-range garbage
            table[i, npg:] = rng.integers(0, num_pages, width - npg)
    return table, num_pages


def check_paged(dev, timer):
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_grouped, paged_decode_plain, split_plan)
    rng = np.random.default_rng(1)

    def case(lens, kvh, g, dh, ps, dtype, extra, shuffle, width=None,
             page_dtype=None):
        b = len(lens)
        table, num_pages = plan_table(lens, extra, ps,
                                      rng if shuffle else None, width)

        def rnd(*shape, dt=dtype):
            return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                    ).to(dev, dt)

        pdt = page_dtype or dtype
        args = (rnd(b, kvh, g, dh), rnd(num_pages, ps, kvh, dh, dt=pdt),
                rnd(num_pages, ps, kvh, dh, dt=pdt),
                torch.from_numpy(table).to(dev),
                torch.tensor(lens, dtype=torch.int32, device=dev),
                rnd(b, kvh, dh), rnd(b, kvh, dh))
        got = paged_decode_attention_grouped(*args)
        want = paged_decode_plain(*args)
        torch.cuda.synchronize()
        np_w = table.shape[1]
        name = (f"paged lens={lens} kvh{kvh} g{g} dh{dh} ps{ps} "
                f"{str(dtype)[6:]} pages {str(pdt)[6:]} shuffled={shuffle} "
                f"NP={np_w} split={split_plan(b, kvh, np_w)}")
        err = close(name, got, want)
        for i, n in enumerate(lens):  # an empty row outputs exactly v_new
            if n == 0 and not torch.equal(
                    got[i], args[6][i][:, None, :].expand_as(got[i])):
                fail(f"{name}: row {i} has no past token but is not v_new")
        return err, args

    # length 0, 1, a partial page and multi-page lengths; shuffled
    # (non-contiguous) tables with garbage past the live pages
    case([0, 1, 10, 40], 2, 7, 64, 16, torch.float32, 4, True)
    case([0, 1, 5, 33, 64], 2, 4, 32, 8, torch.float32, 3, True)
    case([3, 17], 1, 7, 128, 16, torch.float32, 2, True)
    case([9, 0, 30], 2, 7, 16, 16, torch.bfloat16, 5, True)
    # the cluster split: a row of 38 pages (past 8 CTAs x 4 ring slots)
    # beside rows shorter than the cluster, a row of 0 pages and a
    # partial one; G = 32 at Dh 128 (fp32 pages take the shared-memory
    # opt-in); pages of 8 and 32 tokens; the scheduler's table width (64
    # pages a row) far past the live pages; fp32, bf16 and fp32 pages
    # under a bf16 query
    for dtype, pdt in ((torch.float32, None), (torch.bfloat16, None),
                       (torch.bfloat16, torch.float32)):
        case([600, 0, 5, 20, 47], 2, 7, 64, 16, dtype, 3, True, None, pdt)
        case([300, 1, 0, 65], 1, 32, 128, 16, dtype, 2, True, None, pdt)
        case([250, 7, 0, 40], 2, 7, 64, 8, dtype, 1, True, None, pdt)
        case([900, 33, 0, 64], 2, 4, 32, 32, dtype, 5, True, None, pdt)
        case([500, 16, 0, 3], 2, 7, 64, 16, dtype, 0, False, 64, pdt)
        # stablelm-3b's Dh 80 (5 slices in a group of 8 lanes, 3 idle)
        # at G 1, and mistral-large-123b's G 12 at Dh 128
        case([600, 0, 5, 20, 47], 4, 1, 80, 16, dtype, 3, True, None, pdt)
        case([300, 1, 0, 65], 2, 12, 128, 16, dtype, 2, True, None, pdt)
        # the moe configs: qwen3-moe-235b-a22b's G 16 at Dh 128 (16 warps
        # a CTA) and qwen2-moe-a2.7b's 16 kv heads at G 1, Dh 128
        case([300, 1, 0, 65], 4, 16, 128, 16, dtype, 2, True, None, pdt)
        case([600, 0, 5, 20, 47], 16, 1, 128, 16, dtype, 3, True, None, pdt)
    # the main path's decode shape, mid-generation (16 tokens decoded)
    main_lens = [n + 16 for n in PROMPT_LENS]
    # ... at stablelm-3b's heads (32 kv heads, G 1, Dh 80)
    _, a80 = case(main_lens, 32, 1, 80, PAGE_SIZE, torch.bfloat16,
                  MAX_NEW - 16, False)
    ms80 = timer.ms(lambda: paged_decode_attention_grouped(*a80))
    nb80 = (2 * (4 * a80[0].numel()) + 2 * 2 * sum(main_lens) * 32 * 80
            + 4 * len(main_lens))
    b80 = bound_ms(nb80, 4.0 * 32 * 80 * sum(n + 1 for n in main_lens))
    log(f"  paged_decode bf16 at stablelm-3b's decode (8 rows, KVH 32, G 1, "
        f"Dh 80): {ms80:.4f} ms, bound {b80[0]:.5f} ms by {b80[1]}")
    del a80
    # ... at qwen1.5-0.5b's (16 kv heads, G 1, Dh 64), and mistral-large-
    # 123b's 4 rows mid-generation (8 of 16 tokens decoded; G 12, Dh 128)
    h, kvh, dh = attn_shape("qwen1.5-0.5b")
    case(main_lens, kvh, h // kvh, dh, PAGE_SIZE, torch.bfloat16,
         MAX_NEW - 16, False)
    h, kvh, dh = attn_shape("mistral-large-123b")
    mistral_lens = [n + 8 for n in MISTRAL_PROMPT_LENS]
    _, mistral_args = case(mistral_lens, kvh, h // kvh, dh, PAGE_SIZE,
                           torch.bfloat16, MISTRAL_NEW - 8, False)
    # ... and at its heads on the main path's 8 rows (profile_kernels.py
    # --only head_dims' shape), timed below
    _, mistral8_args = case(main_lens, kvh, h // kvh, dh, PAGE_SIZE,
                            torch.bfloat16, MAX_NEW - 16, False)
    # phase 21's decodes mid-generation: qwen2-moe-a2.7b's 8 rows (KVH 16,
    # G 1, Dh 128) in bf16 and (d)'s 4 rows in fp32, qwen3-moe-235b-a22b's
    # 4 rows (KVH 4, G 16, Dh 128) in bf16; the bf16 ones timed, with
    # mistral-large-123b's above
    h, kvh, dh = attn_shape("qwen2-moe-a2.7b")
    _, moe_args = case(main_lens, kvh, h // kvh, dh, PAGE_SIZE,
                       torch.bfloat16, MAX_NEW - 16, False)
    case([n + 8 for n in MOE_FP32_PROMPT_LENS], kvh, h // kvh, dh,
         PAGE_SIZE, torch.float32, MOE_FP32_NEW - 8, False)
    h, kvh, dh = attn_shape("qwen3-moe-235b-a22b")
    q3_lens = [n + 8 for n in QWEN3_PROMPT_LENS]
    _, q3_args = case(q3_lens, kvh, h // kvh, dh, PAGE_SIZE, torch.bfloat16,
                      QWEN3_NEW - 8, False)
    for what, a, lens in (("qwen2-moe-a2.7b's (8 rows, KVH 16, G 1)",
                           moe_args, main_lens),
                          ("qwen3-moe-235b-a22b's (4 rows, KVH 4, G 16)",
                           q3_args, q3_lens),
                          ("mistral-large-123b's (4 rows, KVH 8, G 12)",
                           mistral_args, mistral_lens),
                          ("mistral-large-123b's heads on 8 rows (KVH 8, "
                           "G 12)", mistral8_args, main_lens)):
        msm = timer.ms(lambda: paged_decode_attention_grouped(*a))
        b_, kvh_, g_, dh_ = a[0].shape
        bd = bound_ms(2 * (2 * a[0].numel() + 2 * a[5].numel())
                      + 2 * 2 * sum(lens) * kvh_ * dh_ + 4 * b_,
                      4.0 * kvh_ * g_ * dh_ * sum(n + 1 for n in lens))
        log(f"  paged_decode bf16 at {what} decode, Dh 128: {msm:.4f} ms, "
            f"bound {bd[0]:.5f} ms by {bd[1]}")
    del moe_args, q3_args, mistral_args, mistral8_args
    # phase 22's decodes mid-generation: qwen2-vl-7b's 8 rows (KVH 4, G 7,
    # Dh 128) in bf16, timed, and (c)'s 3 rows in fp32
    from repro_torch.bench.profile_generate import VLM_LENS
    h, kvh, dh = attn_shape("qwen2-vl-7b")
    vlm_lens = [n + 16 for n in VLM_LENS]
    _, vlm_args = case(vlm_lens, kvh, h // kvh, dh, PAGE_SIZE,
                       torch.bfloat16, MAX_NEW - 16, False)
    case([n + 4 for n in VLM_FP32_PROMPT_LENS], kvh, h // kvh, dh, PAGE_SIZE,
         torch.float32, FP32_NEW - 4, False)
    msv = timer.ms(lambda: paged_decode_attention_grouped(*vlm_args))
    bd = bound_ms(2 * (2 * vlm_args[0].numel() + 2 * vlm_args[5].numel())
                  + 2 * 2 * sum(vlm_lens) * kvh * dh + 4 * len(vlm_lens),
                  4.0 * h * dh * sum(n + 1 for n in vlm_lens))
    log(f"  paged_decode bf16 at qwen2-vl-7b's decode (8 rows, KVH 4, G 7, "
        f"Dh 128): {msv:.4f} ms, bound {bd[0]:.5f} ms by {bd[1]}")
    del vlm_args
    case(main_lens, 2, 7, 64, PAGE_SIZE, torch.float32, MAX_NEW - 16, False)
    err, args = case(main_lens, 2, 7, 64, PAGE_SIZE, torch.bfloat16,
                     MAX_NEW - 16, False)
    # kv_dtype="fp32" on a bf16 model: fp32 pages under a bf16 query
    q4, kp, vp, pt, ln, kn, vn = args
    mixed = (q4, kp.float(), vp.float(), pt, ln, kn, vn)
    got = paged_decode_attention_grouped(*mixed)
    want = paged_decode_plain(*mixed)
    torch.cuda.synchronize()
    close(f"paged lens={main_lens} fp32 pages under bf16 q", got, want)
    mixed_ms = timer.ms(lambda: paged_decode_attention_grouped(*mixed))
    mixed_plain_ms = timer.ms(lambda: paged_decode_plain(*mixed))
    log(f"  paged_decode fp32 pages / bf16 q: {mixed_ms:.4f} ms "
        f"(plain {mixed_plain_ms:.4f})")

    ms = timer.ms(lambda: paged_decode_attention_grouped(*args))
    plain_ms = timer.ms(lambda: paged_decode_plain(*args))
    log(f"  paged_decode host us a call: wrapper "
        f"{host_us(lambda: paged_decode_attention_grouped(*args)):.2f} "
        f"(kernel timer {ms:.4f} ms, split "
        f"{split_plan(len(main_lens), 2, args[3].shape[1])} CTAs a row)")
    q4, _, _, _, _, kn, _ = args
    b, kvh, g, dh = q4.shape
    live_pages = sum(-(-n // PAGE_SIZE) for n in main_lens)
    nbytes = (2 * (2 * q4.numel() + 2 * kn.numel())       # q, out, k/v_new
              + 2 * 2 * sum(main_lens) * kvh * dh          # live K and V
              + 4 * b + 4 * live_pages)                    # lengths, table
    flops = 4.0 * kvh * g * dh * sum(n + 1 for n in main_lens)
    bms, by = bound_ms(nbytes, flops)
    return dict(name="paged_decode", route="cuda",
                source="src/repro_torch/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_decode.py:51",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def check_paged_q8(dev, timer):
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_q8_grouped, paged_decode_q8_plain, split_plan)
    rng = np.random.default_rng(4)

    def case(lens, kvh, g, dh, ps, dtype, extra, shuffle, width=None):
        b = len(lens)
        table, num_pages = plan_table(lens, extra, ps,
                                      rng if shuffle else None, width)

        def rnd(*shape):
            return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                    ).to(dev, dtype)

        def codes():
            return torch.from_numpy(rng.integers(
                -127, 128, (num_pages, ps, kvh, dh)).astype(np.int8)).to(dev)

        def scales():
            return torch.from_numpy(rng.uniform(
                0.005, 0.05, (num_pages, ps)).astype(np.float32)).to(dev)

        args = (rnd(b, kvh, g, dh), codes(), codes(), scales(), scales(),
                torch.from_numpy(table).to(dev),
                torch.tensor(lens, dtype=torch.int32, device=dev),
                rnd(b, kvh, dh), rnd(b, kvh, dh))
        got = paged_decode_attention_q8_grouped(*args)
        want = paged_decode_q8_plain(*args)
        torch.cuda.synchronize()
        split = split_plan(b, kvh, table.shape[1])
        name = (f"paged q8 lens={lens} kvh{kvh} g{g} dh{dh} ps{ps} "
                f"{str(dtype)[6:]} shuffled={shuffle} NP={table.shape[1]} "
                f"split={split}")
        err = close(name, got, want)
        for i, n in enumerate(lens):  # an empty row outputs exactly v_new
            if n == 0 and not torch.equal(
                    got[i], args[8][i][:, None, :].expand_as(got[i])):
                fail(f"{name}: row {i} has no past token but is not v_new")
        return err, args

    # length 0, 1, a partial page and multi-page lengths; shuffled tables
    # with garbage past the live pages; every supported head dim
    case([0, 1, 10, 40], 2, 7, 64, 16, torch.float32, 4, True)
    case([0, 1, 5, 33, 64], 2, 4, 32, 8, torch.float32, 3, True)
    case([3, 17], 1, 7, 128, 16, torch.float32, 2, True)
    case([9, 0, 30], 2, 7, 16, 16, torch.bfloat16, 5, True)
    # the cluster split: a row of 38 pages (past 8 CTAs x 4 ring slots)
    # beside rows shorter than the cluster, a row of 0 pages and a
    # partial one; G = 32 at Dh 128; pages of 8 and 32 tokens; the
    # scheduler's table width (64 pages a row) far past the live pages
    for dtype in (torch.float32, torch.bfloat16):
        case([600, 0, 5, 20, 47], 2, 7, 64, 16, dtype, 3, True)
        case([300, 1, 0, 65], 1, 32, 128, 16, dtype, 2, True)
        case([250, 7, 0, 40], 2, 7, 64, 8, dtype, 1, True)
        case([900, 33, 0, 64], 2, 4, 32, 32, dtype, 5, True)
        case([500, 16, 0, 3], 2, 7, 64, 16, dtype, 0, False, width=64)
        # Dh 80 at G 1 (stablelm-3b) and G 12 at Dh 128 (mistral-large)
        case([600, 0, 5, 20, 47], 4, 1, 80, 16, dtype, 3, True)
        case([300, 1, 0, 65], 2, 12, 128, 16, dtype, 2, True)
        # the moe configs: G 16 at Dh 128 (qwen3-moe-235b-a22b; the
        # shared-memory gate of q8_smem_bytes) and KVH 16, G 1, Dh 128
        # (qwen2-moe-a2.7b)
        case([300, 1, 0, 65], 4, 16, 128, 16, dtype, 2, True)
        case([600, 0, 5, 20, 47], 16, 1, 128, 16, dtype, 3, True)
    # the scheduler's decode shape: 8 slots, lengths prompt+16
    main_lens = [n + 16 for n in PROMPT_LENS]
    case(main_lens, 2, 7, 64, PAGE_SIZE, torch.float32, MAX_NEW - 16, False)
    case(main_lens, 2, 7, 64, PAGE_SIZE, torch.bfloat16, MAX_NEW - 16,
         False, width=64)
    # phase 20's int8 scheduler runs at their own shapes: 8 slots of the
    # shared-prefix traffic, 16 tokens into their budgets, the table cut
    # to the scheduler's bucket of 4 pages; qwen1.5-0.5b (KVH 16, G 1, Dh
    # 64) and stablelm-3b (KVH 32, G 1, Dh 80)
    from repro_torch.bench import profile_serve as sp
    from repro_torch.configs import get_arch
    # (phase 22: qwen2-vl-7b, KVH 4, G 7, Dh 128, timed)
    for arch in ("qwen1.5-0.5b", "stablelm-3b", "qwen2-moe-a2.7b",
                 "qwen2-vl-7b"):
        work = sp.shared_prefix_workload(
            get_arch(arch).config.vocab, DENSE_SCHED_REQUESTS, sp.PREFIX,
            sp.SUFFIX_LENS, sp.BUDGETS, seed=0)
        lens = [len(w[0]) + 16 for w in work[:sp.SLOTS]]
        pages = max(-(-(n + 1) // sp.PAGE_SIZE) for n in lens)
        h, kvh, dh = attn_shape(arch)
        _, a = case(lens, kvh, h // kvh, dh, sp.PAGE_SIZE, torch.bfloat16, 1,
                    False, width=-(-pages // 4) * 4)
    msv = timer.ms(lambda: paged_decode_attention_q8_grouped(*a))
    bd = bound_ms(2 * (2 * a[0].numel() + 2 * a[7].numel())
                  + sum(lens) * (2 * kvh * dh + 8) + 4 * len(lens),
                  4.0 * h * dh * sum(n + 1 for n in lens))
    log(f"  paged_decode_q8 bf16 at qwen2-vl-7b's int8 scheduler (8 slots, "
        f"KVH 4, G 7, Dh 128): {msv:.4f} ms, bound {bd[0]:.5f} ms by "
        f"{bd[1]}")
    del a
    # qwen3-moe-235b-a22b's 4 rows at G 16, Dh 128, int8 pages, timed
    h, kvh, dh = attn_shape("qwen3-moe-235b-a22b")
    q3_lens = [n + 8 for n in QWEN3_PROMPT_LENS]
    _, q3_args = case(q3_lens, kvh, h // kvh, dh, PAGE_SIZE, torch.bfloat16,
                      QWEN3_NEW - 8, False)
    ms3 = timer.ms(lambda: paged_decode_attention_q8_grouped(*q3_args))
    bd = bound_ms(2 * (2 * q3_args[0].numel() + 2 * q3_args[7].numel())
                  + sum(q3_lens) * (2 * kvh * dh + 8) + 4 * len(q3_lens),
                  4.0 * h * dh * sum(n + 1 for n in q3_lens))
    log(f"  paged_decode_q8 bf16 at qwen3-moe-235b-a22b's decode (4 rows, "
        f"KVH 4, G 16, Dh 128): {ms3:.4f} ms, bound {bd[0]:.5f} ms by "
        f"{bd[1]}")
    del q3_args
    # stablelm-3b's and mistral-large-123b's heads on the main path's 8
    # rows (profile_kernels.py --only head_dims' shapes), timed
    for what, (kvh, g, dh) in (("stablelm-3b's (KVH 32, G 1, Dh 80)",
                                (32, 1, 80)),
                               ("mistral-large-123b's (KVH 8, G 12, Dh 128)",
                                (8, 12, 128))):
        _, a = case(main_lens, kvh, g, dh, PAGE_SIZE, torch.bfloat16,
                    MAX_NEW - 16, False)
        msa = timer.ms(lambda: paged_decode_attention_q8_grouped(*a))
        bd = bound_ms(2 * (2 * a[0].numel() + 2 * a[7].numel())
                      + sum(main_lens) * (2 * kvh * dh + 8)
                      + 4 * len(main_lens),
                      4.0 * kvh * g * dh * sum(n + 1 for n in main_lens))
        log(f"  paged_decode_q8 bf16 at {what} heads on 8 rows: {msa:.4f} "
            f"ms, bound {bd[0]:.5f} ms by {bd[1]}")
        del a
    err, args = case(main_lens, 2, 7, 64, PAGE_SIZE, torch.bfloat16,
                     MAX_NEW - 16, False)

    ms = timer.ms(lambda: paged_decode_attention_q8_grouped(*args))
    plain_ms = timer.ms(lambda: paged_decode_q8_plain(*args))
    log(f"  paged_decode_q8 host us a call: wrapper "
        f"{host_us(lambda: paged_decode_attention_q8_grouped(*args)):.2f} "
        f"(kernel timer {ms:.4f} ms, split "
        f"{split_plan(len(main_lens), 2, args[5].shape[1])} CTAs a row)")
    q4, _, _, _, _, _, _, kn, _ = args
    b, kvh, g, dh = q4.shape
    live_pages = sum(-(-n // PAGE_SIZE) for n in main_lens)
    # int8 K and V codes of every live token plus its two f32 scales (one
    # per token row, shared by the KV heads): 264 B per token at Dh 64
    nbytes = (2 * (2 * q4.numel() + 2 * kn.numel())       # q, out, k/v_new
              + sum(main_lens) * (2 * kvh * dh + 2 * 4)    # codes + scales
              + 4 * b + 4 * live_pages)                    # lengths, table
    flops = 4.0 * kvh * g * dh * sum(n + 1 for n in main_lens)
    bms, by = bound_ms(nbytes, flops)
    return dict(name="paged_decode_q8", route="cuda",
                source="src/repro_torch/csrc/paged_decode_q8.cu",
                replaces="src/repro/kernels/paged_decode.py:191",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def check_argmax(dev, timer, vocab):
    from repro_torch.kernels.sampling import (argmax_boundary_logits,
                                              argmax_plain, argmax_plan,
                                              block_argmax)
    rng = np.random.default_rng(2)

    def exact(name, xt):
        got = block_argmax(xt)
        want = argmax_plain(xt)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"argmax {name}: kernel {got.tolist()} != plain "
                 f"{want.tolist()}")
        shown = got.tolist() if got.numel() <= 8 else f"{got.numel()} rows"
        log(f"  ok argmax {name} {tuple(xt.shape)} plan "
            f"{argmax_plan(*xt.shape)}: exact, {shown}")

    x = rng.standard_normal((8, vocab), np.float32)
    x[0, [5, 100000]] = 50.0                  # tie: the lower index wins
    x[1, :] = -np.inf                         # all -inf -> index 0
    x[2, [vocab - 2, vocab - 1]] = 60.0       # tie at the row's end
    x[3, :] = -np.inf
    x[3, 77777] = -1.0
    x[4, [0, 1]] = 70.0                       # tie at the row's start
    x[5, ::2] = 3.5                           # many ties: index 0
    x[6, 1::7] = 9.0                          # strided ties: index 1
    last = None
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dev, dtype)
        exact(f"{str(dtype)[6:]} main", xt)
        # ties and NaN at the split boundaries; a view whose rows start one
        # element past a 16-byte boundary (and drift: the row stride is
        # odd); zamba2's vocab; one row and 64 rows
        # qwen2-vl-7b's 152064 and seamless-m4t-medium's 256206 (no
        # multiple of the 16-byte vector or of the split)
        for b, v in ((8, vocab), (8, 32000), (1, vocab), (64, vocab),
                     (64, 32000), (3, 130), (8, 152064), (8, 256206)):
            xb = torch.from_numpy(argmax_boundary_logits(rng, b, v)
                                  ).to(dev, dtype)
            exact(f"{str(dtype)[6:]} split boundaries", xb)
            wide = torch.from_numpy(argmax_boundary_logits(rng, b, v + 1)
                                    ).to(dev, dtype)
            exact(f"{str(dtype)[6:]} view from column 1", wide[:, 1:])
        for shift in range(1, 5):           # B = 1 through every row kind
            xb = argmax_boundary_logits(rng, 5, vocab)[shift:shift + 1]
            exact(f"{str(dtype)[6:]} one row, kind {shift}",
                  torch.from_numpy(xb).to(dev, dtype))
        last = xt
    # phase 22's widest vocabulary, seamless-m4t-medium's 8 x 256206, timed
    # beside torch.argmax
    wide = torch.from_numpy(rng.standard_normal((8, 256206), np.float32)
                            ).to(dev, torch.bfloat16)
    exact("bf16 seamless-m4t-medium", wide)
    msw = timer.ms(lambda: block_argmax(wide))
    libw = timer.ms(lambda: torch.argmax(wide, dim=-1))
    bw = bound_ms(2 * wide.numel() + 4 * wide.shape[0], float(wide.numel()))
    log(f"  argmax bf16 at seamless-m4t-medium's 8 x 256206: kernel "
        f"{msw:.4f} ms, torch.argmax {libw:.4f} ms, bound {bw[0]:.5f} ms "
        f"by {bw[1]}")
    del wide
    ms = timer.ms(lambda: block_argmax(last))
    plain_ms = timer.ms(lambda: argmax_plain(last))
    library_ms = timer.ms(lambda: torch.argmax(last, dim=-1))
    log(f"  argmax host us a call: wrapper "
        f"{host_us(lambda: block_argmax(last)):.2f}, torch.argmax "
        f"{host_us(lambda: torch.argmax(last, dim=-1)):.2f}")
    bms, by = bound_ms(2 * last.numel() + 4 * last.shape[0],
                       float(last.numel()))
    return dict(name="argmax", route="cuda",
                source="src/repro_torch/csrc/argmax.cu",
                replaces="src/repro/kernels/sampling.py:116",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


ZAMBA_PROMPTS = 8                  # zamba2 generate: 8 prompts x 512 tokens
ZAMBA_PROMPT_LEN = 512
#: xlstm-350m's prefill call of kernel #5: 8 rows of 512, 4 heads, dk = dv = 512
XLSTM_SSD_SHAPE = (8, 512, 4, 512, 512)
# a reordered scan; in fp32 the atol is relative to the output's largest
# magnitude: every fp32 evaluation rounds the decays exp(Bc_t - Bc_j) with
# a relative error of ~|Bc| eps (|Bc| reaches ~180 over a 256-step chunk),
# so an element that cancels to near 0 keeps an error on the scale of its
# terms, not of itself
SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5),
           torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


def distinct(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast dim counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def ssd_tol(want: torch.Tensor) -> dict:
    tol = dict(SSD_TOL[want.dtype])
    if want.dtype == torch.float32:
        tol["atol"] *= max(1.0, want.abs().max().item())
    return tol


def ssd_inputs(rng, dev, b, s, h, dk, dv, dtype, *, positive=False,
               lf_value=None, broadcast=False, state=False):
    """Model-layout ssd_scan inputs.  Scores q.k have unit variance; with
    ``positive`` q, k >= 0 keep the normalizer q.n away from 0, where fp32
    cancellation alone would exceed the tolerance.  ``broadcast`` gives q, k
    as views over one head (stride 0), as Mamba2 passes them."""
    def qk():
        x = rng.standard_normal((b, s, 1 if broadcast else h, dk),
                                np.float32) * dk ** -0.25
        t = torch.from_numpy(np.abs(x) if positive else x).to(dev, dtype)
        return t.expand(b, s, h, dk) if broadcast else t

    q, k = qk(), qk()
    v = torch.from_numpy(rng.standard_normal((b, s, h, dv), np.float32)
                         ).to(dev, dtype)
    lf = (np.full((b, s, h), lf_value, np.float32) if lf_value is not None
          else -np.logaddexp(rng.standard_normal((b, s, h)), 0.0))
    li = -np.logaddexp(rng.standard_normal((b, s, h)), 0.0)
    gates = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
             for a in (lf, li)]
    st = None
    if state:
        st = (torch.from_numpy(rng.standard_normal((b, h, dk, dv),
                                                   np.float32)).to(dev),
              torch.from_numpy(np.abs(rng.standard_normal(
                  (b, h, dk), np.float32))).to(dev))
    return (q, k, v, *gates), st


#: the bf16 route's three passes and the fp32 route's kernel, by the names
#: of their ``__global__`` functions
SSD_PASSES = ("ssd_local_states_kernel", "ssd_state_pass_kernel",
              "ssd_outputs_kernel")
SSD_FP32 = "ssd_scan_kernel"


def check_ssd(dev, timer):
    """Kernel #5 against its plain version: the main path's call (zamba2
    generate: 8 x 512 tokens, 64 heads of P = N = 64, q/k broadcast over
    heads, a carried state), the scheduler's one-row admissions (B = 1 at
    S = 64, 300, 512), the flat [512, 512, 64] layout, edge cases and
    mLSTM's dk = dv = 512 state; which ``__global__`` functions each dtype
    runs (bf16: the three tensor-core passes, fp32: the CUDA-core kernel)."""
    from repro_torch.bench.profile_kernels import device_us_by_kernel
    from repro_torch.kernels.ssd_scan import ssd_flops, ssd_scan
    from repro_torch.models.linear_scan import _chunked_linear_attention
    rng = np.random.default_rng(8)

    def plain(args, chunk, normalize, st):
        return _chunked_linear_attention(*args, chunk_size=chunk,
                                         normalize=normalize,
                                         initial_state=st)

    def case(name, shape, dtype, chunk, normalize=False, **kw):
        args, st = ssd_inputs(rng, dev, *shape, dtype, **kw)
        y, (c, n) = ssd_scan(*args, chunk=chunk, normalize=normalize,
                             initial_state=st)
        yp, (cp, np_) = plain(args, chunk, normalize, st)
        torch.cuda.synchronize()
        errs = []
        for what, got, want in (("y", y, yp), ("C", c, cp), ("n", n, np_)):
            tol = ssd_tol(want)
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda m: f"{name} {what}: {m}")
            errs.append((got.float() - want.float()).abs().max().item())
        scaled = " x max|.|" if dtype == torch.float32 else ""
        log(f"  ok ssd_scan {name} {tuple(shape)} {str(dtype)[6:]} chunk "
            f"{chunk} normalize={normalize}: max|err| y {errs[0]:.3g} "
            f"(max|y| {yp.abs().max().item():.3g}), C {errs[1]:.3g}, n "
            f"{errs[2]:.3g} (rtol {SSD_TOL[dtype]['rtol']}, atol "
            f"{SSD_TOL[dtype]['atol']}{scaled})")
        return errs[0], args, st

    case("ragged S", (3, 37, 2, 64, 64), torch.float32, 16)
    case("S < chunk, odd dims", (2, 45, 3, 16, 32), torch.float32, 64,
         state=True)
    case("dv in 2 tiles", (1, 130, 2, 32, 96), torch.float32, 64)
    case("normalize", (2, 300, 2, 64, 64), torch.float32, 128, True,
         positive=True)
    case("initial state", (2, 300, 4, 64, 64), torch.float32, 256,
         state=True, broadcast=True)
    case("log_f = -30", (2, 300, 2, 64, 64), torch.float32, 256,
         lf_value=-30.0, state=True)
    case("mLSTM dk=dv=512", (1, 512, 4, 512, 512), torch.float32, 256, True,
         positive=True)
    case("mLSTM dk=dv=512", (1, 512, 4, 512, 512), torch.bfloat16, 256,
         True, positive=True)
    # xlstm-350m's prefill call: 8 rows of 512, 4 heads of 512, chunk 256,
    # normalize, a non-zero carried state (the serving prefill carries
    # the slot's state through the kernel)
    for dtype in (torch.float32, torch.bfloat16):
        case("xlstm prefill", XLSTM_SSD_SHAPE, dtype, 256, True,
             positive=True, state=True)
    # ... and its scheduler's one-row admission at a ragged length
    case("xlstm admission", (1, 300) + XLSTM_SSD_SHAPE[2:], torch.bfloat16,
         256, True, positive=True, state=True)
    # the bf16 route's edges: ragged S over key and row tiles, dk and dv
    # padded to 64 (dv over two tiles), 4-byte copies (rows of 40 bytes),
    # normalize, a carried state
    case("ragged S", (3, 37, 2, 64, 64), torch.bfloat16, 16)
    case("S < chunk, dv in 2 tiles", (2, 45, 3, 16, 96), torch.bfloat16, 64,
         state=True)
    case("4-byte rows", (2, 200, 3, 20, 36), torch.bfloat16, 128, True,
         positive=True, state=True)
    case("chunk 1024", (1, 1100, 2, 64, 64), torch.bfloat16, 1024,
         state=True, broadcast=True)
    # the flat layout of the Pallas entry, [BH,S,d] as [BH,S,1,d], at the
    # generate shape
    args, _ = ssd_inputs(rng, dev, 512, 512, 1, 64, 64, torch.bfloat16)
    y, _ = ssd_scan(*args, chunk=256)
    yp, _ = plain(args, 256, False, None)
    torch.cuda.synchronize()
    close("ssd_scan flat [512,512,64] bf16 chunk 256", y, yp)
    flat_ms = timer.ms(lambda: ssd_scan(*args, chunk=256))
    # the scheduler's one-row admissions (zamba2, B = 1, a carried state)
    for s in (64, 300, 512):
        _, a1, st1 = case(f"admission S={s}", (1, s, 64, 64, 64),
                          torch.bfloat16, 256, state=True, broadcast=True)
        adm_ms = timer.ms(lambda: ssd_scan(*a1, chunk=256,
                                           initial_state=st1))
        log(f"  ssd_scan admission B=1 S={s} bf16: {adm_ms:.4f} ms")
    # the main path's call, in bf16 and in fp32
    shape = (ZAMBA_PROMPTS, ZAMBA_PROMPT_LEN, 64, 64, 64)
    _, a32, st32 = case("zamba2 generate", shape, torch.float32, 256,
                        state=True, broadcast=True)
    err, args, st = case("zamba2 generate", shape, torch.bfloat16, 256,
                         state=True, broadcast=True)
    ms = timer.ms(lambda: ssd_scan(*args, chunk=256, initial_state=st))
    plain_ms = timer.ms(lambda: plain(args, 256, False, st))
    # each dtype reaches its own route, and only it
    names = SSD_PASSES + (SSD_FP32,)
    split = device_us_by_kernel(
        lambda: ssd_scan(*args, chunk=256, initial_state=st), names)
    if set(split) != set(SSD_PASSES):
        fail(f"a bf16 ssd_scan call ran {sorted(split)}, not the tensor-core "
             f"passes {list(SSD_PASSES)}")
    f32 = device_us_by_kernel(
        lambda: ssd_scan(*a32, chunk=256, initial_state=st32), names)
    if set(f32) != {SSD_FP32}:
        fail(f"an fp32 ssd_scan call ran {sorted(f32)}, not {SSD_FP32}")
    log(f"  ok ssd_scan routes: bf16 runs {list(SSD_PASSES)}, fp32 runs "
        f"{SSD_FP32} ({f32[SSD_FP32]:.1f} us a call)")
    del a32, st32
    b, s, h, dk = args[0].shape
    dv = args[2].shape[3]

    state_bytes = 4 * (b * h * dk * dv + b * h * dk)
    nbytes = (sum(distinct(t) for t in args) + state_bytes      # in
              + distinct(args[2]) + state_bytes)                 # y, C, n
    flops = float(ssd_flops(b, h, s, dk, dv, 256))
    bms, by = bound_ms(nbytes, flops)
    log(f"  ssd_scan main call: {ms:.4f} ms, {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB; bound {bms:.4f} ms by {by} (989 TFLOP/s "
        f"tensor-core peak); fp32 CUDA cores at peak "
        f"{flops / F32_FLOPS * 1e3:.4f} ms; flat [512,512,64] bf16 "
        f"{flat_ms:.4f} ms; device us a call by pass: "
        + ", ".join(f"{n} {split[n]:.1f}" for n in SSD_PASSES))
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:35",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def counters():
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_grouped, paged_decode_attention_q8_grouped)
    from repro_torch.kernels.sampling import block_argmax
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flash_attention": flash_attention_bhsd,
            "paged_decode": paged_decode_attention_grouped,
            "paged_decode_q8": paged_decode_attention_q8_grouped,
            "argmax": block_argmax, "ssd_scan": ssd_scan}


def reset_counters():
    for f in counters().values():
        f.launches = 0


def read_counters():
    return {k: f.launches for k, f in counters().items()}


def main_path(dev):
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    t0 = time.perf_counter()
    lm = LM(CONFIG, torch.bfloat16, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"  qwen2-0.5b: {n_params} params, bf16, random init (seed 0) in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CONFIG.vocab, n).tolist() for n in PROMPT_LENS]
    eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024))
    eng.generate(prompts, max_new_tokens=MAX_NEW)          # warm-up
    torch.cuda.synchronize()

    reset_counters()
    syncs0 = eng.host_syncs
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = read_counters()
    syncs = eng.host_syncs - syncs0

    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1)                # prefill + 1 token
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0

    if syncs != 1:
        fail(f"generate made {syncs} host syncs, expected 1")
    if [len(o) for o in out] != [MAX_NEW] * len(prompts):
        fail(f"unexpected output lengths {[len(o) for o in out]}")
    if not all(0 <= t < CONFIG.vocab for o in out for t in o):
        fail("a generated token is outside the vocabulary")
    n_layers = CONFIG.n_layers
    want = {"flash_attention": n_layers,
            "paged_decode": n_layers * (MAX_NEW - 1), "argmax": MAX_NEW,
            "ssd_scan": 0}
    for k, n in want.items():
        if launches[k] < n:
            fail(f"{k} launched {launches[k]} times on the main path, "
                 f"expected at least {n}")
    dec_tok_s = len(prompts) * (MAX_NEW - 1) / max(t_gen - t_prefill, 1e-9)
    log(f"  generate: {t_gen * 1e3:.2f} ms for {len(prompts)} x {MAX_NEW} "
        f"tokens; prefill (+1 token) {t_prefill * 1e3:.2f} ms; decode "
        f"{dec_tok_s:.1f} tokens/s; host_syncs {syncs}; launches {launches}")
    log(f"  first tokens: {[o[:4] for o in out]}")
    return lm, launches


def scheduler_path(dev, lm):
    """The slice-2 main path: BatchScheduler over int8 pages at full
    width, with the prefix cache (the workload of
    ``repro_torch.bench.profile_serve``)."""
    from repro_torch.bench import profile_serve as ps
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = lm.cfg
    eng = Engine(lm, ServeConfig(page_size=ps.PAGE_SIZE, max_seq=1024,
                                 batch_slots=ps.SLOTS, admission_chunk=8,
                                 kv_dtype="int8"), device=lm.device)
    # warm-up: the same shapes' first launches, cuBLAS handles, allocator
    ps.run_scheduler(eng, ps.shared_prefix_workload(
        cfg.vocab, ps.SLOTS, ps.PREFIX, ps.SUFFIX_LENS, ps.BUDGETS, seed=1))
    torch.cuda.synchronize()
    work = ps.shared_prefix_workload(cfg.vocab, ps.REQUESTS, ps.PREFIX,
                                     ps.SUFFIX_LENS, ps.BUDGETS, seed=0)
    reset_counters()
    syncs0 = eng.host_syncs
    t0 = time.perf_counter()
    sched, out = ps.run_scheduler(eng, work)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    syncs = eng.host_syncs - syncs0
    m = sched.metrics

    if sorted(out) != list(range(len(work))):
        fail(f"scheduler completed {sorted(out)} of {len(work)} requests")
    for rid, (_, budget, _) in enumerate(work):
        if len(out[rid]) != budget:
            fail(f"request {rid}: {len(out[rid])} tokens, budget {budget}")
        if not all(0 <= t < cfg.vocab for t in out[rid]):
            fail(f"request {rid}: a token is outside the vocabulary")
    if syncs != m["segments"]:
        fail(f"scheduler made {syncs} host syncs for {m['segments']} "
             f"segments")
    sched.check()
    sched.pool.check()
    if not sched.pool.allocs == sched.pool.releases > 0:
        fail(f"pool leaked: {sched.pool!r}")
    if m["prefix_hits"] < ps.REQUESTS - 1:
        fail(f"prefix hits {m['prefix_hits']} < {ps.REQUESTS - 1}")
    n_layers = cfg.n_layers
    misses = m["admissions"] - m["prefix_hits"]
    want = {"paged_decode_q8": n_layers * m["decode_steps"],
            "flash_attention": n_layers * misses,
            "argmax": m["decode_steps"], "paged_decode": 0, "ssd_scan": 0}
    for k, n in want.items():
        if launches[k] != n:
            fail(f"{k} launched {launches[k]} times on the scheduler path, "
                 f"expected {n}")
    new_tokens = sum(len(t) for t in out.values())
    ttfts = [r.ttft for r in sched.completed.values()]
    log(f"  scheduler: {len(out)} requests, {new_tokens} tokens in "
        f"{wall * 1e3:.2f} ms = {new_tokens / wall:.1f} tokens/s; mean TTFT "
        f"{np.mean(ttfts) * 1e3:.2f} ms; segments {m['segments']:.0f}; "
        f"decode steps {m['decode_steps']:.0f}; host_syncs {syncs}; "
        f"admissions {m['admissions']:.0f}, prefix hits "
        f"{m['prefix_hits']:.0f}, prefilled {m['prefilled_tokens']:.0f} of "
        f"{m['prompt_tokens']:.0f} prompt tokens; launches {launches}")
    log(f"  first tokens: {[out[r][:4] for r in range(4)]}")
    return launches


def token_check(dev):
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    lm_cpu = LM(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(1))
    # a random model with sigma-1 tied embeddings mostly echoes its input;
    # shrinking the table makes the greedy tokens depend on every layer
    lm_cpu.embed.table.data.mul_(0.1)
    lm_gpu = LM(cfg, torch.float32, dev)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (37, 20, 5)]
    sc_paged = ServeConfig(page_size=PAGE_SIZE, max_seq=128)
    tok = {
        "card paged": Engine(lm_gpu, sc_paged).generate(prompts, 8),
        "card dense": Engine(lm_gpu, ServeConfig(max_seq=128)).generate(
            prompts, 8),
        "cpu paged": Engine(lm_cpu, sc_paged, device="cpu").generate(
            prompts, 8),
    }
    for k, v in tok.items():
        log(f"  {k}: {v}")
    if not tok["card paged"] == tok["card dense"] == tok["cpu paged"]:
        fail("greedy tokens differ between the card and the CPU")

    logits = {}
    for name, lm in (("cpu", lm_cpu), ("card", lm_gpu)):
        eng = Engine(lm, sc_paged, device=lm.device)
        toks, lens = eng._pad_prompts(prompts)
        table, num_pages = eng._page_plan(prompts, 8)
        state = lm.init_decode_state(len(prompts), 128, page_size=PAGE_SIZE,
                                     num_pages=num_pages,
                                     table_width=table.shape[1])
        state["caches"].page_table.copy_(torch.from_numpy(table))
        with torch.inference_mode():
            lg, _ = lm.prefill({"tokens": torch.from_numpy(toks).to(lm.device),
                                "lengths": torch.from_numpy(lens).to(
                                    lm.device)}, state)
        logits[name] = lg.float().cpu()
    rel = ((logits["card"] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    log(f"  prefill logits card vs cpu: max|d|/max|logit| = {rel:.3g}")
    if not rel <= LOGITS_REL_TOL:
        fail(f"prefill logits differ: {rel} > {LOGITS_REL_TOL}")


def sched_token_check(dev):
    """fp32, 2 layers: the card's scheduler against the card's generate and
    the CPU scheduler; int8 decode-step logits card against CPU."""
    from repro_torch.bench.profile_serve import (run_scheduler,
                                                 shared_prefix_workload)
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    lm_cpu = LM(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(2))
    lm_cpu.embed.table.data.mul_(0.1)
    lm_gpu = LM(cfg, torch.float32, dev)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    # a 40-token shared prefix: two full pages of 16 and a fork inside the
    # third, so admissions map pages read-only AND copy the fork page
    work = shared_prefix_workload(cfg.vocab, 6, 40, [3, 9, 17, 30],
                                  [3, 5, 8], seed=5)
    sc = ServeConfig(page_size=PAGE_SIZE, max_seq=128, batch_slots=3,
                     admission_chunk=4)
    sched, card = run_scheduler(Engine(lm_gpu, sc, device=dev), work)
    _, cpu = run_scheduler(Engine(lm_cpu, sc, device="cpu"), work)
    gen = Engine(lm_gpu, sc, device=dev).generate([w[0] for w in work],
                                      max(w[1] for w in work))
    gen = {rid: gen[rid][:w[1]] for rid, w in enumerate(work)}
    m = sched.metrics
    log(f"  card scheduler: {card}")
    log(f"  prefix hits {m['prefix_hits']:.0f}, pages shared "
        f"{m['pages_shared']:.0f}, cow copies {m['cow_copies']:.0f}")
    if not card == gen == cpu:
        fail(f"greedy tokens differ: card scheduler {card}, card generate "
             f"{gen}, cpu scheduler {cpu}")
    if m["cow_copies"] < 1 or m["prefix_hits"] < 1:
        fail("the fp32 scheduler phase did not exercise the prefix cache")

    int8_decode_logits(lm_cpu, lm_gpu, [w[0] for w in work[:3]], "qwen2")


# ---------------------------------------------------------------------------
# the model paths' harness (phases 7-10, 19-20): a timed generate, a
# checked scheduler run, fp32 tokens and logits card against CPU
# ---------------------------------------------------------------------------

def build_lm(cfg, dev, dtype=torch.bfloat16, seed=0):
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    lm = LM(cfg, dtype, dev).init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, {n_params} params, "
        f"{str(dtype)[6:]}, random init (seed {seed}) in "
        f"{time.perf_counter() - t0:.2f} s")
    return lm


def timed_generate(eng, prompts, max_new, want, where, extra=None):
    """Warm up, then one ``generate`` with the counters set to 0 just
    before it and read just after (one host sync, ``want`` launches),
    then prefill plus one token alone; prints prefill ms and decode
    tokens/s.  ``extra`` is the call's ``extra_batch`` (the vlm and
    encdec families' stub inputs).  Returns the launches."""
    vocab = eng.lm.cfg.vocab
    gen = functools.partial(eng.generate, prompts, extra_batch=extra)
    gen(max_new_tokens=max_new)                            # warm-up
    torch.cuda.synchronize()
    reset_counters()
    syncs0 = eng.host_syncs
    t0 = time.perf_counter()
    out = gen(max_new_tokens=max_new)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = read_counters()
    syncs = eng.host_syncs - syncs0
    t0 = time.perf_counter()
    gen(max_new_tokens=1)                                  # prefill + 1 token
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    if syncs != 1:
        fail(f"{where}: generate made {syncs} host syncs, expected 1")
    if [len(o) for o in out] != [max_new] * len(prompts):
        fail(f"{where}: output lengths {[len(o) for o in out]}")
    if not all(0 <= t < vocab for o in out for t in o):
        fail(f"{where}: a generated token is outside the vocabulary")
    if launches != want:
        fail(f"{where}: generate launched {launches}, expected {want}")
    dec_tok_s = len(prompts) * (max_new - 1) / max(t_gen - t_prefill, 1e-9)
    log(f"  {where} generate: {t_gen * 1e3:.2f} ms for {len(prompts)} x "
        f"{max_new} tokens; prefill (+1 token) {t_prefill * 1e3:.2f} ms; "
        f"decode {dec_tok_s:.1f} tokens/s; host_syncs {syncs}; launches "
        f"{launches}")
    log(f"  first tokens: {[o[:4] for o in out]}")
    return launches


def checked_scheduler(eng, work, want_fn, where):
    """``BatchScheduler`` over ``work`` with the counters set to 0 just
    before and read just after: every request completes at its budget,
    one host sync a segment, ``scheduler.check()`` (and the pool's) pass,
    and the launches equal ``want_fn(metrics)``."""
    from repro_torch.bench.profile_serve import run_scheduler
    vocab = eng.lm.cfg.vocab
    reset_counters()
    syncs0 = eng.host_syncs
    t0 = time.perf_counter()
    sched, out = run_scheduler(eng, work)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    syncs = eng.host_syncs - syncs0
    m = sched.metrics
    if sorted(out) != list(range(len(work))):
        fail(f"{where}: completed {sorted(out)} of {len(work)} requests")
    for rid, (_, budget, _) in enumerate(work):
        if len(out[rid]) != budget:
            fail(f"{where}: request {rid}: {len(out[rid])} tokens, budget "
                 f"{budget}")
        if not all(0 <= t < vocab for t in out[rid]):
            fail(f"{where}: request {rid}: a token outside the vocabulary")
    if syncs != m["segments"]:
        fail(f"{where}: {syncs} host syncs for {m['segments']} segments")
    sched.check()
    if sched.pool is not None:
        sched.pool.check()
    want = want_fn(m)
    if launches != want:
        fail(f"{where}: launched {launches}, expected {want}")
    new_tokens = sum(len(t) for t in out.values())
    ttfts = [r.ttft for r in sched.completed.values()]
    log(f"  {where}: {len(out)} requests on {eng.cfg.batch_slots} slots "
        f"({sum(len(w[0]) for w in work)} prompt tokens), {new_tokens} "
        f"tokens in {wall * 1e3:.2f} ms = {new_tokens / wall:.1f} tokens/s; "
        f"mean TTFT {np.mean(ttfts) * 1e3:.2f} ms; segments "
        f"{m['segments']:.0f}; decode steps {m['decode_steps']:.0f}; "
        f"host_syncs {syncs}; admissions {m['admissions']:.0f}; launches "
        f"{launches}")
    return launches


def card_cpu_tokens(dev, cfg, seed, prompts, sc, want, where, max_new=8,
                    extra=None, tol=None):
    """fp32 at ``cfg``'s width and depth, weights from ``seed`` with the
    embedding scaled by 0.1 (a random model with a sigma-1 embedding
    mostly echoes its input): ``max_new`` greedy tokens of
    ``Engine.generate`` (with ``extra`` as its ``extra_batch``, numpy
    arrays) on the card (the kernels, ``want`` launches) equal the CPU's
    (the plain versions), and the logits of every sampled step agree
    within max|d| / max|logit| <= ``tol`` (default
    :data:`LOGITS_REL_TOL`).  Returns the CPU and the card model."""
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine
    lm_cpu = LM(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(seed))
    lm_cpu.embed.table.data.mul_(0.1)
    lm_gpu = LM(cfg, torch.float32, dev)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    tok, steps = {}, {}
    for name, lm in (("card", lm_gpu), ("cpu", lm_cpu)):
        reset_counters()
        with LogitsRecorder() as rec:
            tok[name] = Engine(lm, sc, device=lm.device).generate(
                prompts, max_new, extra_batch=extra)
        steps[name] = [s.cpu() for s in rec.steps]
        if name == "card":
            expect_launches(f"{where} fp32 card run", read_counters(), want)
        log(f"  {name}: {tok[name]}")
    if tok["card"] != tok["cpu"]:
        fail(f"{where} greedy tokens differ between the card and the CPU")
    err, rel = logits_parity(f"{where} card vs cpu", steps["card"],
                             steps["cpu"], tol)
    log(f"  {where} logits card vs cpu, {len(steps['card'])} sampled steps: "
        f"max|d| {err:.3g}, max|d|/max|logit| = {rel:.3g}")
    return lm_cpu, lm_gpu


def int8_decode_logits(lm_cpu, lm_gpu, prompts, where):
    """Prefill ``prompts`` into int8 pages of 16, then three decode steps
    on fixed tokens, on the card (kernel #3, launched once a layer a
    step) and on the CPU: the logits agree within max|d| / max|logit| <=
    :data:`LOGITS_REL_TOL_INT8` (a code that rounds the other way moves a
    logit by a step of the int8 grid)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    sc8 = ServeConfig(page_size=PAGE_SIZE, max_seq=128, kv_dtype="int8")
    nxt = [[7], [11], [13], [17]][:len(prompts)]
    logits = {}
    for name, lm in (("cpu", lm_cpu), ("card", lm_gpu)):
        eng = Engine(lm, sc8, device=lm.device)
        toks, lens = eng._pad_prompts(prompts)
        table, num_pages = eng._page_plan(prompts, 4)
        state = lm.init_decode_state(len(prompts), 128, page_size=PAGE_SIZE,
                                     num_pages=num_pages,
                                     table_width=table.shape[1],
                                     kv_dtype=torch.int8)
        state = eng.set_page_table(state, table)
        tok = torch.tensor(nxt, dtype=torch.int32, device=lm.device)
        reset_counters()
        with torch.inference_mode():
            lm.prefill({"tokens": torch.from_numpy(toks).to(lm.device),
                        "lengths": torch.from_numpy(lens).to(lm.device)},
                       state)
            out = []
            for _ in range(3):
                lg, state = lm.decode_step(tok, state)
                out.append(lg.float().cpu())
        if name == "card":
            expect_launches(f"{where} int8 card run", read_counters(),
                            {"paged_decode_q8": 3 * lm.cfg.n_layers})
        logits[name] = torch.stack(out)
    rel = ((logits["card"] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    log(f"  {where} int8 decode-step logits card vs cpu: max|d|/max|logit| "
        f"= {rel:.3g}")
    if not rel <= LOGITS_REL_TOL_INT8:
        fail(f"{where} int8 decode logits differ: {rel} > "
             f"{LOGITS_REL_TOL_INT8}")


# ---------------------------------------------------------------------------
# phases 8-10: zamba2-1.2b (hybrid: Mamba2 + a shared block), dense KV
# ---------------------------------------------------------------------------

#: phase 9: 8 requests (16 until phase 26 needed the time) on 6 slots,
#: so two wait in the queue and take slots freed mid-decode
ZAMBA_REQUESTS, ZAMBA_SLOTS = 8, 6


def zamba_generate_path(dev):
    """Main path 3: zamba2-1.2b at full width and depth through
    ``Engine.generate``: 8 prompts of 512 tokens, 32 greedy tokens, dense
    KV; each prefill runs the SSD kernel once per Mamba2 layer and the
    flash kernel once per shared-block application."""
    from repro_torch.configs.zamba2_1_2b import CONFIG
    from repro_torch.models.lm import _hybrid_groups
    from repro_torch.serve.engine import Engine, ServeConfig
    lm = build_lm(CONFIG, dev)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, CONFIG.vocab, ZAMBA_PROMPT_LEN).tolist()
               for _ in range(ZAMBA_PROMPTS)]
    eng = Engine(lm, ServeConfig(max_seq=1024), device=dev)
    groups = len(_hybrid_groups(CONFIG.n_layers, CONFIG.attn_every))
    launches = timed_generate(
        eng, prompts, MAX_NEW,
        {"ssd_scan": CONFIG.n_layers, "flash_attention": groups,
         "argmax": MAX_NEW, "paged_decode": 0, "paged_decode_q8": 0},
        "zamba2-1.2b")
    return lm, launches


def zamba_scheduler_path(lm):
    """Main path 4: zamba2-1.2b behind ``BatchScheduler`` with dense KV:
    8 requests of 64-512-token prompts, budgets 16-48, 6 slots; each
    admission prefills one row at its exact length and merges its SSD
    state, conv tail and KV caches into the slot."""
    from repro_torch.models.lm import _hybrid_groups
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = lm.cfg
    rng = np.random.default_rng(11)
    work = [(rng.integers(1, cfg.vocab, int(n)).tolist(), int(b), 1)
            for n, b in zip(rng.integers(64, 513, ZAMBA_REQUESTS),
                            rng.integers(16, 49, ZAMBA_REQUESTS))]
    eng = Engine(lm, ServeConfig(max_seq=1024, batch_slots=ZAMBA_SLOTS,
                                 admission_chunk=8), device=lm.device)
    groups = len(_hybrid_groups(cfg.n_layers, cfg.attn_every))
    return checked_scheduler(
        eng, work, lambda m: {
            "ssd_scan": cfg.n_layers * m["admissions"],
            "flash_attention": groups * m["admissions"],
            "argmax": m["decode_steps"], "paged_decode": 0,
            "paged_decode_q8": 0}, "zamba2-1.2b scheduler")


def zamba_token_check(dev):
    """fp32, full width, 7 layers (groups of 6 and 1), dense KV, two
    prompts of 300 tokens (a full chunk of 256 and a ragged one)."""
    from repro_torch.configs.zamba2_1_2b import CONFIG
    from repro_torch.models.lm import _hybrid_groups
    from repro_torch.serve.engine import ServeConfig
    cfg = dataclasses.replace(CONFIG, n_layers=7)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, 300).tolist() for _ in range(2)]
    groups = len(_hybrid_groups(cfg.n_layers, cfg.attn_every))
    card_cpu_tokens(dev, cfg, 4, prompts, ServeConfig(max_seq=512),
                    {"ssd_scan": cfg.n_layers, "flash_attention": groups,
                     "argmax": 8}, "zamba2")


# ---------------------------------------------------------------------------
# phases 11-12: the tool layer's case studies (STREAM triad, Jacobi-7)
# ---------------------------------------------------------------------------

TRIAD_N = 1 << 27                 # 512 MiB per fp32 array, 1.5 GiB in all
STENCIL = (512, 512, 512)
SWEEPS = 4


def check_triad(dev, timer):
    from repro_torch.kernels.stream_triad import (stream_triad,
                                                  stream_triad_plain)
    gen = torch.Generator(device=dev).manual_seed(6)
    err, last = 0.0, None
    for n in (128, 4096, 128 * 513, TRIAD_N):
        for dtype in (torch.float32, torch.bfloat16):
            b = torch.randn(n, generator=gen, device=dev).to(dtype)
            c = torch.randn(n, generator=gen, device=dev).to(dtype)
            for pipelined in (True, False) if n < TRIAD_N else (True,):
                got = stream_triad(b, c, pipelined=pipelined)
                want = stream_triad_plain(b, c)
                torch.cuda.synchronize()
                e = close(f"triad N={n} {str(dtype)[6:]} pipelined="
                          f"{pipelined}", got, want)
            if n == TRIAD_N and dtype == torch.float32:
                err, last = e, (b, c)
            if n == 128 * 513:       # the schedule never changes a bit
                base = stream_triad(b, c)
                for rows in (1, 3, 256):
                    if not torch.equal(stream_triad(b, c, block_rows=rows),
                                       base):
                        fail(f"triad N={n} {dtype}: block_rows={rows} "
                             f"changes the result")
                if not torch.equal(stream_triad(b, c, pipelined=False),
                                   base):
                    fail(f"triad N={n} {dtype}: one CTA changes the result")
                log(f"  ok triad N={n} {str(dtype)[6:]}: bit-equal across "
                    f"block_rows 1, 3, 256, default and one CTA")
        # views that start 4 bytes past a 16-byte boundary: scalar path
        buf = torch.randn(n + 1, generator=gen, device=dev)
        close(f"triad N={n} fp32 unaligned views",
              stream_triad(buf[1:], buf[:-1]),
              stream_triad_plain(buf[1:], buf[:-1]))
    b, c = last
    a = torch.empty_like(b)
    ms = timer.ms(lambda: stream_triad(b, c))
    plain_ms = timer.ms(lambda: stream_triad_plain(b, c))
    library_ms = timer.ms(lambda: torch.add(b, c, alpha=2.5, out=a))
    bms, by = bound_ms(3 * 4 * TRIAD_N, 2.0 * TRIAD_N, F32_FLOPS)
    b16, c16 = b.bfloat16(), c.bfloat16()
    a16 = torch.empty_like(b16)
    log(f"  triad N=2^27 bf16: {timer.ms(lambda: stream_triad(b16, c16)):.4f}"
        f" ms, torch.add bf16 "
        f"{timer.ms(lambda: torch.add(b16, c16, alpha=2.5, out=a16)):.4f} "
        f"ms (bound {bound_ms(3 * 2 * TRIAD_N, 0.0)[0]:.4f})")
    return dict(name="stream_triad", route="cuda",
                source="src/repro_torch/csrc/stream_triad.cu",
                replaces="src/repro/kernels/stream_triad.py:32",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def check_jacobi(dev, timer):
    from repro_torch.kernels.jacobi7 import (BLOCK_X, MAX_SWEEPS, TILE_YZ,
                                             jacobi7_naive,
                                             jacobi7_valid_plain,
                                             jacobi7_wavefront,
                                             kernel_bytes, lattice_updates)
    gen = torch.Generator(device=dev).manual_seed(7)
    err = 0.0
    default = (BLOCK_X, *TILE_YZ)
    # (37, 45, 99) is no multiple of any tile: ragged edge columns
    # everywhere, z rows not 16-byte aligned (4-byte copies)
    for shape in ((10, 18, 130), (16, 26, 130), (37, 45, 99), STENCIL):
        x = torch.randn(shape, generator=gen, device=dev)
        for t in range(1, SWEEPS + 1):
            got = (jacobi7_naive(x) if t == 1
                   else jacobi7_wavefront(x, sweeps=t))
            e = close(f"jacobi7 {shape} T={t}", got,
                      jacobi7_valid_plain(x, t))
            if shape == STENCIL and t == SWEEPS:
                err = e
        if shape == (37, 45, 99):     # the tile must not change a bit
            base = jacobi7_wavefront(x, sweeps=3)
            for tile in ((4, 8, 32), (3, 5, 7), (16, 16, 16), (8, 16, 64),
                         (16, 32, 64), (64, 16, 64)):
                if not torch.equal(jacobi7_wavefront(x, sweeps=3, tile=tile),
                                   base):
                    fail(f"jacobi7 result depends on the tile ({tile})")
            log(f"  ok jacobi7 (37, 45, 99) T=3: bit-equal across tiles "
                f"(default {default}, x columns of 3 to 64 planes)")
            # the deepest fusions a launch takes (on a tile whose planes
            # fit), and one past them
            small = (16, 8, 32)
            for t in (6, MAX_SWEEPS):
                close(f"jacobi7 {shape} T={t} tile {small}",
                      jacobi7_wavefront(x, sweeps=t, tile=small),
                      jacobi7_valid_plain(x, t))
            try:
                jacobi7_wavefront(x, sweeps=MAX_SWEEPS + 1, tile=small)
            except ValueError as e:
                if "fuses at most" not in str(e):
                    raise
                log(f"  ok jacobi7 T={MAX_SWEEPS + 1} refused on the card")
            else:
                fail(f"jacobi7 ran T={MAX_SWEEPS + 1} sweeps in one launch")
    # 16-byte copies (z rows aligned) against the same data through
    # 4-byte copies (a view one element past a 16-byte boundary), and the
    # default tile against others streaming other x extents, at 512^3
    buf = torch.empty(x.numel() + 1, device=dev)
    xu = buf[1:].view(STENCIL)
    xu.copy_(x)
    for t in (1, SWEEPS):
        base = jacobi7_wavefront(x, sweeps=t)
        others = [("4-byte copies", jacobi7_wavefront(xu, sweeps=t))]
        # (bz = 60: no whole 32-byte sectors a row, stores transposed)
        for tile in ((64, 16, 64), (256, 16, 64), (8, 16, 64), (64, 16, 60)):
            others.append((f"tile {tile}",
                           jacobi7_wavefront(x, sweeps=t, tile=tile)))
        for what, got in others:
            if not torch.equal(got, base):
                fail(f"jacobi7 {STENCIL} T={t}: {what} changes the result")
    log(f"  ok jacobi7 {STENCIL} T=1, {SWEEPS}: bit-equal across 16- and "
        f"4-byte copies, direct and transposed stores, and tiles "
        f"(default {default}, 64|256|8 x 16 x 64, 64 x 16 x 60)")
    del buf, xu
    ms = timer.ms(lambda: jacobi7_wavefront(x, sweeps=SWEEPS))
    plain_ms = timer.ms(lambda: jacobi7_valid_plain(x, SWEEPS))
    nbytes = 4 * (x.numel() + np.prod([s - 2 * SWEEPS for s in STENCIL]))
    flops = 6.0 * sum(np.prod([s - 2 * t for s in STENCIL])
                      for t in range(1, SWEEPS + 1))
    bms, by = bound_ms(float(nbytes), float(flops), F32_FLOPS)
    # one naive sweep, against one cuDNN convolution with the same filter;
    # cuDNN's fp32 convolutions default to TF32, so it is switched off
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros((1, 1, 3, 3, 3), device=dev)
    for i in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
              (1, 1, 2)):
        w[(0, 0) + i] = 1.0 / 6.0
    conv = torch.nn.functional.conv3d
    x5 = x[None, None]
    close("conv3d yardstick (cudnn.allow_tf32 = False) vs one naive sweep",
          conv(x5, w)[0, 0], jacobi7_naive(x))
    naive_ms = timer.ms(lambda: jacobi7_naive(x))
    naive_plain_ms = timer.ms(lambda: jacobi7_valid_plain(x, 1))
    conv_ms = timer.ms(lambda: conv(x5, w))
    nbytes1 = 4 * (x.numel() + np.prod([s - 2 for s in STENCIL]))
    naive_bound = bound_ms(nbytes1, 6.0 * np.prod([s - 2 for s in STENCIL]),
                           F32_FLOPS)
    log(f"  jacobi7 naive {STENCIL} one sweep: {naive_ms:.4f} ms (plain "
        f"{naive_plain_ms:.4f}, conv3d with TF32 off {conv_ms:.4f}, bound "
        f"{naive_bound[0]:.4f} by {naive_bound[1]})")

    # the paper's order: one T-sweep wavefront against T naive sweeps
    def naive_steps():
        y = x
        for _ in range(SWEEPS):
            y = jacobi7_naive(y)
        return y

    four = timer.ms(naive_steps)
    updates = lattice_updates(STENCIL, SWEEPS)
    four_bytes = sum(kernel_bytes([n - 2 * k for n in STENCIL], 1, default)
                     for k in range(SWEEPS))
    log(f"  jacobi7 {STENCIL} {SWEEPS} steps: wavefront T={SWEEPS} "
        f"{ms:.4f} ms ({updates / ms / 1e3:.0f} MLUPS, "
        f"{kernel_bytes(STENCIL, SWEEPS, default) / ms / 1e6:.1f} GB/s "
        f"declared) against {SWEEPS} naive sweeps {four:.4f} ms "
        f"({updates / four / 1e3:.0f} MLUPS, {four_bytes / four / 1e6:.1f} "
        f"GB/s declared): the wavefront is "
        f"{'faster' if ms < four else 'slower'}")
    return dict(name="jacobi7", route="cuda",
                source="src/repro_torch/csrc/jacobi7.cu",
                replaces="src/repro/kernels/jacobi7.py:60",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def case_counters():
    from repro_torch.kernels.jacobi7 import jacobi7_sweeps
    from repro_torch.kernels.stream_triad import stream_triad
    return {"stream_triad": stream_triad, "jacobi7": jacobi7_sweeps}


def perfctr_path(dev):
    """This slice's main path: both case studies at full size through
    ``PerfCtr`` marker regions (the benches' own ``run``), then the
    bandwidth map.  Kernels were warmed up at these shapes in phase 11, so
    the regions run no untimed call and every launch counts."""
    from repro_torch.bench import bench_jacobi_traffic, bench_stream_pinning
    from repro_torch.core.bandwidth import measure_map, model_map, render_map
    from repro_torch.core.perfctr import PerfCtr
    ctr = PerfCtr(groups=("HBM", "ROOFLINE"), device=dev)
    for f in case_counters().values():
        f.launches = 0
    stream = bench_stream_pinning.run(ctr, n=TRIAD_N, samples=100, warmup=0)
    jac = bench_jacobi_traffic.run(ctr, shape=STENCIL, sweeps=SWEEPS,
                                   repeats=10, warmup=0)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in case_counters().items()}
    log(ctr.report())
    log(bench_jacobi_traffic.render(jac))
    per_kernel = {"stream_triad": 0.0, "jacobi7": 0.0}
    for name, m in ctr.regions.items():
        n = m.events["LAUNCHES"]
        if n < 1:
            fail(f"perfctr region {name!r} recorded no launch")
        per_kernel["stream_triad" if name.startswith("triad")
                   else "jacobi7"] += n
    if per_kernel != {k: float(v) for k, v in launches.items()}:
        fail(f"region LAUNCHES {per_kernel} != wrapper counters {launches}")
    hbm = ctr.chip.hbm_bw
    gbps = stream["gbps_median"]
    log(f"  triad 2^27 fp32: median {stream['median_s'] * 1e3:.4f} ms "
        f"[q1 {stream['q1_s'] * 1e3:.4f}, q3 {stream['q3_s'] * 1e3:.4f}] "
        f"= {gbps:.1f} GB/s (best {stream['gbps_best']:.1f}), "
        f"{gbps * 1e9 / hbm:.3f} of the data-sheet {hbm / 1e9:.0f} GB/s")
    if stream["gbps_best"] * 1e9 > 1.05 * hbm:
        fail(f"triad reads {stream['gbps_best']:.1f} GB/s, over 105% of "
             f"the HBM peak")

    pts = measure_map(device=dev, chip=ctr.chip)
    log(render_map(pts, title=f"bandwidth map — {ctr.chip.name} (measured, "
                              f"triad kernel, L2 not flushed)"))
    log(render_map(model_map(ctr.chip),
                   title=f"bandwidth map — {ctr.chip.name} (data sheet)"))
    for p in pts:
        if (p.working_set_bytes >= 4 * ctr.chip.l2_bytes
                and p.bandwidth_best > 1.05 * hbm):
            fail(f"bandwidth map: {p.bandwidth_best / 1e9:.1f} GB/s at "
                 f"{p.working_set_bytes} B, over 105% of the HBM peak")
    if pts[-1].working_set_bytes < 0.99 * 2**31:
        fail("the bandwidth map stops short of 2 GiB")
    return launches


# ---------------------------------------------------------------------------
# phases 13-14: sampled and speculative decoding
# ---------------------------------------------------------------------------

SAMPLED = (("top_k 50", dict(top_k=50)), ("top_p 0.9", dict(top_p=0.9)))
TEMPERATURE = 0.7
SPEC_K = 4
DRAFT_LAYERS = 2
#: phase 14's scheduler: 8 requests (16 until phase 26 needed the time)
#: on 6 slots, so two wait in the queue
SPEC_REQUESTS, SPEC_SLOTS = 8, 6


def qwen2(dev, dtype, embed_scale=1.0):
    """qwen2-0.5b at full width and depth, random weights from seed 0."""
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    lm = LM(CONFIG, dtype, dev).init(torch.Generator(device=dev).manual_seed(0))
    lm.embed.table.data.mul_(embed_scale)
    return lm


def matched_draft(lm):
    """The target's first DRAFT_LAYERS blocks with its embedding, final norm
    and (tied) head, shared, not copied: a draft that agrees with the
    target as far as its first blocks decide."""
    from repro_torch.models.lm import LM
    dcfg = dataclasses.replace(lm.cfg, name=f"{lm.cfg.name}-draft"
                               f"{DRAFT_LAYERS}", n_layers=DRAFT_LAYERS)
    draft = LM(dcfg, lm.dtype, lm.device)
    draft.embed = lm.embed
    draft.final_norm = lm.final_norm
    draft.blocks = torch.nn.ModuleList(list(lm.blocks[:DRAFT_LAYERS]))
    return draft


def expect_launches(where, launches, want):
    for k, n in want.items():
        if launches[k] != n:
            fail(f"{k} launched {launches[k]} times on the {where}, "
                 f"expected {n}")


def sampled_path(dev, lm):
    """Phase 13: sampled ``Engine.generate`` (top_k, then top_p) at full
    width; every token is kernel #4 over Gumbel-shifted logits."""
    from repro_torch.kernels.sampling import (argmax_plain, block_argmax,
                                              filtered_logits, gumbel_shift)
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = lm.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    greedy = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024)
                    ).generate(prompts, max_new_tokens=MAX_NEW)
    n_layers = cfg.n_layers
    want = {"flash_attention": n_layers,
            "paged_decode": n_layers * (MAX_NEW - 1), "argmax": MAX_NEW,
            "paged_decode_q8": 0, "ssd_scan": 0}
    launches = None
    for name, filt in SAMPLED:
        eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024,
                                     temperature=TEMPERATURE, seed=5,
                                     **filt))
        outs, walls = [], []
        for _ in range(2):
            reset_counters()
            syncs0 = eng.host_syncs
            t0 = time.perf_counter()
            outs.append(eng.generate(prompts, max_new_tokens=MAX_NEW))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = read_counters()
            expect_launches(f"sampled generate ({name})", launches, want)
            if eng.host_syncs - syncs0 != 1:
                fail(f"sampled generate made {eng.host_syncs - syncs0} "
                     f"host syncs, expected 1")
        if outs[0] != outs[1]:
            fail(f"sampled generate ({name}): the same seed gave other "
                 f"tokens")
        if [len(o) for o in outs[0]] != [MAX_NEW] * len(prompts) or not all(
                0 <= t < cfg.vocab for o in outs[0] for t in o):
            fail(f"sampled generate ({name}): bad output")
        # one step's #4 launch against its plain twin over the SAME
        # shifted logits (a top_k row is -inf outside its 50 tokens; the
        # edge row has one finite entry, at the vocabulary's end)
        toks, lens, extra = eng._check_call(prompts, MAX_NEW, None)
        with torch.inference_mode():
            logits, _ = eng._prefill_call(toks, lens, prompts, MAX_NEW,
                                          extra)
            x = filtered_logits(logits, temperature=TEMPERATURE,
                                k=filt.get("top_k", 0),
                                p=filt.get("top_p", 1.0))
            top1 = torch.softmax(x.float(), dim=-1).amax(dim=-1)
            x = gumbel_shift(x, torch.Generator(device=dev).manual_seed(9))
            x[0] = -torch.inf
            x[0, -1] = 0.0
            got, plain = block_argmax(x), argmax_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, plain) or int(got[0]) != cfg.vocab - 1:
            fail(f"argmax over shifted logits ({name}): kernel "
                 f"{got.tolist()} != plain {plain.tolist()}")
        kept = int(torch.isfinite(x[1]).sum())
        # the draws are live: a first step whose distributions are spread
        # (mean top-1 probability < 0.5) cannot give the greedy token in
        # every row but by a chance under 0.5^8
        p1 = float(top1.mean())
        first_greedy = all(o[0] == g[0] for o, g in zip(outs[0], greedy))
        if first_greedy and p1 < 0.5:
            fail(f"sampled generate ({name}): every first token is the "
                 f"greedy one at a mean top-1 probability of {p1:.3f}")
        n_greedy = sum(a == b for o, g in zip(outs[0], greedy)
                       for a, b in zip(o, g))
        log(f"  sampled generate ({name}, T {TEMPERATURE}): "
            f"{len(prompts) * MAX_NEW / walls[1]:.1f} tokens/s "
            f"({walls[1] * 1e3:.2f} ms a call, {walls[0] * 1e3:.2f} the "
            f"first); the same seed twice gives the same tokens; host_syncs "
            f"1 a call; #4 over the shifted logits equals its plain twin "
            f"({kept} finite logits in row 1); the first step's mean top-1 "
            f"probability {p1:.4f}, {n_greedy} of "
            f"{len(prompts) * MAX_NEW} tokens equal greedy's; launches "
            f"{launches}")
        log(f"  first tokens: {[o[:4] for o in outs[1]]}")
    return launches


def spec_fused_launches(rounds, cfg, k=SPEC_K, greedy=True):
    """Launches one spec ``generate`` implies: both prompt prefills (#1),
    K+1 draft decode steps a round (#2), and #4 for ``y``, the K+1 draft
    samples and, greedy, the verify's argmax."""
    return {"flash_attention": cfg.n_layers + DRAFT_LAYERS,
            "paged_decode": rounds * (k + 1) * DRAFT_LAYERS,
            "argmax": rounds * (k + 2 + int(greedy)),
            "paged_decode_q8": 0, "ssd_scan": 0}


def spec_path(dev, lm):
    """Phase 14: speculative decoding, K = 4, the 2-layer matched draft:
    fp32 parity with target-only greedy (fused and streamed), bf16 against
    target-only, then a mixed spec / non-spec BatchScheduler."""
    from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                          ServeConfig)
    from repro_torch.serve.spec import SpecConfig
    cfg = lm.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    sc = ServeConfig(page_size=PAGE_SIZE, max_seq=1024)
    blind = -(-MAX_NEW // (SPEC_K + 1))

    # ---- fp32: the reference's own invariant (the embedding scaled by 0.1,
    # as in phase 6, so tokens depend on every layer)
    lm32 = qwen2(dev, torch.float32, embed_scale=0.1)
    d32 = matched_draft(lm32)
    spec = SpecConfig(draft_config=d32.cfg, num_draft_tokens=SPEC_K)
    want = Engine(lm32, sc).generate(prompts, max_new_tokens=MAX_NEW)
    eng = Engine(lm32, sc, spec=spec, draft_lm=d32)
    reset_counters()
    syncs0 = eng.host_syncs
    fused = eng.generate(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    st = dict(eng.spec_stats)
    expect_launches("fp32 spec generate", read_counters(),
                    spec_fused_launches(st["rounds"], cfg))
    fused_syncs = eng.host_syncs - syncs0
    if fused_syncs != st["rounds"] - blind + 1:
        fail(f"fp32 spec generate made {fused_syncs} syncs over "
             f"{st['rounds']} rounds")
    events = []
    reset_counters()
    streamed = eng.generate(prompts, max_new_tokens=MAX_NEW,
                            stream_cb=lambda i, t, d: events.append(len(t)))
    torch.cuda.synchronize()
    expect_launches("fp32 spec streaming", read_counters(),
                    spec_fused_launches(eng.spec_stats["rounds"], cfg))
    log(f"  fp32 target-only: {[o[:6] for o in want]}")
    if fused != want or streamed != want:
        fail(f"fp32 greedy spec tokens differ from target-only: fused "
             f"{fused}, streamed {streamed}, target-only {want}")
    log(f"  fp32 spec greedy == target-only greedy, fused and streamed; "
        f"accept rate {st['accept_rate']:.4f} ({st['accepted']} of "
        f"{st['proposed']}), rounds {st['rounds']}, host_syncs "
        f"{fused_syncs}; streaming: {len(events)} callback "
        f"waves for {sum(events)} tokens in {eng.spec_stats['rounds']} "
        f"rounds")
    del lm32, d32, eng
    torch.cuda.empty_cache()

    # ---- bf16 at full width: spec beside target-only
    draft = matched_draft(lm)
    spec = SpecConfig(draft_config=draft.cfg, num_draft_tokens=SPEC_K)
    base = Engine(lm, sc)
    eng = Engine(lm, sc, spec=spec, draft_lm=draft)
    rates = {}
    for name, e in (("target-only", base), ("spec", eng)):
        out0 = e.generate(prompts, max_new_tokens=MAX_NEW)      # warm-up
        torch.cuda.synchronize()
        reset_counters()
        syncs0 = e.host_syncs
        t0 = time.perf_counter()
        out = e.generate(prompts, max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        if out != out0:
            fail(f"bf16 {name} generate is not deterministic")
        rates[name] = (len(prompts) * MAX_NEW / wall, wall,
                       e.host_syncs - syncs0, out)
    st = dict(eng.spec_stats)
    expect_launches("bf16 spec generate", launches,
                    spec_fused_launches(st["rounds"], cfg))
    gen_launches = launches
    same = sum(a == b for a, b in zip(rates["spec"][3],
                                      rates["target-only"][3]))
    log(f"  bf16 target-only: {rates['target-only'][0]:.1f} tokens/s "
        f"({rates['target-only'][1] * 1e3:.2f} ms, host_syncs "
        f"{rates['target-only'][2]})")
    log(f"  bf16 spec K={SPEC_K}, {DRAFT_LAYERS}-layer matched draft: "
        f"{rates['spec'][0]:.1f} tokens/s ({rates['spec'][1] * 1e3:.2f} ms, "
        f"host_syncs {rates['spec'][2]}); accept rate "
        f"{st['accept_rate']:.4f} ({st['accepted']} of {st['proposed']}), "
        f"rounds {st['rounds']}; rows equal to target-only {same} of "
        f"{len(prompts)}; launches {launches}")

    # ---- the scheduler: 6 slots, bf16 pages, half the requests spec
    seng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024,
                                  batch_slots=SPEC_SLOTS, admission_chunk=8),
                  spec=spec, draft_lm=draft)
    srng = np.random.default_rng(7)
    work = [(srng.integers(1, cfg.vocab, int(srng.integers(16, 257))
                           ).tolist(), int(srng.integers(16, 49)), r % 2 == 0)
            for r in range(SPEC_REQUESTS)]

    def run():
        sched = BatchScheduler(seng)
        for rid, (p, budget, sp) in enumerate(work):
            sched.submit(Request(rid=rid, prompt=p, max_new_tokens=budget,
                                 spec=sp))
        return sched, sched.run()

    run()                                                    # warm-up
    torch.cuda.synchronize()
    reset_counters()
    syncs0 = seng.host_syncs
    t0 = time.perf_counter()
    sched, out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    m = sched.metrics
    if sorted(out) != list(range(SPEC_REQUESTS)):
        fail(f"spec scheduler completed {sorted(out)}")
    for rid, (_, budget, _) in enumerate(work):
        if len(out[rid].generated) != budget:
            fail(f"spec request {rid}: {len(out[rid].generated)} tokens, "
                 f"budget {budget}")
    if seng.host_syncs - syncs0 != m["segments"]:
        fail(f"spec scheduler made {seng.host_syncs - syncs0} host syncs "
             f"for {m['segments']} segments")
    sched.check()
    sched.pool.check()
    if not sched.pool.allocs == sched.pool.releases > 0:
        fail(f"spec scheduler leaked pages: {sched.pool!r}")
    misses = m["admissions"] - m["prefix_hits"]
    seg = int(m["segments"])
    expect_launches("spec scheduler", launches, {
        "flash_attention": cfg.n_layers * misses
        + DRAFT_LAYERS * m["admissions"],
        "paged_decode": seg * (SPEC_K + 1) * DRAFT_LAYERS,
        "argmax": seg * (SPEC_K + 3), "paged_decode_q8": 0, "ssd_scan": 0})
    new_tokens = sum(len(r.generated) for r in out.values())
    rate = m["draft_accepted"] / max(m["draft_proposed"], 1)
    log(f"  spec scheduler: {SPEC_REQUESTS} requests on {SPEC_SLOTS} slots "
        f"({sum(w[2] for w in work)} spec), {new_tokens} "
        f"tokens in {wall * 1e3:.2f} ms = {new_tokens / wall:.1f} tokens/s; "
        f"rounds {seg} = segments = host_syncs {seng.host_syncs - syncs0}; "
        f"accept rate {rate:.4f} ({m['draft_accepted']:.0f} of "
        f"{m['draft_proposed']:.0f}); KVPool.check() and scheduler.check() "
        f"pass; launches {launches}")
    return gen_launches, launches


# ---------------------------------------------------------------------------
# phase 15: serving snapshots, restore and chaos injection
# ---------------------------------------------------------------------------

SNAP_BUDGETS = [9, 12, 16]
SNAP_KILL = 2           # (a): segments before the kill
CHAOS_KILL = 8          # (b): segments before the kill, past every event


def snapshot_dir():
    """A fresh directory for snapshots inside the checkout's git-ignored
    build tree."""
    import tempfile
    base = ROOT / "build" / "snapshots"
    base.mkdir(parents=True, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=base)


def instrument_snapshots(sched, writes, applies):
    """Time every snapshot write (with its file's bytes and index pages)
    and the restore's page write-back, each ended by a synchronize."""
    write, apply = sched._write_snapshot, sched._apply_restore_index

    def timed_write(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = write(*args, **kwargs)
        dt = time.perf_counter() - t0
        if path is not None:
            writes.append((dt, Path(path).stat().st_size,
                           sched.ft_events[-1]["index_pages"]))
        return path

    def timed_apply(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply(state)
        torch.cuda.synchronize()
        applies.append(time.perf_counter() - t0)
        return out

    sched._write_snapshot = timed_write
    sched._apply_restore_index = timed_apply


def indexed_snapshots(sched):
    return sum(1 for e in sched.ft_events
               if e["type"] == "snapshot" and e["index_pages"])


def check_snapshot_syncs(where, eng, syncs0, sched):
    syncs = eng.host_syncs - syncs0
    want = sched.metrics["segments"] + indexed_snapshots(sched)
    if syncs != want:
        fail(f"{where}: {syncs} host syncs, expected segments "
             f"{sched.metrics['segments']:.0f} + indexed snapshots "
             f"{indexed_snapshots(sched)}")


def snap_stats(writes):
    ms = [w[0] * 1e3 for w in writes]
    nbytes = [w[1] for w in writes]
    pages = [w[2] for w in writes]
    return (f"{len(writes)} snapshots, {min(nbytes)}-{max(nbytes)} bytes "
            f"(median {statistics.median(nbytes):.0f}), index pages "
            f"{min(pages)}-{max(pages)}, write {min(ms):.2f}-{max(ms):.2f} "
            f"ms (median {statistics.median(ms):.2f})")


def first_divergence(got, want):
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        if a != b:
            k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return f"request {rid} first differs at token {k}: {a} vs {b}"
    return "none"


def snapshot_parity(dev, smi):
    """Phase 15(a): fp32, full width, 2 layers, fp32 pages of 16 and the
    prefix cache: killed after SNAP_KILL segments with a snapshot after
    each, restored on a FRESH engine, run to the end; every request's
    tokens must equal an uninterrupted card run's."""
    from repro_torch.bench.profile_serve import shared_prefix_workload
    from repro_torch.checkpoint import store
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                          ServeConfig)
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    lm = LM(cfg, torch.float32, dev).init(
        torch.Generator(device=dev).manual_seed(2))
    lm.embed.table.data.mul_(0.1)
    work = shared_prefix_workload(cfg.vocab, 6, 40, [3, 9, 17, 30],
                                  SNAP_BUDGETS, seed=5)
    sc = ServeConfig(page_size=PAGE_SIZE, max_seq=128, batch_slots=3,
                     admission_chunk=4, kv_dtype="fp32")

    def submit(sched):
        for rid, (p, budget, prio) in enumerate(work):
            sched.submit(Request(rid=rid, prompt=p, max_new_tokens=budget,
                                 priority=prio))
        return sched

    base = submit(BatchScheduler(Engine(lm, sc, device=dev)))
    base.run()
    want = {rid: list(r.generated) for rid, r in base.completed.items()}
    writes, applies = [], []
    with snapshot_dir() as d:
        reset_counters()
        eng = Engine(lm, sc, device=dev)
        sched = submit(BatchScheduler(eng, snapshot_dir=d, snapshot_every=1))
        instrument_snapshots(sched, writes, applies)
        sched.run(max_segments=SNAP_KILL)
        check_snapshot_syncs("15(a) killed run", eng, 0, sched)
        if len(sched.completed) >= len(work):
            fail("15(a): the kill left nothing to restore")
        snap = store.latest_snapshot(d)
        eng2 = Engine(lm, sc, device=dev)               # fresh pool, fresh state
        t0 = time.perf_counter()
        sched2 = eng2.restore(snap)
        load_ms = (time.perf_counter() - t0) * 1e3
        instrument_snapshots(sched2, [], applies)
        sched2.run()
        torch.cuda.synchronize()
        launches = read_counters()
    got = {rid: list(r.generated) for rid, r in sched2.completed.items()}
    restore_ev = [e for e in sched2.ft_events if e["type"] == "restore"][0]
    log(f"  15(a) uninterrupted: {want}")
    if got != want:
        fail(f"15(a): restored fp32 tokens differ from the uninterrupted "
             f"run: {first_divergence(got, want)}")
    if restore_ev["index_pages"] <= 0:
        fail(f"15(a): the restore used no page index: {restore_ev}")
    if sched2.metrics["prefix_hits"] < 1:
        fail("15(a): no restored request hit the page index")
    check_snapshot_syncs("15(a) restored run", eng2, 0, sched2)
    sched2.check()
    expect = {"flash_attention": 1, "paged_decode": 1, "argmax": 1}
    for k in expect:
        if launches[k] < 1:
            fail(f"15(a): {k} never launched on the snapshot path")
    log(f"  15(a) killed after {SNAP_KILL} segments; restored on a fresh "
        f"engine: {restore_ev['index_pages']} index pages, "
        f"{restore_ev['pending']} pending, load {load_ms:.2f} ms + page "
        f"write-back {applies[0] * 1e3:.3f} ms; tokens == uninterrupted "
        f"(fp32 pages, card); {snap_stats(writes)}; launches {launches} "
        f"[{smi}]")
    return launches


def chaos_path(dev, lm, smi):
    """Phase 15(b): qwen2-0.5b full width and depth, bf16, phase 5's
    traffic over int8 pages: tokens/s with snapshots every 0 and 1
    segments, then ``ChaosSchedule.smoke()`` with snapshots every 2,
    killed after CHAOS_KILL segments and restored on a fresh engine."""
    from repro_torch.bench import profile_serve as ps
    from repro_torch.checkpoint import store
    from repro_torch.ft.chaos import ChaosSchedule
    from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                          ServeConfig)
    cfg = lm.cfg
    sc = ServeConfig(page_size=ps.PAGE_SIZE, max_seq=1024,
                     batch_slots=ps.SLOTS, admission_chunk=8,
                     kv_dtype="int8")
    eng = Engine(lm, sc, device=dev)
    ps.run_scheduler(eng, ps.shared_prefix_workload(
        cfg.vocab, ps.SLOTS, ps.PREFIX, ps.SUFFIX_LENS, ps.BUDGETS, seed=1))
    work = ps.shared_prefix_workload(cfg.vocab, ps.REQUESTS, ps.PREFIX,
                                     ps.SUFFIX_LENS, ps.BUDGETS, seed=0)

    def submit(sched):
        for rid, (p, budget, prio) in enumerate(work):
            sched.submit(Request(rid=rid, prompt=p, max_new_tokens=budget,
                                 priority=prio))
        return sched

    rates, outs, writes = {}, {}, []
    # one turn each (four turns, 0, 1, 1, 0, until phase 25 needed the
    # time)
    for every in (0, 1):
        with snapshot_dir() as d:
            kw = dict(snapshot_dir=d, snapshot_every=1) if every else {}
            sched = submit(BatchScheduler(eng, **kw))
            if every:
                instrument_snapshots(sched, writes, [])
            torch.cuda.synchronize()
            syncs0 = eng.host_syncs
            t0 = time.perf_counter()
            sched.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check_snapshot_syncs(f"15(b) snapshot_every={every}", eng, syncs0,
                             sched)
        toks = {rid: list(r.generated) for rid, r in sched.completed.items()}
        if sorted(toks) != list(range(len(work))):
            fail(f"15(b) snapshot_every={every}: completed {sorted(toks)}")
        outs.setdefault(every, toks)
        if toks != outs[every] or toks != outs[0]:
            fail("15(b): snapshots changed the tokens of a bf16 run")
        rates.setdefault(every, []).append(
            sum(len(t) for t in toks.values()) / wall)
    base = outs[0]
    log(f"  15(b) tokens/s, snapshot_every 0: "
        f"{', '.join(f'{r:.1f}' for r in rates[0])}; snapshot_every 1: "
        f"{', '.join(f'{r:.1f}' for r in rates[1])} (turns 0, 1); "
        f"{snap_stats(writes)} [{smi}]")

    chaos = ChaosSchedule.smoke()
    applies = []
    with snapshot_dir() as d:
        reset_counters()
        eng1 = Engine(lm, sc, device=dev)
        sched = submit(BatchScheduler(eng1, snapshot_dir=d, snapshot_every=2,
                                      chaos=chaos))
        sched.run(max_segments=CHAOS_KILL)
        check_snapshot_syncs("15(b) chaos run", eng1, 0, sched)
        cs = chaos.summary()
        if cs["applied"] != len(chaos.events):
            fail(f"15(b): chaos applied {cs['applied']} of "
                 f"{len(chaos.events)} events: {cs}")
        if sorted(cs["skipped"]) != ["device_death", "heartbeat_flap"]:
            fail(f"15(b): unexpected skips {cs['skipped']}")
        notes = {e["kind"]: e.get("note", "") for e in sched.ft_events
                 if e["type"] == "chaos"}
        if not notes["snapshot_corrupt"].startswith("corrupted + detected"):
            fail(f"15(b): snapshot_corrupt: {notes['snapshot_corrupt']!r}")
        bad = sorted(Path(d).glob("*.corrupt"))
        if not bad:
            fail("15(b): no corrupted snapshot on disk")
        try:
            Engine(lm, sc, device=dev).restore(str(bad[0]))
        except store.SnapshotCorrupt:
            pass
        else:
            fail(f"15(b): Engine.restore accepted {bad[0].name}")
        snap = store.latest_snapshot(d)
        eng2 = Engine(lm, sc, device=dev)
        t0 = time.perf_counter()
        sched2 = eng2.restore(snap)
        load_ms = (time.perf_counter() - t0) * 1e3
        instrument_snapshots(sched2, [], applies)
        t0 = time.perf_counter()
        sched2.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
    check_snapshot_syncs("15(b) restored run", eng2, 0, sched2)
    sched2.check()
    sched2.pool.check()
    restore_ev = [e for e in sched2.ft_events if e["type"] == "restore"][0]
    for rid in range(len(work)):
        if not sched2.requests[rid].terminal:
            fail(f"15(b): request {rid} ended {sched2.requests[rid].status}")
    got = {rid: list(r.generated) for rid, r in sched2.completed.items()}
    same = sum(int(a == b) for rid, t in got.items()
               for a, b in zip(t, base[rid]))
    total = sum(len(t) for t in got.values())
    for k in ("flash_attention", "paged_decode_q8", "argmax"):
        if launches[k] < 1:
            fail(f"15(b): {k} never launched on the chaos path")
    kinds = [e["kind"] for e in sched.ft_events if e["type"] == "chaos"]
    log(f"  15(b) chaos (smoke schedule, snapshots every 2): events "
        f"{kinds}, {cs['checks']} invariant closures (KVPool.check + "
        f"scheduler.check), corrupt {bad[0].name} refused by the loader "
        f"and Engine.restore; killed after {CHAOS_KILL} segments with "
        f"{len(sched.completed)} done")
    log(f"  15(b) restore from {Path(snap).name}: "
        f"{restore_ev['index_pages']} index pages, {restore_ev['pending']} "
        f"pending, load {load_ms:.2f} ms + page write-back "
        f"{applies[0] * 1e3:.3f} ms; the rest ran in {wall * 1e3:.2f} ms; "
        f"{len(got)} done, {len(sched2.aborted)} aborted, all terminal; "
        f"tokens equal to the uninterrupted run {same} of {total} "
        f"({same / max(total, 1):.4f}); launches {launches} [{smi}]")
    return launches


# ---------------------------------------------------------------------------
# phase 16: the serving benches
# ---------------------------------------------------------------------------

#: (path name, bench module, run() kwargs, kernels its run must launch)
SERVING_BENCHES = (
    ("bench_serve", "bench_serve", {},
     ("flash_attention", "paged_decode", "argmax")),
    ("bench_paged_decode", "bench_paged_decode", {},
     ("flash_attention", "paged_decode", "paged_decode_q8", "argmax")),
    ("bench_flash_prefill", "bench_flash_prefill", {}, ("flash_attention",)),
    ("bench_spec", "bench_spec", {},
     ("flash_attention", "paged_decode", "argmax")),
    ("bench_serve_qwen2", "bench_serve",
     {"arch": "qwen2-0.5b", "smoke": True},
     ("flash_attention", "paged_decode", "argmax")),
    ("bench_spec_qwen2", "bench_spec",
     {"arch": "qwen2-0.5b", "smoke": True},
     ("flash_attention", "paged_decode", "argmax")),
)


def serving_benches(dev, smi):
    """Phase 16: the four serving benches' ``run()`` at the JAX benches'
    default sizes, then ``bench_serve`` and ``bench_spec`` at qwen2-0.5b's
    full width (``--smoke`` reps and lengths).  A failed correctness
    claim raises out of the bench and fails the script; a missed speed
    bar is printed, not fatal.  Each run is its own path: counters set to
    0 before it and read after."""
    import importlib
    by_path = {}
    for path, name, kw, kernels in SERVING_BENCHES:
        mod = importlib.import_module(f"repro_torch.bench.{name}")
        csv = []
        reset_counters()
        t0 = time.perf_counter()
        summary = mod.run(csv, device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counters()
        for k in kernels:
            if launches[k] < 1:
                fail(f"{path}: {k} never launched")
        by_path[path] = launches
        log(f"  {path} ({kw or 'default size'}): every claim held in "
            f"{secs:.1f} s; launches {launches}")
        for row in csv:
            log(f"    {row[0]}: {row[1]:.2f} ({row[2]})")
        for bar, b in summary.get("bars", {}).items():
            log(f"  bar {path}.{bar}: {b['value']:.4f} against "
                f"{b['bar']}: {'met' if b['met'] else 'MISSED'} [{smi}]")
    return by_path


# ---------------------------------------------------------------------------
# phase 17: the tool layer (topology, pin, features) and the kernel registry
# ---------------------------------------------------------------------------

#: the torch pins of phase 17: both serving families on their plain impls
TORCH_PINS = {"attention": "torch_flash", "paged_decode": "torch_paged"}
TORCH_PIN_SPEC = "attention=torch_flash,paged_decode=torch_paged"
REGISTRY_NEW = 16


def run_cli(args, timeout=300):
    """``python -m <args>`` from the repository root, with ``src`` on the
    path; fails the script on a non-zero exit."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        fail(f"python -m {' '.join(args)} exited {res.returncode}: "
             f"{res.stderr[-2000:]}")
    return res.stdout


def in_process(main, argv):
    """(return value, stdout) of a CLI ``main(argv)`` run in this process."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rv = main(argv)
    return rv, buf.getvalue()


def topology_check(dev, smi):
    """Phase 17(a): the probed card, the topology CLI, pin and features."""
    from repro_torch.core import hwinfo, topology
    from repro_torch.launch import features as features_cli
    from repro_torch.launch import pin as pin_cli
    topo = topology.probe()
    props = torch.cuda.get_device_properties(dev)
    chip = topo.chips[0] if topo.chips else None
    if topo.synthetic or topo.total_chips != 1:
        fail(f"probe(): synthetic={topo.synthetic}, "
             f"{topo.total_chips} chips")
    if chip.core_count != 132 or topo.chip_spec.sm_count != 132:
        fail(f"probe(): {chip.core_count} SMs, data sheet "
             f"{topo.chip_spec.sm_count}")
    if topo.chip_spec.l2_bytes != 50 * 2**20 or \
            getattr(props, "L2_cache_size", topo.chip_spec.l2_bytes) \
            != topo.chip_spec.l2_bytes:
        fail(f"probe(): L2 {topo.chip_spec.l2_bytes} B, device "
             f"{getattr(props, 'L2_cache_size', None)} B")
    if not 0.9 <= props.total_memory / topo.chip_spec.hbm_bytes <= 1.1:
        fail(f"probe(): memory {props.total_memory} B against the data "
             f"sheet's {topo.chip_spec.hbm_bytes} B")
    if topo.check_device:
        fail(f"probe(): check_device {list(topo.check_device)}")
    smi_name = smi.split(",")[0].strip()
    if smi_name != torch.cuda.get_device_name(0) or \
            hwinfo.lookup_chip(smi_name) is not topo.chip_spec:
        fail(f"nvidia-smi names {smi_name!r}, torch "
             f"{torch.cuda.get_device_name(0)!r}, the probe's sheet "
             f"{topo.chip_spec.name}")
    log(topo.render(graphical=True))
    log(f"  probe(): {topo.total_chips} card, {chip.core_count} SMs, L2 "
        f"{topo.chip_spec.l2_bytes} B, memory {props.total_memory} B, "
        f"check_device empty, {smi_name!r} as nvidia-smi names it")
    out = ROOT / "build" / "topology.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    run_cli(["repro_torch.launch.topology", "-g", "--json", str(out)])
    got = json.loads(out.read_text())
    if got["chips"] != 1 or got["synthetic"] or got["sm_count"] != [132] \
            or got["check_device"]:
        fail(f"launch.topology --json: {got}")
    log(f"  python -m repro_torch.launch.topology -g --json: {got['chips']} "
        f"chip, {got['chip']}, SMs {got['sm_count']}, synthetic "
        f"{got['synthetic']}")
    rv, text = in_process(pin_cli.main, ["--compare"])
    rows = [ln.split() for ln in text.splitlines()[1:]]
    hops = {(r[0], r[1]): float(r[2]) for r in rows}
    if rv != 0 or hops[("compact", "0")] != 1.0 or \
            hops[("ring", "1")] != 1.0:
        fail(f"launch.pin --compare: {text}")
    log("  launch.pin --compare:\n" + text.rstrip())
    rv, text = in_process(features_cli.main, [
        "--set", "remat_policy=full", "matmul_precision=high", "--export",
        "--torch-settings"])
    if rv != 0 or "export REPRO_FEATURE_REMAT_POLICY=full" not in text or \
            "set_float32_matmul_precision('high')" not in text:
        fail(f"launch.features --set ... --export: {text}")
    log("  launch.features --set remat_policy=full matmul_precision=high "
        "--export --torch-settings: ok")


class LogitsRecorder:
    """Records, in order, the logits every ``Engine._sample`` call of the
    engines built while it is open samples from (prefill's, then each
    decode step's), so two runs can be held to each other step by step,
    not only by their greedy tokens."""

    def __init__(self):
        self.steps = []

    def __enter__(self):
        from repro_torch.serve.engine import Engine
        self._orig = Engine._sample
        orig, steps = self._orig, self.steps

        def sample(eng, logits, generator):
            steps.append(logits.detach().float().clone())  # no sync
            return orig(eng, logits, generator)

        Engine._sample = sample
        return self

    def __exit__(self, *exc):
        from repro_torch.serve.engine import Engine
        Engine._sample = self._orig
        return False


def logits_parity(where, got, want, tol=None):
    """Every recorded step of ``got`` against ``want``: max|d| over the
    step's max|logit| within ``tol`` (default :data:`LOGITS_REL_TOL`,
    phase 6's fp32 test of logits that went through a whole model; a
    kernel's own fp32 tolerance, phase 3's 1e-5, is a bound for one call:
    the 24 layers' differences in summation order come to ~2e-5 absolute
    in the prefill logits).  Returns the largest |difference| and the
    largest ratio."""
    tol = LOGITS_REL_TOL if tol is None else tol
    if len(got) != len(want):
        fail(f"{where}: {len(got)} sampled steps against {len(want)}")
    worst = rel = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        d = (g - w).abs().max().item()
        r = d / max(w.abs().max().item(), 1e-30)
        if not r <= tol:
            fail(f"{where}: logits of step {i}: max|d| {d} = {r:.3g} of "
                 f"max|logit| > {tol}")
        worst, rel = max(worst, d), max(rel, r)
    return worst, rel


def distinct_tokens(out):
    """(distinct tokens over all rows, the fewest distinct in one row)."""
    rows = out.values() if isinstance(out, dict) else out
    rows = [list(r) for r in rows]
    return (len({t for r in rows for t in r}),
            min(len(set(r)) for r in rows))


def registry_serving_path(dev, smi):
    """Phase 17(b): qwen2-0.5b at full width and depth in fp32 (the
    embedding scaled by 0.1, as in phase 6) on a paged engine, 4 prompts,
    16 greedy tokens: the default selection against the torch pins set
    through ``ServeConfig.impls``, ``REPRO_IMPL`` and the launcher's
    ``--impl``; then the int8 scheduler against ``torch_paged_q8``."""
    import os
    from repro_torch.bench import profile_serve as ps
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.serve.engine import Engine, ServeConfig
    lm = qwen2(dev, torch.float32, embed_scale=0.1)
    cfg = lm.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in PROMPT_LENS[:4]]
    paged = dict(page_size=PAGE_SIZE, max_seq=1024)
    Engine(lm, ServeConfig(**paged)).generate(prompts, REGISTRY_NEW)
    torch.cuda.synchronize()
    n_layers = cfg.n_layers
    default_want = {"flash_attention": n_layers,
                    "paged_decode": n_layers * (REGISTRY_NEW - 1),
                    "argmax": REGISTRY_NEW, "paged_decode_q8": 0,
                    "ssd_scan": 0}
    pinned_want = dict(default_want, flash_attention=0, paged_decode=0)
    runs = {}

    def generate(name, eng, want):
        reset_counters()
        with LogitsRecorder() as rec:
            t0 = time.perf_counter()
            out = eng.generate(prompts, REGISTRY_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counters()
        expect_launches(f"registry path ({name})", launches, want)
        runs[name] = (out, launches, wall, rec.steps)

    generate("default", Engine(lm, ServeConfig(**paged)), default_want)
    generate("ServeConfig.impls", Engine(lm, ServeConfig(
        **paged, impls=TORCH_PINS)), pinned_want)
    os.environ["REPRO_IMPL"] = TORCH_PIN_SPEC
    try:
        generate("REPRO_IMPL", Engine(lm, ServeConfig(**paged)),
                 pinned_want)
    finally:
        del os.environ["REPRO_IMPL"]
    want, want_logits = runs["default"][0], runs["default"][3]
    for name, (out, launches, wall, steps) in runs.items():
        if out != want:
            fail(f"registry path: {name} tokens {out} != default {want}")
        err, rel = logits_parity(f"registry path: {name}", steps,
                                 want_logits)
        log(f"  {name}: {wall * 1e3:.2f} ms for 4 x {REGISTRY_NEW} fp32 "
            f"tokens, launches {launches}; logits of {len(steps)} steps "
            f"against the default's: max|d| {err:.3g}, max|d|/max|logit| "
            f"{rel:.3g} [{smi}]")
    log(f"  fp32 greedy tokens equal under the default kernels and the "
        f"torch pins {TORCH_PINS}: {[o[:4] for o in want]}; "
        f"{distinct_tokens(want)[0]} distinct tokens, the fewest in a row "
        f"{distinct_tokens(want)[1]}; logits held step by step, max|d| "
        f"<= {LOGITS_REL_TOL} of max|logit|")
    selection_cost(lm, prompts, paged, smi)

    # the launcher's --impl (its own model: seed 0, fp32, 4 requests)
    argv = ["--arch", "qwen2-0.5b", "--dtype", "fp32", "--requests", "4",
            "--max-new", str(REGISTRY_NEW), "--page-size", str(PAGE_SIZE),
            "--max-seq", "1024", "--slots", "4", "--prompt-len", "64"]
    launcher = {}
    for name, extra in (("launcher default", []),
                        ("launcher --impl", ["--impl", TORCH_PIN_SPEC])):
        out = ROOT / "build" / f"serve_{len(launcher)}.json"
        reset_counters()
        with LogitsRecorder() as rec:
            rv, _ = in_process(serve_launcher.main,
                               argv + extra + ["--json", str(out)])
            torch.cuda.synchronize()
        launches = read_counters()
        summary = json.loads(out.read_text())
        if rv != 0 or len(summary["tokens"]) != 4:
            fail(f"{name}: rc {rv}, summary {summary}")
        launcher[name] = (summary, launches, rec.steps)
        log(f"  {name}: impls {summary['impls']}, {summary['tok_s']:.1f} "
            f"tokens/s, launches {launches} [{smi}]")
    (s0, l0, g0), (s1, l1, g1) = launcher.values()
    if s0["tokens"] != s1["tokens"]:
        fail(f"launcher --impl tokens {s1['tokens']} != default "
             f"{s0['tokens']}")
    err, rel = logits_parity("launcher --impl", g1, g0)
    log(f"  launcher --impl: tokens equal ({distinct_tokens(s0['tokens'])[0]}"
        f" distinct), logits of {len(g0)} sampled steps against the "
        f"default's: max|d| {err:.3g}, max|d|/max|logit| {rel:.3g}")
    if l0["flash_attention"] < 1 or l0["paged_decode"] < 1 or \
            l1["flash_attention"] or l1["paged_decode"]:
        fail(f"launcher launches: default {l0}, --impl {l1}")
    if s1["impls"] != TORCH_PINS:
        fail(f"launcher --impl pinned {s1['impls']}")

    # the int8 scheduler: the default (#3) against torch_paged_q8
    work = ps.shared_prefix_workload(cfg.vocab, 8, 64, ps.SUFFIX_LENS,
                                     ps.BUDGETS, seed=0)
    q8 = {}
    for name, impls in (("default", None),
                        ("torch_paged_q8", {"paged_decode":
                                            "torch_paged_q8"})):
        eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024,
                                     batch_slots=4, kv_dtype="int8",
                                     impls=impls))
        reset_counters()
        with LogitsRecorder() as rec:
            sched, out = ps.run_scheduler(eng, work)
            torch.cuda.synchronize()
        launches = read_counters()
        sched.check()
        sched.pool.check()
        q8[name] = (out, launches, sched.metrics["decode_steps"], rec.steps)
    (o0, l0, steps, g0), (o1, l1, _, g1) = q8.values()
    if o0 != o1:
        fail(f"int8 scheduler: torch_paged_q8 tokens differ from the "
             f"default's: {o1} != {o0}")
    if l0["paged_decode_q8"] != n_layers * steps or l1["paged_decode_q8"]:
        fail(f"int8 scheduler launches: default {l0}, torch_paged_q8 {l1}")
    err, rel = logits_parity("int8 scheduler torch_paged_q8", g1, g0,
                             LOGITS_REL_TOL_INT8)
    log(f"  int8 scheduler: default and torch_paged_q8 give equal fp32 "
        f"tokens ({len(o0)} requests, {distinct_tokens(o0)[0]} distinct "
        f"tokens); logits of {len(g0)} sampled steps (every slot) within "
        f"{LOGITS_REL_TOL_INT8} of max|logit|: max|d| {err:.3g}, "
        f"max|d|/max|logit| {rel:.3g}; #3 launched "
        f"{l0['paged_decode_q8']} and 0 times")
    del lm
    torch.cuda.empty_cache()
    return runs["default"][1], q8["default"][1]


def selection_cost(lm, prompts, paged, smi, rounds=2):
    """What the registry costs a generate call, two ways: the host us of
    the engine's per-call context (one env snapshot, entered once a
    ``generate``) and of one ``registry.run`` against the runner the
    heuristic picks, and the wall of a fp32 ``generate`` with every
    ``registry.run`` against the same generate with selection bypassed
    (each family's default runner called straight), alternated in this
    process (A B B A, ``rounds`` times: 2; 8 until phase 25 and 3 until
    phase 26 needed the time)."""
    from repro_torch.kernels import registry
    from repro_torch.serve.engine import Engine, ServeConfig
    eng = Engine(lm, ServeConfig(**paged))

    def enter_ctx():
        with eng._impl_ctx():
            pass

    ctx_us = statistics.median(host_us(enter_ctx) for _ in range(3))
    # the runners the CUDA heuristics pick (phase 17's counts hold them)
    default = {"attention": "cuda_flash", "paged_decode": "cuda_paged",
               "sampling": "cuda_greedy"}
    runners = {f: registry.get_spec(f, n).fn for f, n in default.items()}
    selecting = registry.run

    def bypass(family, *args, impl=None, **kwargs):
        return runners[family](*args, **kwargs)

    walls = {"registry.run": [], "selection bypassed": []}
    for _ in range(rounds):
        for name in ("registry.run", "selection bypassed",
                     "selection bypassed", "registry.run"):
            registry.run = bypass if name != "registry.run" else selecting
            try:
                t0 = time.perf_counter()
                eng.generate(prompts, REGISTRY_NEW)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
            finally:
                registry.run = selecting
    med = {k: statistics.median(v) for k, v in walls.items()}
    low = {k: min(v) for k, v in walls.items()}
    # flash + paged a layer, one sampling call a token
    calls = (lm.cfg.n_layers + 1) * REGISTRY_NEW
    log(f"  the engine's per-call context (env snapshot, no pin): "
        f"{ctx_us:.2f} host us, once a generate [{smi}]")
    for k, v in walls.items():
        log(f"  fp32 generate 4 x {REGISTRY_NEW}, {k}: median "
            f"{med[k]:.2f} ms, least {low[k]:.2f} (runs "
            f"{[round(x, 2) for x in v]}) [{smi}]")
    a, b = "registry.run", "selection bypassed"
    log(f"  registry / bypassed: median {med[a] / med[b]:.4f}, least "
        f"{low[a] / low[b]:.4f} ({calls} registry calls a generate)")
    return ctx_us, med


def registry_families_check(dev, smi):
    """Phase 17(c): ``registry.run`` of ssd_scan, stream_triad and jacobi7,
    each kernel impl against the plain one on the card (phases 3 and 11's
    tolerances); the host microseconds a paged decode call costs through
    the registry beside the direct wrapper."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.jacobi7 import jacobi7_sweeps, \
        jacobi7_valid_plain
    from repro_torch.kernels.paged_decode import \
        paged_decode_attention_grouped
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.stream_triad import stream_triad
    rng = np.random.default_rng(17)
    for dtype in (torch.float32, torch.bfloat16):
        args, st = ssd_inputs(rng, dev, 2, 300, 4, 64, 64, dtype, state=True)
        n0 = ssd_scan.launches
        y, (c, n) = registry.run("ssd_scan", *args, impl="cuda_ssd",
                                 chunk=256, initial_state=st)
        yp, (cp, np_) = registry.run("ssd_scan", *args, impl="torch_scan",
                                     chunk=256, initial_state=st)
        torch.cuda.synchronize()
        if ssd_scan.launches != n0 + 1:
            fail("registry ssd_scan: cuda_ssd did not launch once, or "
                 "torch_scan launched")
        name = f"registry ssd_scan cuda_ssd vs torch_scan {str(dtype)[6:]}"
        # phase 3's tolerances: y at its dtype's, C and n (fp32) at fp32's
        for what, got, want in (("y", y, yp), ("C", c, cp), ("n", n, np_)):
            torch.testing.assert_close(got.float(), want.float(),
                                       **ssd_tol(want),
                                       msg=lambda m: f"{name} {what}: {m}")
        log(f"  ok {name}: max|err| y "
            f"{(y.float() - yp.float()).abs().max().item():.3g}")
    gen = torch.Generator(device=dev).manual_seed(17)
    b = torch.randn(1 << 20, generator=gen, device=dev)
    c = torch.randn(1 << 20, generator=gen, device=dev)
    n0 = stream_triad.launches
    got = registry.run("stream_triad", b, c, impl="cuda_triad")
    want = registry.run("stream_triad", b, c, impl="torch_triad")
    if stream_triad.launches != n0 + 1:
        fail("registry stream_triad: cuda_triad did not launch once")
    close("registry stream_triad cuda_triad vs torch_triad 2^20 fp32", got,
          want)
    x = torch.randn(37, 45, 99, generator=gen, device=dev)
    want = jacobi7_valid_plain(x, 3)
    n0 = jacobi7_sweeps.launches
    for impl, launches in (("wavefront", 1), ("naive", 3)):
        got = registry.run("jacobi7", x, impl=impl, sweeps=3)
        torch.cuda.synchronize()
        if jacobi7_sweeps.launches != n0 + launches:
            fail(f"registry jacobi7 {impl}: {jacobi7_sweeps.launches - n0} "
                 f"launches, expected {launches}")
        n0 = jacobi7_sweeps.launches
        close(f"registry jacobi7 {impl} T=3 (37,45,99) vs the plain sweeps",
              got, want)

    # a head dim the flash kernel lacks: the heuristic still selects it,
    # and its wrapper raises rather than run the plain version
    from repro_torch.kernels.flash_attention import SUPPORTED_HEAD_DIMS
    q = torch.randn(1, 16, 4, 48, generator=gen, device=dev)
    kv = torch.randn(1, 16, 2, 48, generator=gen, device=dev)
    if 48 in SUPPORTED_HEAD_DIMS or \
            registry.select("attention", sq=16, sk=16, dh=48,
                            backend="cuda") != "cuda_flash":
        fail("registry attention: head dim 48 does not select cuda_flash")
    try:
        registry.run("attention", q, kv, kv)
    except ValueError as e:
        log(f"  registry attention at head dim 48 on the card: the kernel "
            f"is selected and raises ({e})")
    else:
        fail("registry attention: head dim 48 ran on the card")

    # host cost: phase 4's decode call (8 rows, KVH 2, G 7, Dh 64, pages
    # of 16) through the registry and straight to the wrapper
    lens = [n + MAX_NEW for n in PROMPT_LENS]
    table, num_pages = plan_table(lens, 1, PAGE_SIZE)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, torch.bfloat16)

    args = (rnd(8, 2, 7, 64), rnd(num_pages, PAGE_SIZE, 2, 64),
            rnd(num_pages, PAGE_SIZE, 2, 64), torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev),
            rnd(8, 2, 64), rnd(8, 2, 64))
    # the engine runs every call inside one env snapshot
    runs = {"direct wrapper": [], "registry.run": [],
            "registry.run in env_snapshot": []}
    for _ in range(3):
        runs["direct wrapper"].append(
            host_us(lambda: paged_decode_attention_grouped(*args)))
        runs["registry.run"].append(
            host_us(lambda: registry.run("paged_decode", *args)))
        with registry.env_snapshot():
            runs["registry.run in env_snapshot"].append(
                host_us(lambda: registry.run("paged_decode", *args)))
    med = {k: statistics.median(v) for k, v in runs.items()}
    d = med["direct wrapper"]
    log(f"  host us a paged decode call (bf16, phase 4's decode shape), "
        f"median of 3 x 200 [{smi}]:")
    for k, v in runs.items():
        log(f"    {k}: {med[k]:.2f} (+{med[k] - d:.2f}; runs "
            f"{[round(x, 2) for x in v]})")
    return med


def tool_benches(smi):
    """Phase 17(d): the tool benches through the runner."""
    out = ROOT / "build" / "tool_benches.json"
    run_cli(["repro_torch.bench", "--only",
             "marker_overhead,perfctr,stream_pinning", "--json", str(out)],
            timeout=600)
    report = json.loads(out.read_text())
    benches = {b["name"]: b for b in report["benches"]}
    for name, b in benches.items():
        if b["status"] != "ok":
            fail(f"bench {name}: {b['status']}")
    mo = benches["marker_overhead"]["summary"]
    for case in ("matmul", "paged_decode"):
        r = mo[case]
        log(f"  marker overhead, {case}: bare {r['bare_us']:.2f} us/call, "
            f"measured {r['measured_us']:.2f} us/call, overhead "
            f"{r['overhead'] * 100:+.2f}% (runs {r['bare_runs_us']} / "
            f"{r['measured_runs_us']}) [{smi}]")
    pf = benches["perfctr"]["summary"]
    log(f"  perfctr listing: Benchmark {pf['benchmark_calls']} calls, "
        f"{pf['benchmark_flops']:.4g} FLOPs declared, "
        f"{pf['us_per_call']:.2f} us/call [{smi}]")
    sp = benches["stream_pinning"]["summary"]
    pl = sp["placement"]
    log(f"  stream pinning: compact 2D {pl['mesh_cost']['compact']}, ring "
        f"1D {pl['flat_cost']['ring']}, unpinned 2D median "
        f"{pl['unpinned_2d']['median']}; triad 2^27 median "
        f"{sp['median_s'] * 1e3:.4f} ms = {sp['gbps_median']:.1f} GB/s "
        f"[{smi}]")
    return {"marker_overhead": mo, "perfctr": pf, "stream_pinning": sp}



# ---------------------------------------------------------------------------
# phase 18: the registry's tune half (ProfileSession, the artifact cache,
# autotune / best over every kernel family, --tune, bench_autotune)
# ---------------------------------------------------------------------------

TUNE_NEW = 16


def fresh_root(tag: str) -> str:
    """A new, empty artifact-cache root under this run's temporary
    directory (removed at exit)."""
    import tempfile
    return tempfile.mkdtemp(prefix=f"{tag}-", dir=TMP_ROOT)


def cell_facts(cell, suite):
    """(family, impl, the lookup facts) of a suite cell: the sweep's facts
    on the card, with the page size a paged runner's lookup adds."""
    from repro_torch.core.perf_report import suite_family
    family, impl, facts = suite_family(cell, suite)
    full = dict(facts, backend="cuda")
    full["dtype"] = getattr(torch, facts.get("dtype", "float32"))
    if family == "paged_decode":
        full["page_size"] = PAGE_SIZE
    return family, impl, full


def hold_to_plain(name, family, out, want):
    """One tune candidate's output against the plain version's, at phase
    3's tolerances (argmax exact; the SSD scan's y, C and n at
    ``ssd_tol``); returns max|err|."""
    if family == "sampling":
        if not torch.equal(out, want):
            fail(f"{name}: tokens {out.tolist()} != plain {want.tolist()}")
        return 0.0
    if family == "ssd_scan":
        (y, (c, n)), (yp, (cp, np_)) = out, want
        for what, g, w in (("y", y, yp), ("C", c, cp), ("n", n, np_)):
            torch.testing.assert_close(g.float(), w.float(), **ssd_tol(w),
                                       msg=lambda m: f"{name} {what}: {m}")
        return (y.float() - yp.float()).abs().max().item()
    tol = TOL[want.dtype]
    torch.testing.assert_close(out.float(), want.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    return (out.float() - want.float()).abs().max().item()


def hold_candidates(label, family, impl, facts, cands):
    """Each tune candidate ``cands`` of ``family``/``impl`` at ``facts``
    (as ``registry.autotune`` sweeps them: on the card, inputs from the
    tune space's seed) against its plain version, via
    :func:`hold_to_plain`; returns the max|err| of each."""
    from repro_torch.kernels import registry
    ts = registry._tuned_spec(family, impl).tune
    full = dict(facts, backend="cuda")
    full.setdefault("dtype", torch.float32)
    errs = []
    for cand in cands:
        cand = tuple(cand)
        fn, args = ts.probe(cand, **full)
        out = fn(*args)
        want = ts.plain(cand, **full)(*args)
        errs.append(hold_to_plain(f"{label} {list(cand)}", family, out,
                                  want))
        del fn, args, out, want
    torch.cuda.empty_cache()
    return errs


def bench_autotune_card(root, *extra):
    """``python -m repro_torch.bench.bench_autotune --suite card`` in a
    fresh process over the cache root ``root``: its summary and seconds."""
    import os
    out = Path(root) / f"bench_autotune_{len(os.listdir(root))}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_CACHE_DIR=root)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.bench_autotune",
         "--suite", "card", "--json", str(out), *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"bench_autotune --suite card {' '.join(extra)} exited "
             f"{res.returncode}: {res.stdout[-2000:]} {res.stderr[-2000:]}")
    return json.loads(out.read_text()), secs


def tune_suite_cold(smi):
    """Phase 18(a): ``run_tune_suite`` over ``CARD_SUITE``, cold, in a
    fresh root (``bench_autotune --suite card`` in a fresh process: late
    in a long process ``torch.profiler`` stops reporting kernels, PERF.md
    §7), every candidate timed on the card; then every measured
    candidate held against its plain version here (launches for that do
    not count)."""
    from repro_torch.core.perf_report import CARD_SUITE
    from repro_torch.kernels import registry
    root = fresh_root("tune-suite")
    cold, secs = bench_autotune_card(root)
    res = cold["families"]
    if cold["sweeps"] != len(CARD_SUITE) or cold["lowerings"] < len(res):
        fail(f"cold tune suite: {cold['sweeps']} sweeps, "
             f"{cold['lowerings']} timed probes")
    log(f"  cold, fresh process: {cold['sweeps']} families swept, "
        f"{cold['lowerings']} timed probes ({cold['event_timed']} timed by "
        f"CUDA events) in {cold['seconds']:.1f} s of sweeping, "
        f"{secs:.1f} s of command [{smi}]")
    t0 = time.perf_counter()
    for cell, r in res.items():
        family, impl, full = cell_facts(cell, CARD_SUITE)
        ts = registry._tuned_spec(family, impl).tune
        default = list(ts.resolve_default(**full))
        scores = {k: v for k, v in r["scores_us"].items()
                  if v != float("inf")}
        errs = hold_candidates(f"tune {cell}", family, impl, full,
                               [json.loads(k) for k in scores])
        per = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            scores.items(), key=lambda kv: kv[1]))
        d_us = scores.get(str(default))
        if d_us is None or not r["score_us"] > 0:
            fail(f"tune {cell}: default {default} not swept, or a zero "
                 f"score: {r}")
        log(f"  {cell}: {r['key']}: winner {r['choice']} "
            f"{r['score_us']:.2f} device us (timer {r['timer']}); default "
            f"{default} "
            f"{d_us:.2f} us (default / winner "
            f"{d_us / r['score_us']:.3f}); per candidate: {per}; "
            f"{len(scores)} held to the plain version, max|err| "
            f"{max(errs):.3g} [{smi}]")
    log(f"  {sum(len(r['scores_us']) for r in res.values())} candidates "
        f"held to their plain versions in {time.perf_counter() - t0:.1f} s")
    launches = cold["launches"]
    for k in launches:
        if launches[k] < 1:
            fail(f"tune suite: {k} never launched")
    log(f"  launches {launches}")
    return root, res, launches


def tune_suite_warm(root, cold, smi):
    """Phase 18(b): the same suite in a fresh process on the same root:
    0 sweeps and 0 timed probes, the same choices."""
    warm, secs = bench_autotune_card(root, "--assert-warm")
    if warm["sweeps"] or warm["lowerings"]:
        fail(f"warm tune suite: {warm['sweeps']} sweeps, "
             f"{warm['lowerings']} timed probes")
    for cell, r in cold.items():
        got = warm["families"][cell]["choice"]
        if got != r["choice"]:
            fail(f"warm tune suite: {cell} chose {got}, cold {r['choice']}")
    log(f"  fresh process, same root: 0 sweeps, 0 timed probes, "
        f"{len(cold)} equal choices in {secs:.1f} s (command, process start "
        f"included) [{smi}]")


def tune_launcher(smi):
    """Phase 18(c): the serving launcher at qwen2-0.5b's full width,
    bf16, int8 pages of 16, ``--tune``, cold and then warm in a fresh
    root; where each served call's tile came from."""
    root = fresh_root("tune-serve")
    argv = ["repro_torch.launch.serve", "--arch", "qwen2-0.5b",
            "--page-size", str(PAGE_SIZE), "--kv-dtype", "int8", "--tune",
            "--cache-dir", root, "--requests", "8", "--slots", "8",
            "--max-seq", "1024", "--prompt-len", "128", "--max-new", "16"]
    runs = []
    for leg in ("cold", "warm"):
        out = Path(root) / f"{leg}.json"
        t0 = time.perf_counter()
        run_cli(argv + ["--json", str(out)], timeout=600)
        secs = time.perf_counter() - t0
        summary = json.loads(out.read_text())
        tune = summary["tune"]
        runs.append(tune)
        log(f"  launcher {leg}: {tune['stats']}; "
            f"{summary['requests']} requests at {summary['tok_s']:.1f} "
            f"tokens/s, {secs:.1f} s of command [{smi}]")
        for fam, c in tune["choices"].items():
            log(f"    {fam}: {c['key']} -> {c['choice']} "
                f"({'swept' if c['swept'] else 'warm'}, "
                f"{c['timed_probes']} timed probes)")
        for row in tune["served"]:
            log(f"    served {row['family']}/{row['impl']} {row['key']}: "
                f"{row['choice']} from {row['source']}")
        if summary["requests"] != 8 or not tune["served"]:
            fail(f"launcher {leg}: {summary['requests']} requests, served "
                 f"sites {tune['served']}")
    cold, warm = runs
    for fam, c in cold["choices"].items():
        facts = dict(c["facts"], dtype=getattr(torch, c["facts"]["dtype"]))
        cands = [json.loads(k) for k, v in c["scores_us"].items()
                 if v != float("inf")]
        errs = hold_candidates(f"launcher tune {fam}", fam, c["impl"],
                               facts, cands)
        log(f"    {fam}: {len(cands)} swept candidates held to the plain "
            f"version, max|err| {max(errs):.3g} (timer {c['timer']})")
    if cold["timed_probes"] < 1 or warm["timed_probes"] != 0:
        fail(f"launcher --tune: cold timed {cold['timed_probes']} probes, "
             f"warm {warm['timed_probes']} (want > 0, then 0)")
    if {k: v["choice"] for k, v in cold["choices"].items()} != \
            {k: v["choice"] for k, v in warm["choices"].items()}:
        fail(f"launcher --tune: warm choices {warm['choices']} differ from "
             f"cold {cold['choices']}")


def tuned_generate(dev, smi):
    """Phase 18(d): fp32 qwen2-0.5b (the embedding scaled by 0.1, as in
    phase 6), 4 prompts, 16 greedy tokens: the default tiles (an empty
    table over an empty root), then every call site that run resolved
    autotuned at its own facts, then the same generate on the tuned
    tiles: equal tokens, logits within phase 6's bound."""
    import os
    from repro_torch.core.session import ProfileSession
    from repro_torch.kernels import registry
    from repro_torch.serve.engine import Engine, ServeConfig
    lm = qwen2(dev, torch.float32, embed_scale=0.1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, lm.cfg.vocab, n).tolist()
               for n in PROMPT_LENS[:4]]
    eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024))
    prev_root = os.environ["REPRO_CACHE_DIR"]
    os.environ["REPRO_CACHE_DIR"] = fresh_root("tune-generate")
    try:
        registry.clear_tune_table()
        runs = {}
        for leg in ("default", "tuned"):
            if leg == "tuned":
                sess = ProfileSession(cache_dir=os.environ[
                    "REPRO_CACHE_DIR"])
                t0 = time.perf_counter()
                for family, impl, facts in sites:
                    f = dict(facts)
                    cands = None
                    if family == "paged_decode":
                        ps = f.pop("page_size")
                        cands = [(ps, sp) for sp in (1, 2, 4, 8)]
                    rec = registry.autotune(family, sess, impl=impl,
                                            candidates=cands, **f)
                    errs = hold_candidates(
                        f"tuned {family}/{impl}", family, impl, f,
                        [c for c, v in rec.scores.items()
                         if v != float("inf")])
                    log(f"    tuned {family}/{impl} {rec.key}: "
                        f"{rec.choice} over {len(rec.scores)} candidates "
                        f"(timer {rec.timer}), each held to the plain "
                        f"version, max|err| {max(errs):.3g}")
                log(f"  {len(sites)} call sites tuned, their candidates "
                    f"held, in {time.perf_counter() - t0:.1f} s "
                    f"({sess.stats()})")
            reset_counters()
            with LogitsRecorder() as rec:
                out = eng.generate(prompts, TUNE_NEW)
                torch.cuda.synchronize()
            launches = read_counters()
            served = [(f, i, fa, *registry.resolve(f, impl=i, **fa))
                      for f, i, fa in registry.served_sites()]
            runs[leg] = (out, launches, rec.steps, served)
            if leg == "default":
                sites = [(f, i, fa) for f, i, fa, _c, _s in served]
            for f, i, fa, choice, source in served:
                log(f"    {leg}: {f}/{i} b={fa.get('b')} -> {choice} from "
                    f"{source}")
            want_src = {"default"} if leg == "default" else {"swept"}
            if {s for *_x, s in served} != want_src or len(served) < 3:
                fail(f"tuned generate ({leg}): served sources "
                     f"{[(f, s) for f, _i, _fa, _c, s in served]}")
        (o0, l0, g0, s0), (o1, l1, g1, s1) = runs.values()
        if o0 != o1:
            fail(f"tuned generate: tokens {o1} != default tiles' {o0}")
        if l0 != l1:
            fail(f"tuned generate: launches {l1} != default tiles' {l0}")
        err, rel = logits_parity("tuned generate", g1, g0)
        differ = [f"{f}/{i}: {c0} -> {c1}" for (f, i, _a, c0, _s),
                  (_f, _i, _b, c1, _t) in zip(s0, s1) if c0 != c1]
        log(f"  fp32 greedy tokens equal on the default and the tuned tiles "
            f"({distinct_tokens(o0)[0]} distinct tokens); logits of "
            f"{len(g0)} steps: max|d| {err:.3g}, max|d|/max|logit| "
            f"{rel:.3g} (bound {LOGITS_REL_TOL}); tiles that moved: "
            f"{differ or 'none (every winner was the default)'} [{smi}]")
    finally:
        os.environ["REPRO_CACHE_DIR"] = prev_root
        registry.clear_tune_table()
    del lm, eng
    torch.cuda.empty_cache()
    return runs["tuned"][1]


# ---------------------------------------------------------------------------
# phases 19-20: xlstm-350m, and the other dense configs
# ---------------------------------------------------------------------------

#: phases 19-22's scheduler runs take 8 requests (16 until phase 25
#: needed the time), xlstm's 4 (8 until phase 26) on 3 slots, so one
#: waits in the queue
XLSTM_REQUESTS, XLSTM_SLOTS = 4, 3
#: the dense configs' int8 scheduler run: phase 5's traffic, shortened
DENSE_SCHED_REQUESTS = 8
#: mistral-large-123b on one card: full width, 2 of its 88 layers
MISTRAL_LAYERS = 2
MISTRAL_PROMPTS = 4
MISTRAL_PROMPT_LENS = PROMPT_LENS[1:1 + 2 * MISTRAL_PROMPTS:2]
MISTRAL_NEW = 16
#: phase 21: the moe family.  qwen3-moe-235b-a22b on one card: full
#: width, 2 of its 94 layers, mistral's 4 prompts; the fp32 card-vs-CPU
#: check at 2 of qwen2-moe-a2.7b's 24 layers
MOE_SCHED_REQUESTS = 8
QWEN3_LAYERS = 2
QWEN3_PROMPTS = MISTRAL_PROMPTS
QWEN3_PROMPT_LENS = MISTRAL_PROMPT_LENS
QWEN3_NEW = 16
MOE_FP32_LAYERS = 2
MOE_FP32_PROMPT_LENS = (64, 37, 20, 5)
MOE_FP32_NEW = 16
#: phase 22: the vlm and encdec families.  qwen2-vl-7b at full width and
#: depth on 8 prompts of 512 down to 288 tokens (each at least its 256
#: patch positions; ``profile_generate.VLM_LENS``) with the vision stub's
#: patch embeddings, and its int8 scheduler on phase 5's traffic cut to
#: 8 requests; seamless-m4t-medium at full width and depth on 8 prompts
#: of 256 tokens (equal: the family runs pads as context) with [8, 64,
#: 1024] source embeddings; the fp32 card-vs-CPU checks at 2 of
#: qwen2-vl's 28 layers and at seamless's full depth, every sampled
#: step's logits within 1e-5 of max|logit|
VLM_SCHED_REQUESTS = 8
VLM_FP32_LAYERS = 2
VLM_FP32_PROMPT_LENS = (300, 277, 260)
ENCDEC_PROMPTS = 8
ENCDEC_PROMPT_LEN = 256
ENCDEC_FP32_PROMPTS = 3
FP32_NEW = 8
P22_LOGITS_REL_TOL = 1e-5


def attn_shape(arch):
    """(query heads, kv heads, head dim) of a registered config."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).config
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def xlstm_paths(dev):
    """Phase 19 (a), (b): xlstm-350m at full width and depth (12
    mLSTM/sLSTM pairs, d_model 1024, 4 heads of 512), bf16, dense state:
    (a) ``Engine.generate`` on 8 prompts of 512 tokens, 32 greedy tokens,
    #5 launched once a pair (12 times) for the prefill; (b) the
    ``BatchScheduler`` on 4 requests of 64-512 tokens, budgets 16-48, 3
    slots, #5 launched 12 times an admission."""
    from repro_torch.configs.xlstm_350m import CONFIG
    from repro_torch.serve.engine import Engine, ServeConfig
    lm = build_lm(CONFIG, dev)
    pairs = CONFIG.n_layers // 2
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, CONFIG.vocab, XLSTM_SSD_SHAPE[1]).tolist()
               for _ in range(XLSTM_SSD_SHAPE[0])]
    eng = Engine(lm, ServeConfig(max_seq=1024), device=dev)
    none = {"flash_attention": 0, "paged_decode": 0, "paged_decode_q8": 0}
    gen = timed_generate(eng, prompts, MAX_NEW,
                         dict(none, ssd_scan=pairs, argmax=MAX_NEW),
                         "xlstm-350m")
    work = [(rng.integers(1, CONFIG.vocab, int(n)).tolist(), int(b), 1)
            for n, b in zip(rng.integers(64, 513, XLSTM_REQUESTS),
                            rng.integers(16, 49, XLSTM_REQUESTS))]
    seng = Engine(lm, ServeConfig(max_seq=1024, batch_slots=XLSTM_SLOTS,
                                  admission_chunk=8), device=dev)
    sched = checked_scheduler(
        seng, work, lambda m: dict(none, ssd_scan=pairs * m["admissions"],
                                   argmax=m["decode_steps"]),
        "xlstm-350m scheduler")
    return gen, sched


def xlstm_token_check(dev):
    """Phase 19 (c): fp32, full width, 4 of 24 layers (2 pairs), dense
    state, two prompts of 300 tokens (a full chunk of 256 and a ragged
    one): kernel #5 in fp32 on the card against the chunked plain
    version on the CPU."""
    from repro_torch.configs.xlstm_350m import CONFIG
    from repro_torch.serve.engine import ServeConfig
    cfg = dataclasses.replace(CONFIG, n_layers=4)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab, 300).tolist() for _ in range(2)]
    card_cpu_tokens(dev, cfg, 5, prompts, ServeConfig(max_seq=512),
                    {"ssd_scan": cfg.n_layers // 2, "argmax": 8}, "xlstm")


def dense_config_paths(dev):
    """Phase 20 (a)-(c): the other dense configs at full width, bf16,
    pages of 16.  qwen1.5-0.5b (16 heads, G 1, QKV bias, tied embedding)
    and stablelm-3b (LayerNorm, 32 heads of 80) at full depth: phase 4's
    8 ragged prompts, 32 new tokens, then the int8 scheduler on phase 5's
    traffic cut to 8 requests; mistral-large-123b (96 heads over 8 of
    128, G 12) at 2 of its 88 layers: 4 prompts, 16 new tokens."""
    from repro_torch.bench import profile_serve as ps
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import Engine, ServeConfig
    by_path = {}
    rng = np.random.default_rng(22)
    for arch in ("qwen1.5-0.5b", "stablelm-3b"):
        cfg = get_arch(arch).config
        lm = build_lm(cfg, dev)
        prompts = [rng.integers(0, cfg.vocab, n).tolist()
                   for n in PROMPT_LENS]
        eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024),
                     device=dev)
        L = cfg.n_layers
        by_path[f"{arch}_generate"] = timed_generate(
            eng, prompts, MAX_NEW,
            {"flash_attention": L, "paged_decode": L * (MAX_NEW - 1),
             "argmax": MAX_NEW, "paged_decode_q8": 0, "ssd_scan": 0}, arch)
        seng = Engine(lm, ServeConfig(page_size=ps.PAGE_SIZE, max_seq=1024,
                                      batch_slots=ps.SLOTS,
                                      admission_chunk=8, kv_dtype="int8"),
                      device=dev)
        work = ps.shared_prefix_workload(cfg.vocab, DENSE_SCHED_REQUESTS,
                                         ps.PREFIX, ps.SUFFIX_LENS,
                                         ps.BUDGETS, seed=0)
        by_path[f"{arch}_scheduler_int8"] = checked_scheduler(
            seng, work, lambda m, L=L: {
                "paged_decode_q8": L * m["decode_steps"],
                "flash_attention": L * (m["admissions"] - m["prefix_hits"]),
                "argmax": m["decode_steps"], "paged_decode": 0,
                "ssd_scan": 0}, f"{arch} int8 scheduler")
        del lm, eng, seng
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch("mistral-large-123b").config,
                              n_layers=MISTRAL_LAYERS)
    lm = build_lm(cfg, dev)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in MISTRAL_PROMPT_LENS]
    eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024),
                 device=dev)
    L = cfg.n_layers
    by_path["mistral-large-123b_generate"] = timed_generate(
        eng, prompts, MISTRAL_NEW,
        {"flash_attention": L, "paged_decode": L * (MISTRAL_NEW - 1),
         "argmax": MISTRAL_NEW, "paged_decode_q8": 0, "ssd_scan": 0},
        f"mistral-large-123b ({L} of 88 layers)")
    del lm, eng
    torch.cuda.empty_cache()
    return by_path


def stablelm_token_check(dev):
    """Phase 20 (d): stablelm-3b in fp32 at full width and 2 layers
    (LayerNorm, Dh 80): the paged engine's tokens and logits on the card
    (#1 a layer, #2 a layer a step) against the CPU's, then int8 pages'
    decode-step logits (#3 at KVH 32, G 1, Dh 80)."""
    from repro_torch.configs.stablelm_3b import CONFIG
    from repro_torch.serve.engine import ServeConfig
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (37, 20, 5)]
    L = cfg.n_layers
    lm_cpu, lm_gpu = card_cpu_tokens(
        dev, cfg, 6, prompts, ServeConfig(page_size=PAGE_SIZE, max_seq=128),
        {"flash_attention": L, "paged_decode": 7 * L, "argmax": 8},
        "stablelm")
    int8_decode_logits(lm_cpu, lm_gpu, prompts, "stablelm")


# ---------------------------------------------------------------------------
# phase 21: the moe family
# ---------------------------------------------------------------------------

def decode_step_without_sync(eng, prompts, where):
    """Prefill ``prompts`` into ``eng``'s bf16 pages, then one decode step
    of the model under ``torch.cuda.set_sync_debug_mode("error")``: an
    implicit host sync anywhere in the step (the MoE dispatch included)
    raises.  ``engine.host_syncs`` counts only the engine's own syncs."""
    lm = eng.lm
    toks, lens = eng._pad_prompts(prompts)
    table, num_pages = eng._page_plan(prompts, 4)
    state = lm.init_decode_state(len(prompts), eng.cfg.max_seq,
                                 page_size=PAGE_SIZE, num_pages=num_pages,
                                 table_width=table.shape[1])
    state = eng.set_page_table(state, table)
    tok = torch.full((len(prompts), 1), 7, dtype=torch.int32,
                     device=lm.device)
    with torch.inference_mode():
        lm.prefill({"tokens": torch.from_numpy(toks).to(lm.device),
                    "lengths": torch.from_numpy(lens).to(lm.device)}, state)
        lm.decode_step(tok, state)      # this shape's first call
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, state = lm.decode_step(tok, state)
        except RuntimeError as e:
            fail(f"{where}: a decode step synchronized with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not torch.isfinite(logits.float()).all():
        fail(f"{where}: the decode step's logits are not finite")
    log(f"  {where}: one decode step under sync debug mode 'error': no "
        f"implicit host sync")


def moe_paths(dev):
    """Phase 21 (a)-(c), bf16, pages of 16.  (a) qwen2-moe-a2.7b at full
    width and depth (24 layers, 60 experts of 1408, top-4, a shared
    expert of 5632): phase 4's 8 ragged prompts, 32 new tokens, one host
    sync, then one decode step with no implicit sync; (b) the int8
    scheduler with the prefix cache on phase 5's traffic cut to 8
    requests; (c) qwen3-moe-235b-a22b at full width and 2 of its 94
    layers (128 experts of 1536, top-8; 64 heads over 4 of 128, G 16): 4
    prompts, 16 new tokens."""
    from repro_torch.bench import profile_serve as ps
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import Engine, ServeConfig
    by_path = {}
    rng = np.random.default_rng(24)
    cfg = get_arch("qwen2-moe-a2.7b").config
    lm = build_lm(cfg, dev)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024),
                 device=dev)
    L = cfg.n_layers
    by_path["qwen2-moe-a2.7b_generate"] = timed_generate(
        eng, prompts, MAX_NEW,
        {"flash_attention": L, "paged_decode": L * (MAX_NEW - 1),
         "argmax": MAX_NEW, "paged_decode_q8": 0, "ssd_scan": 0},
        "qwen2-moe-a2.7b")
    decode_step_without_sync(eng, prompts, "qwen2-moe-a2.7b")
    seng = Engine(lm, ServeConfig(page_size=ps.PAGE_SIZE, max_seq=1024,
                                  batch_slots=ps.SLOTS, admission_chunk=8,
                                  kv_dtype="int8"), device=dev)
    work = ps.shared_prefix_workload(cfg.vocab, MOE_SCHED_REQUESTS,
                                     ps.PREFIX, ps.SUFFIX_LENS, ps.BUDGETS,
                                     seed=0)
    by_path["qwen2-moe-a2.7b_scheduler_int8"] = checked_scheduler(
        seng, work, lambda m: {
            "paged_decode_q8": L * m["decode_steps"],
            "flash_attention": L * (m["admissions"] - m["prefix_hits"]),
            "argmax": m["decode_steps"], "paged_decode": 0, "ssd_scan": 0},
        "qwen2-moe-a2.7b int8 scheduler")
    del lm, eng, seng
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").config,
                              n_layers=QWEN3_LAYERS)
    lm = build_lm(cfg, dev)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in QWEN3_PROMPT_LENS]
    eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024),
                 device=dev)
    L = cfg.n_layers
    by_path["qwen3-moe-235b-a22b_generate"] = timed_generate(
        eng, prompts, QWEN3_NEW,
        {"flash_attention": L, "paged_decode": L * (QWEN3_NEW - 1),
         "argmax": QWEN3_NEW, "paged_decode_q8": 0, "ssd_scan": 0},
        f"qwen3-moe-235b-a22b ({L} of 94 layers)")
    del lm, eng
    torch.cuda.empty_cache()
    return by_path


class RouterMargins:
    """Records, while open, the smallest top-k margin of every MoE router
    call: the probability of each row's k-th expert less its (k+1)-th's.
    A margin near 0 is a near-tie that a different summation order can
    flip (on the device, no sync)."""

    def __enter__(self):
        from repro_torch.models import moe
        self._mod, self._orig = moe, moe.route
        self.mins = []
        orig, mins = self._orig, self.mins

        def route(m, xt, cfg, *rest):
            probs = torch.softmax(xt.float() @ m.router, dim=-1)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            mins.append((top[:, -2] - top[:, -1]).min())
            return orig(m, xt, cfg, *rest)

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._mod.route = self._orig
        return False

    def smallest(self) -> float:
        return (min(t.item() for t in self.mins) if self.mins
                else float("nan"))


def moe_token_check(dev):
    """Phase 21 (d): qwen2-moe-a2.7b in fp32 at full width and 2 of its 24
    layers (~7.1 GB of weights), the same batch on both sides: 4 ragged
    prompts of at most 64 tokens, 16 greedy tokens through the paged
    engine on the card (#1 a layer, #2 a layer a step, #4 a step) equal
    the CPU's, and every sampled step's logits agree within 1e-4 of
    max|logit|.  The router's smallest top-k margin on each side is
    printed whatever the outcome (a near-tie that flips an expert would
    show there)."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import ServeConfig
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").config,
                              n_layers=MOE_FP32_LAYERS)
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in MOE_FP32_PROMPT_LENS]
    L = cfg.n_layers
    with RouterMargins() as rm:
        try:
            card_cpu_tokens(
                dev, cfg, 7, prompts,
                ServeConfig(page_size=PAGE_SIZE, max_seq=128),
                {"flash_attention": L,
                 "paged_decode": (MOE_FP32_NEW - 1) * L,
                 "argmax": MOE_FP32_NEW}, "qwen2-moe", max_new=MOE_FP32_NEW)
        finally:
            log(f"  qwen2-moe router: smallest top-{cfg.moe_top_k} margin "
                f"over {len(rm.mins)} router calls (card and cpu) "
                f"{rm.smallest():.3g}")


def perf_report_and_example(smi):
    """Phase 20 (e): the tool layer's last CLI, ``python -m
    repro_torch.launch.perf_report``, on the card in a fresh cache root:
    cold (the family suite swept, the production path timed, a baseline
    of the port's own written), warm (0 timed probes), its written report
    re-gated against that baseline (exit 0) and against the committed
    ``PERF_BASELINE.json`` (another chip: not comparable, not gated),
    which must stay byte for byte as it was; then
    ``examples/serve_batched_torch.py`` on the card."""
    import hashlib
    import runpy
    committed = ROOT / "PERF_BASELINE.json"
    digest = hashlib.sha256(committed.read_bytes()).hexdigest()
    root = Path(fresh_root("perf-report"))
    base, report = root / "base.json", root / "report.json"
    # an empty artifacts directory: a BENCH_*.json or TUNE_TABLE.json left
    # in the checkout would be pinned instead of swept
    arts = fresh_root("perf-report-artifacts")
    cli = ["repro_torch.launch.perf_report", "--cache-dir", str(root),
           "--artifacts", arts]
    t0 = time.perf_counter()
    cold = run_cli(cli + ["--baseline", str(base), "--update-baseline",
                          "--json", str(report), "--md",
                          str(root / "report.md")], timeout=600)
    secs = time.perf_counter() - t0
    rows = json.loads(report.read_text())["rows"]
    if "swept" not in cold or not base.exists() or not rows:
        fail(f"perf_report cold: {cold[-2000:]}")
    if not all(r["key"].endswith("-cuda") for r in rows) or \
            not any(r.get("wall_s") for r in rows):
        fail(f"perf_report rows are not the card's: {rows}")
    log(f"  perf_report cold: {len(rows)} rows in {secs:.1f} s [{smi}]")
    for line in cold.splitlines():
        if line.startswith(("attention", "paged", "sampling", "ssd",
                            "stream", "jacobi")):
            log(f"    {line}")
    warm = run_cli(cli + ["--baseline", str(base), "--no-measure"],
                   timeout=600)
    if "swept" in warm or "tune table (warm)" not in warm:
        fail(f"perf_report warm swept again: {warm[-2000:]}")
    # the two gates compare written reports and measure nothing: in this
    # process (two fresh processes until phase 25 needed the time)
    from repro_torch.launch import perf_report as perf_report_cli
    argv = cli[1:] + ["--check", str(report), "--gate", "--baseline"]
    (rc_g, gated), (rc_o, other) = (
        in_process(perf_report_cli.main, argv + [str(b)])
        for b in (base, committed))
    if (rc_g, rc_o) != (0, 0) or "[gate] ok" not in gated or \
            "not comparable" not in other:
        fail(f"perf_report gate: {rc_g} {gated[-1000:]} / {rc_o} "
             f"{other[-1000:]}")
    if hashlib.sha256(committed.read_bytes()).hexdigest() != digest:
        fail("perf_report changed the committed PERF_BASELINE.json")
    log("  perf_report warm: 0 timed probes; re-gated against its own "
        "baseline: ok; against the committed PERF_BASELINE.json: not "
        "comparable, not gated, unchanged")
    reset_counters()
    mod = runpy.run_path(str(ROOT / "examples" / "serve_batched_torch.py"))
    outs, done = mod["main"]([])
    launches = read_counters()
    if [len(o) for o in outs] != [16] * 3 or len(done) != 10 or \
            launches["flash_attention"] < 1 or launches["argmax"] < 1:
        fail(f"serve_batched_torch on the card: {outs}, {len(done)} "
             f"requests, launches {launches}")
    log(f"  examples/serve_batched_torch.py on the card: launches {launches}")


# ---------------------------------------------------------------------------
# phase 22: the vlm and encdec families
# ---------------------------------------------------------------------------

def vlm_encdec_paths(dev):
    """Phase 22 (a), (b), bf16.  (a) qwen2-vl-7b at full width and depth
    (28 layers, 28 heads over 4 of 128, M-RoPE), pages of 16: 8 prompts
    of 512-288 tokens with patch embeddings [8, 256, 3584] from a seeded
    generator, 32 greedy tokens through ``Engine.generate`` (#1 28
    times, #2 28 x 31, #4 32); then the int8 scheduler with the prefix
    cache on phase 5's traffic cut to 8 requests (text-only, as the
    JAX scheduler admits).  (b) seamless-m4t-medium at full width and
    depth (12 encoder + 12 decoder layers, 16 heads of 64, vocab
    256206), dense KV: 8 prompts of 256 tokens with source embeddings
    [8, 64, 1024], 32 greedy tokens (#1 24 times: the encoder's 12
    non-causal, the decoder's 12 causal; #4 32)."""
    from repro_torch.bench import profile_generate as pg
    from repro_torch.bench import profile_serve as ps
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import Engine, ServeConfig
    by_path = {}
    rng = np.random.default_rng(26)
    cfg = get_arch("qwen2-vl-7b").config
    lm = build_lm(cfg, dev)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in pg.VLM_LENS]
    extra = pg.stub_inputs(cfg, pg.VLM_LENS, lm.dtype, dev, seed=26)
    eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024),
                 device=dev)
    L = cfg.n_layers
    by_path["vlm_generate"] = timed_generate(
        eng, prompts, MAX_NEW,
        {"flash_attention": L, "paged_decode": L * (MAX_NEW - 1),
         "argmax": MAX_NEW, "paged_decode_q8": 0, "ssd_scan": 0},
        "qwen2-vl-7b", extra=extra)
    seng = Engine(lm, ServeConfig(page_size=ps.PAGE_SIZE, max_seq=1024,
                                  batch_slots=ps.SLOTS, admission_chunk=8,
                                  kv_dtype="int8"), device=dev)
    work = ps.shared_prefix_workload(cfg.vocab, VLM_SCHED_REQUESTS,
                                     ps.PREFIX, ps.SUFFIX_LENS, ps.BUDGETS,
                                     seed=0)
    by_path["vlm_scheduler_int8"] = checked_scheduler(
        seng, work, lambda m: {
            "paged_decode_q8": L * m["decode_steps"],
            "flash_attention": L * (m["admissions"] - m["prefix_hits"]),
            "argmax": m["decode_steps"], "paged_decode": 0, "ssd_scan": 0},
        "qwen2-vl-7b int8 scheduler")
    del lm, eng, seng, extra
    torch.cuda.empty_cache()
    cfg = get_arch("seamless-m4t-medium").config
    lm = build_lm(cfg, dev)
    lens = (ENCDEC_PROMPT_LEN,) * ENCDEC_PROMPTS
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    extra = pg.stub_inputs(cfg, lens, lm.dtype, dev, seed=27)
    eng = Engine(lm, ServeConfig(max_seq=1024), device=dev)
    by_path["encdec_generate"] = timed_generate(
        eng, prompts, MAX_NEW,
        {"flash_attention": cfg.enc_layers + cfg.n_layers,
         "paged_decode": 0, "argmax": MAX_NEW, "paged_decode_q8": 0,
         "ssd_scan": 0}, "seamless-m4t-medium", extra=extra)
    del lm, eng, extra
    torch.cuda.empty_cache()
    return by_path


def vlm_encdec_token_check(dev):
    """Phase 22 (c), fp32, every sampled step's logits within
    :data:`P22_LOGITS_REL_TOL` of max|logit|: qwen2-vl-7b at full width
    and 2 of its 28 layers (~6.2 GB of weights), 3 ragged prompts of at
    least 256 tokens with patch embeddings, pages of 16 (#1 a layer, #2 a
    layer a step); seamless-m4t-medium at full width and depth, 3
    prompts of 256 tokens with [3, 64, 1024] source embeddings, dense KV
    (#1 once an encoder and once a decoder layer)."""
    from repro_torch.bench import profile_generate as pg
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import ServeConfig
    rng = np.random.default_rng(28)
    cfg = dataclasses.replace(get_arch("qwen2-vl-7b").config,
                              n_layers=VLM_FP32_LAYERS)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in VLM_FP32_PROMPT_LENS]
    extra = {k: v.numpy() for k, v in pg.stub_inputs(
        cfg, VLM_FP32_PROMPT_LENS, torch.float32, torch.device("cpu"),
        seed=28).items()}
    L = cfg.n_layers
    card_cpu_tokens(dev, cfg, 8, prompts,
                    ServeConfig(page_size=PAGE_SIZE, max_seq=512),
                    {"flash_attention": L, "paged_decode": (FP32_NEW - 1) * L,
                     "argmax": FP32_NEW}, "qwen2-vl", max_new=FP32_NEW,
                    extra=extra, tol=P22_LOGITS_REL_TOL)
    torch.cuda.empty_cache()
    cfg = get_arch("seamless-m4t-medium").config
    lens = (ENCDEC_PROMPT_LEN,) * ENCDEC_FP32_PROMPTS
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    extra = {k: v.numpy() for k, v in pg.stub_inputs(
        cfg, lens, torch.float32, torch.device("cpu"), seed=29).items()}
    card_cpu_tokens(dev, cfg, 9, prompts, ServeConfig(max_seq=512),
                    {"flash_attention": cfg.enc_layers + cfg.n_layers,
                     "paged_decode": 0, "argmax": FP32_NEW},
                    "seamless-m4t-medium", max_new=FP32_NEW, extra=extra,
                    tol=P22_LOGITS_REL_TOL)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 23: training
# ---------------------------------------------------------------------------

#: (a): qwen2-0.5b at full width and depth, 8 x 512 tokens a step, 8
#: steps (a checkpoint at 4), then 2 more with 2 microbatches a step
#: (20 and 10 until phase 25, 12 and 4 until phase 26 needed the time)
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_STEPS, TRAIN_CKPT_AT, TRAIN_ACCUM_STEPS = 8, 4, 2
TRAIN_WARM = 3                    # steps left out of the median step time
TRAIN_SCHED = dict(peak_lr=3e-4, warmup_steps=5,
                   total_steps=TRAIN_STEPS + 2 + TRAIN_ACCUM_STEPS)
#: the resumed run's losses against the uninterrupted run's, relative:
#: bf16 compute, and the embedding's and the MoE's index_add backward sum
#: in another order each run on the card
RESUME_LOSS_RTOL = 1e-2
#: (b), (c): fp32 card against CPU.  Gradients: each leaf within rtol
#: plus atol x the largest gradient of the model (xlstm-350m: its mLSTM
#: normaliser, see tests/test_torch_train_families.py); the loss, grad
#: norm and rate within METRIC_RTOL; parameters after each step as
#: :func:`hold_params` says
P23_GRAD_TOL = {"default": (1e-4, 1e-6), "xlstm-350m": (1e-3, 3e-4)}
P23_METRIC_RTOL = {"default": 1e-5, "xlstm-350m": 1e-3}
CARD_CPU_LAYERS, CARD_CPU_STEPS = 2, 3
CARD_CPU_BATCH, CARD_CPU_SEQ = 2, 32
#: (c): one arch a family, at its SMOKE config
TRAIN_FAMILIES = ("qwen2-0.5b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
                  "zamba2-1.2b", "xlstm-350m", "seamless-m4t-medium")


def all_counters():
    """Kernels #1-#7's launch counters."""
    out = read_counters()
    out.update({k: f.launches for k, f in case_counters().items()})
    return out


def train_data_cfg(cfg, batch, seq):
    from repro_torch.data import DataConfig
    return DataConfig(
        seq_len=seq, global_batch=batch, vocab=cfg.vocab,
        src_embeds_dim=cfg.d_model if cfg.family == "encdec" else 0,
        src_ratio=cfg.src_ratio,
        patch_embeds=cfg.n_patches if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)


def train_main_path(dev, smi):
    """Phase 23 (a): qwen2-0.5b at full width and depth (24 layers, d
    896, 14 heads over 2, vocab 151936, tied), bf16 compute over fp32
    masters, ``FeatureSet`` defaults (remat ``dots_no_batch``), AdamW with
    clipping, warmup then cosine, 8 x 512 synthetic tokens a step, the
    weights drawn on the host (phase 25 (a) trains a mesh from the same
    draw): 8 steps through ``Trainer`` with one checkpoint, at step 4
    (the one ``serve --ckpt-dir`` serves), then 2 steps with
    ``accum_steps=2``.  Prints the median
    step time after 3 warm-up steps, tokens/s, model FLOPs a step
    (``model_flops``: 6 N T + 12 L H Dh S T), MFU against 989 TFLOP/s,
    peak ``max_memory_allocated``, device launches a step and the
    device's idle share over two profiled steps.  Then a fresh
    ``Trainer`` resumes from the step-6 checkpoint to 12: its losses
    within :data:`RESUME_LOSS_RTOL` of the uninterrupted run's.  Returns
    (the trained weights as a bf16 serving LM, the checkpoint directory,
    the figures, the host draw and the first steps' history and state
    bytes for phase 25 (a))."""
    from repro_torch.bench.profile_generate import _profiled
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.core.devtime import device_time_us
    from repro_torch.core.features import default_features
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.step import model_flops
    ckpt = Path(fresh_root("train-ckpt"))
    feats = default_features()
    host = LM(CONFIG, torch.bfloat16, "cpu", features=feats,
              param_dtype=torch.float32)
    t0 = time.perf_counter()
    host.init(torch.Generator().manual_seed(0))
    draw_s = time.perf_counter() - t0
    lm = LM(CONFIG, torch.bfloat16, dev, features=feats,
            param_dtype=torch.float32)
    lm.load_state_dict(host.state_dict())
    data = train_data_cfg(CONFIG, TRAIN_BATCH, TRAIN_SEQ)

    def trainer(total, ckpt_dir=None, accum=1):
        return Trainer(lm, data, TrainerConfig(
            total_steps=total, log_every=5, ckpt_every=TRAIN_CKPT_AT,
            ckpt_dir=ckpt_dir, ckpt_keep=3, accum_steps=accum),
            AdamWConfig(), ScheduleConfig(**TRAIN_SCHED))

    # to step 6, writing its one checkpoint there; then on to 12
    tr = trainer(TRAIN_CKPT_AT, str(ckpt))
    state = tr.init_state()                 # the host draw's weights
    plain_bytes = state_bytes(state)
    n_params = lm.num_params()
    log(f"  qwen2-0.5b: {n_params} params, fp32 masters, bf16 compute, "
        f"remat {feats.remat_policy}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"a step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    for f in case_counters().values():
        f.launches = 0
    t0 = time.perf_counter()
    state = tr.run(state)
    # the checkpoint's weights as a serving model (bf16), before any
    # further step
    served = LM(CONFIG, torch.bfloat16, dev)
    served.load_state_dict({k: v.detach() for k, v in lm.state_dict().items()})
    rest = trainer(TRAIN_STEPS)
    state = rest.run(state)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    hist = tr.history + rest.history
    losses = [r["loss"] for r in hist]
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall: {losses}")
    step_s = float(np.median([r["wall_s"] for r in hist[TRAIN_WARM:]]))
    flops = model_flops(lm, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fig = {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "model_flops": flops, "mfu": flops / step_s / BF16_FLOPS,
           "peak_mem_gb": peak / 1e9, "first_loss": losses[0],
           "last_loss": losses[-1]}
    # two steps under the profiler: launches a step and the idle share
    batches = [rest.batch_at(TRAIN_STEPS + i) for i in range(2)]

    def two_steps():
        nonlocal state
        for b in batches:
            state, m = rest.step_fn(state, b)
        m["loss"].item()

    from repro_torch.kernels import flash_attention_train as ft
    before = dict(ft.LAUNCHES)
    wall_ms, avgs = _profiled(two_steps)
    # the training attention's kernels, a step: 2L forward (the remat
    # recomputes it) and L of each backward kernel
    per_step = {k: (n - before[k]) / 2 for k, n in ft.LAUNCHES.items()}
    nl = CONFIG.n_layers
    if per_step != {"fwd": 2 * nl, "bwd_dq": nl, "bwd_dkdv": nl}:
        fail(f"train: the training attention's kernels launched "
             f"{per_step} a step")
    fig["flash_train_launches_per_step"] = per_step
    busy_ms = sum(device_time_us(a) for a in avgs) / 1e3
    fig.update(launches_per_step=sum(a.count for a in avgs) / 2,
               idle_share=1.0 - busy_ms / wall_ms,
               profiled_step_ms=wall_ms / 2, busy_ms_per_step=busy_ms / 2,
               idle_share_unprofiled=1.0 - busy_ms / 2 / fig["step_ms"])
    top = sorted(avgs, key=device_time_us, reverse=True)[:8]
    log(f"  step {fig['step_ms']:.2f} ms (median of steps {TRAIN_WARM}-"
        f"{TRAIN_STEPS - 1}); {fig['tokens_per_s']:.0f} tokens/s; model "
        f"FLOPs {flops:.4g} a step (6 N T + 12 L H Dh S T, N = {n_params}"
        f"); MFU {fig['mfu']:.4f} of 989 TFLOP/s; peak allocated "
        f"{fig['peak_mem_gb']:.3f} GB [{smi}]")
    log(f"  profiled: {fig['profiled_step_ms']:.2f} ms a step, "
        f"{fig['launches_per_step']:.0f} launches a step, device busy "
        f"{fig['busy_ms_per_step']:.2f} ms a step, idle "
        f"{fig['idle_share']:.4f} under the profiler, "
        f"{fig['idle_share_unprofiled']:.4f} of the unprofiled median step "
        f"[{smi}]")
    for a in top:
        log(f"    {device_time_us(a) / 2e3:9.3f} ms a step  x{a.count // 2:<4}"
            f" {a.key[:70]}")
    log(f"  losses {[round(x, 4) for x in losses]}; Trainer.run "
        f"{run_s:.1f} s, of which steps {sum(r['wall_s'] for r in hist):.1f}"
        f" s and the rest (a checkpoint of "
        f"{sum(p.numel() for p in lm.parameters()) * 12 / 1e9:.2f} GB "
        f"copied to host and written; data, logging) "
        f"{run_s - sum(r['wall_s'] for r in hist):.1f} s")
    # 4 steps of 2 microbatches
    acc = trainer(TRAIN_STEPS + 2 + TRAIN_ACCUM_STEPS, accum=2)
    state = acc.run(state)
    acc_ms = float(np.median([r["wall_s"] for r in acc.history[1:]])) * 1e3
    if len(acc.history) != TRAIN_ACCUM_STEPS or not all(
            np.isfinite(r["loss"]) for r in acc.history):
        fail(f"train accum_steps=2: {acc.history}")
    fig["accum2_step_ms"] = acc_ms
    log(f"  accum_steps=2: {TRAIN_ACCUM_STEPS} steps, median "
        f"{acc_ms:.2f} ms a step of 2 x {TRAIN_BATCH // 2} x {TRAIN_SEQ}; "
        f"losses {[round(r['loss'], 4) for r in acc.history]} [{smi}]")
    launched = all_counters()
    if any(launched.values()):
        fail(f"training launched a hand-written kernel: {launched}")
    # resume: a fresh Trainer from the step-6 checkpoint (linked into a
    # directory of its own) to 12; it writes no checkpoint of its own
    cut = Path(fresh_root("train-resume"))
    name = f"step_{TRAIN_CKPT_AT:09d}"
    (cut / name).symlink_to(ckpt / name, target_is_directory=True)
    (cut / f"{name}.COMMITTED").touch()
    res = trainer(TRAIN_STEPS, str(cut))
    t0 = time.perf_counter()
    rstate = res.init_or_restore()
    restore_s = time.perf_counter() - t0
    if int(rstate.step) != TRAIN_CKPT_AT:
        fail(f"resume restored step {int(rstate.step)}")
    res.cfg.ckpt_dir = None
    res.run(rstate)
    got = [r["loss"] for r in res.history]
    want = losses[TRAIN_CKPT_AT:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if len(got) != len(want) or rel > RESUME_LOSS_RTOL:
        fail(f"resumed losses {got} against {want}")
    fig["resume_max_rel"] = rel
    log(f"  resumed from step {TRAIN_CKPT_AT} in a fresh Trainer "
        f"(init_or_restore {restore_s:.1f} s): losses "
        f"{[round(x, 4) for x in got]}, max relative difference from the "
        f"uninterrupted run {rel:.3g} (tolerance {RESUME_LOSS_RTOL})")
    launched = all_counters()
    if any(launched.values()):
        fail(f"training launched a hand-written kernel: {launched}")
    del lm, state, rstate, tr, rest, acc, res
    torch.cuda.empty_cache()
    return served, ckpt, fig, dict(host=host, history=hist,
                                   state_bytes=plain_bytes, draw_s=draw_s)


def walk_leaf(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def hold_grads(where, card, cpu, tol):
    """Every parameter's gradient finite and not None on both devices,
    the card's within ``tol`` = (rtol, atol x largest) of the CPU's."""
    for name, g in list(card.items()) + list(cpu.items()):
        if g is None or not torch.isfinite(g).all():
            fail(f"{where}: gradient of {name} is "
                 f"{'None' if g is None else 'not finite'}")
    gmax = max(g.abs().max().item() for g in cpu.values())
    worst = 0.0
    for name, g in cpu.items():
        d = (card[name].cpu() - g).abs()
        bad = d > tol[0] * g.abs() + tol[1] * gmax
        if bad.any():
            fail(f"{where}: gradient of {name} off by {d.max().item():.3g} "
                 f"(largest gradient {gmax:.3g})")
        worst = max(worst, d.max().item() / gmax)
    return worst


def hold_params(where, card, cpu, lrs):
    """Parameters after the steps: every element within Adam's bound (2 x
    the summed rate) of the CPU's, and each leaf's mean difference within
    1e-2 of the summed rate.  A dropped gradient or a wrong update moves
    most of a leaf by ~lr; Adam turns a rounding difference in a
    gradient near zero into a step of ~lr on a few elements, and on all
    of the key bias (``bk``: softmax is invariant to it, its true
    gradient is zero), which is held to the bound alone."""
    bound = 2.0 * sum(lrs) + 1e-6
    for name, p in cpu.items():
        d = (card[name].detach().cpu() - p.detach()).abs()
        if d.max().item() > bound:
            fail(f"{where}: {name} off by {d.max().item():.3g} > {bound}")
        if not name.endswith("attn.bk") and \
                d.mean().item() > 1e-2 * sum(lrs) + 1e-7:
            fail(f"{where}: {name} off by {d.mean().item():.3g} on average")


def card_cpu_train(dev, cfg, where, steps, batch, seq, seed):
    """fp32: ``steps`` train steps of ``cfg`` on the card and on the CPU
    from the same weights and batches; each step's gradients (taken
    before the step), loss, grad norm and rate, and the parameters after
    it, held to each other (:data:`P23_GRAD_TOL` etc.).  Each step starts
    both devices from the CPU's parameters and moments, so no step holds
    the card to weights the other device never had.  Returns the worst
    gradient difference over the largest gradient."""
    from repro_torch.core.features import default_features
    from repro_torch.data import make_source
    from repro_torch.models.lm import LM
    from repro_torch.optim import (AdamWConfig, ScheduleConfig,
                                   apply_updates, lr_at)
    from repro_torch.train import init_train_state
    key = cfg.name.replace("-smoke", "")
    key = key if key in P23_GRAD_TOL else "default"
    feats = default_features().with_(remat_policy="none")
    lms = {"cpu": LM(cfg, torch.float32, "cpu", features=feats).init(
        torch.Generator().manual_seed(seed))}
    lms["card"] = LM(cfg, torch.float32, dev, features=feats)
    lms["card"].load_state_dict(lms["cpu"].state_dict())
    adamw, sched = AdamWConfig(), ScheduleConfig(peak_lr=1e-3,
                                                 warmup_steps=0,
                                                 total_steps=10)
    states = {k: init_train_state(lm, adamw) for k, lm in lms.items()}
    src = make_source(train_data_cfg(cfg, batch, seq))
    worst = 0.0
    for i in range(steps):
        b = src.batch_at(i)
        grads, metrics = {}, {}
        for k, lm in lms.items():
            # make_train_step's body (accum_steps=1), its gradients kept
            tb = {n: torch.from_numpy(v).to(lm.device) for n, v in b.items()}
            st = states[k]
            loss, _ = lm.loss(tb)
            gs = torch.autograd.grad(loss, list(st.params.values()),
                                     allow_unused=True)
            grads[k] = dict(zip(st.params, gs))
            lr = lr_at(st.opt.step, sched)
            params, opt, m = apply_updates(st.params, grads[k], st.opt, lr,
                                           adamw)
            states[k] = st._replace(params=params, opt=opt, step=st.step + 1)
            metrics[k] = {"loss": loss.item(), "grad_norm":
                          m["grad_norm"].item(), "lr": lr.item()}
        worst = max(worst, hold_grads(f"{where} step {i}", grads["card"],
                                      grads["cpu"], P23_GRAD_TOL[key]))
        for n in ("loss", "grad_norm", "lr"):
            a, w = metrics["card"][n], metrics["cpu"][n]
            if abs(a - w) > P23_METRIC_RTOL[key] * abs(w):
                fail(f"{where} step {i}: {n} {a} on the card, {w} on the CPU")
        hold_params(f"{where} step {i}", states["card"].params,
                    states["cpu"].params, [metrics["cpu"]["lr"]])
        # the next step starts both devices from the CPU's state, so each
        # step's gradients are taken at the same weights
        with torch.no_grad():
            for tree in ("params", "m", "v"):
                frm, to = (getattr(st if tree == "params" else st.opt, tree)
                           for st in (states["cpu"], states["card"]))
                for k, t in frm.items():
                    to[k].copy_(t)
    log(f"  {where}: {steps} fp32 steps card vs cpu: losses "
        f"{metrics['card']['loss']:.6g} / {metrics['cpu']['loss']:.6g} "
        f"(last), worst gradient difference {worst:.3g} of the largest")
    del lms, states
    return worst


def train_card_cpu(dev):
    """Phase 23 (b) qwen2-0.5b at full width, 2 of 24 layers, and (c)
    one train step of each family at its SMOKE config, fp32, card
    against CPU; kernels #1-#7 launch no time."""
    import dataclasses as dc
    from repro_torch.configs import get_arch
    from repro_torch.configs.qwen2_0_5b import CONFIG
    for f in (*counters().values(), *case_counters().values()):
        f.launches = 0
    card_cpu_train(dev, dc.replace(CONFIG, n_layers=CARD_CPU_LAYERS),
                   f"qwen2-0.5b {CARD_CPU_LAYERS} layers", CARD_CPU_STEPS,
                   CARD_CPU_BATCH, CARD_CPU_SEQ, seed=30)
    torch.cuda.empty_cache()
    for i, arch in enumerate(TRAIN_FAMILIES):
        card_cpu_train(dev, get_arch(arch).smoke, f"{arch} smoke", 1, 4, 32,
                       seed=31 + i)
    launched = all_counters()
    if any(launched.values()):
        fail(f"a train step launched a hand-written kernel: {launched}")
    log(f"  kernels #1-#7 launched over (a)-(c): {launched}")


#: (d): 4 requests of 16 tokens, 8 greedy tokens each, 4 slots
SERVE_CKPT = dict(requests=4, prompt_len=16, max_new=8, slots=4)


def serve_checkpoint(ckpt):
    """Phase 23 (d), started: ``python -m repro_torch.launch.serve --arch
    qwen2-0.5b --ckpt-dir <(a)'s checkpoints>`` in a subprocess, pages of
    16.  It serves while (b) and (c) run; :func:`check_served_checkpoint`
    waits for it.  Returns (the process, its summary's path, its start
    time)."""
    import os
    out = Path(fresh_root("train-serve")) / "serve.json"
    args = ["repro_torch.launch.serve", "--arch", "qwen2-0.5b",
            "--ckpt-dir", str(ckpt), "--page-size", str(PAGE_SIZE),
            "--max-seq", "128", "--json", str(out)]
    for k, v in SERVE_CKPT.items():
        args += [f"--{k.replace('_', '-')}", str(v)]
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out, time.perf_counter()


def check_served_checkpoint(dev, served, ckpt, serving, smi):
    """Phase 23 (d): the launcher's restore (``restore_params``, what
    ``--ckpt-dir`` runs) gives (a)'s final in-memory weights bit for bit;
    the launcher's greedy tokens, admissions and segments equal those of
    a scheduler on the in-memory weights over the same requests; and the
    launcher launched #1 once a layer of each prefilled admission, #2
    once a layer of each decode step and #4 once a decode step (#3
    never), as the in-memory run did.  Returns the launches."""
    from repro_torch.launch.serve import restore_params
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                          ServeConfig)
    restored = LM(served.cfg, torch.bfloat16, dev)
    restore_params(str(ckpt), restored)
    want_p = dict(served.named_parameters())
    for name, p in restored.named_parameters():
        if not torch.equal(p, want_p[name]):
            fail(f"serve --ckpt-dir restores {name} off by "
                 f"{(p.float() - want_p[name].float()).abs().max().item()}")
    del restored
    proc, out, t0 = serving
    _, err = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"serve --ckpt-dir exited {proc.returncode}: {err[-2000:]}")
    summary = json.loads(out.read_text())
    n_req, slots = SERVE_CKPT["requests"], SERVE_CKPT["slots"]
    eng = Engine(served, ServeConfig(max_seq=128, batch_slots=slots,
                                     page_size=PAGE_SIZE), device=dev)
    sched = BatchScheduler(eng)
    rng = np.random.default_rng(0)        # the launcher's prompts
    for rid in range(n_req):
        sched.submit(Request(
            rid=rid, max_new_tokens=SERVE_CKPT["max_new"],
            prompt=rng.integers(1, served.cfg.vocab,
                                size=SERVE_CKPT["prompt_len"]).tolist()))
    before = read_counters()
    done = sched.run()
    mem_launched = {k: n - before[k] for k, n in read_counters().items()}
    want = {str(r): list(done[r].generated) for r in sorted(done)}
    if summary["tokens"] != want:
        fail(f"served checkpoint tokens {summary['tokens']} != in-memory "
             f"{want}")
    m = sched.metrics
    for k in ("admissions", "segments"):
        if summary[k] != m[k]:
            fail(f"serve --ckpt-dir: {k} {summary[k]}, in memory {m[k]}")
    L = served.cfg.n_layers
    expect = {"flash_attention": L * (m["admissions"] - m["prefix_hits"]),
              "paged_decode": L * m["decode_steps"],
              "paged_decode_q8": 0, "argmax": m["decode_steps"],
              "ssd_scan": 0}
    launched = summary["launches"]
    got = {"flash_attention": launched["flash_attention_bhsd"],
           "paged_decode": launched["paged_decode_attention_grouped"],
           "paged_decode_q8": launched["paged_decode_attention_q8_grouped"],
           "argmax": launched["block_argmax"], "ssd_scan": 0}
    for k, n in expect.items():
        if got[k] != n or mem_launched[k] != n:
            fail(f"serve --ckpt-dir launched {k} {got[k]} times, the "
                 f"in-memory run {mem_launched[k]}, expected {n}")
    if not (got["flash_attention"] and got["paged_decode"]
            and got["argmax"]):
        fail(f"serving the checkpoint launched no #1, #2 or #4: {got}")
    log(f"  serve --ckpt-dir in a subprocess ({secs:.1f} s, beside (b) and "
        f"(c)): restored weights equal (a)'s bit for bit; tokens equal the "
        f"in-memory engine's: {want}; {m['admissions']:.0f} admissions, "
        f"{m['decode_steps']:.0f} decode steps; launched {got}, as "
        f"expected [{smi}]")
    return got


# ---------------------------------------------------------------------------
# phase 24: sharded serving and its fault tolerance
# ---------------------------------------------------------------------------

#: (a): 8 requests (16 until phase 26 needed the time) on 6 slots, so
#: two wait in the queue
MESH_REQUESTS, MESH_SLOTS = 8, 6
MESH_LAYERS = 4                   # (b): qwen2-0.5b at 4 of its 24 layers
MESH_RANKS = 3                    # (b): a (1, 2) mesh plus one hot spare


def mesh_work(vocab, n, seed, lo, hi, blo, bhi):
    """``n`` requests with ragged prompts of ``lo``..``hi`` tokens and
    budgets of ``blo``..``bhi``, from a seed."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist(),
             int(rng.integers(blo, bhi + 1))) for _ in range(n)]


def mesh_sched(eng, work, kill=None, **kw):
    """A ``BatchScheduler`` over ``work`` with the counters set to 0 just
    before it runs and read just after: (scheduler, tokens, wall s,
    launches)."""
    from repro_torch.serve.engine import BatchScheduler, Request
    sched = BatchScheduler(eng, **kw)
    for rid, (prompt, budget) in enumerate(work):
        sched.submit(Request(rid=rid, prompt=prompt, max_new_tokens=budget))
    if kill is not None:
        sched.inject_failure(kill, at_segment=1)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    return sched, {rid: list(r.generated) for rid, r in done.items()}, \
        wall, launches


def sched_launches(layers, m, q8=False):
    """What a scheduler run over a paged engine launches: #1 once a layer
    an admission, #2 (#3 on int8 pages) once a layer a decode step, #4
    once a decode step."""
    steps = int(m["decode_steps"])
    return {"flash_attention": layers * int(m["admissions"]),
            "paged_decode": 0 if q8 else layers * steps,
            "paged_decode_q8": layers * steps if q8 else 0,
            "argmax": steps, "ssd_scan": 0}


def host_copy(lm):
    """``lm``'s weights in a full LM on the CPU: the host copy a sharded
    engine takes, so the card holds one rank's blocks only."""
    from repro_torch.models.lm import LM
    host = LM(lm.cfg, lm.dtype, "cpu")
    host.load_state_dict(lm.state_dict())
    return host


def tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def sharded_engine(where, host, scfg, mesh, dev):
    """``Engine(host, mesh=)`` on ``dev``, checking that the card took
    this rank's blocks of the weights and nothing more: the shard's
    weights are at most 1/m of the full model's split weights plus the
    weights its layout keeps whole on every rank (:func:`replicated_bytes`:
    norms, the MoE router, Mamba2's B and C columns, the sLSTM's
    recurrence) and 1 MiB, and the bytes the engine allocated are the
    shard's tensors (weights and buffers) plus at most 2% and 8 MiB of
    the allocator's rounding, far below a second copy of the model."""
    from repro_torch.serve.engine import Engine
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    eng = Engine(host, scfg, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    took = torch.cuda.memory_allocated(dev) - before
    full, m = tensor_bytes(host.parameters()), eng._shard.tp.size
    shard = tensor_bytes(eng._shard.parameters())
    held = shard + tensor_bytes(eng._shard.buffers())
    rep = replicated_bytes(eng, host)
    if (shard > (full - rep) / m + rep + (1 << 20) or took < held
            or took > held * 1.02 + (8 << 20)):
        fail(f"{where}: the sharded engine allocated {took} bytes on the "
             f"card for a shard of {shard} bytes of weights ({held} with "
             f"its buffers; full model {full}, model axis {m})")
    return eng, took, full


def mesh_one_rank(dev, smi):
    """Phase 24 (a): qwen2-0.5b at full width and depth, bf16, behind
    ``BatchScheduler`` through a (1, 1) ``ServeMesh`` over NCCL (a world
    of one) and unsharded, on the same 8 requests; a chaos schedule with
    one heartbeat flap (absorbed) and one device death (skipped: the last
    device)."""
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.ft.chaos import ChaosEvent, ChaosSchedule
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.serve.engine import Engine, ServeConfig
    import gc
    mesh_mod.init_process("cuda")
    if torch.distributed.get_backend() != "nccl":
        fail(f"phase 24 (a): backend {torch.distributed.get_backend()}, "
             f"expected nccl")
    lm = qwen2(dev, torch.bfloat16)
    scfg = ServeConfig(page_size=PAGE_SIZE, max_seq=1024,
                       batch_slots=MESH_SLOTS, prefix_cache=False)
    work = mesh_work(CONFIG.vocab, MESH_REQUESTS, 24, 17, 256, 8, 32)
    plain = Engine(lm, scfg)
    mesh_sched(plain, work[:4])                             # warm-up
    sched0, want, wall0, l0 = mesh_sched(plain, work)
    m0 = (dict(sched0.metrics), sorted(sched0.completed))
    # the sharded engine's full model is a host copy: the card copy goes
    host = host_copy(lm)
    del plain, sched0, lm
    gc.collect()
    torch.cuda.empty_cache()
    sm = mesh_mod.make_serve_mesh((1, 1))
    eng, took, full = sharded_engine("phase 24 (a)", host, scfg, sm, dev)
    facts = eng.mesh_facts
    if facts != {"mesh_shape": (1, 1), "mesh_axis": "model",
                 "per_device_heads": 2}:
        fail(f"phase 24 (a): mesh_facts {facts}")
    chaos = ChaosSchedule(events=[
        ChaosEvent(segment=2, kind="heartbeat_flap", device=0),
        ChaosEvent(segment=3, kind="device_death", device=0)])
    sched, got, wall, launches = mesh_sched(eng, work, chaos=chaos,
                                            ft_confirm=2)
    if got != want:
        fail("phase 24 (a): the (1, 1) mesh's tokens differ from the "
             "unsharded scheduler's")
    for where, (metrics, completed), ln in (
            ("unsharded", m0, l0),
            ("(1, 1) mesh", (sched.metrics, sorted(sched.completed)),
             launches)):
        want_l = sched_launches(CONFIG.n_layers, metrics)
        if ln != want_l:
            fail(f"phase 24 (a) {where}: launched {ln}, expected {want_l}")
        if completed != list(range(len(work))):
            fail(f"phase 24 (a) {where}: completed {completed}")
    notes = {e["kind"]: e["note"] for e in sched.ft_events
             if e["type"] == "chaos"}
    if (sched.heartbeats is None or sched.metrics["remeshes"] != 0
            or "misses one heartbeat" not in notes.get("heartbeat_flap", "")
            or notes.get("device_death")
            != "skipped: would kill the last device"):
        fail(f"phase 24 (a): ft {sched.metrics.get('remeshes')} re-meshes, "
             f"chaos notes {notes}")
    ntok = sum(len(t) for t in want.values())
    log(f"  (a) qwen2-0.5b bf16, 24 layers, (1, 1) mesh over nccl (world "
        f"of 1), {len(work)} requests on {MESH_SLOTS} slots, {ntok} "
        f"tokens: {ntok / wall:.1f} tokens/s beside {ntok / wall0:.1f} unsharded; tokens equal; "
        f"launches {launches}; facts {facts}; heartbeats armed, chaos "
        f"{notes}, re-meshes 0; the full model on the host, the sharded "
        f"engine allocated {took} bytes on the card (the model's weights: "
        f"{full}) [{smi}]")
    del eng, sched, host
    mesh_mod.leave_process_group()
    torch.cuda.empty_cache()
    return launches


def _mesh_rank(rank, world, init_method):
    """Phase 24 (b), one rank: qwen2-0.5b at full width and 4 of its 24
    layers, fp32, on ``cuda:0`` with every rank (gloo); the unsharded
    engine, then a (1, 2) mesh plus one spare, on fp32 and int8 pages;
    then a kill of ``device_ids[1]`` at segment 1.  The unsharded runs
    come first; the sharded engines then take the full model as a host
    copy on the CPU, with the card's copy gone, so the rank's card holds
    its blocks alone."""
    import gc
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    dev = mesh_mod.init_process("cuda:0", backend="gloo",
                                init_method=init_method, rank=rank,
                                world_size=world)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(CONFIG, n_layers=MESH_LAYERS)
    lm = LM(cfg, torch.float32, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (61, 40, 23, 9)]
    work = mesh_work(cfg.vocab, 8, 26, 8, 64, 8, 24)
    out = {"rank": rank, "runs": {}}
    kvs = (None, "int8")
    scfgs = {kv: ServeConfig(page_size=PAGE_SIZE, max_seq=256,
                             batch_slots=4, kv_dtype=kv) for kv in kvs}
    wants = {}
    for kv in kvs:
        plain = Engine(lm, scfgs[kv])
        g_want = plain.generate(prompts, 12)
        _, s_want, wall0, _ = mesh_sched(plain, work)
        wants[kv] = (g_want, s_want, wall0)
    host = host_copy(lm)
    del plain, lm
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    for kv in kvs:
        tag = kv or "fp32"
        scfg = scfgs[kv]
        g_want, s_want, wall0 = wants[kv]
        sm = mesh_mod.make_serve_mesh((1, 2))
        eng, took, full = sharded_engine(f"phase 24 (b) rank {rank} {tag}",
                                         host, scfg, sm, dev)
        held = torch.cuda.memory_allocated(dev) - base
        reset_counters()
        g = eng.generate(prompts, 12)
        torch.cuda.synchronize()
        g_launches = read_counters()
        sched, s_got, wall, s_launches = mesh_sched(eng, work)
        local_kvh = eng.lm.block_config().attn.num_kv_heads
        member, facts = eng.member, eng.mesh_facts
        s_metrics = dict(sched.metrics)
        del eng, sched
        gc.collect()
        km = mesh_mod.make_serve_mesh((1, 2))
        keng, _, _ = sharded_engine(f"phase 24 (b) rank {rank} {tag} kill",
                                    host, scfg, km, dev)
        ksched, k_got, kwall, k_launches = mesh_sched(
            keng, work, kill=km.device_ids[1], ft_timeout_steps=1,
            ft_confirm=1)
        out["runs"][tag] = dict(
            card_bytes=held, shard_bytes=took, full_bytes=full,
            member=member, local_kvh=local_kvh if member else None,
            facts=facts, device_ids=list(sm.device_ids),
            spares=list(sm.spares), generate_equal=g == g_want,
            generate_launches=g_launches, sched_equal=s_got == s_want,
            sched_launches=s_launches, sched_metrics=s_metrics,
            tok_s=sum(map(len, s_got.values())) / wall,
            tok_s_unsharded=sum(map(len, s_want.values())) / wall0,
            kill_equal=k_got == s_want, kill_launches=k_launches,
            killed=km.device_ids[1],
            remesh=[e for e in ksched.ft_events if e["type"] == "remesh"],
            kill_remeshes=ksched.metrics["remeshes"],
            kill_member=keng.member)
        del keng, ksched
        gc.collect()
    return out


def mesh_three_ranks(smi):
    """Phase 24 (b): three spawned ranks on the one card (gloo over CUDA
    tensors, staged through the host); every rank's results checked
    here."""
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    ranks = mesh_mod.spawn(_mesh_rank, MESH_RANKS, timeout_s=300)
    secs = time.perf_counter() - t0
    layers = MESH_LAYERS
    by_rank = {}
    for r in ranks:
        rank = r["rank"]
        for tag, run in r["runs"].items():
            where = f"phase 24 (b) rank {rank} {tag}"
            q8 = tag == "int8"
            if run["device_ids"] != [0, 1] or run["spares"] != [2]:
                fail(f"{where}: mesh {run['device_ids']}, spares "
                     f"{run['spares']}")
            for what in ("generate_equal", "sched_equal", "kill_equal"):
                if not run[what]:
                    fail(f"{where}: {what} is false: the sharded tokens "
                         f"differ from the unsharded engine's")
            member = rank in (0, 1)
            if run["member"] != member:
                fail(f"{where}: member {run['member']}")
            # everything this rank holds on the card once its sharded
            # engine is built: half the model's weights, not the whole
            if run["card_bytes"] > run["full_bytes"] / 2 + (32 << 20):
                fail(f"{where}: the card holds {run['card_bytes']} bytes "
                     f"beside a sharded engine, more than half of the "
                     f"model's {run['full_bytes']}")
            if member:
                if run["local_kvh"] != 1 or run["facts"][
                        "per_device_heads"] != 1:
                    fail(f"{where}: {run['local_kvh']} kv heads a rank")
                gen_want = {"flash_attention": layers,
                            "paged_decode": 0 if q8 else layers * 11,
                            "paged_decode_q8": layers * 11 if q8 else 0,
                            "argmax": 12, "ssd_scan": 0}
                if run["generate_launches"] != gen_want:
                    fail(f"{where}: generate launched "
                         f"{run['generate_launches']}, expected {gen_want}")
                want = sched_launches(layers, run["sched_metrics"], q8)
                if run["sched_launches"] != want:
                    fail(f"{where}: the scheduler launched "
                         f"{run['sched_launches']}, expected {want}")
            elif any(run["generate_launches"].values()) or any(
                    run["sched_launches"].values()):
                fail(f"{where}: the spare launched kernels")
            ev = run["remesh"]
            if (run["kill_remeshes"] != 1 or len(ev) != 1
                    or run["killed"] in ev[0]["device_ids"]
                    or ev[0]["device_ids"] != [0, 2]):
                fail(f"{where}: re-mesh events {ev}")
            if run["kill_member"] != (rank in (0, 2)):
                fail(f"{where}: after the re-mesh member "
                     f"{run['kill_member']}")
            by_rank.setdefault(tag, {})[rank] = run
    for tag, runs in by_rank.items():
        key = "paged_decode_q8" if tag == "int8" else "paged_decode"
        kl = {r: runs[r]["kill_launches"][key] for r in runs}
        if not (kl[2] > 0 and kl[1] < kl[0] and kl[1] + kl[2] == kl[0]):
            fail(f"phase 24 (b) {tag}: the kill run's {key} launches by "
                 f"rank {kl}: the spare must take over the dead rank's")
        r0 = runs[0]
        lat = [runs[r]["remesh"][0]["remesh_latency_s"] * 1e3 for r in runs]
        log(f"  (b) {tag} pages, (1, 2) mesh + 1 spare, 3 ranks on cuda:0 "
            f"(gloo, host-staged): generate and scheduler tokens equal "
            f"the unsharded engine's; {r0['tok_s']:.1f} tokens/s beside "
            f"{r0['tok_s_unsharded']:.1f} unsharded; #1/#2/#3 at 1 kv head "
            f"a rank, rank 0 launches {r0['sched_launches']}; kill of rank "
            f"1 at segment 1: re-mesh onto {r0['remesh'][0]['device_ids']}, "
            f"remesh_latency_s by rank {[round(x / 1e3, 6) for x in lat]}, "
            f"tokens after equal; {key} launches by rank {kl}; card bytes "
            f"by rank with the sharded engine built "
            f"{[runs[r]['card_bytes'] for r in sorted(runs)]} of a "
            f"{r0['full_bytes']}-byte model kept on the host [{smi}]")
    log(f"  (b) three ranks in {secs:.1f} s (spawn, build check, weights "
        f"and every run)")


def per_device_paged(dev, smi, kvh=1, g=7, dh=64, where="(c)",
                     what="the (1, 2) mesh's per-device shape"):
    """Kernels #2 and #3 at a mesh's per-device shape (phase 24 (c):
    qwen2 on a (1, 2) mesh, KVH 1, G 7, Dh 64; phase 25 (d): qwen2-moe,
    KVH 8, G 1, Dh 128), 8 rows, bf16, against their plain versions,
    timed beside their bounds."""
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_grouped, paged_decode_attention_q8_grouped,
        paged_decode_plain, paged_decode_q8_plain)
    timer = Timer(dev)
    rng = np.random.default_rng(24)
    lens = [n + 16 for n in PROMPT_LENS]
    b = len(lens)
    table, num_pages = plan_table(lens, MAX_NEW - 16, PAGE_SIZE)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, torch.bfloat16)

    common = (torch.from_numpy(table).to(dev),
              torch.tensor(lens, dtype=torch.int32, device=dev),
              rnd(b, kvh, dh), rnd(b, kvh, dh))
    q4 = rnd(b, kvh, g, dh)
    fp = (q4, rnd(num_pages, PAGE_SIZE, kvh, dh),
          rnd(num_pages, PAGE_SIZE, kvh, dh)) + common
    codes = [torch.from_numpy(rng.integers(-127, 128, (
        num_pages, PAGE_SIZE, kvh, dh)).astype(np.int8)).to(dev)
        for _ in range(2)]
    scales = [torch.from_numpy(rng.uniform(0.005, 0.05, (
        num_pages, PAGE_SIZE)).astype(np.float32)).to(dev) for _ in range(2)]
    q8 = (q4, *codes, *scales) + common
    flops = 4.0 * kvh * g * dh * sum(n + 1 for n in lens)
    io = 2 * (2 * q4.numel() + 2 * common[2].numel()) + 4 * b
    pages = 4 * sum(-(-n // PAGE_SIZE) for n in lens)
    shape = f"KVH {kvh}, G {g}, Dh {dh}, {b} rows"
    rows = []
    for name, fn, plain, args, kv_bytes in (
            ("paged_decode", paged_decode_attention_grouped,
             paged_decode_plain, fp, 2 * 2 * sum(lens) * kvh * dh),
            ("paged_decode_q8", paged_decode_attention_q8_grouped,
             paged_decode_q8_plain, q8, sum(lens) * (2 * kvh * dh + 8))):
        err = close(f"{name} at {what} ({shape})", fn(*args), plain(*args))
        ms = timer.ms(lambda: fn(*args))
        plain_ms = timer.ms(lambda: plain(*args))
        bms, by = bound_ms(io + kv_bytes + pages, flops)
        log(f"  {where} {name} bf16 per device ({shape}): {ms:.4f} ms "
            f"(plain {plain_ms:.4f}), bound {bms:.5f} ms by {by}, max|err| "
            f"{err:.3g} [{smi}]")
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms, bound_ms=bms))
    return rows


# ---------------------------------------------------------------------------
# phase 25: training on a mesh, and the moe family on a mesh
# ---------------------------------------------------------------------------

#: (a): qwen2-0.5b at full width and depth, phase 23's 8 x 512 tokens a
#: step, bf16 over fp32 masters: 6 steps through a (1, 1) mesh over NCCL
#: from phase 23 (a)'s draw, held to its first 6 steps
MESH_TRAIN_STEPS = 6
#: (a): the sharded run's losses and grad norms against the unsharded
#: run's, relative.  bf16 compute, and the embedding's index_add backward
#: sums in another order each run on the card: over 6 steps the losses
#: came out equal and the grad norms 1.3e-5 apart, so 1e-3 holds ~70x
#: that and still catches a step that skips a leaf's update or decay
MESH_TRAIN_RTOL = 1e-3
#: (b): qwen2-0.5b at full width and 2 of its 24 layers, fp32, 4 x 128
#: tokens a step, 3 steps a run on four ranks sharing the card (gloo)
MESH_TRAIN_LAYERS, MESH_TRAIN_RANKS = 2, 4
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_RUN = 4, 128, 3
MESH_TRAIN_SCHED = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
#: (b): the runs: a mesh shape, microbatches, int8 error feedback and the
#: compute dtype; the (2, 2) run writes the checkpoint a (1, 2) trainer
#: resumes
MESH_TRAIN_RUNS = {"plain": ((2, 2), 1, False, torch.float32),
                   "accum": ((2, 1), 2, False, torch.float32),
                   "ef": ((1, 2), 1, True, torch.float32)}
MESH_TRAIN_SAVED = "plain"
#: (b): losses and grad norms against the unsharded run's, relative (int8
#: codes that flip across a rounding boundary move the norm by ~a scale)
MESH_TRAIN_METRIC_RTOL = {False: P23_METRIC_RTOL["default"], True: 1e-4}
#: ``--train-mesh-four-cards``: (b)'s rank body one rank a card over NCCL,
#: qwen2-0.5b at full depth, phase 23's 8 x 512 tokens and schedule, 6
#: steps on (2, 2) in bf16 over fp32 masters and in fp32
FOUR_CARD_RUNS = {"bf16": ((2, 2), 1, False, torch.bfloat16),
                  "fp32": ((2, 2), 1, False, torch.float32),
                  "fp32_sp": ((2, 2), 1, False, torch.float32)}
#: the fp32 run's losses and grad norms against the unsharded fp32 run's,
#: relative: only the order of fp32 sums differs, and a step that skips a
#: leaf's update moves a loss by more than 1e-3.  The bf16 run rounds each
#: rank's partial sums to bf16 before they are reduced, a rounding the
#: unsharded run never makes: its losses are held as phase 23 holds bf16
#: runs that sum in another order (:data:`RESUME_LOSS_RTOL`), its grad
#: norms' gaps are printed beside the fp32 run's
FOUR_CARD_FP32_RTOL = 1e-4
#: (c): qwen2-moe-a2.7b at full width and 2 of its 24 layers, fp32, on a
#: (1, 2) mesh of two ranks sharing the card (30 experts a rank)
MOE_MESH_LAYERS, MOE_MESH_NEW = 2, 12
MOE_MESH_PROMPT_LENS = (61, 40, 23, 9)


def state_bytes(state):
    """Bytes of a train state's distinct tensors (a state's params may be
    its LM's own)."""
    seen, total = set(), 0
    trees = (state.params, state.opt.m, state.opt.v, state.opt.ef or {})
    for tree in trees:
        for t in tree.values():
            key = t.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += t.numel() * t.element_size()
    return total


def with_state(make, dev):
    """(a trainer ``make()`` builds, its fresh state, the bytes both left
    allocated on the card)."""
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    tr = make()
    state = tr.init_state()
    torch.cuda.synchronize(dev)
    return tr, state, torch.cuda.memory_allocated(dev) - before


def check_state_bytes(where, held, state):
    """The card holds the state's tensors and nothing more, up to the
    allocator's rounding (2% and 8 MiB)."""
    want = state_bytes(state)
    if held < want or held > want * 1.02 + (8 << 20):
        fail(f"{where}: the card took {held} bytes for a train state of "
             f"{want} bytes")
    return want


def mesh_train_one_rank(dev, smi, plain):
    """Phase 25 (a): qwen2-0.5b at full width and depth, bf16 over fp32
    masters, 8 x 512 tokens a step: ``Trainer(mesh=, state_shardings=
    train_state_pspecs(...))`` on a (1, 1) mesh over NCCL (a world of
    one), 6 steps from phase 23 (a)'s host draw (``plain["host"]``: the
    sharded trainer takes the whole model as its host copy), held to
    phase 23 (a)'s unsharded run over the same steps, batches and
    schedule (``plain["history"]``): losses and grad norms within
    :data:`MESH_TRAIN_RTOL`; the card's bytes for the state its
    tensors'."""
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import Trainer, TrainerConfig, train_state_pspecs
    mesh_mod.init_process("cuda")
    if torch.distributed.get_backend() != "nccl":
        fail(f"phase 25 (a): backend {torch.distributed.get_backend()}")
    host = plain["host"]
    data = train_data_cfg(CONFIG, TRAIN_BATCH, TRAIN_SEQ)
    mesh = mesh_mod.build_mesh([0], (1, 1), ("data", "model"))
    tr, state, held = with_state(lambda: Trainer(
        host, data, TrainerConfig(total_steps=MESH_TRAIN_STEPS,
                                  log_every=MESH_TRAIN_STEPS),
        AdamWConfig(), ScheduleConfig(**TRAIN_SCHED), mesh=mesh,
        state_shardings=train_state_pspecs(host, mesh)), dev)
    sharded_bytes = check_state_bytes("phase 25 (a)", held, state)
    state = tr.run(state)
    torch.cuda.synchronize()
    got, want = tr.history, plain["history"][:MESH_TRAIN_STEPS]
    del tr, state
    torch.cuda.empty_cache()
    for key in ("loss", "grad_norm"):
        a, w = [r[key] for r in got], [r[key] for r in want]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, w))
        if len(a) != MESH_TRAIN_STEPS or rel > MESH_TRAIN_RTOL:
            fail(f"phase 25 (a): sharded {key} {a} against unsharded {w}")
    launched = all_counters()
    if any(launched.values()):
        fail(f"phase 25 (a): training launched a kernel: {launched}")
    ms = [float(np.median([r["wall_s"] for r in h[2:]])) * 1e3
          for h in (got, want)]
    log(f"  (a) qwen2-0.5b bf16 over fp32 masters, 24 layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, (1, 1) mesh over nccl (a "
        f"world of 1): step {ms[0]:.2f} ms beside {ms[1]:.2f} ms unsharded "
        f"(phase 23 (a); median of steps 2-{MESH_TRAIN_STEPS - 1}); losses "
        f"{[round(r['loss'], 5) for r in got]} beside "
        f"{[round(r['loss'], 5) for r in want]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in got]} beside "
        f"{[round(r['grad_norm'], 4) for r in want]}; train state on the "
        f"card {sharded_bytes} bytes beside {plain['state_bytes']} "
        f"unsharded; the host draw {plain['draw_s']:.1f} s [{smi}]")
    mesh_mod.leave_process_group()


def _hold_slices(where, layout, params, full, lrs):
    """This rank's slices of ``params`` against the unsharded run's whole
    ``full`` parameters (on the host), as :func:`hold_params` holds
    them."""
    hold_params(where, params, {k: layout.cut(k, v).cpu()
                                for k, v in full.items()}, lrs)


def mesh_train_plan(four_cards=False):
    """Phase 25 (b)'s plan: four ranks on ``cuda:0`` over gloo, qwen2-0.5b
    at 2 of 24 layers, :data:`MESH_TRAIN_RUNS`, every parameter held, a
    checkpoint resumed across shapes.  With ``four_cards``, the same rank
    body one rank a card over NCCL: full depth, phase 23's tokens, remat
    and schedule, :data:`FOUR_CARD_RUNS`, losses and grad norms held (bf16
    parameters are not held to fp32 bounds), no checkpoint."""
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.core.features import default_features
    if four_cards:
        return dict(device="cuda", backend="nccl", cfg=CONFIG,
                    remat=default_features().remat_policy,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=MESH_TRAIN_STEPS,
                    sched=TRAIN_SCHED, runs=FOUR_CARD_RUNS, saved=None,
                    hold_params=False)
    return dict(device="cuda:0", backend="gloo",
                cfg=dataclasses.replace(CONFIG, n_layers=MESH_TRAIN_LAYERS),
                remat="none", batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ,
                steps=MESH_TRAIN_RUN, sched=MESH_TRAIN_SCHED,
                runs=MESH_TRAIN_RUNS, saved=MESH_TRAIN_SAVED,
                hold_params=True)


def mesh_train_lm(plan, dtype, device, name=""):
    """The plan's LM: ``dtype`` compute over fp32 parameters; a run whose
    ``name`` ends in ``_sp`` trains under sequence parallelism
    (``act_seq -> model``)."""
    from repro_torch.core.features import default_features
    from repro_torch.models.layers import DEFAULT_RULES
    from repro_torch.models.lm import LM
    feats = default_features().with_(remat_policy=plan["remat"])
    rules = (DEFAULT_RULES.replace(act_seq=("model",))
             if name.endswith("_sp") else DEFAULT_RULES)
    return LM(plan["cfg"], dtype, device, features=feats,
              param_dtype=torch.float32, rules=rules)


def mesh_train_draw(plan):
    """The plan's weights, drawn on the host from seed 0."""
    host = mesh_train_lm(plan, torch.float32, "cpu")
    host.init(torch.Generator().manual_seed(0))
    return dict(host.state_dict())


def mesh_trainer(lm, plan, total, accum, ef, **kw):
    """A ``Trainer`` of the plan's data and schedule (``kw``: ``mesh=``,
    ``ckpt_dir=``)."""
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import Trainer, TrainerConfig
    return Trainer(lm, train_data_cfg(plan["cfg"], plan["batch"],
                                      plan["seq"]), TrainerConfig(
        total_steps=total, log_every=100, accum_steps=accum, ckpt_every=0,
        ckpt_dir=kw.pop("ckpt_dir", None)),
        AdamWConfig(grad_compression="int8_ef" if ef else "none"),
        ScheduleConfig(**plan["sched"]), **kw)


def mesh_train_refs(dev, plan, path, limits):
    """The plan's unsharded runs on ``dev``, once for every rank: each
    run's losses and grad norms (the saved run 2 steps further), its
    median step ms and ``limits(refs)``'s limits for it; with
    ``hold_params``, its parameters after its steps (and the saved run's
    after 2 more).  Written to ``path`` whole or not at all (the ranks
    wait for it); returns (the refs, the bytes of the whole weights)."""
    import os
    weights = mesh_train_draw(plan)
    refs, params = {}, {}

    def host_params(st):
        return {k: v.detach().to("cpu", copy=True)
                for k, v in st.params.items()}

    for name, (_, accum, ef, dtype) in plan["runs"].items():
        if name.endswith("_sp"):
            # unsharded, sequence parallelism has nothing to split: the
            # run without it is the reference
            refs[name] = refs[name[:-3]]
            continue
        lm = mesh_train_lm(plan, dtype, dev)
        lm.load_state_dict(weights)
        tr = mesh_trainer(lm, plan, plan["steps"], accum, ef)
        st = tr.run(tr.init_state())
        hist = list(tr.history)
        if plan["hold_params"]:
            params[name] = {"at": host_params(st)}
        if name == plan["saved"]:
            more = mesh_trainer(lm, plan, plan["steps"] + 2, accum, ef)
            st = more.run(st)
            hist += more.history
            params[name]["final"] = host_params(st)
        refs[name] = dict(
            hist=[{k: float(r[k]) for k in ("loss", "grad_norm")}
                  for r in hist],
            step_ms=float(np.median([r["wall_s"]
                                     for r in hist[1:plan["steps"]]])) * 1e3)
        del lm, tr, st
        torch.cuda.empty_cache()
    limits(refs)
    torch.save(dict(refs=refs, params=params), path + ".part")
    os.replace(path + ".part", path)
    return refs, sum(v.numel() * v.element_size() for v in weights.values())


def wait_for_refs(path, timeout_s=300.0):
    """:func:`mesh_train_refs`'s file, once the parent has written it."""
    import os
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            fail(f"no unsharded runs at {path} after {timeout_s:.0f} s")
        time.sleep(0.2)
    return torch.load(path, mmap=True, weights_only=True)


def _train_mesh_rank(rank, world, init_method, plan, refs_path, ckpt_root):
    """One rank of phase 25 (b) (or of ``--train-mesh-four-cards``), as
    :func:`mesh_train_plan` lays it out: from one host draw, each run of
    ``plan["runs"]`` through ``Trainer(mesh=)``, its losses and grad norms
    held to the unsharded run's within its limits, its card bytes its
    slices', with ``hold_params`` this rank's slices of the parameters
    against the unsharded run's (the parent makes the unsharded runs
    once, while the ranks start, and writes them to ``refs_path``: a rank
    waits for them after its first run); the saved run writes its
    checkpoint, and a fresh ``Trainer`` on (1, 2) resumes it for 2 more
    steps, held to the unsharded run's."""
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    secs = {}                       # where the rank's time went
    dev = mesh_mod.init_process(plan["device"], backend=plan["backend"],
                                init_method=init_method, rank=rank,
                                world_size=world)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)        # the ranks share the host's cores
    weights = mesh_train_draw(plan)
    made = {}                       # the unsharded runs, once written
    steps = plan["steps"]
    lrs = [plan["sched"]["peak_lr"]] * steps

    def lap(what):
        nonlocal t0
        t = time.perf_counter()
        secs[what] = t - t0
        t0 = t

    lap("start and draw")
    out = {"rank": rank, "runs": {}, "secs": secs}

    def check(where, hist, name, lo):
        if not made:
            t = time.perf_counter()
            made.update(wait_for_refs(refs_path))
            secs["of which waiting"] = time.perf_counter() - t
        ref = made["refs"][name]
        gaps = {}
        for key in ("loss", "grad_norm"):
            a = [r[key] for r in hist]
            w = [r[key] for r in ref["hist"][lo:lo + len(hist)]]
            lim = ref["limits"][key][lo:lo + len(hist)]
            gaps[key] = [abs(x - y) / abs(y) for x, y in zip(a, w)]
            if len(a) != len(w) or any(
                    g > m for g, m in zip(gaps[key], lim)):
                fail(f"{where}: {key} {a} against the unsharded {w}: "
                     f"relative gaps {gaps[key]}, limits {lim}")
        return gaps

    for name, (shape, accum, ef, dtype) in plan["runs"].items():
        n = int(np.prod(shape))
        mesh = mesh_mod.build_mesh(range(n), shape, ("data", "model"))
        if rank >= n:
            continue
        where = f"phase 25 (b) rank {rank} {shape} {name}"
        host = mesh_train_lm(plan, dtype, "cpu", name)
        host.load_state_dict(weights)
        tr, st, held = with_state(lambda: mesh_trainer(
            host, plan, steps, accum, ef, mesh=mesh,
            ckpt_dir=ckpt_root if name == plan["saved"] else None), dev)
        mine = check_state_bytes(where, held, st)
        if tr.lm._sp != name.endswith("_sp"):
            fail(f"{where}: sequence parallelism {tr.lm._sp}")
        st = tr.run(st)
        gaps = check(where, tr.history, name, 0)
        if plan["hold_params"]:
            _hold_slices(where, tr.layout, st.params,
                         made["params"][name]["at"], lrs)
        out["runs"][name] = dict(
            shape=shape, state_bytes=mine, held=held, gaps=gaps,
            losses=[r["loss"] for r in tr.history],
            grad_norms=[r["grad_norm"] for r in tr.history],
            step_ms=float(np.median([r["wall_s"] for r in tr.history[1:]]))
            * 1e3, gathered=len(tr.layout.gathered))
        del tr, st, host
        torch.cuda.empty_cache()
        lap(name)
    if plan["saved"] is not None:
        mesh = mesh_mod.build_mesh(range(2), (1, 2), ("data", "model"))
    if plan["saved"] is not None and rank < 2:
        where = f"phase 25 (b) rank {rank} (1, 2) resumed"
        _, accum, ef, dtype = plan["runs"][plan["saved"]]
        host = mesh_train_lm(plan, dtype, "cpu")
        host.load_state_dict(weights)
        tr = mesh_trainer(host, plan, steps + 2, accum, ef, mesh=mesh,
                          ckpt_dir=ckpt_root)
        st = tr.init_or_restore()
        if int(st.step) != steps:
            fail(f"{where}: restored step {int(st.step)}")
        tr.cfg.ckpt_dir = None
        st = tr.run(st)
        check(where, tr.history, plan["saved"], steps)
        _hold_slices(where, tr.layout, st.params,
                     made["params"][plan["saved"]]["final"], lrs + lrs[:2])
        out["resumed"] = [r["loss"] for r in tr.history]
        lap("resumed")
    launched = all_counters()
    if any(launched.values()):
        fail(f"phase 25 (b) rank {rank}: training launched a kernel: "
             f"{launched}")
    return out


def _state_of(full_bytes, ef):
    """An unsharded fp32 state's bytes: params, two moments (and the
    error-feedback residuals)."""
    return full_bytes * (4 if ef else 3)


def log_mesh_train(ranks, plan, refs, full_bytes, where, smi):
    """A line for each run: losses, step ms sharded beside unsharded, the
    state a rank keeps on its card."""
    r0 = ranks[0]
    for name, run in r0["runs"].items():
        by_rank = [r["runs"][name]["state_bytes"] for r in ranks
                   if name in r["runs"]]
        worst = {k: max(g) for k, g in run["gaps"].items()}
        log(f"  {where} {name} on {run['shape']}: losses "
            f"{[round(x, 5) for x in run['losses']]}, grad norms "
            f"{[round(x, 4) for x in run['grad_norms']]}, within "
            f"{worst} of the unsharded run's; step {run['step_ms']:.2f} ms "
            f"beside {refs[name]['step_ms']:.2f} unsharded; train state on "
            f"the card by rank {by_rank} bytes (each its slices; "
            f"{run['gathered']} leaves gathered over data for a step) "
            f"beside {_state_of(full_bytes, plan['runs'][name][2])} "
            f"unsharded "
            f"[{smi}]")


def mesh_train_four_ranks(dev, smi):
    """Phase 25 (b): four spawned ranks sharing the card while the
    unsharded runs are made once on it, beside them; every rank checks
    its own runs."""
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    plan = mesh_train_plan()
    refs_path = str(Path(fresh_root("mesh-train-refs")) / "refs.pt")

    def limits(refs):
        for name, (_, _, ef, _) in plan["runs"].items():
            n = len(refs[name]["hist"])
            refs[name]["limits"] = {k: [MESH_TRAIN_METRIC_RTOL[ef]] * n
                                    for k in ("loss", "grad_norm")}

    def unsharded():
        out = mesh_train_refs(dev, plan, refs_path, limits)
        return out + (time.perf_counter() - t0,)

    ranks, (refs, full_bytes, t_refs) = concurrently(
        lambda: mesh_mod.spawn(_train_mesh_rank, MESH_TRAIN_RANKS, (
            plan, refs_path, fresh_root("mesh-train-ckpt")), timeout_s=400),
        unsharded)
    secs = time.perf_counter() - t0
    log_mesh_train(ranks, plan, refs, full_bytes, "(b)", smi)
    r0 = ranks[0]
    log(f"  (b) the (2, 2) run's checkpoint resumed on (1, 2): losses "
        f"{[round(x, 5) for x in r0['resumed']]} equal the unsharded "
        f"run's; the unsharded runs done at {t_refs:.1f} s, the four "
        f"ranks at {secs:.1f} s; rank 0's seconds "
        f"{ {k: round(v, 1) for k, v in r0['secs'].items()} }")
    return ranks


def train_mesh_four_cards() -> int:
    """``chip_smoke.py --train-mesh-four-cards``: phase 25 (b)'s rank body
    on four cards, one rank a card over NCCL (:func:`mesh_train_plan`):
    the unsharded bf16 and fp32 runs on card 0 first (one card's step
    ms; the gap between them printed, bf16 rounding's own size), then
    the four ranks, held as :data:`FOUR_CARD_FP32_RTOL` says."""
    from repro_torch.launch import mesh as mesh_mod
    if torch.cuda.device_count() < 4:
        fail(f"--train-mesh-four-cards needs 4 cards, this host has "
             f"{torch.cuda.device_count()}")
    smi = gpu_name_and_limit()
    log(f"  nvidia-smi: {smi}")
    plan = mesh_train_plan(four_cards=True)
    wit = {}

    def limits(refs):
        wit.update({k: [abs(x[k] - y[k]) / abs(y[k]) for x, y in
                        zip(refs["bf16"]["hist"], refs["fp32"]["hist"])]
                    for k in ("loss", "grad_norm")})
        n = len(wit["loss"])
        refs["bf16"]["limits"] = {"loss": [RESUME_LOSS_RTOL] * n,
                                  "grad_norm": [float("inf")] * n}
        refs["fp32"]["limits"] = {k: [FOUR_CARD_FP32_RTOL] * n
                                  for k in wit}

    # one card's runs alone on card 0 first: their step ms is one card's
    refs_path = str(Path(fresh_root("mesh-train-refs")) / "refs.pt")
    refs, full_bytes = mesh_train_refs(torch.device("cuda", 0), plan,
                                       refs_path, limits)
    log(f"  unsharded on one card: bf16 losses "
        f"{[round(r['loss'], 5) for r in refs['bf16']['hist']]}, fp32 "
        f"{[round(r['loss'], 5) for r in refs['fp32']['hist']]}; bf16 "
        f"against fp32, relative: {wit}")
    t0 = time.perf_counter()
    ranks = mesh_mod.spawn(_train_mesh_rank, 4, (plan, refs_path, None),
                           timeout_s=600)
    log_mesh_train(ranks, plan, refs, full_bytes, "four cards, nccl,", smi)
    log(f"  four ranks in {time.perf_counter() - t0:.1f} s; rank 0's "
        f"seconds {ranks[0]['secs']}")
    print(smi, flush=True)
    print(json.dumps({name: dict(
        step_ms=ranks[0]["runs"][name]["step_ms"],
        unsharded_step_ms=refs[name]["step_ms"],
        state_bytes=[r["runs"][name]["state_bytes"] for r in ranks],
        gaps=ranks[0]["runs"][name]["gaps"],
        limits=refs[name]["limits"]) for name in plan["runs"]}), flush=True)
    return 0


def _moe_mesh_rank(rank, world, init_method):
    """Phase 25 (c), one rank of two on ``cuda:0`` (gloo): qwen2-moe-a2.7b
    at full width and 2 of 24 layers, fp32.  The unsharded engine's
    ``generate`` and ``BatchScheduler`` on fp32 and int8 pages first;
    then the same through a (1, 2) mesh, the full model a host copy on
    the CPU: tokens, launches and the card's bytes."""
    import dataclasses as dc
    import gc
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    dev = mesh_mod.init_process("cuda:0", backend="gloo",
                                init_method=init_method, rank=rank,
                                world_size=world)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dc.replace(CONFIG, n_layers=MOE_MESH_LAYERS)
    lm = LM(cfg, torch.float32, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        lm.embed.table.mul_(0.1)
    rng = np.random.default_rng(251)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in MOE_MESH_PROMPT_LENS]
    work = mesh_work(cfg.vocab, 8, 252, 8, 64, 8, 24)
    kvs = (None, "int8")
    # the prefix cache off: a hit prefills its suffix with plain ops, and
    # #1's count is then not the admissions'
    scfgs = {kv: ServeConfig(page_size=PAGE_SIZE, max_seq=256,
                             batch_slots=4, kv_dtype=kv, prefix_cache=False)
             for kv in kvs}
    wants = {}
    for kv in kvs:
        plain = Engine(lm, scfgs[kv])
        g_want = plain.generate(prompts, MOE_MESH_NEW)
        _, s_want, wall0, _ = mesh_sched(plain, work)
        wants[kv] = (g_want, s_want, wall0)
    host = host_copy(lm)
    del plain, lm
    gc.collect()
    torch.cuda.empty_cache()
    out = {"rank": rank, "runs": {}}
    for kv in kvs:
        tag = kv or "fp32"
        where = f"phase 25 (c) rank {rank} {tag}"
        g_want, s_want, wall0 = wants[kv]
        sm = mesh_mod.make_serve_mesh((1, 2))
        eng, took, full = sharded_engine(where, host, scfgs[kv], sm, dev)
        reset_counters()
        g = eng.generate(prompts, MOE_MESH_NEW)
        torch.cuda.synchronize()
        g_launches = read_counters()
        sched, s_got, wall, s_launches = mesh_sched(eng, work)
        q8 = kv == "int8"
        want_g = {"flash_attention": MOE_MESH_LAYERS,
                  "paged_decode": 0 if q8 else MOE_MESH_LAYERS
                  * (MOE_MESH_NEW - 1),
                  "paged_decode_q8": MOE_MESH_LAYERS * (MOE_MESH_NEW - 1)
                  if q8 else 0, "argmax": MOE_MESH_NEW, "ssd_scan": 0}
        want_s = sched_launches(MOE_MESH_LAYERS, sched.metrics, q8)
        if g != g_want or s_got != s_want:
            fail(f"{where}: the sharded tokens differ from the unsharded "
                 f"engine's")
        if g_launches != want_g or s_launches != want_s:
            fail(f"{where}: launched {g_launches} / {s_launches}, expected "
                 f"{want_g} / {want_s}")
        blk = eng.lm.blocks[0]
        if (blk.moe.w_gate.shape[0] != cfg.moe_experts // 2
                or eng.lm.block_config().attn.num_kv_heads
                != cfg.num_kv_heads // 2):
            fail(f"{where}: a rank holds {blk.moe.w_gate.shape[0]} experts "
                 f"and {eng.lm.block_config().attn.num_kv_heads} kv heads")
        out["runs"][tag] = dict(
            shard_bytes=took, full_bytes=full, g_launches=g_launches,
            s_launches=s_launches,
            tok_s=sum(map(len, s_got.values())) / wall,
            tok_s_unsharded=sum(map(len, s_want.values())) / wall0)
        del eng, sched
        gc.collect()
    return out


def moe_mesh_two_ranks(smi):
    """Phase 25 (c): two spawned ranks on the card; every rank checks its
    runs.  Returns rank 0's scheduler launches on int8 pages."""
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    ranks = mesh_mod.spawn(_moe_mesh_rank, 2, timeout_s=400)
    secs = time.perf_counter() - t0
    for tag in ("fp32", "int8"):
        runs = [r["runs"][tag] for r in ranks]
        r0 = runs[0]
        log(f"  (c) qwen2-moe-a2.7b {MOE_MESH_LAYERS} layers fp32, {tag} "
            f"pages, (1, 2) mesh (30 experts and 8 kv heads a rank): "
            f"generate and scheduler tokens equal the unsharded engine's; "
            f"{r0['tok_s']:.1f} tokens/s beside {r0['tok_s_unsharded']:.1f} "
            f"unsharded; rank 0 launches generate {r0['g_launches']}, "
            f"scheduler {r0['s_launches']}; the sharded engine allocated "
            f"{[r['shard_bytes'] for r in runs]} bytes by rank of a "
            f"{r0['full_bytes']}-byte model kept on the host [{smi}]")
    log(f"  (c) two ranks in {secs:.1f} s")
    return ranks[0]["runs"]["int8"]["s_launches"]


class Background:
    """``fn()`` on a thread of its own from now on: :meth:`result` joins
    it and returns its value, or raises its failure."""

    def __init__(self, fn):
        import threading
        self._out = None
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        daemon=True)
        self._thread.start()

    def _run(self, fn):
        try:
            self._out = (True, fn())
        except BaseException as e:          # raised again in result()
            self._out = (False, e)

    def result(self):
        self._thread.join()
        ok, value = self._out
        if not ok:
            raise value
        return value


def concurrently(*fns):
    """Every ``fn()`` on a thread of its own, side by side; their results
    in order, or the first one's failure raised here."""
    running = [Background(fn) for fn in fns]
    return [b.result() for b in running]


def per_device_flash(dev, smi):
    """Phase 25 (d): kernel #1 at qwen2-moe-a2.7b's per-device prefill on
    a (1, 2) mesh, [8, 8, 512, 128] (16 heads over 2, G 1), phase 3's
    ragged prompts, bf16, causal: against its plain version, timed
    beside its bound and SDPA with the mask."""
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_plain)
    timer = Timer(dev)
    rng = np.random.default_rng(253)
    b, h, kvh, dh, s = len(PROMPT_LENS), 8, 8, 128, max(PROMPT_LENS)

    def rnd(n):
        return torch.from_numpy(rng.standard_normal(
            (b, n, s, dh), np.float32)).to(dev, torch.bfloat16)

    q, k, v = rnd(h), rnd(kvh), rnd(kvh)
    kvv = torch.tensor(PROMPT_LENS, dtype=torch.int32, device=dev)
    kw = dict(causal=True, kv_valid=kvv)
    err = close("flash at qwen2-moe-a2.7b's per-device prefill "
                "[8,8,512,128]", flash_attention_bhsd(q, k, v, **kw),
                flash_attention_plain(q, k, v, **kw))
    ms = timer.ms(lambda: flash_attention_bhsd(q, k, v, **kw))
    plain_ms = timer.ms(lambda: flash_attention_plain(q, k, v, **kw))
    kpos = torch.arange(s, device=dev)
    mask = ((kpos[None, :] <= kpos[:, None])[None, None]
            & (kpos[None, None, None, :] < kvv[:, None, None, None]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timer.ms(lambda: sdpa(q, k, v, attn_mask=mask))
    bms, by = flash_bound(q, k, PROMPT_LENS)
    log(f"  (d) flash_attention bf16 per device [8,8,512,128] ragged causal: "
        f"{ms:.4f} ms (plain {plain_ms:.4f}, SDPA with the mask "
        f"{library_ms:.4f}), bound {bms:.5f} ms by {by}, max|err| {err:.3g} "
        f"[{smi}]")
    return dict(name="flash_attention", ms=ms, plain_ms=plain_ms,
                bound_ms=bms, library_ms=library_ms)


# ---------------------------------------------------------------------------
# phase 26: the hybrid, xlstm and encdec families on a mesh; the dry run
# ---------------------------------------------------------------------------

FAM_ARCHS = ("zamba2-1.2b", "xlstm-350m", "seamless-m4t-medium")
#: (a): full width and depth (seamless at its 12 + 12 layers), bf16: 4
#: prompts of 64 tokens, 8 new; 6 scheduler requests (hybrid, xlstm)
FAM_PROMPTS, FAM_PROMPT_LEN, FAM_NEW, FAM_REQUESTS = 4, 64, 8, 6
#: (a): the (1, 1) Trainer: zamba2-1.2b at full width and 8 of its 38
#: layers (two applications of the shared block), bf16 over fp32
#: masters, 4 x 128 tokens a step, 3 steps
FAM_TRAIN_LAYERS, FAM_TRAIN_BATCH, FAM_TRAIN_SEQ = 8, 4, 128
FAM_TRAIN_STEPS = 3
#: (b): fp32 at full width and reduced depth, ranks on cuda:0 over gloo:
#: zamba2 at 8 layers (two applications of the shared block), xlstm at 2
#: pairs, seamless at 2 + 2
FAM_MESH_LAYERS = {"zamba2-1.2b": 8, "xlstm-350m": 4,
                   "seamless-m4t-medium": 2}
FAM_MESH_RANKS = 3                 # a (1, 2) mesh plus one spare
FAM_MESH_PROMPTS, FAM_MESH_PROMPT_LEN, FAM_MESH_NEW = 3, 24, 6
FAM_MESH_REQUESTS = 4
FAM_MESH_BATCH, FAM_MESH_SEQ = 2, 32
#: (b): one training step's loss and grad norm on (1, 2) against the
#: unsharded step's, relative (xlstm-350m: its test tolerance,
#: tests/test_torch_train_families.py)
FAM_TRAIN_RTOL = {"default": 1e-5, "xlstm-350m": 1e-3}


def fam_cfg(arch, layers=None):
    """``arch``'s full config, at ``layers`` layers (seamless: ``layers``
    encoder and ``layers`` decoder layers) when given."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).config
    if layers is None:
        return cfg
    extra = {"enc_layers": layers} if cfg.family == "encdec" else {}
    return dataclasses.replace(cfg, n_layers=layers, **extra)


def fam_traffic(cfg, seed, rows, length, requests):
    """Equal-length prompts (the recurrent and encdec families prefill
    equal-length rows), the encdec family's source frames from the same
    seed, and ragged scheduler requests."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, length).tolist()
               for _ in range(rows)]
    extra = None
    if cfg.family == "encdec":
        extra = {"src_embeds": rng.standard_normal(
            (rows, max(length // cfg.src_ratio, 1), cfg.d_model),
            np.float32)}
    work = mesh_work(cfg.vocab, requests, seed + 1, 8, length, 4, 12)
    return prompts, extra, work


def counted_generate(eng, prompts, max_new, extra):
    """(tokens, launches) of one ``generate`` with the counters set to 0
    just before it and read just after."""
    torch.cuda.synchronize()
    reset_counters()
    out = eng.generate(prompts, max_new, extra_batch=extra)
    torch.cuda.synchronize()
    return out, read_counters()


def replicated_bytes(eng, host):
    """Bytes of a sharded engine's weights that every rank of the model
    axis holds whole: the leaves its layout keeps whole (norms, a width
    the axis does not divide, the sLSTM's recurrence) and the whole parts
    of the split ones (Mamba2's B and C columns, the mLSTM's xm half)."""
    from repro_torch.models.layers import spec_tree_to_pspecs
    from repro_torch.serve.engine import SERVE_RULES
    full = dict(host.named_parameters())
    shard = eng._shard
    specs = shard.rank_pspecs(spec_tree_to_pspecs(
        host.param_specs(), SERVE_RULES, eng.mesh, shapes=full), full)
    splits = shard.model_splits()
    total = 0
    for k, p in shard.named_parameters():
        if "model" not in str(specs[k]):
            total += p.numel() * p.element_size()
        elif k in splits:
            sp = splits[k]
            whole = sum(n for n, split in sp.parts if not split)
            total += whole * p.numel() // p.shape[sp.dim] * p.element_size()
    return total


def family_mesh_one_rank(dev, smi):
    """Phase 26 (a): zamba2-1.2b and xlstm-350m at full width and depth,
    seamless-m4t-medium at 12 + 12 layers, bf16, through a (1, 1)
    ``ServeMesh`` over NCCL (a world of one) beside the unsharded engine:
    ``generate`` tokens and launches equal, and the scheduler's for the
    hybrid and xlstm; then zamba2-1.2b at full width and 8 layers through
    ``Trainer(mesh=)`` on a (1, 1) mesh beside the unsharded ``Trainer``:
    losses and grad norms within :data:`MESH_TRAIN_RTOL`, no kernel
    launched.  Returns each path's launches."""
    import gc
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.serve.engine import Engine, ServeConfig
    mesh_mod.init_process("cuda")
    if torch.distributed.get_backend() != "nccl":
        fail(f"phase 26 (a): backend {torch.distributed.get_backend()}")
    by_path = {}
    for i, arch in enumerate(FAM_ARCHS):
        where = f"phase 26 (a) {arch}"
        cfg = fam_cfg(arch)
        lm = build_lm(cfg, dev)
        scfg = ServeConfig(max_seq=256, batch_slots=4)
        prompts, extra, work = fam_traffic(cfg, 260 + i, FAM_PROMPTS,
                                           FAM_PROMPT_LEN, FAM_REQUESTS)
        sched = cfg.family != "encdec"
        plain = Engine(lm, scfg)
        plain.generate(prompts, 2, extra_batch=extra)           # warm-up
        want, l0 = counted_generate(plain, prompts, FAM_NEW, extra)
        if sched:
            _, s_want, wall0, sl0 = mesh_sched(plain, work)
        host = host_copy(lm)
        del plain, lm
        gc.collect()
        torch.cuda.empty_cache()
        sm = mesh_mod.make_serve_mesh((1, 1))
        eng, took, full = sharded_engine(where, host, scfg, sm, dev)
        got, l1 = counted_generate(eng, prompts, FAM_NEW, extra)
        if got != want or l1 != l0:
            fail(f"{where}: generate on the (1, 1) mesh gave {got} with "
                 f"launches {l1}; unsharded {want}, {l0}")
        for k in ("flash_attention", "ssd_scan"):
            if k in {"zamba2-1.2b": ("flash_attention", "ssd_scan"),
                     "xlstm-350m": ("ssd_scan",),
                     "seamless-m4t-medium": ("flash_attention",)}[arch] \
                    and l1[k] < 1:
                fail(f"{where}: {k} never launched")
        by_path[f"{arch}_mesh_generate_1x1"] = l1
        line = (f"  (a) {arch} bf16, {cfg.n_layers} layers, (1, 1) mesh "
                f"over nccl: generate of {FAM_PROMPTS} x {FAM_PROMPT_LEN} "
                f"+ {FAM_NEW} tokens equal the unsharded engine's, "
                f"launches {l1}")
        if sched:
            _, s_got, wall, sl1 = mesh_sched(eng, work)
            if s_got != s_want or sl1 != sl0:
                fail(f"{where}: the (1, 1) mesh's scheduler gave other "
                     f"tokens or launches ({sl1} against {sl0})")
            ntok = sum(len(t) for t in s_want.values())
            by_path[f"{arch}_mesh_scheduler_1x1"] = sl1
            line += (f"; scheduler {len(work)} requests equal, "
                     f"{ntok / wall:.1f} tokens/s beside "
                     f"{ntok / wall0:.1f} unsharded, launches {sl1}")
        log(line + f"; the engine allocated {took} bytes on the card for "
            f"a {full}-byte model [{smi}]")
        del eng, host
        gc.collect()
        torch.cuda.empty_cache()
    family_mesh_trainer(dev, smi)
    mesh_mod.leave_process_group()
    return by_path


def family_mesh_trainer(dev, smi):
    """Phase 26 (a)'s training half (see :func:`family_mesh_one_rank`)."""
    from repro_torch.core.features import default_features
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import Trainer, TrainerConfig, train_state_pspecs
    cfg = fam_cfg("zamba2-1.2b", FAM_TRAIN_LAYERS)
    feats = default_features()
    host = LM(cfg, torch.bfloat16, "cpu", features=feats,
              param_dtype=torch.float32)
    host.init(torch.Generator().manual_seed(0))
    data = train_data_cfg(cfg, FAM_TRAIN_BATCH, FAM_TRAIN_SEQ)

    def trainer(lm, **kw):
        return Trainer(lm, data, TrainerConfig(
            total_steps=FAM_TRAIN_STEPS, log_every=FAM_TRAIN_STEPS),
            AdamWConfig(), ScheduleConfig(**MESH_TRAIN_SCHED), **kw)

    card = LM(cfg, torch.bfloat16, dev, features=feats,
              param_dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    for f in (*counters().values(), *case_counters().values()):
        f.launches = 0
    tr0, st0, _ = with_state(lambda: trainer(card), dev)
    held0 = state_bytes(st0)
    tr0.run(st0)
    want = tr0.history
    del tr0, st0, card
    torch.cuda.empty_cache()
    mesh = mesh_mod.build_mesh([0], (1, 1), ("data", "model"))
    tr1, st1, held1 = with_state(lambda: trainer(
        host, mesh=mesh, state_shardings=train_state_pspecs(host, mesh)),
        dev)
    check_state_bytes("phase 26 (a) trainer", held1, st1)
    tr1.run(st1)
    got = tr1.history
    del tr1, st1
    torch.cuda.empty_cache()
    for key in ("loss", "grad_norm"):
        a, w = [r[key] for r in got], [r[key] for r in want]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, w))
        if len(a) != FAM_TRAIN_STEPS or rel > MESH_TRAIN_RTOL:
            fail(f"phase 26 (a) trainer: sharded {key} {a} against "
                 f"unsharded {w}")
    launched = all_counters()
    if any(launched.values()):
        fail(f"phase 26 (a) trainer: training launched a kernel: "
             f"{launched}")
    ms = [float(np.median([r["wall_s"] for r in h[1:]])) * 1e3
          for h in (got, want)]
    log(f"  (a) zamba2-1.2b trainer, bf16 over fp32 masters, "
        f"{FAM_TRAIN_LAYERS} layers, {FAM_TRAIN_BATCH} x {FAM_TRAIN_SEQ} "
        f"tokens, (1, 1) mesh over nccl: losses "
        f"{[round(r['loss'], 5) for r in got]} beside "
        f"{[round(r['loss'], 5) for r in want]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in got]} beside "
        f"{[round(r['grad_norm'], 4) for r in want]}; step {ms[0]:.2f} ms "
        f"beside {ms[1]:.2f}; state on the card {held1} bytes beside "
        f"{held0} [{smi}]")


def _fam_step(lm, batch, layout=None, params=None):
    """One fp32 AdamW step of ``lm`` over ``batch`` (on a mesh, of the
    state ``params`` a ``layout`` holds): (loss, grad norm)."""
    from repro_torch.optim import AdamWConfig, ScheduleConfig, init_opt_state
    from repro_torch.train import step as step_mod
    adamw = AdamWConfig()
    if layout is None:
        state = step_mod.init_train_state(lm, adamw)
    else:
        state = step_mod.TrainState(params, init_opt_state(params, adamw),
                                    torch.zeros((), dtype=torch.int32,
                                                device=lm.device))
    fn = step_mod.make_train_step(lm, adamw,
                                  ScheduleConfig(**MESH_TRAIN_SCHED),
                                  layout=layout)
    _, m = fn(state, batch)
    return float(m["loss"]), float(m["grad_norm"])


def fam_mesh_inputs(arch, i, dev):
    """Phase 26 (b)'s inputs for the ``i``-th family, alike on every rank
    and in the parent: (config, the full model on the CPU, prompts, the
    source frames or None, scheduler work or None, a training batch on
    the CPU).  The weights are drawn on ``dev`` from seed 0 (a CPU draw
    of the fp32 models took ~13 s a rank) and copied to the host; the
    card copy is freed before the caller measures the card."""
    from repro_torch.data import make_source
    from repro_torch.models.lm import LM
    cfg = fam_cfg(arch, FAM_MESH_LAYERS[arch])
    drawn = LM(cfg, torch.float32, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        drawn.embed.table.mul_(0.1)
    host = host_copy(drawn)
    del drawn
    torch.cuda.empty_cache()
    prompts, extra, work = fam_traffic(
        cfg, 270 + i, FAM_MESH_PROMPTS, FAM_MESH_PROMPT_LEN,
        FAM_MESH_REQUESTS)
    data = train_data_cfg(cfg, FAM_MESH_BATCH, FAM_MESH_SEQ)
    batch = {k: torch.as_tensor(np.asarray(v))
             for k, v in next(iter(make_source(data))).items()}
    return cfg, host, prompts, extra, \
        (work if cfg.family != "encdec" else None), batch


def family_mesh_refs(dev):
    """Phase 26 (b)'s unsharded references, made in this process on the
    card: each family's ``generate`` and scheduler tokens and one training
    step's (loss, grad norm)."""
    import gc
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    refs = {}
    for i, arch in enumerate(FAM_ARCHS):
        cfg, host, prompts, extra, work, batch = fam_mesh_inputs(arch, i,
                                                                 dev)
        lm = LM(cfg, torch.float32, dev, param_dtype=torch.float32)
        lm.load_state_dict(host.state_dict())
        plain = Engine(lm, ServeConfig(max_seq=128, batch_slots=4))
        ref = {"generate": plain.generate(prompts, FAM_MESH_NEW,
                                          extra_batch=extra)}
        if work is not None:
            ref["sched"] = mesh_sched(plain, work)[1]
        ref["train"] = _fam_step(lm, {k: v.to(dev) for k, v in batch.items()})
        refs[arch] = ref
        del plain, lm, host
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def _family_mesh_rank(rank, world, init_method):
    """Phase 26 (b), one rank: each family at full width and reduced
    depth, fp32, on ``cuda:0`` with every rank (gloo), on a (1, 2) mesh
    plus one spare (the full model a host copy on the CPU): ``generate``
    (and for the hybrid and xlstm the scheduler), a kill of
    ``device_ids[1]`` for the hybrid; then one training step on the
    (1, 2) mesh.  Returns the tokens, metrics and seconds; phase 26
    compares them with the unsharded runs (:func:`family_mesh_refs`)."""
    import gc
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.train import step as step_mod
    t0 = time.perf_counter()
    dev = mesh_mod.init_process("cuda:0", backend="gloo",
                                init_method=init_method, rank=rank,
                                world_size=world)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank, "runs": {},
           "secs": {"start": round(time.perf_counter() - t0, 1)}}
    scfg = ServeConfig(max_seq=128, batch_slots=4)
    for i, arch in enumerate(FAM_ARCHS):
        t = time.perf_counter()
        cfg, host, prompts, extra, work, batch = fam_mesh_inputs(arch, i,
                                                                 dev)
        batch = {k: v.to(dev) for k, v in batch.items()}
        secs = {"weights": time.perf_counter() - t}
        t = time.perf_counter()
        run = {}
        base = torch.cuda.memory_allocated(dev)
        sm = mesh_mod.make_serve_mesh((1, 2))
        eng, took, full = sharded_engine(f"phase 26 (b) rank {rank} {arch}",
                                         host, scfg, sm, dev)
        held = torch.cuda.memory_allocated(dev) - base
        g, g_launches = counted_generate(eng, prompts, FAM_MESH_NEW, extra)
        run.update(member=eng.member, generate=g,
                   generate_launches=g_launches, card_bytes=held,
                   shard_bytes=took, full_bytes=full,
                   replicated=replicated_bytes(eng, host))
        if work is not None:
            _, run["sched"], _, run["sched_launches"] = mesh_sched(eng, work)
        del eng
        gc.collect()
        secs["serve"] = time.perf_counter() - t
        if arch == "zamba2-1.2b":
            t = time.perf_counter()
            km = mesh_mod.make_serve_mesh((1, 2))
            keng, _, _ = sharded_engine(
                f"phase 26 (b) rank {rank} {arch} kill", host, scfg, km, dev)
            ksched, run["kill"], _, run["kill_launches"] = mesh_sched(
                keng, work, kill=km.device_ids[1], ft_timeout_steps=1,
                ft_confirm=1)
            run.update(kill_remeshes=ksched.metrics["remeshes"],
                       kill_ids=list(keng.serve_mesh.device_ids))
            del keng, ksched
            gc.collect()
            secs["kill"] = time.perf_counter() - t
        # one training step on (1, 2) (building a mesh is collective: the
        # spare builds it too and trains nothing)
        t = time.perf_counter()
        mesh = mesh_mod.build_mesh(range(2), (1, 2), ("data", "model"))
        if rank < 2:
            tp, dp = mesh_mod.model_axis(mesh), mesh_mod.data_axis(mesh)
            lm = LM(cfg, torch.float32, dev, param_dtype=torch.float32,
                    tp=tp, dp=dp).requires_grad_(True)
            specs = step_mod.train_state_pspecs(host, mesh).params
            layout = step_mod.StateLayout(lm, specs, mesh,
                                          dict(host.named_parameters()))
            params = layout.init_params(
                {k: v.to(dev) for k, v in host.named_parameters()})
            run["train"] = _fam_step(lm, batch, layout, params)
            del lm, layout, params
            gc.collect()
            torch.cuda.empty_cache()
        secs["train"] = time.perf_counter() - t
        out["runs"][arch] = run
        out["secs"][arch] = {k: round(v, 1) for k, v in secs.items()}
    return out


def spawn_family_ranks():
    """Phase 26 (b)'s three spawned ranks on the one card (gloo over CUDA
    tensors, staged through the host), run beside phase 23 (b)-(d):
    (every rank's results, seconds)."""
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    ranks = mesh_mod.spawn(_family_mesh_rank, FAM_MESH_RANKS, timeout_s=600)
    return ranks, time.perf_counter() - t0


def family_mesh_three_ranks(smi, refs, ranks, secs, refs_secs):
    """Phase 26 (b): every rank's results (:func:`spawn_family_ranks`)
    checked here against the unsharded runs (:func:`family_mesh_refs`).
    Returns rank 0's launches by path."""
    by_path = {}
    for r in ranks:
        rank = r["rank"]
        for arch, run in r["runs"].items():
            where = f"phase 26 (b) rank {rank} {arch}"
            want = refs[arch]
            member = rank < 2
            if run["member"] != member:
                fail(f"{where}: member {run['member']}")
            if len({tuple(t) for t in want["generate"]}) < 2:
                fail(f"{where}: the unsharded rows' tokens are all alike")
            for got, ref in (("generate", "generate"), ("sched", "sched"),
                             ("kill", "sched")):
                if got in run and run[got] != want[ref]:
                    fail(f"{where}: the sharded {got} tokens differ from "
                         f"the unsharded engine's")
            # the card holds the shard: 1/2 of the split weights plus
            # the whole-held ones, never the whole model
            if member and run["card_bytes"] > (
                    (run["full_bytes"] - 2 * run["replicated"]) / 2
                    + run["replicated"] + (32 << 20)):
                fail(f"{where}: the card holds {run['card_bytes']} bytes "
                     f"beside a sharded engine of a "
                     f"{run['full_bytes']}-byte model "
                     f"({run['replicated']} bytes whole on every rank)")
            launched = run["generate_launches"]
            if member:
                need = {"zamba2-1.2b": ("flash_attention", "ssd_scan",
                                       "argmax"),
                        "xlstm-350m": ("ssd_scan", "argmax"),
                        "seamless-m4t-medium": ("flash_attention",
                                                "argmax")}[arch]
                if any(launched[k] < 1 for k in need):
                    fail(f"{where}: generate launched {launched}")
                loss, norm = run["train"]
                wl, wn = want["train"]
                tol = FAM_TRAIN_RTOL.get(arch, FAM_TRAIN_RTOL["default"])
                if abs(loss - wl) > tol * abs(wl) or \
                        abs(norm - wn) > tol * abs(wn):
                    fail(f"{where}: (1, 2) step loss {loss}, grad norm "
                         f"{norm}; unsharded {wl}, {wn} (rtol {tol})")
            elif any(launched.values()):
                fail(f"{where}: the spare launched {launched}")
            if arch == "zamba2-1.2b" and (run["kill_remeshes"] != 1
                                          or run["kill_ids"] != [0, 2]):
                fail(f"{where}: kill: {run['kill_remeshes']} re-meshes onto "
                     f"{run['kill_ids']}")
            if rank == 0:
                by_path[f"{arch}_mesh_generate_1x2_rank0"] = launched
                if "sched_launches" in run:
                    by_path[f"{arch}_mesh_scheduler_1x2_rank0"] = \
                        run["sched_launches"]
    for arch in FAM_ARCHS:
        runs = {r["rank"]: r["runs"][arch] for r in ranks}
        r0 = runs[0]
        line = (f"  (b) {arch} fp32, {FAM_MESH_LAYERS[arch]} layers, (1, 2) "
                f"mesh + 1 spare on cuda:0 (gloo, host-staged): generate "
                + ("and scheduler " if "sched" in r0 else "")
                + f"tokens equal the unsharded engine's; rank 0 launched "
                f"{r0['generate_launches']}; card bytes by rank "
                f"{[runs[r]['card_bytes'] for r in sorted(runs)]} of a "
                f"{r0['full_bytes']}-byte model ({r0['replicated']} bytes "
                f"whole on each rank); one training step on (1, 2): loss "
                f"{r0['train'][0]:.6f} / {refs[arch]['train'][0]:.6f}, grad "
                f"norm {r0['train'][1]:.5f} / {refs[arch]['train'][1]:.5f}")
        if arch == "zamba2-1.2b":
            line += (f"; a kill of rank 1 re-meshed onto {r0['kill_ids']}, "
                     f"tokens equal; ssd_scan launches by rank "
                     f"{[runs[r]['kill_launches']['ssd_scan'] for r in sorted(runs)]}")
        log(line + f" [{smi}]")
    log(f"  (b) three ranks in {secs:.1f} s (run beside phase 23 (b)-(d), "
        f"which time nothing), the unsharded runs here in {refs_secs:.1f} "
        f"s; rank 0's seconds {ranks[0]['secs']}")
    return by_path


def per_device_families(dev, smi):
    """Phase 26 (c): kernels #5 and #1 at this slice's per-device shapes
    on a (1, 2) mesh, bf16, against their plain versions, timed beside
    their bounds (and #1 beside SDPA): #5 at zamba2-1.2b's prefill (32 of
    64 heads, P = N = 64, 8 x 512, B and C broadcast, a carried state)
    and at xlstm-350m's (2 of 4 heads, dk = dv = 512, normalize), #1 at
    zamba2's shared block (16 of 32 heads, Dh 64, causal, 8 x 512) and
    at seamless-m4t-medium's encoder (8 of 16 heads, Dh 64, not causal,
    8 x 64 frames).  Each row's launches a rank come from phase 26 (b)
    (``arch`` names its path)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_flops, ssd_scan
    from repro_torch.models.linear_scan import _chunked_linear_attention
    timer = Timer(dev)
    rng = np.random.default_rng(26)
    rows = []

    for arch, shape, normalize, kw in (
            ("zamba2-1.2b", (ZAMBA_PROMPTS, ZAMBA_PROMPT_LEN, 32, 64, 64),
             False, dict(broadcast=True)),
            ("xlstm-350m", (8, 512, 2, 512, 512), True,
             dict(positive=True))):
        args, st = ssd_inputs(rng, dev, *shape, torch.bfloat16, state=True,
                              **kw)
        y, (c, n) = ssd_scan(*args, chunk=256, normalize=normalize,
                             initial_state=st)
        yp, (cp, np_) = _chunked_linear_attention(
            *args, chunk_size=256, normalize=normalize, initial_state=st)
        torch.cuda.synchronize()
        for what, got, want in (("y", y, yp), ("C", c, cp), ("n", n, np_)):
            torch.testing.assert_close(got.float(), want.float(),
                                       **ssd_tol(want),
                                       msg=lambda m: f"{arch} {what}: {m}")
        err = (y.float() - yp.float()).abs().max().item()
        ms = timer.ms(lambda: ssd_scan(*args, chunk=256, normalize=normalize,
                                       initial_state=st))
        plain_ms = timer.ms(lambda: _chunked_linear_attention(
            *args, chunk_size=256, normalize=normalize, initial_state=st))
        b, s, h, dk = args[0].shape
        dv = args[2].shape[3]
        state = 4 * (b * h * dk * dv + b * h * dk)
        nbytes = sum(distinct(t) for t in args) + 2 * state + distinct(
            args[2])
        bms, by = bound_ms(nbytes, float(ssd_flops(b, h, s, dk, dv, 256)))
        log(f"  (c) ssd_scan bf16 per device at {arch}'s (1, 2) prefill "
            f"{shape}: {ms:.4f} ms (plain {plain_ms:.4f}), bound {bms:.5f} "
            f"ms by {by}, max|err| {err:.3g} [{smi}]")
        rows.append(dict(
            name=f"ssd_scan@{arch}/1x2", arch=arch, route="cuda",
            source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:35", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=None))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for arch, b, h, s, causal in (("zamba2-1.2b", 8, 16, 512, True),
                                  ("seamless-m4t-medium", 8, 8, 64, False)):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, h, s, 64), np.float32)).to(dev, torch.bfloat16)
            for _ in range(3))
        err = close(f"flash at {arch}'s per-device [{b},{h},{s},64] "
                    f"causal={causal}",
                    flash_attention_bhsd(q, k, v, causal=causal),
                    flash_attention_plain(q, k, v, causal=causal))
        ms = timer.ms(lambda: flash_attention_bhsd(q, k, v, causal=causal))
        plain_ms = timer.ms(lambda: flash_attention_plain(q, k, v,
                                                          causal=causal))
        library_ms = timer.ms(lambda: sdpa(q, k, v, is_causal=causal))
        bms, by = flash_bound(q, k, [s] * b, causal=causal)
        log(f"  (c) flash_attention bf16 per device at {arch}'s (1, 2) "
            f"prefill [{b},{h},{s},64] causal={causal}: {ms:.4f} ms (plain "
            f"{plain_ms:.4f}, SDPA {library_ms:.4f}), bound {bms:.5f} ms by "
            f"{by} [{smi}]")
        rows.append(dict(
            name=f"flash_attention@{arch}/1x2", arch=arch, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:46",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=library_ms))
    return rows


def dryrun_on_the_card(smi):
    """Phase 26 (d): the perfctr CLI's ``main`` in this process, ``-g
    ROOFLINE --arch zamba2-1.2b --shape decode_32k --execute`` on the
    card, after (b)'s ranks are done: the dry run's record (a meta walk
    of one rank of the 16 x 16 mesh) with status ``ok`` and the SMOKE
    config's loss timed on ``cuda``."""
    from repro_torch.launch import perfctr as perfctr_cli
    path = Path(TMP_ROOT) / "perfctr.json"
    argv = ["-g", "ROOFLINE", "--arch", "zamba2-1.2b", "--shape",
            "decode_32k", "--execute", "--cache-dir", fresh_root("dryrun"),
            "--json", str(path)]
    t0 = time.perf_counter()
    rc, out = in_process(perfctr_cli.main, argv)
    secs = time.perf_counter() - t0
    rec = json.loads(path.read_text()) if path.exists() else None
    if rc != 0 or rec is None or rec["status"] != "ok" or \
            rec["device"] != "cuda" or not rec["wall_s"] or \
            rec["events"].get("ICI_AR_COUNT", 0) < 1:
        fail(f"phase 26 (d): perfctr exited {rc}, record {rec}: "
             f"{out[-2000:]}")
    ev = rec["events"]
    log(f"  (d) perfctr -g ROOFLINE zamba2-1.2b/decode_32k/16x16 --execute "
        f"in {secs:.1f} s (in this process, nothing beside it): status ok; "
        f"one rank declares {ev['FLOPS_TOTAL']:.4g} FLOPs, "
        f"{ev['BYTES_ACCESSED']:.4g} bytes, {ev['ICI_TOTAL_BYTES']:.4g} "
        f"NVLink bytes in {ev['ICI_AR_COUNT']:.0f} all-reduces; the SMOKE "
        f"loss {rec['wall_s'] * 1e3:.2f} ms a call on the card [{smi}]")
    for line in out.splitlines():
        if line.startswith(("| T_", "| Bound", "[cache:")):
            log(f"    {line}")


#: phase 27 (a): qwen2-vl-7b at full width and 2 of its 28 layers, fp32,
#: one train step of 2 x 384 tokens (its 256 patch positions first) on a
#: (1, 2) mesh of two gloo ranks on the card, with and without sequence
#: parallelism (``act_seq -> model``)
SP_LAYERS, SP_BATCH, SP_SEQ = 2, 2, 384
#: (a): the loss and grad norm of the step with sequence parallelism
#: against the step without it and the unsharded one's, relative (phase
#: 25's fp32 bound)
SP_RTOL = 1e-5
#: (b): qwen2-0.5b at full width and depth, fp32: 8 prompts of 32 tokens
#: prefilled on the card into a dense cache of 64 positions, then 16
#: greedy tokens on a (1, 2) mesh of two gloo ranks from the cut state
SEQ_PROMPTS, SEQ_PROMPT_LEN, SEQ_NEW, SEQ_MAX = 8, 32, 16, 64
#: (c): the dry run's cells whose KV cache a rank phase 27 prints (the
#: reference's decode-state layout: the sequence over the axes the batch
#: leaves free)
SEQ_WALK_CELLS = (("qwen2-0.5b", "decode_32k"), ("zamba2-1.2b", "long_500k"))


def sp_vl_cfg():
    from repro_torch.configs.qwen2_vl_7b import CONFIG
    return dataclasses.replace(CONFIG, n_layers=SP_LAYERS)


def sp_vl_draw(dev):
    """(a)'s qwen2-vl-7b at 2 layers, fp32, drawn on ``dev`` from seed 0
    (the same weights in every process on the one card)."""
    from repro_torch.models.lm import LM
    from repro_torch.core.features import default_features
    return LM(sp_vl_cfg(), torch.float32, dev,
              features=default_features().with_(remat_policy="none"),
              param_dtype=torch.float32).init(
        torch.Generator(device=dev).manual_seed(0))


def sp_trainer(lm, **kw):
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import Trainer, TrainerConfig
    return Trainer(lm, train_data_cfg(lm.cfg, SP_BATCH, SP_SEQ),
                   TrainerConfig(total_steps=1, log_every=100,
                                 ckpt_every=0),
                   AdamWConfig(), ScheduleConfig(peak_lr=1e-3,
                                                 warmup_steps=0,
                                                 total_steps=10), **kw)


def seq_prompts(vocab):
    rng = np.random.default_rng(27)
    return torch.from_numpy(rng.integers(
        0, vocab, (SEQ_PROMPTS, SEQ_PROMPT_LEN)).astype(np.int32))


def seq_decode(lm, state, tok, steps):
    """``steps`` greedy tokens from ``tok`` [B, 1] (kernel #4 picks each):
    (tokens [B, steps], each step's logits on the host)."""
    from repro_torch.kernels.sampling import block_argmax
    toks, logits = [], []
    for _ in range(steps):
        lg, state = lm.decode_step(tok, state)
        logits.append(lg.float().cpu())
        tok = block_argmax(lg)[:, None].to(torch.int32)
        toks.append(tok)
    return torch.cat(toks, 1).cpu(), logits, state


def seq_prefill(dev):
    """(b)'s qwen2-0.5b at full width and depth, fp32, drawn on ``dev`` from
    seed 0 (the embedding x 0.1, as phase 6), its prompts prefilled on the
    card (kernel #1): (the LM, the state, the first greedy token, the
    prefill's launches)."""
    from repro_torch.kernels.sampling import block_argmax
    lm = qwen2(dev, torch.float32, embed_scale=0.1)
    state = lm.init_decode_state(SEQ_PROMPTS, SEQ_MAX)
    reset_counters()
    with torch.no_grad():
        lg, state = lm.prefill(
            {"tokens": seq_prompts(lm.cfg.vocab).to(dev)}, state)
        first = block_argmax(lg)[:, None].to(torch.int32)
    torch.cuda.synchronize(dev)
    launches = read_counters()
    expect_launches("phase 27 (b) prefill", launches,
                    {"flash_attention": lm.cfg.n_layers, "argmax": 1})
    return lm, state, first, launches


def _seq_layout_rank(rank, world, init_method, root):
    """One rank of phase 27 (a) and (b), on ``cuda:0`` over gloo: (a)
    qwen2-vl's step through ``Trainer(mesh=)`` on (1, 2) without and with
    ``act_seq -> model`` (its peak allocated bytes each); (b) qwen2-0.5b
    prefilled on the card, its state cut by ``LM.state_pspecs`` (the
    sequence over the model axis, then ``kv_shard="headdim"``'s head-dim
    cut), 16 greedy tokens from each cut, their logits written under
    ``root`` for the parent to hold to the unsharded run's."""
    import gc
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.attention import KVCache
    from repro_torch.models.layers import DEFAULT_RULES
    from repro_torch.models.lm import LM
    from repro_torch.train.step import train_state_pspecs
    dev = mesh_mod.init_process("cuda:0", backend="gloo",
                                init_method=init_method, rank=rank,
                                world_size=world)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)        # the ranks share the host's cores
    mesh = mesh_mod.build_mesh(range(2), (1, 2), ("data", "model"))
    out = {"rank": rank}
    # (a)
    lm = sp_vl_draw(dev)
    host = LM(lm.cfg, torch.float32, "cpu", features=lm.features,
              param_dtype=torch.float32)
    host.load_state_dict(lm.state_dict())
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    for tag, rules in (("tp", DEFAULT_RULES),
                       ("sp", DEFAULT_RULES.replace(act_seq=("model",)))):
        host.rules = rules
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        tr = sp_trainer(host, mesh=mesh,
                        state_shardings=train_state_pspecs(host, mesh))
        tr.run(tr.init_state())
        out[tag] = {k: float(tr.history[0][k])
                    for k in ("loss", "grad_norm")}
        out[tag].update(peak=torch.cuda.max_memory_allocated(dev) - base,
                        sp=tr.lm._sp)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    del host
    gc.collect()
    # (b)
    lm, state, first, out["prefill_launches"] = seq_prefill(dev)
    host = host_copy(lm)
    whole = {"caches": KVCache(*(t.cpu() for t in state["caches"]))}
    del lm, state
    gc.collect()
    torch.cuda.empty_cache()
    full_kv = tensor_bytes((whole["caches"].k, whole["caches"].v))
    for layout in ("seq", "headdim"):
        rules = host.state_rules(whole, mesh, dryrun._rules_for(
            None, dryrun.TrainPolicy(kv_shard=layout), "decode"))
        lm = LM(CONFIG, torch.float32, dev, rules=rules,
                tp=mesh_mod.model_axis(mesh), mesh=mesh)
        with torch.no_grad():
            own = dict(lm.named_parameters())
            for k, v in lm.shard_params(dict(host.named_parameters()),
                                        mesh).items():
                own[k].copy_(v)
            local = lm.cut_state(whole)
            local = {"caches": KVCache(*(t.to(dev) for t in
                                         local["caches"]))}
            kv = tensor_bytes((local["caches"].k, local["caches"].v))
            reset_counters()
            toks, logits, _ = seq_decode(lm, local, first, SEQ_NEW)
            torch.cuda.synchronize(dev)
        path = str(Path(root) / f"rank{rank}-{layout}.pt")
        torch.save(torch.stack(logits), path)
        out[layout] = dict(tokens=toks.tolist(), logits=path, kv_bytes=kv,
                           full_kv_bytes=full_kv,
                           kv_shape=tuple(local["caches"].k.shape),
                           launches=read_counters())
        del lm, local
        gc.collect()
        torch.cuda.empty_cache()
    return out


def spawn_seq_layout_ranks():
    """Phase 27's two ranks, started beside phase 23 (b)-(d), which time
    nothing; joined and checked in phase 27."""
    from repro_torch.launch import mesh as mesh_mod
    root = fresh_root("seq-layout")
    return mesh_mod.spawn(_seq_layout_rank, 2, (root,), timeout_s=600)


def seq_layout_refs(dev, smi):
    """Phase 27's unsharded runs on the card: (a) qwen2-vl's train step;
    (b) qwen2-0.5b's prefill (kernel #1), then 16 greedy tokens and their
    logits from the unsharded LM, and ``Engine.generate``'s tokens."""
    from repro_torch.serve.engine import Engine, ServeConfig
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    tr = sp_trainer(sp_vl_draw(dev))
    tr.run(tr.init_state())
    sp_ref = {k: float(tr.history[0][k]) for k in ("loss", "grad_norm")}
    sp_ref["peak"] = torch.cuda.max_memory_allocated(dev) - base
    del tr
    torch.cuda.empty_cache()
    lm, state, first, launches = seq_prefill(dev)
    with torch.no_grad():
        toks, logits, _ = seq_decode(lm, state, first, SEQ_NEW)
    eng = Engine(lm, ServeConfig(max_seq=SEQ_MAX, batch_slots=SEQ_PROMPTS),
                 device=dev)
    gen = eng.generate(seq_prompts(lm.cfg.vocab).tolist(), SEQ_NEW + 1)
    want = torch.cat([first.cpu(), toks[:, :-1]], 1)
    if [g[:SEQ_NEW] for g in gen] != want.tolist():
        fail(f"phase 27 (b): the unsharded LM's greedy tokens "
             f"{want.tolist()} differ from Engine.generate's {gen}")
    del eng, lm, state
    torch.cuda.empty_cache()
    log(f"  unsharded on the card: (a) qwen2-vl-7b at {SP_LAYERS} layers, "
        f"fp32, one step of {SP_BATCH} x {SP_SEQ} tokens: loss "
        f"{sp_ref['loss']:.6f}, grad norm {sp_ref['grad_norm']:.6f}, peak "
        f"allocated {sp_ref['peak']} bytes; (b) qwen2-0.5b fp32 prefill of "
        f"{SEQ_PROMPTS} x {SEQ_PROMPT_LEN} (#1 {launches['flash_attention']}"
        f" launches), {SEQ_NEW} greedy tokens equal Engine.generate's "
        f"[{smi}]")
    return sp_ref, toks, logits, launches


def seq_layouts_on_the_card(dev, smi, ranks):
    """Phase 27: (a) and (b)'s unsharded runs, then the two ranks' results
    (:func:`spawn_seq_layout_ranks`, run beside phase 23) checked against
    them; (c) the dry run's :data:`SEQ_WALK_CELLS` walked in this
    process."""
    from repro_torch.launch import dryrun
    sp, toks, logits, prefill_launches = seq_layout_refs(dev, smi)
    want = torch.stack(logits)
    for r in ranks:
        for tag in ("tp", "sp"):
            gaps = {k: abs(r[tag][k] - sp[k]) / abs(sp[k])
                    for k in ("loss", "grad_norm")}
            if max(gaps.values()) > SP_RTOL or r[tag]["sp"] != (tag == "sp"):
                fail(f"phase 27 (a) rank {r['rank']} {tag}: {r[tag]} "
                     f"against the unsharded {sp}: gaps {gaps}")
        log(f"  (a) rank {r['rank']}: loss {r['sp']['loss']:.6f}, grad norm "
            f"{r['sp']['grad_norm']:.6f} with sequence parallelism, "
            f"{r['tp']['loss']:.6f} / {r['tp']['grad_norm']:.6f} without, "
            f"within {SP_RTOL} of the unsharded step; peak allocated "
            f"{r['sp']['peak']} bytes with, {r['tp']['peak']} without "
            f"(the unsharded step {sp['peak']}) [{smi}]")
        expect_launches(f"phase 27 (b) rank {r['rank']} prefill",
                        r["prefill_launches"], prefill_launches)
        for layout in ("seq", "headdim"):
            b = r[layout]
            got = torch.load(b["logits"], weights_only=True)
            worst = max(float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(got, want))
            if b["tokens"] != toks.tolist() or worst > LOGITS_REL_TOL or \
                    2 * b["kv_bytes"] != b["full_kv_bytes"] or \
                    b["launches"]["argmax"] != SEQ_NEW:
                fail(f"phase 27 (b) rank {r['rank']} {layout}: tokens "
                     f"{b['tokens']} against {toks.tolist()}, logits "
                     f"within {worst} of max|logit|, {b}")
            log(f"  (b) rank {r['rank']} {layout}: {SEQ_NEW} greedy tokens "
                f"equal the unsharded engine's, logits within {worst:.3g} "
                f"of max|logit|; KV {b['kv_shape']} = {b['kv_bytes']} "
                f"bytes, half of {b['full_kv_bytes']}")
    for arch, shape in SEQ_WALK_CELLS:
        rec = dryrun.run_cell(arch, shape, False, verbose=False)
        if rec["status"] != "ok":
            fail(f"phase 27 (c) {arch}/{shape}: {rec}")
        w = rec["walk"]
        log(f"  (c) {rec['cell']}: KV cache {w['kv_cache_shape']} = "
            f"{w['kv_cache_bytes']} bytes a rank, the sequence over "
            f"{w['cache_seq']} (the weights' model axis walked at "
            f"{w['mesh_walked']['model']})")
    r0 = ranks[0]
    return {"seq_layout_prefill": prefill_launches,
            "seq_layout_decode_rank0": r0["seq"]["launches"],
            "headdim_decode_rank0": r0["headdim"]["launches"]}


class PhaseClock:
    """Logs each phase's title when it starts and its seconds when the
    next one starts (or at :meth:`stop`)."""

    def __init__(self):
        self.title, self.t0 = None, 0.0

    def __call__(self, title: str) -> None:
        self.stop()
        log(title)
        self.title, self.t0 = title.split("]")[0] + "]", time.perf_counter()

    def stop(self) -> None:
        if self.title is not None:
            log(f"  {self.title} in {time.perf_counter() - self.t0:.1f} s")
        self.title = None


def main() -> int:
    four_cards = sys.argv[1:] == ["--train-mesh-four-cards"]
    if sys.argv[1:] and not four_cards:
        print("usage: chip_smoke.py [--train-mesh-four-cards]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import os
    import shutil
    import tempfile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global TMP_ROOT
    TMP_ROOT = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        # phases 1-17 read and write tune records in a fresh, empty root,
        # so no earlier tune record can change their tiles
        os.environ["REPRO_CACHE_DIR"] = fresh_root("phases-1-17")
        return train_mesh_four_cards() if four_cards else run_phases()
    finally:
        shutil.rmtree(TMP_ROOT, ignore_errors=True)


def run_phases() -> int:
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    phase = PhaseClock()

    phase("[1/27] probe")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"  device {torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}, count "
        f"{torch.cuda.device_count()}")
    smi = gpu_name_and_limit()
    log(f"  nvidia-smi: {smi}")
    from repro_torch.core import hwinfo
    chip = hwinfo.current_chip(dev)
    bad = hwinfo.check_device(chip, torch.cuda.get_device_properties(dev))
    if bad:
        fail(f"data sheet {chip.name} disagrees with the device: {bad}")
    log(f"  data sheet {chip.name}: {chip.sm_count} SMs, L2 "
        f"{chip.l2_bytes} B, HBM {chip.hbm_bw / 1e12} TB/s, agrees with "
        f"the device's properties")

    phase("[2/27] build")
    secs = _build.build_all()
    log(f"  built {list(_build.SOURCES)} in {secs:.2f} s into "
        f"{_build.build_dir()}")

    phase("[3/27] kernels vs plain versions")
    timer = Timer(dev)
    from repro_torch.configs.qwen2_0_5b import CONFIG
    rows = [check_flash(dev, timer), check_paged(dev, timer),
            check_paged_q8(dev, timer),
            check_argmax(dev, timer, CONFIG.vocab), check_ssd(dev, timer)]
    train_row = check_flash_train(dev)
    for r in rows + [train_row]:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']})")
    del timer

    phase("[4/27] main path 1: qwen2-0.5b Engine.generate, paged, greedy")
    lm, gen_launches = main_path(dev)

    phase("[5/27] main path 2: qwen2-0.5b BatchScheduler, int8 pages, "
          "prefix cache")
    sched_launches = scheduler_path(dev, lm)
    del lm
    torch.cuda.empty_cache()

    phase("[6/27] fp32 token check: card paged / card dense / cpu paged")
    token_check(dev)

    phase("[7/27] fp32 scheduler token check: card scheduler / card generate "
          "/ cpu scheduler; int8 logits card vs cpu")
    sched_token_check(dev)

    phase("[8/27] main path 3: zamba2-1.2b Engine.generate, dense KV, greedy")
    lm, zamba_launches = zamba_generate_path(dev)

    phase("[9/27] main path 4: zamba2-1.2b BatchScheduler, dense KV")
    zamba_scheduler_path(lm)
    del lm
    torch.cuda.empty_cache()
    # each kernel's launches on the path that carries it
    for r in rows:
        r["launches"] = {"paged_decode_q8": sched_launches,
                         "ssd_scan": zamba_launches}.get(
                             r["name"], gen_launches)[r["name"]]

    phase("[10/27] fp32 zamba2 token check: card / cpu, 7 layers")
    zamba_token_check(dev)

    phase("[11/27] case-study kernels vs plain versions: STREAM triad, "
          "Jacobi-7")
    timer = Timer(dev)
    case_rows = [check_triad(dev, timer), check_jacobi(dev, timer)]
    del timer
    for r in case_rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']})")

    phase("[12/27] main path 5: the case studies through PerfCtr marker "
          "regions (HBM, ROOFLINE), the bandwidth map")
    case_launches = perfctr_path(dev)
    for r in case_rows:
        r["launches"] = case_launches[r["name"]]
    rows += case_rows

    phase("[13/27] main path 6: qwen2-0.5b sampled Engine.generate (top_k, "
          "top_p), paged")
    # the embedding scaled by 0.1 (as in phase 6): unscaled, the random
    # model echoes its last token with a near one-hot distribution, so
    # neither the draws nor the draft's rejections would matter
    lm = qwen2(dev, torch.bfloat16, embed_scale=0.1)
    sampled_launches = sampled_path(dev, lm)

    phase("[14/27] main path 7: speculative decoding, K = 4, 2-layer matched "
          "draft: fp32 parity, bf16 generate, mixed BatchScheduler")
    spec_launches, spec_sched_launches = spec_path(dev, lm)

    phase("[15/27] main path 8: serving snapshots and chaos: (a) fp32 "
          "kill / restore parity, (b) qwen2-0.5b int8 scheduler under the "
          "smoke schedule, killed and restored")
    snap_launches = snapshot_parity(dev, smi)
    chaos_launches = chaos_path(dev, lm, smi)
    del lm
    torch.cuda.empty_cache()

    phase("[16/27] main path 9: the serving benches (serve, paged decode, "
          "flash prefill, spec) at their default sizes, serve and spec at "
          "qwen2-0.5b full width")
    bench_launches = serving_benches(dev, smi)
    torch.cuda.empty_cache()

    phase("[17/27] main path 10: the tool layer (topology, pin, features) "
          "and the kernel registry on the serving path: qwen2-0.5b fp32, the "
          "default kernels against the torch pins three ways")
    topology_check(dev, smi)
    reg_launches, reg_q8_launches = registry_serving_path(dev, smi)
    registry_families_check(dev, smi)
    tool_benches(smi)
    torch.cuda.empty_cache()

    phase("[18/27] main path 11: the registry's tune half: (a) every tunable "
          "family's card cell swept cold, each candidate held to its plain "
          "version; (b) warm in a fresh process; (c) the launcher's --tune "
          "at qwen2-0.5b full width, cold then warm; (d) fp32 greedy on the "
          "tuned tiles against the default tiles")
    root, cold, tune_launches = tune_suite_cold(smi)
    tune_suite_warm(root, cold, smi)
    tune_launcher(smi)
    tuned_gen_launches = tuned_generate(dev, smi)
    torch.cuda.empty_cache()

    phase("[19/27] main path 12: xlstm-350m at full width and depth, dense "
          "state: (a) Engine.generate, (b) BatchScheduler, (c) fp32 tokens "
          "card vs cpu at 4 layers")
    xlstm_gen_launches, xlstm_sched_launches = xlstm_paths(dev)
    torch.cuda.empty_cache()
    xlstm_token_check(dev)

    phase("[20/27] main path 13: the other dense configs, pages of 16: "
          "qwen1.5-0.5b and stablelm-3b (LayerNorm, Dh 80) at full depth, "
          "generate and the int8 scheduler; mistral-large-123b at 2 of 88 "
          "layers (G 12); fp32 stablelm tokens card vs cpu at 2 layers")
    dense_launches = dense_config_paths(dev)
    stablelm_token_check(dev)
    perf_report_and_example(smi)
    torch.cuda.empty_cache()

    phase("[21/27] main path 14: the moe family, pages of 16: (a) qwen2-moe-"
          "a2.7b at full width and depth, generate, one host sync, a decode "
          "step with no implicit sync; (b) its int8 scheduler with the prefix "
          "cache; (c) qwen3-moe-235b-a22b at 2 of 94 layers (G 16); (d) fp32 "
          "qwen2-moe tokens card vs cpu at 2 layers")
    moe_launches = moe_paths(dev)
    torch.cuda.empty_cache()
    moe_token_check(dev)

    phase("[22/27] main path 15: the vlm and encdec families: (a) qwen2-vl-"
          "7b at full width and depth with patch embeddings, generate, then "
          "its int8 scheduler with the prefix cache; (b) seamless-m4t-medium "
          "at 12 + 12 layers with source embeddings, generate; (c) fp32 "
          "tokens card vs cpu: qwen2-vl at 2 layers, seamless at full depth")
    vlm_launches = vlm_encdec_paths(dev)
    vlm_encdec_token_check(dev)
    torch.cuda.empty_cache()

    phase("[23/27] main path 16: training: (a) qwen2-0.5b at full width and "
          "depth, bf16 over fp32 masters, 8 x 512 tokens a step, 8 steps "
          "through Trainer, 2 with accum_steps=2, resumed from step 4; (b) "
          "fp32 card vs cpu, 2 layers, 3 steps; (c) one fp32 step of each "
          "family, card vs cpu; (d) serve --ckpt-dir; phase 26 (b)'s and "
          "phase 27's ranks beside (b)-(d)")
    served, ckpt, train_fig, plain_train = train_main_path(dev, smi)
    train_row["launches"] = train_fig["flash_train_launches_per_step"]
    train_row["launches_by_path"] = {"train_step_2x": {
        k: 2 * n for k, n in train_row["launches"].items()}}
    serving = serve_checkpoint(ckpt)
    # phase 26 (b)'s ranks run beside (b)-(d), which time nothing, and are
    # joined before phase 24; phase 26 checks their results
    fam_ranks = Background(spawn_family_ranks)
    seq_ranks = Background(spawn_seq_layout_ranks)
    try:
        train_card_cpu(dev)
        train_serve_launches = check_served_checkpoint(dev, served, ckpt,
                                                       serving, smi)
    finally:
        if serving[0].poll() is None:
            serving[0].kill()
            serving[0].wait()
    fam_ranks = fam_ranks.result()
    seq_ranks = seq_ranks.result()
    del served
    torch.cuda.empty_cache()

    phase("[24/27] main path 17: sharded serving and its fault tolerance: "
          "(a) qwen2-0.5b at full width and depth behind BatchScheduler "
          "through a (1, 1) ServeMesh over NCCL, a heartbeat flap absorbed; "
          "(b) 3 ranks on the card, a (1, 2) mesh plus a spare, fp32 and "
          "int8 pages, a killed rank re-meshed onto the spare; (c) #2 and "
          "#3 at the per-device shape")
    mesh_launches = mesh_one_rank(dev, smi)
    mesh_three_ranks(smi)
    per_device_paged(dev, smi)
    torch.cuda.empty_cache()

    phase("[25/27] main path 18: training on a mesh and the moe family on "
          "a mesh: (a) qwen2-0.5b at full width and depth through "
          "Trainer(mesh=, state_shardings=) on a (1, 1) mesh over NCCL "
          "beside the unsharded Trainer; (b) 4 ranks on the card, "
          "qwen2-0.5b at 2 layers fp32 on (2, 2), (2, 1) with 2 "
          "microbatches and (1, 2) with int8 error feedback, the (2, 2) "
          "checkpoint resumed on (1, 2); (c) qwen2-moe-a2.7b at 2 layers "
          "fp32 on a (1, 2) mesh of 2 ranks, fp32 and int8 pages; (d) #1, "
          "#2 and #3 at qwen2-moe's per-device shapes")
    # (a) holds every counter at 0 over the training runs
    for f in (*counters().values(), *case_counters().values()):
        f.launches = 0
    mesh_train_one_rank(dev, smi, plain_train)
    del plain_train
    # (b) and (c) share the card: their ranks start and run side by side
    _, moe_mesh_launches = concurrently(
        lambda: mesh_train_four_ranks(dev, smi),
        lambda: moe_mesh_two_ranks(smi))
    per_device_flash(dev, smi)
    per_device_paged(dev, smi, kvh=8, g=1, dh=128, where="(d)",
                     what="qwen2-moe-a2.7b's per-device decode")
    torch.cuda.empty_cache()

    phase("[26/27] main path 19: the hybrid, xlstm and encdec families on "
          "a mesh, and the dry run: (a) zamba2-1.2b and xlstm-350m at full "
          "width and depth, seamless-m4t-medium at 12 + 12 layers, through "
          "a (1, 1) ServeMesh over NCCL beside the unsharded engine, and "
          "zamba2's Trainer(mesh=) on (1, 1); (b) 3 ranks on the card, each "
          "family fp32 on a (1, 2) mesh plus a spare (generate, scheduler, "
          "a hybrid kill re-meshed, one training step); (c) #5 and #1 at "
          "the families' per-device shapes; (d) perfctr over the dry run's "
          "zamba2 decode_32k cell, --execute on the card")
    fam_launches = family_mesh_one_rank(dev, smi)
    fam_rows = per_device_families(dev, smi)
    # (b): the ranks ran in phase 23; the unsharded runs here; (d) alone
    t0 = time.perf_counter()
    fam_refs = family_mesh_refs(dev)
    refs_secs = time.perf_counter() - t0
    fam_mesh_launches = family_mesh_three_ranks(smi, fam_refs, *fam_ranks,
                                                refs_secs)
    torch.cuda.empty_cache()
    dryrun_on_the_card(smi)
    for r in fam_rows:
        kernel, arch = r["name"].split("@")[0], r.pop("arch")
        r["launches"] = fam_mesh_launches[
            f"{arch}_mesh_generate_1x2_rank0"][kernel]
        r["launches_by_path"] = {
            p: c[kernel] for p, c in fam_mesh_launches.items()
            if p.startswith(arch) and c.get(kernel)}
        log(f"  {r['name']}: launches a rank {r['launches']} (phase 26 "
            f"(b), rank 0's generate)")
    by_path = {"generate": gen_launches, "scheduler_int8": sched_launches,
               "zamba2_generate": zamba_launches,
               "sampled_generate": sampled_launches,
               "spec_generate": spec_launches,
               "spec_scheduler": spec_sched_launches,
               "snapshot_restore_fp32": snap_launches,
               "chaos_restore_int8": chaos_launches, **bench_launches,
               "registry_generate_fp32": reg_launches,
               "registry_scheduler_int8": reg_q8_launches,
               "tune_suite_card": tune_launches,
               "tuned_generate_fp32": tuned_gen_launches,
               "xlstm_generate": xlstm_gen_launches,
               "xlstm_scheduler": xlstm_sched_launches, **dense_launches,
               **moe_launches, **vlm_launches,
               "train_serve_ckpt": train_serve_launches,
               "mesh_scheduler_1x1": mesh_launches,
               "moe_mesh_scheduler_int8_rank0": moe_mesh_launches,
               **fam_launches, **fam_mesh_launches}
    for r in rows:
        r["launches_by_path"] = (
            {"perfctr": r["launches"],
             "tune_suite_card": tune_launches[r["name"]]}
            if r in case_rows else
            {p: c[r["name"]] for p, c in by_path.items()
             if c.get(r["name"])})
    rows += fam_rows

    phase("[27/27] main path 20: the reference's decode-state layouts and "
          "sequence parallelism: (a) qwen2-vl-7b at full width and 2 "
          "layers, fp32, one train step on a (1, 2) mesh of two gloo ranks "
          "with and without act_seq -> model, beside the unsharded step; "
          "(b) qwen2-0.5b at full width and depth, fp32, prefilled on the "
          "card, its cache cut into two sequence slices by "
          "LM.state_pspecs, then by kv_shard=headdim, 16 greedy tokens on "
          "the two ranks; (c) the dry run's qwen2-0.5b/decode_32k and "
          "zamba2-1.2b/long_500k cells walked here")
    seq_launches = seq_layouts_on_the_card(dev, smi, seq_ranks)
    torch.cuda.empty_cache()
    for r in rows:
        r["launches_by_path"].update(
            {p: c[r["name"]] for p, c in seq_launches.items()
             if c.get(r["name"])})
    rows.append(train_row)

    phase.stop()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
    print(gpu_name_and_limit(), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
