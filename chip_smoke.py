"""Smoke run of the PyTorch port on one NVIDIA H100: builds the CUDA
kernels, holds each against its plain PyTorch version, runs the paper's
kernel estimates through the port's library, serves full-width
qwen3-4b through the port's engine with full-KV pages (bf16, int8,
prefix cache), with SRF attention, and with seeded SRF attention
(per-request embed seeds, greedy and sampled requests in one batch),
through the legacy per-slot engine beside the paged one, through the
request router with fault-tolerant serving and a chaos fault on one of
two replicas, and through the serve CLI with kernel timing and a Chrome
trace, serves full-width mamba2-2.7b (SSD) and hymba-1.5b (hybrid),
the three other dense configs, moonshot-v1-16b-a3b (MoE),
deepseek-v2-lite-16b (MLA with MoE), qwen2-vl-2b (vision) and
seamless-m4t-large-v2 (enc-dec), serves head-sharded over a mesh of the
card repeated (``Engine(mesh=...)`` at TP 2, the router over sharded
replicas), then trains full-width qwen3-4b with SRF and with full
attention, qwen2-vl-2b with both, mamba2-2.7b, hymba-1.5b,
seamless-m4t-large-v2, and moonshot-v1-16b-a3b and deepseek-v2-lite-16b
at 8 layers, and qwen2-vl-2b with the compressed cross-pod gradient
mean (``Trainer(mesh=...)``), and ends with the dry run: its
smokes and the five ``examples/torch_*.py`` on the card, the 40-cell
cost analysis on meta, and the analysis held to a real step.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
result line):

1. Build: compile ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
   source, started together) and print the build time.
2. Kernels against their plain versions on the card.
   * spinner at the serving shapes (circulant n=128, m=256, G=8 kv heads;
     decode query B=32, decode key B=8, prefill query B=512, prefill key
     B=128; bf16 and f32), at the library shape (G=1, B=8192, n=1024,
     m=4096, f32 and bf16: timed beside ``z @ A.T`` on the materialized A
     in the same dtype, for orientation) and a sweep over every kernel
     kind x epilogue x grouped/ungrouped with ragged B and m; both spinner
     kernels run on the tensor cores (``csrc/window_mma.cuh``, shared
     with circulant_project); srf_decode at (B=8, H=32,
     m=256, dv=128) and two ragged shapes. Tolerance: max|kernel - plain|
     <= 1e-4 * max|plain| in f32, 2e-2 * max|plain| in bf16; the serving
     shapes' ``exp`` outputs (the keys' features, spanning decades)
     element by element: |kernel - plain| <= rtol (|plain| +
     mean|plain|), rtol 1e-4 in f32, 2e-2 in bf16 (``check_exp``).
   * paged_gather (bf16, f32, int8 pools; one pool, and two pools in
     one launch through paged_gather_kv) and paged_gather_dequant (int8
     -> bf16, f32; one pool, and a layer's K and V in one launch through
     paged_gather_dequant_kv) at the full-width decode shape (R=8, M=16,
     P=16, D=1024), a prefill-sized shape (R=32, M=64) and ragged shapes
     (row bytes not a multiple of 16, ids out of range), int32 and int64
     tables; the copy gather also on a pair of rows of 512 and 64 (MLA's
     latents), a pair of pages of 16 and 4 rows, and pairs with one pool
     8 bytes off 16-byte alignment (narrower units); the dequant kernel also on pool views off 16-byte
     alignment (its vector and scalar paths), a page of 64 rows (larger
     than a ring stage) and rows of 32768 int8 (cut within the row):
     bit-equal (torch.equal). Times: each gather for one pool, and for K
     and V in one launch beside two single-pool launches; the copy gather
     also beside two ``pool[tables]`` calls.
   * the seeded spinner at the seeded serving shapes (circulant n=128,
     m=256, G = 8 kv heads x 8 requests = 64 groups; decode query B=4,
     decode key B=1, prefill query B=64, prefill key B=16; bf16 and f32),
     the library shape as above, and a sweep over every kernel kind x
     epilogue x grouped/ungrouped
     with ragged B and m: held to its plain version (the tolerance
     above) and to the materialized spinner kernel run on
     ``seedgen.grouped_params`` computed on the card (bit-equal, or
     within the tolerance: bf16 generators are rounded for the
     materialized kernel); distinct seeds must give distinct outputs.
     The plain stateless sampler is timed at the full-width decode
     shape (8 rows x 151936 logits, mixed greedy and sampled rows):
     device time under ``torch.profiler``, and time a call by events.
   * fwht at the reference test shapes, (8192, 1024) and (4096, 16384),
     f32 and bf16, normalized and not; circulant_project at the five
     reference test shapes and g (4, 1024), x (8192, 1024), m = 4096,
     every epilogue, f32 and bf16: within ``tests/test_kernels.py``'s
     ``_tol`` of the plain version (exp in log space; heaviside where
     |y| > 1e-3, the flips below counted). Then the public ops alone at
     the real shapes, their launches counted (0 before, read after).
     Times at (8192, 1024) f32 beside ``x @ H_n``, and at the real
     circulant shape, f32 (3xTF32 on the tensor cores) and bf16, beside
     ``x @ A.T`` in the same dtype, each with its bytes bound.
   * both spinner kernels at the training shapes (G = 8 kv heads, n =
     128, m = 256, bf16; query B = 2048 rows with ``identity``, key B =
     512 with ``exp``): against the plain version, timed beside it and
     its bound, and the plain backward that training runs after each
     forward (the VJP with respect to g, x, d0, d1; seeded: x) timed.
     The key's ``exp`` features are held element by element
     (``check_exp``), not against their largest value. The materialized
     spinner the same way at the families' training shapes
     (``_family_shapes``: hymba G=5 kv heads, n=64, query B=40960, key
     B=8192; seamless G=16, n=64, B=4096 (encoder and decoder); moonshot
     G=16, n=128, B=8192; deepseek's MLA + SRF G=16 heads, n=192 without
     HD, B=8192).
   * kernels 1, 2, 4 and 5 at hymba-1.5b's shapes
     (``phase_hymba_kernels``): the spinner at n=64, m=256, G=5 kv heads
     (decode query B=40, key B=8; bf16), srf_decode at (B=8, H=25,
     m=256, dv=64), paged_gather_kv on bf16 rows of D=5*64=320 and
     paged_gather_dequant_kv on int8 rows of 320 (R=8, M=16, P=16,
     N=257, 32 layer pools cycled; bit-equal), timed beside their plain
     versions and bounds.
   * kernels 1, 2, 4 and 5 at the MoE and MLA configs' shapes
     (``phase_moe_mla_kernels``): the spinner at deepseek's MLA-SRF
     shape (n=192 without HD, m=256, G=16 query heads; decode query and
     key B=8, prefill query and key B=128; bf16 and f32; the route
     ``ops.kernel_takes`` picks must be the kernel) and moonshot's (n=128,
     HD, G=16, B=8, bf16); srf_decode at (B=8, H=16, m=256, dv=128);
     paged_gather_kv on bf16 rows of D=512 and D=64 (deepseek's latents c
     and kpe in one launch, 27 layer pools) and on K and V of D=2048
     (moonshot, 48 pools), bit-equal to the plain version, the one-pool
     entry also to ``pool[tables]`` and on pool views 2 and 8 bytes off
     16-byte alignment; paged_gather_dequant_kv on int8
     rows of 2048; timed beside their plain versions and bounds.
   * kernels 1, 2, 4 and 5 at the vision and enc-dec configs' shapes
     (``phase_vlm_encdec_kernels``): the spinner at qwen2-vl's decode
     query and key (n=128, HD, G=2 kv heads, B=48 and 8), seamless's
     (n=64, HD, G=16, B=8) and its encoder's (B=1024 frames a request);
     srf_decode at (B=8, H=12, dv=128) and (B=8, H=16, dv=64);
     paged_gather_kv on K and V of D=256 (28 pools) and D=1024 (24 pools)
     and the one-pool paged_gather on the encoder-memory pool (a 2 MiB page of 1024 x 1024 bf16 a
     slot, R=8, M=1), bit-equal to the plain version and to
     ``pool[tables]``; paged_gather_dequant_kv on int8 rows of 1024.
   * kernels 1-5 at the shapes one shard of qwen3-4b served at TP 2
     launches (``phase_mesh_kernels``): the spinner at G=4 kv heads (query
     B=32, key B=8), the seeded spinner at the shard's seeds (G=32, query
     B=4, key B=1), srf_decode at (B=8, H=16, dv=128), paged_gather_kv on
     K and V of D=4*128=512 (qwen3-4b, 36 pools; seamless's 8*64, 24 pools)
     and paged_gather_dequant_kv on int8 rows of 512; the gathers
     bit-equal and timed beside ``pool[tables]``.
   Times: CUDA events over back-to-back launches queued behind a device
   sleep, median of 5 repeats (3 for the circulant); the gathers cycle
   through 36 layer pools, as a decode step does, so pages come from HBM.
3. The kernel-estimation library: ``estimators.estimate`` of 8192 pairs
   of unit vectors (n = 1024, m = 4096 and 256; ``spinner.single`` and
   ``spinner.hd_chain`` depth 3, circulant; f identity, heaviside,
   sign, relu, trig, softmax), the card route against the plain route
   on the same params, the error falling with m, the spinner launched
   and never its plain version; ``mc_error`` for the sweep of
   ``examples/kernel_approx.py``.
4. Serve full-width qwen3-4b (36 layers, d_model 2560, 32 q / 8 kv heads
   of 128, bf16), random weights from a seeded torch.Generator, 8 greedy
   requests (prompt 128, 32 new tokens, 8 slots, max_len 256): with full
   KV on bf16 pages, on int8 pages, and with the prefix cache (prompts
   sharing their first 96 tokens; a cold wave, then the same prompts
   warm, in one engine); then with SRF attention. Every count is set to
   0 just before each run and read just after; a run fails unless every
   request finishes with 32 tokens, every sampled logit row is finite,
   and its kernels launched as the path needs (full KV: paged_gather_kv
   exactly 36 per step on bf16 pages, or paged_gather_dequant_kv exactly
   36 per step on int8 pages, a layer's K and V in one launch; the other
   gathers never; SRF: the spinner at least 72 per step and srf_decode
   36 per decode step). The prefix run must serve prompt tokens from the
   cache and leak no page. Then seeded SRF (``SRFAttnConfig(seeded=True)``,
   one seed per layer and kv head): embed_seed 0 for uids 0-3 and a
   distinct non-zero seed for uids 4-7, odd uids sampled (temperature
   0.8, top_k 40, top_p 0.95), even uids greedy; the seeded spinner at
   least 72 per step, srf_decode exactly 36 per decode step, the
   materialized spinner and the seeded plain route never. Both SRF
   runs publish exactly one live quality sample (``srf_quality`` gauge,
   stats finite and under ``DRIFT_TOL``, no ``quality_drift``). Reduced
   configs (SRF; full KV with bf16 and with int8 pages; seeded SRF with
   mixed embed seeds and mixed greedy / sampled requests) are also
   served on the card and on the CPU (plain versions); their tokens
   must be equal.
   The legacy per-slot engine (``serving/legacy.py``): reduced qwen3-4b
   (f32, 2 layers) with full KV, an int8 KV cache, SRF and seeded SRF,
   8 mixed-length requests greedy and sampled (temperature 0.8): card
   tokens equal CPU tokens, and the paged engine's card tokens equal
   the legacy engine's (int8: greedy; the two quantize per token and
   per token and head). Then full-width qwen3-4b (bf16) at
   ``CUT_LAYERS`` (12) of its 36 layers, 8 greedy
   requests (prompt 128, 16 new, 4 slots, max_len 256), full KV and
   then SRF, through the legacy engine and the paged engine on the same
   params: every request finishes with 16 tokens, no non-finite logit
   row; legacy full KV launches no kernel, legacy SRF the spinner at
   least 2 per layer and model call and its plain route never; the
   first-token logits of the two engines agree within
   ``FIRST_LOGIT_TOL`` of each row's largest |logit|, and each within
   ``F32_ANCHOR_TOL`` of an f32 copy's prefill; tok/s, TTFT p50 and the
   share of equal generated tokens printed.
   The router and fault-tolerant serving (``serving/mesh/router.py``,
   ``serving/ft.py``, the test-only ``serving/chaos.py``): reduced
   qwen3-4b (f32, 2 layers), 8 greedy requests of 4-19 prompt tokens and
   10 new, 2 replicas of 2 slots (max_len 64), ``RouterConfig(migrate=
   False)``, ``FTConfig(grace_steps=2, stuck_rounds=3)``, replica 1
   faulted at its step 4, on step clocks that advance 5 ms a read: full
   KV, int8 pages and SRF under raise, hang, reject and oom, on the card
   and on the CPU. Each cell: tokens equal to the undisturbed single
   engine's on the card and to the CPU route's, router counters equal to
   the CPU run's, every request done once, two more requests equal after
   ``heal()`` and ``revive(1)``, no page or slot leaked, the path's
   kernels launched and no plain route. A sampled cell (temperature 0.9,
   top_k 50, top_p 0.95, both replicas at seed 0): rescued ==
   undisturbed bit for bit; a preempted sequence migrated with its
   snapshot between like replicas: tokens equal to the unmigrated run,
   card == CPU. Then full width at ``CUT_LAYERS`` (12) of the 36
   layers (the params shared by every engine), 16
   greedy requests of 128 + 32 tokens (max_len 256): (a) one engine of
   8 slots; (b) ``launch.serve.router`` over 2 replicas of 4 slots with
   ``FTConfig()`` on wall clocks and no migration, no fault; (c) the
   same with replica 1 faulted at its step 12 (full KV: raise, hang,
   reject, oom; SRF: raise, oom). Each run: every request done once with
   32 tokens and finite logit rows, kernels as the path needs summed
   over the replicas' steps (full KV paged_gather_kv exactly 1 a layer a
   step; SRF the spinner at least 2 a layer a step and srf_decode exactly 36 a decode
   step; nothing else, no plain route), no leak after ``heal()`` and
   ``revive(1)``; (b) quarantines nothing; each (c) quarantines replica
   1 once, fails nothing, rescues or replays a request, and every token
   emitted before the quarantine equals (b)'s. tok/s, TTFT p50, the
   counters, the rounds and seconds from the kill to the last moved
   request's end, and the share of tokens equal to (a) and (b) printed.
   Then ``launch.serve.main`` in process with ``--replicas 2 --ft
   --chaos raise@12:1 --metrics-out F --trace-out T`` (8 requests, 4
   slots; full depth, the CLI's own config): one quarantine and no failed request in F, the trace's B/E
   events paired and monotone in 3 process rows (2 replicas and the
   router).
   Kernel timing: ``launch.serve.main`` in process at full width with
   ``--attn srf`` and with ``--quantize-kv`` (4 requests, 8 new),
   without, with ``--kernel-timing --metrics-out F --trace-out T``
   (under ``chiprun_out/chip_smoke/``) and without again: with timing,
   one ``kernel_dispatch_seconds`` series per kernel launched, its
   count equal to the launch counter (reset just before the run, read
   just after), the trace's B/E events paired and monotone; p50 / p99
   per kernel and tok/s of the three runs printed; one timed dispatch
   each of ``ops.fwht`` and ``ops.circulant_project`` at the library
   shapes.
   The SSD and hybrid families (``phase_reduced_families``): reduced
   mamba2-2.7b and hymba-1.5b (f32, 2 layers; hymba with full KV, int8
   pages and SRF), 8 mixed-length requests greedy and sampled through
   the paged and the legacy engine: card tokens == CPU tokens, paged ==
   legacy (int8: card == CPU only), the cell's kernels launched (mamba2
   none); hymba's prefix scenarios (hit, partial, miss, evict, cow):
   tokens equal cold and CPU, counters equal the CPU's; hymba's chaos
   cells (raise, hang, reject, oom): tokens equal the undisturbed
   engine's and the CPU's, counters the CPU's. Then full width at half
   of each stack (``SERVE_CUT``: mamba2 32 of 64 layers, hymba 16 of 32),
   8 greedy requests of 128 + 32 tokens, 8 slots, max_len 256:
   mamba2-2.7b (64 layers, 80 SSD heads of 64, state 128) through the
   paged and the legacy engine (the legacy engine, here and for hymba,
   on the first 4 requests at 128 + 16), no kernel launched
   (``phase_serve_ssd``); hymba-1.5b (32 layers, 25
   q / 5 kv heads of 64 beside 50 SSD heads, state 16;
   ``phase_serve_hybrid``) with full KV (paged_gather_kv exactly 1 a
   layer a step), int8 pages (paged_gather_dequant_kv exactly 32 a step), SRF
   (the spinner at least 64 a step, srf_decode exactly 32 a decode
   step), the legacy engine with full KV, and the prefix cache (a donor
   of the 96 shared tokens, then the 8 requests: 768 hit tokens). Each
   run prints tok/s, TTFT p50, peak memory and the slot- and
   paged-domain pool bytes; the first-token logits of the two engines
   agree within ``FAMILY_LOGIT_TOL``, each engine's with an f32 copy's
   prefill too. Then qwen2.5-14b, mistral-nemo-12b and internlm2-20b at
   full width, one after another (``phase_serve_dense_configs``): full
   KV, 4 greedy requests of 128 + 16 tokens, paged_gather_kv exactly 1
   a layer a step; tok/s, TTFT p50, peak memory.
   The MoE and MLA families: reduced moonshot-v1-16b-a3b (full KV, int8
   pages, SRF) and deepseek-v2-lite-16b (MLA latent pages, MLA + SRF),
   f32, 2 layers, capacity factor 8 (no routing slot drops, so paged ==
   legacy holds), in ``phase_reduced_families``'s part (1). Then full
   width, random weights, each model freed before the next:
   moonshot-v1-16b-a3b (24 of its 48 layers, ``SERVE_CUT``; 64 experts
   top-6 + 2 shared; ``phase_serve_moe``) with full KV at 8 requests of 128 + 32
   tokens, 8 slots (paged_gather_kv exactly 1 a layer a step), int8 pages
   and SRF at 4 x (128 + 16), 4 slots (paged_gather_dequant_kv exactly 1
   a layer a step; the spinner exactly 2 a layer a step plus the quality
   probe's, srf_decode exactly 1 a layer a decode step);
   deepseek-v2-lite-16b (27 layers, MLA kv_lora 512, 15.7 B params;
   ``phase_serve_mla``) with MLA latent pages at 8 x (128 + 32)
   (paged_gather_kv exactly 1 a layer a step: c and kpe), the legacy
   engine
   on the first 4 requests at 128 + 16 (no kernel; first-token logits
   within ``FAMILY_LOGIT_TOL["mla"]`` of the paged engine's), and MLA +
   SRF at 4 x (128 + 16). Each run prints tok/s, TTFT p50, peak memory
   and the pools' bytes; no plain spinner on the card.
   The vision and enc-dec families: reduced qwen2-vl-2b (full KV, SRF)
   and seamless-m4t-large-v2 (full KV, int8 pages, SRF; each request
   with its own features) in ``phase_reduced_families``' part (1), card
   == CPU and paged == legacy; then (``_reduced_new_families``) seeded
   SRF with mixed embed seeds on reduced deepseek-v2-lite-16b (MLA) and
   seamless, card == CPU; seamless's prefix cache with two feature sets
   (hits only inside the donor's features' namespace); qwen2-vl's
   ``loss_fn`` with ``pos3`` rows apart, card == CPU. Full width:
   qwen2-vl-2b (28 layers, 12 q / 2 kv heads of 128; ``phase_serve_vlm``)
   with full KV and SRF at 8 x (128 + 32), exact launches;
   seamless-m4t-large-v2 (12 of its 24 encoder and 12 of its 24 decoder
   layers, ``SERVE_CUT``; 16 heads of 64; ``phase_serve_encdec``), each request with its own 1024 x 160
   features, with full KV (paged_gather_kv exactly 1 a layer a step plus
   the memory's one-pool paged_gather, 1 a step), int8 pages and SRF at 8 x (128 + 32),
   the prefix cache (a donor, then 4 requests with its features that hit
   its 96 tokens and 4 with their own that hit nothing) and the legacy
   engine on the first 4 requests (first-token logits within
   ``FAMILY_LOGIT_TOL["audio"]``, each engine within it of an f32
   copy's prefill too); encode ms a request and the cross attention's
   device ms a step printed beside tok/s, TTFT p50, peak memory and the
   memory pool's bytes.
   The mesh, on meshes of the card repeated (``launch.mesh``; every
   sharded path and every kernel at its per-shard shapes, no memory
   saved): ``phase_reduced_mesh`` runs the reference's FAM matrix (kv,
   srf, mla, ssd, hybrid, encdec; f32, 2 layers, 16 requests through a
   router of 2 replicas x TP 2): tokens == the unsharded card engine's
   == the CPU's, ``pool_bytes_per_device`` against ``pool_bytes`` as the
   reference's test relates them, each shard's launches exact; a tight
   TP 2 pool's preemption, int8 pages at TP 2 == unsharded == CPU, and
   migration between sharded replicas (a preempted sequence with its
   snapshot, a fresh backlog). ``phase_serve_mesh``: full-width qwen3-4b
   at ``CUT_LAYERS`` (12) of its 36 layers, at TP 2 and at TP 1 beside
   it, 8 x (128 + 32), full KV, int8 pages,
   SRF, seeded SRF with embed seeds: exact launches (every shard's: 2
   K-and-V gathers a layer a step, bf16 or int8, the spinner 4 a layer
   a step plus the probe's, srf_decode 2 a layer a decode step), half
   the pools a position,
   first-token logits within ``MESH_LOGIT_TOL`` of TP 1's, tok/s, TTFT
   and token agreement printed; the FT router over 2 replicas x TP 2
   with replica 1 raising at its step 12 (1 quarantine, 0 failed);
   seamless-m4t-large-v2 at TP 2, full KV.
5. Train (after freeing the serving memory). Full-width, full-depth
   qwen3-4b (bf16, remat full, B = 8, seq = 64, the training launcher's
   defaults), random weights, 5 steps of ``launch.steps.make_train_step``
   fed by ``data.loader.ShardedLoader`` over ``synth.full_batch`` (the
   Trainer's step without its 44 GB checkpoint): SRF attention, seeded
   SRF, then full attention. Every loss and gradient norm finite, the
   first xent within 0.5 of ln(V_pad) + 1/2 (random weights' expected
   first loss), each SRF run's spinner (materialized or seeded) launched
   exactly 4 per layer a step (2 in the forward, 2 in the recompute)
   with 2 plain backward calls per layer, the plain forward and the
   other spinner never; step ms, training tokens/s and the bf16-peak
   share of 6·N·tokens a step (``launch.profile_train.timed`` and
   ``step_rates``, the one definition both scripts use) and peak memory
   printed. Then the reference test's crash-and-resume
   (``tests/test_trainer_ft.py``) on the card under
   ``torch.use_deterministic_algorithms(True)`` (reduced, 2 layers; full
   and SRF attention): final params torch.equal. Then reduced seeded SRF
   (f32), 3 steps on the card and on the CPU: losses within rtol 1e-4.
   Then full-width qwen2-vl-2b (``phase_train_vlm``): 3 steps at B = 2,
   seq = 2048 (a 1024-patch vision prefix, M-RoPE over ``pos3``) with SRF
   attention and 3 with full attention, checked as qwen3-4b's are.
   Then the other families (``phase_train_families``, ``FAMILY_TRAIN``),
   3 steps each: mamba2-2.7b (64 layers) at 2 x 4096; hymba-1.5b (32)
   full and SRF at 2 x 4096; seamless-m4t-large-v2 (24 + 24) full and
   SRF at 4 x 1024 over 1024 frames; moonshot-v1-16b-a3b and
   deepseek-v2-lite-16b full width at 8 layers (1 dense + 7 MoE; the
   whole stacks do not fit one card), full (MLA) and SRF at 2 x 4096.
   Each run's batch and predicted peak come from the dry run of the
   same call on meta (``_train_prediction``, by the grid workers; the
   batch halved above 76 GiB); checked as above (the first xent, MoE
   aux > 0, the spinner's launches 2 a self-attention layer in the
   forward and 2 in the recompute, encoder layers included, mamba2
   none), and the peak within 0.9-1.1x of the prediction.
   Then ``Trainer(mesh=...)`` with ``compress_dp`` on a (pod 2) mesh of
   the card repeated (``phase_train_compressed``): reduced qwen3-4b, 5
   steps, losses card == CPU within rtol 1e-4; full-width qwen2-vl-2b,
   3 compressed steps beside the plain ones: step ms, peak memory,
   ``compression.wire_bytes``' ratio.
6. The dry run (``launch/dryrun.py`` over ``launch/cost_analysis.py``).
   Its 40 single-pod cells (10 configs x train_4k, prefill_32k,
   decode_32k, long_500k, full width on meta) run from the start of the
   script in ``GRID_WORKERS`` spawned CPU processes at the lowest
   priority, beside the card's phases. (a) The five smokes on
   ``cuda:0`` (pipeline, serve_mesh, serve_chaos, serve_prefix,
   serve_seeded; each ``ok``, its path's kernels launched) and the five
   examples on the card at their defaults (quickstart and kernel_approx
   launch the spinner, serve_lm full KV paged_gather_kv and SRF the spinner
   and srf_decode, train_lm's loss falls). (b) One line per cell
   (flops, bytes, t_roofline, bottleneck, peak_bytes, fits_hbm: analysis
   over datasheet peaks, not card timings), the records in
   ``chiprun_out/chip_smoke/dryrun_grid.jsonl``; a cell not ``ok`` fails.
   (c) Full-width qwen3-4b's train step (phase 5's: B = 8, seq 64) and a
   decode step (B = 8, a 4096-position cache) analyzed on meta and
   around the real step on the card: flops equal; the predicted peak
   beside ``torch.cuda.max_memory_allocated``, ``t_roofline`` beside the
   step's CUDA-event time, and the card's ``total_memory``.
7. Print the card (nvidia-smi name, power limit), one JSON line with a
   record per kernel, and the result line. The spinner records carry
   their training fields (``train_*``: the training run's launches and
   plain backward calls, and the kernel at the training shapes; the
   materialized one also ``train_families_*``, each SRF family run's
   forward launches and plain backward calls, and
   ``train_<config>_<query | key>_*``, the kernel at the families'
   training shapes), and
   the spinner, srf_decode and int8-gather records their dispatch
   fields (``dispatch_*``: p50, p99 and count from the timed serve
   run), fwht and circulant_project one timed dispatch; the spinner,
   srf_decode and paged_gather records carry their launches in the
   full-width router run (b), the int8 gather's its launches in the
   reduced int8 router cells (``router_*``); the spinner, srf_decode and
   both gathers their time at hymba-1.5b's shapes and their launches in
   its serve runs (``hymba_*``), paged_gather its launches in the dense
   configs' runs (``dense_*``); the same four their time at the MoE and
   MLA shapes and their launches in those serve runs (``moonshot_*``,
   ``deepseek_*``; paged_gather's: the latents c and kpe in one launch).
   The paged_gather record times the kernel as the serve runs launch it,
   a layer's two pools in one ``paged_gather_kv`` launch, beside two
   one-pool launches (``two_single_launches_ms``), the one-pool entry
   (``one_pool_*``) and two plain and two ``pool[tables]`` calls, at the
   decode shape and (``prefill``) the prefill shape; its launches are
   the ``paged_gather_kv`` counter's, but the memory gather's
   (``seamless_memory_*``), which the one-pool entry makes.
   The same four carry ``qwen2vl_*`` and ``seamless_*`` fields: their
   time at those configs' shapes and their launches in their serve runs
   (the spinner also ``*_key`` and ``seamless_encoder*``, paged_gather
   ``seamless_memory_*``: the memory gather), and the spinner its
   launches in qwen2-vl's SRF training (``qwen2vl_train_*``). Rows 1-5
   carry ``tp2_*`` fields: the kernel at its TP 2 shard shape and its
   launches in the TP 2 serve runs (paged_gather also
   ``tp2_seamless_*`` and ``tp2_router_*``).
   ``library_ms`` is ``pool[tables]`` for paged_gather, ``x @ H_n`` for fwht, ``x @ A.T``
   for circulant_project, and null for the others: no single
   PyTorch call computes f(A·D1·H·D0·x) with a regenerated structured A
   (nor with A, D0 and D1 regenerated from a seed), the fused in-place
   SRF state update and readout, or a gather fused with the int8
   dequant.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# deterministic cuBLAS for phase 5's crash-and-resume check: read when
# the CUDA context is made, so it is set before torch is imported
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOP_PER_S = 67e12       # H100 SXM f32, CUDA cores (data sheet)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, launches: int = 100, repeats: int = 5) -> float:
    """Median device time of one call of ``fn``: ``launches`` calls queued
    behind a device sleep (so host overhead does not leak into the
    window), timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)           # ~25 ms: host queues ahead
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / launches)
    return statistics.median(out)


def max_err(k: torch.Tensor, p: torch.Tensor):
    k, p = k.float(), p.float()
    return (k - p).abs().max().item(), p.abs().max().item()


def check(name: str, k: torch.Tensor, p: torch.Tensor, dtype) -> float:
    if k.shape != p.shape:
        raise AssertionError(f"{name}: shape {tuple(k.shape)} != "
                             f"{tuple(p.shape)}")
    if not torch.isfinite(k).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err, scale = max_err(k, p)
    limit = TOL[dtype] * scale
    log(f"  {name}: max|k-p| = {err:.3e}  limit = {limit:.3e}")
    if not err <= limit:
        raise AssertionError(f"{name}: max|k-p| {err:.3e} > {limit:.3e}")
    return err


def check_rel(name: str, k: torch.Tensor, p: torch.Tensor,
              rtol: float = TOL[torch.bfloat16]) -> float:
    """Element by element, |k - p| <= rtol |p| + rtol mean|p|: for outputs
    whose largest values sit far above a typical one (the exp epilogue),
    where a limit scaled by max|p| would let most elements go unchecked."""
    if k.shape != p.shape:
        raise AssertionError(f"{name}: shape {tuple(k.shape)} != "
                             f"{tuple(p.shape)}")
    if not torch.isfinite(k).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    k, p = k.float(), p.float()
    typical = p.abs().mean().item()
    diff = (k - p).abs()
    rel = diff / (rtol * (p.abs() + typical))
    worst = rel.max().item()
    log(f"  {name}: typical |p| (mean) {typical:.3e}, max|p| "
        f"{p.abs().max().item():.3e}; max|k-p| / (rtol (|p| + mean|p|)) = "
        f"{worst:.3f} (limit 1, rtol {rtol})")
    if not worst <= 1:
        raise AssertionError(f"{name}: {int((rel > 1).sum())} elements "
                             f"outside rtol {rtol} (|p| + mean|p|)")
    return diff.max().item()


def check_exp(name: str, k: torch.Tensor, p: torch.Tensor, dtype,
              epilogue: str) -> float:
    """A spinner output against its plain version: the exp epilogue's
    features span decades (a typical one far below the largest), so they
    are checked element by element (``check_rel`` at the dtype's
    tolerance); the others against their largest value (``check``)."""
    if epilogue == "exp":
        return check_rel(name, k, p, TOL[dtype])
    return check(name, k, p, dtype)


def exact(name: str, k: torch.Tensor, p: torch.Tensor) -> None:
    """Bit equality (same shape, dtype and bits)."""
    if k.shape != p.shape or k.dtype != p.dtype or not torch.equal(k, p):
        raise AssertionError(f"{name}: kernel != plain version")
    log(f"  {name}: bit-equal")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def spinner_inputs(kind, gsz, bsz, n, m, dtype, gen, use_hd=True):
    from repro_torch.kernels import spinner as kspin
    dev = "cuda"
    x = torch.randn((gsz, bsz, n), generator=gen, device=dev) * n ** -0.25
    g = torch.randn(kspin._gen_shape(kind, gsz, n, m), generator=gen,
                    device=dev)
    sign = lambda: (2 * torch.randint(0, 2, (gsz, n), generator=gen,  # noqa
                                      device=dev) - 1).float()
    params = {"g": g.to(dtype)}
    if use_hd:
        params["d0"], params["d1"] = sign().to(dtype), sign().to(dtype)
    return x.to(dtype), params


def bound(byts: float, ops: float):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and operations over the f32 peak (the operations counted are the
    function's own: FFT products, butterflies and the seeded draws, f32
    and integer work of the CUDA cores; not the dense products the
    kernels run on the tensor cores)."""
    t_b, t_o = byts / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def kernel_bound(name, *args, **kw):
    """``bound`` of a kernel's function, its operations and bytes by
    ``kernels/cost.py`` (the counts the cost analysis of a step adds for
    the kernel too)."""
    from repro_torch.kernels import cost
    ops, byts = getattr(cost, name)(*args, **kw)
    return bound(byts, ops)


def spinner_bound(kind, gsz, bsz, n, m, itemsize, gen_elems, width,
                  use_hd=True):
    """x read once, generator and diagonals read once, output written
    once. Operations: what the function needs, not what the kernel does
    (it regenerates A and takes B*m*n multiply-adds): per row, the fast
    structured matvec's count (``structured.flops_fast``, an FFT product)
    plus the HD butterfly's n*log2(n) adds (none without HD, nor the two
    diagonals). ``kernels/cost.spinner``, which the cost analysis of a
    step counts the kernel by too."""
    return kernel_bound("spinner", kind, gsz, bsz, n, m, itemsize, gen_elems,
                        width, use_hd)


LIBRARY = (1, 8192, 1024, 4096)        # G, B, n, m: one estimate's call


def library_shape(label, kernel, plain, x, p, dtype, bound_ms):
    """A spinner kernel at the library shape (one call of
    ``estimators.estimate`` at m = 4096): checked against its plain
    version, timed beside it, and beside ``z @ A.T`` on the materialized A
    in the same dtype (z = D1 H D0 x / sqrt(n) by the plain version's HD:
    the dense product the kernel's tensor-core mainloop does, for
    orientation; not the same function, so no ``library_ms``)."""
    from repro_torch.core import structured
    from repro_torch.kernels import ref
    gsz, bsz, n, m = LIBRARY
    k = kernel()
    err = check(f"{label} library shape {str(dtype)[6:]} (B={bsz}, n={n}, "
                f"m={m})", k, plain(), dtype)
    del k
    k_ms = device_ms(kernel, launches=5, repeats=3)
    p_ms = device_ms(plain, launches=3, repeats=3)
    z = ref._hd_kron(x[0].float(), p["d0"][0].float(),
                     p["d1"][0].float()).to(dtype)
    a = structured.materialize("circulant", {"g": p["g"][0]}, m, n).to(dtype)
    mm_ms = device_ms(lambda: z @ a.T, launches=5, repeats=3)
    log(f"    kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  z @ A.T {mm_ms:.4f} "
        f"ms  bound {bound_ms[0]:.5f} ms ({bound_ms[1]})")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, matmul_ms=mm_ms,
                bound_ms=bound_ms[0], bound_by=bound_ms[1])


def phase_spinner(gen):
    from repro_torch.kernels import ops, ref, spinner as kspin
    n, m, gsz = 128, 256, 8
    shapes = [("decode query", 32, "identity"), ("decode key", 8, "exp"),
              ("prefill query", 8 * 16 * 4, "identity"),
              ("prefill key", 8 * 16, "exp")]
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, bsz, epi in shapes:
            x, p = spinner_inputs("circulant", gsz, bsz, n, m, dtype, gen)
            args = ("circulant", p["g"], x, m)
            kw = dict(d0=p["d0"], d1=p["d1"], epilogue=epi,
                      out_scale=m ** -0.5)
            k = kspin.spinner_project_cuda(*args, **kw)
            pl = ref.spinner_project_ref(*args, **kw)
            name = f"spinner {label} {str(dtype)[6:]} (G={gsz}, B={bsz})"
            err = check_exp(name, k, pl, dtype, epi)
            k_ms = device_ms(lambda: kspin.spinner_project_cuda(*args, **kw))
            p_ms = device_ms(lambda: ref.spinner_project_ref(*args, **kw),
                             launches=10, repeats=3)
            b_ms, b_by = spinner_bound("circulant", gsz, bsz, n, m,
                                       x.element_size(),
                                       p["g"][0].numel(), m)
            log(f"    kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
                f"bound {b_ms:.5f} ms ({b_by})")
            records[(label, dtype)] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                           bound_ms=b_ms, bound_by=b_by)
        gsz_l, bsz_l, n_l, m_l = LIBRARY
        x, p = spinner_inputs("circulant", gsz_l, bsz_l, n_l, m_l, dtype, gen)
        args = ("circulant", p["g"], x, m_l)
        kw = dict(d0=p["d0"], d1=p["d1"])
        records[("library", dtype)] = library_shape(
            "spinner", lambda: kspin.spinner_project_cuda(*args, **kw),
            lambda: ref.spinner_project_ref(*args, **kw), x, p, dtype,
            spinner_bound("circulant", gsz_l, bsz_l, n_l, m_l,
                          x.element_size(), p["g"][0].numel(), m_l))
        del x, p, args, kw
        torch.cuda.empty_cache()

    # every kernel kind x epilogue x grouped/ungrouped, ragged B and m
    n, m, bsz = 64, 200, 13
    for kind in kspin.KERNEL_KINDS:
        for epi in kspin.EPILOGUES:
            for grouped in (True, False):
                gs = 3 if grouped else 1
                x, p = spinner_inputs(kind, gs, bsz, n, m, torch.float32,
                                      gen)
                if not grouped:
                    x, p = x[0], {k: v[0] for k, v in p.items()}
                before = kspin.spinner_project_cuda.launches
                k = ops.spinner_project(kind, p, x, m, epilogue=epi,
                                        y_scale=0.7, out_scale=m ** -0.5,
                                        grouped=grouped)
                if kspin.spinner_project_cuda.launches != before + 1:
                    raise AssertionError("sweep call did not launch")
                lift = (lambda t: t) if grouped else (lambda t: t[None])

                def plain(e):
                    return ref.spinner_project_ref(
                        kind, lift(p["g"]), lift(x), m, d0=lift(p["d0"]),
                        d1=lift(p["d1"]), epilogue=e, y_scale=0.7,
                        out_scale=m ** -0.5).reshape(k.shape)
                pl = plain(epi)
                if epi in ("heaviside", "sign"):
                    # a step function of y: compare where |y| is not
                    # within f32 summation-order noise of the step
                    y = plain("identity")
                    far = y.abs() > 1e-4 * y.abs().max()
                    k, pl = k[far], pl[far]
                check(f"sweep {kind} {epi} grouped={grouped}", k, pl,
                      torch.float32)
    return records


def seeded_bound(kind, gsz, bsz, n, m, itemsize, width):
    """x read once, the output written once, and each group's 8-byte seed
    (the port's int64 word; the reference reads a 4-byte uint32).
    Operations: the spinner's rule (``spinner_bound``) plus drawing each
    group's generator (its canonical size: nb*n for circulant, n+m-1 for
    toeplitz/hankel, m*n dense) and 2n signs once
    (``kernels/cost.seeded``: ``OPS_PER_NORMAL``, ``OPS_PER_SIGN``)."""
    return kernel_bound("seeded", kind, gsz, bsz, n, m, itemsize, width)


def _materialized_twin(kind, seeds, x, m, epi, y_scale, out_scale):
    """The materialized spinner kernel on ``seedgen.grouped_params(seeds)``
    computed by PyTorch on the card (cast to x's dtype)."""
    from repro_torch.kernels import seedgen, spinner as kspin
    p = seedgen.grouped_params(kind, x.shape[-1], m, seeds)
    return kspin.spinner_project_cuda(
        kind, p["g"].to(x.dtype).contiguous(), x, m,
        d0=p["d0"].to(x.dtype), d1=p["d1"].to(x.dtype), epilogue=epi,
        y_scale=y_scale, out_scale=out_scale)


def _against_twin(name, k, twin, dtype):
    """Bit-equal to the materialized twin, or within the tolerance."""
    if k.shape == twin.shape and torch.equal(k, twin):
        log(f"    {name}: seeded == materialized kernel, bit-equal")
        return True
    check(f"{name} vs materialized kernel", k, twin, dtype)
    return False


def phase_seeded_spinner(gen):
    """The seeded spinner kernel at the seeded serving shapes and over
    every kind x epilogue x grouped/ungrouped."""
    from repro_torch.kernels import ops, ref, seedgen, spinner as kspin
    dev = "cuda"
    n, m, gsz = 128, 256, 64
    shapes = [("decode query", 4, "identity"), ("decode key", 1, "exp"),
              ("prefill query", 64, "identity"), ("prefill key", 16, "exp")]
    records, equal = {}, 0
    for dtype in (torch.bfloat16, torch.float32):
        for label, bsz, epi in shapes:
            x = (torch.randn((gsz, bsz, n), generator=gen, device=dev)
                 * n ** -0.25).to(dtype)
            seeds = torch.randint(0, 2 ** 32, (gsz,), generator=gen,
                                  device=dev, dtype=torch.int64)
            kw = dict(use_hd=True, epilogue=epi, out_scale=m ** -0.5)
            k = kspin.spinner_project_seeded_cuda("circulant", seeds, x, m,
                                                  **kw)
            pl = ref.spinner_project_seeded_ref("circulant", seeds, x, m,
                                                **kw)
            name = (f"seeded spinner {label} {str(dtype)[6:]} "
                    f"(G={gsz}, B={bsz})")
            err = check_exp(name, k, pl, dtype, epi)
            twin = _materialized_twin("circulant", seeds, x, m, epi, 1.0,
                                      m ** -0.5)
            equal += _against_twin(name, k, twin, dtype)
            k_ms = device_ms(lambda: kspin.spinner_project_seeded_cuda(
                "circulant", seeds, x, m, **kw))
            p_ms = device_ms(lambda: ref.spinner_project_seeded_ref(
                "circulant", seeds, x, m, **kw), launches=10, repeats=3)
            gp = {k_: v.to(dtype) for k_, v in seedgen.grouped_params(
                "circulant", n, m, seeds).items()}
            mat_ms = device_ms(lambda: kspin.spinner_project_cuda(
                "circulant", gp["g"], x, m, d0=gp["d0"], d1=gp["d1"],
                epilogue=epi, out_scale=m ** -0.5))
            b_ms, b_by = seeded_bound("circulant", gsz, bsz, n, m,
                                      x.element_size(), m)
            log(f"    kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
                f"materialized kernel {mat_ms:.4f} ms  bound {b_ms:.5f} ms "
                f"({b_by})")
            records[(label, dtype)] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                           materialized_ms=mat_ms,
                                           bound_ms=b_ms, bound_by=b_by)
        gsz_l, bsz_l, n_l, m_l = LIBRARY
        x = (torch.randn((gsz_l, bsz_l, n_l), generator=gen, device=dev)
             * n_l ** -0.25).to(dtype)
        seeds = torch.randint(0, 2 ** 32, (gsz_l,), generator=gen,
                              device=dev, dtype=torch.int64)
        gp = {k_: v.to(dtype) for k_, v in seedgen.grouped_params(
            "circulant", n_l, m_l, seeds).items()}
        records[("library", dtype)] = library_shape(
            "seeded spinner",
            lambda: kspin.spinner_project_seeded_cuda("circulant", seeds, x,
                                                      m_l),
            lambda: ref.spinner_project_seeded_ref("circulant", seeds, x,
                                                   m_l), x, gp, dtype,
            seeded_bound("circulant", gsz_l, bsz_l, n_l, m_l,
                         x.element_size(), m_l))
        equal += _against_twin(
            f"seeded spinner library shape {str(dtype)[6:]}",
            kspin.spinner_project_seeded_cuda("circulant", seeds, x, m_l),
            _materialized_twin("circulant", seeds, x, m_l, "identity", 1.0,
                               1.0), dtype)
        del x, gp
        torch.cuda.empty_cache()

    # every kernel kind x epilogue x grouped/ungrouped, ragged B and m
    n, m, bsz, cases = 64, 200, 13, 0
    for kind in kspin.KERNEL_KINDS:
        for epi in kspin.EPILOGUES:
            for grouped in (True, False):
                gs = 3 if grouped else 1
                x = torch.randn((gs, bsz, n), generator=gen, device=dev) \
                    * n ** -0.25
                seeds = torch.randint(0, 2 ** 32, (gs,), generator=gen,
                                      device=dev, dtype=torch.int64)
                xa, sa = (x, seeds) if grouped else (x[0], seeds[0])
                before = kspin.spinner_project_seeded_cuda.launches
                k = ops.spinner_project_seeded(
                    kind, sa, xa, m, epilogue=epi, y_scale=0.7,
                    out_scale=m ** -0.5, grouped=grouped)
                if kspin.spinner_project_seeded_cuda.launches != before + 1:
                    raise AssertionError("seeded sweep call did not launch")
                k = k.reshape((gs, bsz, -1))

                def plain(e, s=seeds):
                    return ref.spinner_project_seeded_ref(
                        kind, s, x, m, epilogue=e, y_scale=0.7,
                        out_scale=m ** -0.5)
                pl, twin = plain(epi), _materialized_twin(
                    kind, seeds, x, m, epi, 0.7, m ** -0.5)
                name = f"seeded sweep {kind} {epi} grouped={grouped}"
                equal += _against_twin(name, k, twin, torch.float32)
                kk = k
                if epi in ("heaviside", "sign"):
                    # a step function of y: compare where |y| is not
                    # within f32 summation-order noise of the step
                    y = plain("identity")
                    far = y.abs() > 1e-4 * y.abs().max()
                    kk, pl = k[far], pl[far]
                check(name, kk, pl, torch.float32)
                other = ops.spinner_project_seeded(
                    kind, (sa + 1) % 2 ** 32, xa, m, epilogue=epi,
                    y_scale=0.7, out_scale=m ** -0.5, grouped=grouped)
                if torch.equal(other.reshape(k.shape), k):
                    raise AssertionError(f"{name}: distinct seeds gave the "
                                         f"same output")
                cases += 1
    log(f"  seeded spinner: {cases} sweep cases, 8 serving shapes and 2 "
        f"library shapes; {equal} of {cases + 10} bit-equal to the "
        f"materialized kernel; "
        f"distinct seeds gave distinct outputs in every sweep case")
    return records


# the SRF feature maps of one full-width training step (qwen3-4b: 8 kv
# heads, batch 8 x seq 64; the 4 query heads of a kv head grouped onto
# it): (label, G, rows per group, n, epilogue, HD); m = 256, bf16
TRAIN_SHAPES = [("train query", 8, 8 * 4 * 64, 128, "identity", True),
                ("train key", 8, 8 * 64, 128, "exp", True)]


def _family_shapes():
    """The SRF feature maps of ``phase_train_families``' SRF runs at their
    batches (``FAMILY_TRAIN``): per config the queries (a kv head's
    query heads grouped onto it) and the keys; seamless's encoder and
    decoder self-attention share one shape (B x 1024 rows either way);
    deepseek's MLA + SRF maps every head's n = 192 rows, without HD."""
    from repro_torch.configs import registry
    from repro_torch.models import attention as attn_lib
    out = []
    for label, arch, attn, over, b, seq in FAMILY_TRAIN:
        if attn != "srf":
            continue
        cfg = registry.get(arch, attn_impl=attn, **over)
        sc = attn_lib.srf_cfg(cfg)
        g = 1 if cfg.is_mla else cfg.n_heads // cfg.n_kv_heads
        heads = cfg.n_heads if cfg.is_mla else cfg.n_kv_heads
        tag = label.split()[0]
        out += [(f"{tag} query", heads, b * g * seq, sc.head_dim,
                 "identity", sc.use_hd),
                (f"{tag} key", heads, b * seq, sc.head_dim, "exp",
                 sc.use_hd)]
    return out


def phase_spinner_train(gen):
    """Both spinner kernels at qwen3-4b's training shapes (G = 8, n = 128,
    m = 256, bf16), the materialized one also at the families' training
    shapes (``_family_shapes``): the forward against its plain version
    and timed beside it and its bound, and the backward that training
    runs after it (the plain version's VJP: g, x and, with HD, d0, d1
    materialized; x seeded) timed by events."""
    from repro_torch.kernels import ref, seedgen, spinner as kspin
    m, dtype = 256, torch.bfloat16
    records = {}
    shapes = [(s, True) for s in TRAIN_SHAPES] + \
        [(s, False) for s in _family_shapes()]
    for (label, gsz, bsz, n, epi, hd), with_seeded in shapes:
        x, p = spinner_inputs("circulant", gsz, bsz, n, m, dtype, gen,
                              use_hd=hd)
        d0, d1 = p.get("d0"), p.get("d1")
        seeds = torch.randint(0, 2 ** 32, (gsz,), generator=gen,
                              device="cuda", dtype=torch.int64)
        kw = dict(epilogue=epi, out_scale=m ** -0.5)
        dy = torch.randn((gsz, bsz, m), generator=gen,
                         device="cuda").to(dtype)
        leaves = [t.clone().requires_grad_()
                  for t in (p["g"], x, d0, d1) if t is not None]

        def bwd():
            ds = leaves[2:] if hd else (None, None)
            y = ref.spinner_project_ref("circulant", leaves[0], leaves[1], m,
                                        d0=ds[0], d1=ds[1], **kw)
            return torch.autograd.grad(y, leaves, dy)
        xs = x.clone().requires_grad_()

        def seeded_bwd():           # regenerates the params, as it must
            gp = seedgen.grouped_params("circulant", n, m, seeds)
            y = ref.spinner_project_ref("circulant", gp["g"], xs, m,
                                        d0=gp["d0"], d1=gp["d1"], **kw)
            return torch.autograd.grad(y, [xs], dy)
        runs = [("spinner", lambda: kspin.spinner_project_cuda(
                    "circulant", p["g"], x, m, d0=d0, d1=d1, **kw),
                 lambda: ref.spinner_project_ref(
                    "circulant", p["g"], x, m, d0=d0, d1=d1, **kw),
                 bwd, spinner_bound("circulant", gsz, bsz, n, m,
                                    x.element_size(), p["g"][0].numel(), m,
                                    use_hd=hd))]
        if with_seeded:
            runs.append(
                ("seeded spinner", lambda: kspin.spinner_project_seeded_cuda(
                    "circulant", seeds, x, m, **kw),
                 lambda: ref.spinner_project_seeded_ref(
                    "circulant", seeds, x, m, **kw),
                 seeded_bwd, seeded_bound("circulant", gsz, bsz, n, m,
                                          x.element_size(), m)))
        for name, kernel, plain, backward, b in runs:
            what = (f"{name} {label} bf16 (G={gsz}, B={bsz}, n={n}"
                    f"{'' if hd else ', no HD'})")
            err = check_exp(what, kernel(), plain(), dtype, epi)
            k_ms = device_ms(kernel)
            p_ms = device_ms(plain, launches=10, repeats=3)
            b_ms = device_ms(backward, launches=10, repeats=3)
            log(f"    kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  plain "
                f"backward {b_ms:.4f} ms  bound {b[0]:.5f} ms ({b[1]})")
            records[(name, label)] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                          bwd_ms=b_ms, bound_ms=b[0],
                                          bound_by=b[1])
    return records


def profiled_device_ms(fn, calls: int = 10) -> float:
    """Device time of one call of ``fn``: the sum of its kernels' and
    copies' device time under ``torch.profiler``, over ``calls`` calls.
    Unlike ``device_ms`` it leaves out the gaps in which the device waits
    for the host (a copy from pageable host memory synchronizes)."""
    from repro_torch.launch.profile_serve import _device_us
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(_device_us(e) for e in prof.key_averages()
             if getattr(e, "device_type", None) == cuda)
    return us / 1e3 / calls


def phase_sampler(gen):
    """The plain stateless sampler at the full-width decode shape, as the
    engine calls it (host arrays for the per-row settings): 8 rows of
    151936 logits, 4 greedy and 4 sampled (temperature 0.8, top_k 40,
    top_p 0.95). Device time from the profiler; time per call from CUDA
    events, which also holds the device's waits on the host (each
    host-to-device copy of the row settings synchronizes)."""
    import numpy as np
    from repro_torch.kernels import seedgen
    from repro_torch.serving import sampler
    b, v = 8, 151936
    logits = torch.randn((b, v), generator=gen, device="cuda") * 4
    temps = np.array([0.0, 0.8] * 4, np.float32)
    ks, ps = np.full(b, 40, np.int64), np.full(b, 0.95, np.float32)
    uids, pos = np.arange(b, dtype=np.int64), np.full(b, 17, np.int64)
    key = seedgen.threefry_seed(0, "cuda")

    def call(t):
        return lambda: sampler.sample_stateless(key, uids, pos, logits, t,
                                                ks, ps)
    dev = profiled_device_ms(call(temps))
    per_call = device_ms(call(temps), launches=20, repeats=3)
    greedy = profiled_device_ms(call(np.zeros(b, np.float32)))
    log(f"  plain stateless sampler (B={b}, V={v}): device {dev:.4f} ms "
        f"a call with sampled rows ({greedy:.4f} ms all greedy: argmax "
        f"only); {per_call:.4f} ms a call by CUDA events")
    return dev


def phase_srf_decode(gen):
    from repro_torch.kernels import ref
    kdec = _kernel_module("srf_decode")
    b, h, m, dv = 8, 32, 256, 128
    dev = "cuda"
    phi = lambda: torch.rand((b, h, m), generator=gen, device=dev) / 16  # noqa
    s = torch.randn((b, h, m, dv), generator=gen, device=dev) * 4
    z = phi() * 128
    pq, pk = phi(), phi()
    v = torch.randn((b, h, dv), generator=gen, device=dev)
    ps, pz, po = ref.srf_decode_ref(s, z, pq, pk, v)
    ks, kz, ko = kdec.srf_decode_cuda(s.clone(), z.clone(), pq, pk, v)
    errs = [check("srf_decode S'", ks, ps, torch.float32),
            check("srf_decode z'", kz, pz, torch.float32),
            check("srf_decode out (B=8, H=32, m=256, dv=128)", ko, po,
                  torch.float32)]
    for shape in ((2, 3, 37, 13), (1, 2, 300, 260)):   # ragged, unaligned dv
        rs = torch.randn(shape, generator=gen, device=dev)
        rz, rq, rk = (torch.rand(shape[:3], generator=gen, device=dev)
                      for _ in range(3))
        rv = torch.randn(shape[:2] + shape[3:], generator=gen, device=dev)
        want = ref.srf_decode_ref(rs, rz, rq, rk, rv)
        got = kdec.srf_decode_cuda(rs.clone(), rz.clone(), rq, rk, rv)
        for part, k, p in zip(("S'", "z'", "out"), got, want):
            check(f"srf_decode {part} {shape}", k, p, torch.float32)
    s2, z2 = s.clone(), z.clone()
    k_ms = device_ms(lambda: kdec.srf_decode_cuda(s2, z2, pq, pk, v))
    p_ms = device_ms(lambda: ref.srf_decode_ref(s, z, pq, pk, v),
                     launches=20, repeats=3)
    b_ms, b_by = kernel_bound("srf_decode", b, h, m, dv)
    log(f"    kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
        f"bound {b_ms:.5f} ms ({b_by})")
    return dict(err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)


def _layer_pools(n_layers, n, p, d, dtype, gen):
    """``n_layers`` distinct pools, as the model has one per layer: cycling
    through them reads cold pages (36 x 8.4 MB outgrows the 50 MB L2)."""
    dev = "cuda"
    if dtype == torch.int8:
        return [torch.randint(-127, 128, (n, p, d), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(n_layers)]
    return [torch.randn((n, p, d), generator=gen, device=dev).to(dtype)
            for _ in range(n_layers)]


def _cycle(fn, pools):
    it = itertools.cycle(pools)
    return lambda: fn(next(it))


def _dequant_exact(label, kq, ks, vq, vs, t):
    """paged_gather_dequant on the K pool and paged_gather_dequant_kv on
    both, int8 -> bf16 and f32, bit-equal to the plain version."""
    from repro_torch.kernels import ref
    kpg = _kernel_module("paged_gather")
    for odt in (torch.bfloat16, torch.float32):
        want_k = ref.paged_gather_dequant_ref(kq, ks, t, odt)
        want_v = ref.paged_gather_dequant_ref(vq, vs, t, odt)
        exact(f"paged_gather_dequant {label} int8->{str(odt)[6:]}",
              kpg.paged_gather_dequant_cuda(kq, ks, t, odt), want_k)
        k, v = kpg.paged_gather_dequant_kv_cuda(kq, ks, vq, vs, t, odt)
        exact(f"paged_gather_dequant_kv {label} K int8->{str(odt)[6:]}",
              k, want_k)
        exact(f"paged_gather_dequant_kv {label} V int8->{str(odt)[6:]}",
              v, want_v)


def _offset(t, elems):
    """A copy of ``t`` whose base lies ``elems`` elements past an
    allocation's start: off 16-byte alignment unless 0."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = buf[elems:].view(t.shape)
    view.copy_(t)
    return view


def _dequant_paths(gen):
    """The dequant kernel's other paths, bit-equal: pool views off 16-byte
    alignment at the decode widths (the vector and scalar paths of the
    same kernel), a page of 64 rows (64 KB, cut into ring stages), and
    rows of 32768 int8 longer than a stage (cut within the row)."""
    kpg = _kernel_module("paged_gather")
    dev = "cuda"
    cases = [("decode widths", 257, 16, 1024, 8, 16),
             ("page of 64 rows", 65, 64, 1024, 4, 8),
             ("rows of 32768", 9, 4, 32768, 3, 5)]
    for label, n, p, d, r, m in cases:
        t = torch.randint(-3, n + 3, (r, m), generator=gen, device=dev,
                          dtype=torch.int32)
        q = torch.randint(-127, 128, (2, n, p, d), generator=gen,
                          device=dev, dtype=torch.int8)
        sc = torch.rand((2, n, p, 1), generator=gen, device=dev) / 127
        views = [("aligned", (0, 0))]
        if label == "decode widths":
            views += [("pool at +8 bytes", (8, 0)),
                      ("pool at +1 byte", (1, 0)),
                      ("scales at +4 bytes", (0, 1))]
        for how, (qo, so) in views:
            kq, vq = _offset(q[0], qo), _offset(q[1], qo)
            ks, vs = _offset(sc[0], so), _offset(sc[1], so)
            plan = kpg.dequant_plan(
                p, d, 2, r * m, (kq.data_ptr() | vq.data_ptr()) % 16, 0,
                torch.bfloat16,
                scales_addr_mod16=(ks.data_ptr() | vs.data_ptr()) % 16,
                n_pages=n, sms=torch.cuda.get_device_properties(
                    0).multi_processor_count)
            _dequant_exact(f"{label}, {how}, {plan.path} path, "
                           f"{plan.chunk_rows} x {plan.chunk_cols} chunks "
                           f"(N={n}, P={p}, D={d}, R={r}, M={m})",
                           kq, ks, vq, vs, t)


def _pair_exact(label, a, b, t):
    """paged_gather_kv on pools ``a`` and ``b`` (one launch) bit-equal to
    two plain calls."""
    from repro_torch.kernels import ref
    kpg = _kernel_module("paged_gather")
    ga, gb = kpg.paged_gather_kv_cuda(a, b, t)
    exact(f"paged_gather_kv {label} first pool", ga,
          ref.paged_gather_ref(a, t))
    exact(f"paged_gather_kv {label} second pool", gb,
          ref.paged_gather_ref(b, t))


def _pair_paths(gen):
    """The copy gather's pairs beyond one shape: MLA's latents (rows of
    512 and 64), a pair whose pages differ in rows too, and pairs whose
    second pool lies 8 bytes off 16-byte alignment (narrower units in the
    same kernel), each pair's unit printed."""
    kpg = _kernel_module("paged_gather")
    dev = "cuda"
    for label, n, (pa, da), (pb, db), r, m, off in (
            ("c+kpe (512, 64)", 257, (16, 512), (16, 64), 8, 16, 0),
            ("pages 16 x 512 and 4 x 64", 257, (16, 512), (4, 64), 8, 16,
             0),
            ("K and V, V at +8 bytes", 257, (16, 1024), (16, 1024), 8, 16,
             8),
            ("ragged (13, 4), V at +8 bytes", 7, (3, 13), (3, 4), 3, 5, 8)):
        tables = torch.randint(-3, n + 3, (r, m), generator=gen, device=dev)
        for tdt in (torch.int64, torch.int32):
            for dtype in (torch.bfloat16, torch.float32, torch.int8):
                a = _layer_pools(1, n, pa, da, dtype, gen)[0]
                b = _layer_pools(1, n, pb, db, dtype, gen)[0]
                b = _offset(b, off // dtype.itemsize)
                plan = kpg.gather_plan(((pa, da), (pb, db)), r * m,
                                       dtype.itemsize,
                                       (0, b.data_ptr() % 16))
                _pair_exact(f"{label} {str(dtype)[6:]} {str(tdt)[6:]}, "
                            f"{plan.unit}-byte units (N={n}, R={r}, M={m})",
                            a, b, tables.to(tdt))


def _pair_times(label, tables, pools_a, pools_b, p, da, db):
    """One paged_gather_kv launch against two one-pool launches, two plain
    calls and two ``pool[tables]`` calls, cycling through the layers'
    pools; the pair's bound is the two pools' gathers. Returns the
    record (the one-pool kernel's numbers, on the first pool, as
    ``one_pool_*``)."""
    from repro_torch.kernels import ref
    kpg = _kernel_module("paged_gather")
    layers = list(zip(pools_a, pools_b))
    rows = tables.numel() * p
    pair_ms = device_ms(_cycle(lambda a: kpg.paged_gather_kv_cuda(
        a[0], a[1], tables), layers))
    two_ms = device_ms(_cycle(lambda a: [kpg.paged_gather_cuda(x, tables)
                                         for x in a], layers))
    one_ms = device_ms(_cycle(lambda a: kpg.paged_gather_cuda(a[0], tables),
                              layers))
    plain = device_ms(_cycle(lambda a: [ref.paged_gather_ref(x, tables)
                                        for x in a], layers))
    lib = device_ms(_cycle(lambda a: [x[tables] for x in a], layers))
    one_lib = device_ms(_cycle(lambda a: a[0][tables], layers))
    one_b, one_by = kernel_bound("gather", rows, da, 2)
    b_b = kernel_bound("gather", rows, db, 2)[0]
    pair_b = one_b + b_b
    log(f"    {label} paged_gather_kv bf16 (D={da} and {db}): one launch "
        f"{pair_ms:.5f} ms ({100 * pair_b / pair_ms:.0f}% of bound)  two "
        f"one-pool launches {two_ms:.5f} ms  two pool[tables] {lib:.5f} ms  "
        f"two plain {plain:.5f} ms  bound {pair_b:.5f} ms ({one_by})")
    log(f"    {label} paged_gather bf16, one pool (D={da}): kernel "
        f"{one_ms:.5f} ms ({100 * one_b / one_ms:.0f}% of bound)  "
        f"pool[tables] {one_lib:.5f} ms  bound {one_b:.5f} ms")
    return dict(err=0.0, ms=pair_ms, plain_ms=plain, library_ms=lib,
                bound_ms=pair_b, bound_by=one_by, one_pool_ms=one_ms,
                one_pool_library_ms=one_lib, one_pool_bound_ms=one_b,
                two_single_launches_ms=two_ms)


def phase_paged_gather(gen):
    """Both gathers, bit-equal (torch.equal) to their plain versions at
    the full-width decode shape (R=8 rows, M=16 pages of P=16 tokens,
    D = 8 kv heads x 128; N=257 pages, the engine's default pool), a
    prefill-sized shape (R=32, M=64) and ragged shapes (row bytes not a
    multiple of 16, ids out of range on both sides): the copy gather for
    one pool and for two pools in one launch (``paged_gather_kv``; also
    MLA's rows of 512 and 64 and a pool off 16-byte alignment,
    ``_pair_paths``), the int8 gather for one pool and for a layer's K
    and V in one launch, and on its other paths (``_dequant_paths``).
    Times at the decode and prefill shapes: each gather for one pool, and
    for K and V in one launch beside two single-pool launches (how the
    attention gathered them before), the copy gather also beside two
    ``pool[tables]`` calls."""
    from repro_torch.kernels import ref
    kpg = _kernel_module("paged_gather")
    dev = "cuda"
    shapes = [("decode", 257, 16, 1024, 8, 16),
              ("prefill", 2049, 16, 1024, 32, 64),
              ("ragged a", 7, 3, 13, 3, 5), ("ragged b", 11, 5, 7, 4, 3),
              ("ragged c", 9, 2, 1, 5, 2)]
    records = {}
    for label, n, p, d, r, m in shapes:
        ragged = label.startswith("ragged")
        lo, hi = (-3, n + 3) if ragged else (1, n)
        tables = torch.randint(lo, hi, (r, m), generator=gen, device=dev,
                               dtype=torch.int64)
        for tdt in (torch.int64, torch.int32):
            t = tables.to(tdt)
            what = f"(N={n}, P={p}, D={d}, R={r}, M={m}, {str(tdt)[6:]})"
            for dtype in (torch.bfloat16, torch.float32, torch.int8):
                pool, other = _layer_pools(2, n, p, d, dtype, gen)
                k = kpg.paged_gather_cuda(pool, t)
                pl = ref.paged_gather_ref(pool, t)
                exact(f"paged_gather {label} {str(dtype)[6:]} {what}", k, pl)
                _pair_exact(f"{label} {str(dtype)[6:]} {what}", pool, other,
                            t)
                del pool, other
            kq, vq = _layer_pools(2, n, p, d, torch.int8, gen)
            ks, vs = (torch.rand((n, p, 1), generator=gen, device=dev) / 127
                      for _ in range(2))
            _dequant_exact(f"{label} {what}", kq, ks, vq, vs, t)
        if ragged:
            continue
        # times: cycling through 36 layers' pools, as one decode step does
        nl = 36
        pools = _layer_pools(2 * nl, n, p, d, torch.bfloat16, gen)
        rows = r * m * p
        copy = _pair_times(label, tables, pools[::2], pools[1::2], p, d, d)
        del pools
        qpools = _layer_pools(2 * nl, n, p, d, torch.int8, gen)
        scs = [torch.rand((n, p, 1), generator=gen, device=dev) / 127
               for _ in range(2 * nl)]
        layers = [((qpools[2 * i], scs[2 * i]),
                   (qpools[2 * i + 1], scs[2 * i + 1])) for i in range(nl)]
        bf = torch.bfloat16
        one_ms = device_ms(_cycle(lambda a: kpg.paged_gather_dequant_cuda(
            a[0][0], a[0][1], tables, bf), layers))
        kv_ms = device_ms(_cycle(lambda a: kpg.paged_gather_dequant_kv_cuda(
            a[0][0], a[0][1], a[1][0], a[1][1], tables, bf), layers))
        two_ms = device_ms(_cycle(lambda a: [
            kpg.paged_gather_dequant_cuda(q, sc, tables, bf)
            for q, sc in a], layers))
        one_plain = device_ms(_cycle(lambda a: ref.paged_gather_dequant_ref(
            a[0][0], a[0][1], tables, bf), layers))
        kv_plain = device_ms(_cycle(lambda a: [
            ref.paged_gather_dequant_ref(q, sc, tables, bf)
            for q, sc in a], layers))
        del qpools, scs, layers
        # one pool: int8 pages and f32 scales read once, bf16 written once
        one_b, one_by = kernel_bound("gather_dequant", rows, d, 2)
        kv_b, kv_by = kernel_bound("gather_dequant", rows, d, 2, pools=2)
        log(f"    {label} paged_gather_dequant int8->bf16, one pool: kernel "
            f"{one_ms:.5f} ms ({100 * one_b / one_ms:.0f}% of bound)  plain "
            f"{one_plain:.5f} ms  bound {one_b:.5f} ms ({one_by})")
        log(f"    {label} paged_gather_dequant int8->bf16, K and V: one "
            f"launch {kv_ms:.5f} ms ({100 * kv_b / kv_ms:.0f}% of bound)  "
            f"two single launches {two_ms:.5f} ms  plain {kv_plain:.5f} ms  "
            f"bound {kv_b:.5f} ms ({kv_by})")
        records[label] = {
            "paged_gather": copy,
            "paged_gather_dequant": dict(
                err=0.0, ms=kv_ms, plain_ms=kv_plain, library_ms=None,
                bound_ms=kv_b, bound_by=kv_by, one_pool_ms=one_ms,
                one_pool_plain_ms=one_plain, one_pool_bound_ms=one_b,
                two_single_launches_ms=two_ms)}
    _pair_paths(gen)
    _dequant_paths(gen)
    return records


def allclose(name, k, p, rtol, atol):
    """Elementwise |k - p| <= atol + rtol |p| (``tests/test_kernels.py``'s
    ``_tol`` numbers); returns max|k - p|."""
    if k.shape != p.shape:
        raise AssertionError(f"{name}: shape {tuple(k.shape)} != "
                             f"{tuple(p.shape)}")
    k, p = k.float(), p.float()
    if not torch.isfinite(k).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (k - p).abs()
    bad = int((diff > atol + rtol * p.abs()).sum())
    err = diff.max().item() if diff.numel() else 0.0
    if bad:
        raise AssertionError(f"{name}: {bad} elements outside rtol={rtol}, "
                             f"atol={atol} (max|k-p| {err:.3e})")
    return err


def _tol(dtype, epilogue="identity"):
    """``tests/test_kernels.py:_tol``."""
    if dtype == torch.bfloat16:
        if epilogue in ("cos_sin", "exp"):
            return dict(rtol=5e-2, atol=1.5e-1)
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=2e-5, atol=2e-5)


FWHT_TEST = [(1, 8), (4, 64), (16, 128), (5, 512), (300, 32)]
FWHT_REAL = [(8192, 1024), (4096, 16384)]


def _kernel_module(name):
    """A CUDA wrapper module of ``repro_torch.kernels``: the package
    re-exports the ops ``fwht``, ``paged_gather`` and ``srf_decode`` over
    the modules of the same names."""
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


def phase_fwht(gen):
    """ops.fwht at the reference test shapes and at (8192, 1024) and
    (4096, 16384), f32 and bf16, normalized and not, against the plain
    version (``_tol``); then the public op alone at the two real shapes
    (its counted launches); times at (8192, 1024) f32: the kernel, the
    plain version, the bound, and ``x @ H_n`` with the dense normalized
    Hadamard (the one PyTorch call computing the same function)."""
    from repro_torch.core import transforms
    from repro_torch.kernels import ops, ref
    kfwht = _kernel_module("fwht")
    dev, errs, equal, cases = "cuda", [], 0, 0
    for b, n in FWHT_TEST + FWHT_REAL:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, n), generator=gen, device=dev).to(dtype)
            for normalized in (True, False):
                k = kfwht.fwht_cuda(x, normalized)
                p = ref.fwht_ref(x, normalized)
                err = allclose(f"fwht ({b}, {n}) {str(dtype)[6:]} "
                               f"normalized={normalized}", k, p,
                               **_tol(dtype))
                equal += torch.equal(k, p)
                cases += 1
                if (b, n) == FWHT_REAL[0] and dtype == torch.float32 \
                        and normalized:
                    errs.append(err)
    log(f"  fwht: {cases} cases within _tol of the plain version, {equal} "
        f"bit-equal")
    xs = {(b, n, dt): torch.randn((b, n), generator=gen, device=dev).to(dt)
          for b, n in FWHT_REAL for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    ops.reset_counts()
    for x in xs.values():
        ops.fwht(x)
    counts = ops.launch_counts()
    if counts["fwht"] != len(xs) or counts["fwht_plain_on_cuda"]:
        raise AssertionError(f"fwht: the public op at the real shapes "
                             f"launched {counts}")
    b, n = FWHT_REAL[0]
    x = xs[(b, n, torch.float32)]
    h = transforms.hadamard(n, device=dev)
    k_ms = device_ms(lambda: kfwht.fwht_cuda(x))
    p_ms = device_ms(lambda: ref.fwht_ref(x), launches=20, repeats=3)
    lib_ms = device_ms(lambda: x @ h)
    b_ms, b_by = kernel_bound("fwht", b, n, 4)
    big = xs[(*FWHT_REAL[1], torch.float32)]
    big_ms = device_ms(lambda: kfwht.fwht_cuda(big), launches=20)
    big_b, _ = bound(2 * 4 * big.numel(), 0)
    log(f"    ({b}, {n}) f32: kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
        f"x @ H_n {lib_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by}); "
        f"{FWHT_REAL[1]} f32: kernel {big_ms:.4f} ms  bound {big_b:.5f} ms")
    return dict(err=max(errs), ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, launches=counts["fwht"])


CIRC_TEST = [(1, 16, 4, 16), (2, 32, 8, 48), (4, 64, 16, 256),
             (1, 128, 300, 128), (2, 256, 7, 512)]
CIRC_REAL = (4, 1024, 8192, 4096)      # g (4, 1024), x (8192, 1024), m
STEP_EPS = 1e-3                        # |y| below it: a step may flip


def _circ_inputs(nb, n, b, dtype, gen, unit=False):
    dev = "cuda"
    g = torch.randn((nb, n), generator=gen, device=dev).to(dtype)
    x = torch.randn((b, n), generator=gen, device=dev)
    x = x / x.norm(dim=-1, keepdim=True) if unit else x * 0.3
    x = x.to(dtype)
    return g, x, 0.5 * (x.float() ** 2).sum(-1)


def phase_circulant(gen):
    """ops.circulant_project at the five reference test shapes and the real
    shape (g (4, 1024), unit-norm x (8192, 1024), m = 4096), every
    epilogue, f32 and bf16, against the plain version (``_tol``; exp in
    log space; heaviside where |y| of the plain version exceeds
    STEP_EPS, the sign flips below it counted); then the public op
    alone at the real shape, every epilogue and dtype (its counted
    launches); times at the real shape, identity, f32 and bf16: the
    kernel, the bound, and ``x @ A.T`` on the plain version's own
    materialized A in the same dtype; the plain version in f32."""
    from repro_torch.kernels import circulant as kcirc, ops, ref
    flips, near, cases, errs = 0, 0, 0, []
    for nb, n, b, m in CIRC_TEST + [CIRC_REAL]:
        real = (nb, n, b, m) == CIRC_REAL
        for dtype in (torch.float32, torch.bfloat16):
            g, x, sq = _circ_inputs(nb, n, b, dtype, gen, unit=real)
            y = ref.circulant_project_ref(g, x, m).float()
            for epi in kcirc.EPILOGUES:
                k = kcirc.circulant_project_cuda(g, x, m, epi, sq).float()
                p = ref.circulant_project_ref(g, x, m, epi, sq).float()
                name = (f"circulant ({nb}, {n}, {b}, {m}) {epi} "
                        f"{str(dtype)[6:]}")
                if epi == "exp":
                    k, p = k.log(), p.log()
                if epi == "heaviside":
                    close = y.abs() <= STEP_EPS
                    near += int(close.sum())
                    flips += int((k != p)[close].sum())
                    k, p = k[~close], p[~close]
                err = allclose(name, k, p, **_tol(dtype, epi))
                if real and dtype == torch.float32 and epi == "identity":
                    errs.append(err)
                cases += 1
    log(f"  circulant: {cases} cases within _tol of the plain version; "
        f"heaviside: {flips} sign flips among {near} outputs with "
        f"|y| <= {STEP_EPS}")
    nb, n, b, m = CIRC_REAL
    ins = {dt: _circ_inputs(nb, n, b, dt, gen, unit=True)
           for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    ops.reset_counts()
    for g, x, sq in ins.values():
        for epi in kcirc.EPILOGUES:
            ops.circulant_project(g, x, m, epi, sq)
    counts = ops.launch_counts()
    if counts["circulant_project"] != 2 * len(kcirc.EPILOGUES):
        raise AssertionError(f"circulant: the public op at the real shape "
                             f"launched {counts}")
    times = {}
    for dt, passes in ((torch.float32, 3), (torch.bfloat16, 1)):
        g, x, _ = ins[dt]
        a = ref.circulant_matrix(g, m)
        k_ms = device_ms(lambda: kcirc.circulant_project_cuda(g, x, m),
                         launches=10, repeats=3)
        lib_ms = device_ms(lambda: x @ a.T, launches=10, repeats=3)
        size = x.element_size()
        b_ms, b_by = kernel_bound("circulant", b, n, nb, m, size, m)
        times[dt] = (k_ms, lib_ms, b_ms, b_by)
        log(f"    real shape {str(dt)[6:]} identity: kernel {k_ms:.4f} ms  "
            f"x @ A.T {lib_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by}); the "
            f"kernel's {passes} x {2 * b * m * n / 1e9:.1f} GFLOP of "
            f"tensor-core products at "
            f"{passes * 2 * b * m * n / k_ms / 1e9:.1f} TFLOP/s")
    g, x, _ = ins[torch.float32]
    p_ms = device_ms(lambda: ref.circulant_project_ref(g, x, m),
                     launches=10, repeats=3)
    k_ms, lib_ms, b_ms, b_by = times[torch.float32]
    log(f"    real shape f32 identity: plain {p_ms:.4f} ms; kernel "
        f"{'below' if k_ms < lib_ms else 'NOT below'} x @ A.T")
    return dict(err=max(errs), ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by,
                launches=counts["circulant_project"])


# ---------------------------------------------------------------------------
# phase 3: the kernel-estimation library
# ---------------------------------------------------------------------------

FNAMES = ("identity", "heaviside", "sign", "relu", "trig", "softmax")
STEP_F = {"heaviside": 1.0, "sign": 2.0}   # the most one flip moves a term


class plain_route:
    """Inside: every spinner call on the card takes the dispatcher's plain
    version (its written rule, ``kernel_takes``, forced false). The
    plain calls made inside are not counted, and no kernel launches."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved = (ops.kernel_takes, ops.spinner_project.plain_calls,
                      ops.launch_counts()["spinner"])
        ops.kernel_takes = lambda *a, **k: False

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.kernel_takes, ops.spinner_project.plain_calls, launched = \
            self.saved
        if ops.launch_counts()["spinner"] != launched:
            raise AssertionError("the plain route launched the kernel")


def _near_step(pipe, params, v):
    """Per row: how many of the last block's projections lie within
    1e-4 of the largest of them (f32 summation-order noise), where a
    step f may flip between the kernel and the plain version."""
    y = pipe.with_f("identity").apply(params, v)
    return (y.abs() <= 1e-4 * y.abs().max()).sum(-1)


def phase_estimators(gen):
    """The paper's kernel estimates (``core.estimators.estimate``) of
    N = 8192 pairs of unit vectors of width n = 1024 with features of
    width m = 4096, through spinner.single and spinner.hd_chain (depth
    3) circulant pipelines, f in FNAMES: the card route (spinner kernel)
    against the plain route on the same params (1e-4 of the largest
    plain estimate; step f also within the terms that may flip); mean
    |estimate - exact| per f, which must fall from m = 256 to m = 4096.
    Then ``mc_error`` for the sweep of examples/kernel_approx.py (n=128;
    unstructured, circulant, toeplitz, ldr; heaviside and trig; m 16 ...
    1024; 32 trials): the error at m = 1024 below m = 16 everywhere."""
    from repro_torch.core import estimators, spinner
    from repro_torch.kernels import ops
    dev = "cuda"
    N, n = 8192, 1024
    v = torch.randn((2, N, n), generator=gen, device=dev)
    v1, v2 = v / v.norm(dim=-1, keepdim=True)
    closed = {f: estimators.exact(f, v1, v2) for f in FNAMES}
    errs, worst, times = {}, 0.0, {}
    ops.reset_counts()
    for build in ("single", "hd_chain"):
        for m in (256, 4096):
            kw = dict(m=m, n=n) if build == "single" else \
                dict(n=n, m=m, depth=3)
            pipe = getattr(spinner, build)("circulant", **kw)
            params = pipe.init(gen)
            for f in FNAMES:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                est = estimators.estimate(pipe, params, f, v1, v2)
                torch.cuda.synchronize()
                t_card = time.perf_counter() - t0
                errs[(build, m, f)] = (est - closed[f]).abs().mean().item()
                if m != 4096:
                    continue
                with plain_route():
                    t0 = time.perf_counter()
                    plain = estimators.estimate(pipe, params, f, v1, v2)
                    torch.cuda.synchronize()
                    t_plain = time.perf_counter() - t0
                limit = 1e-4 * plain.abs().max().item()
                if f in STEP_F:
                    limit = limit + STEP_F[f] / m * (
                        _near_step(pipe, params, v1)
                        + _near_step(pipe, params, v2)).float()
                diff = (est - plain).abs()
                if not torch.isfinite(est).all() or (diff > limit).any():
                    raise AssertionError(
                        f"estimate {build} m={m} {f}: card route differs "
                        f"from the plain route by {diff.max().item():.3e}")
                worst = max(worst, diff.max().item())
                if build == "single":
                    times[f] = (t_card, t_plain)
                log(f"  estimate {build} m={m} {f}: mean|est-exact| "
                    f"{errs[(build, m, f)]:.5f} (m=256: "
                    f"{errs[(build, 256, f)]:.5f}); card {1e3 * t_card:.1f} "
                    f"ms, plain route {1e3 * t_plain:.1f} ms (host clock)")
    counts = ops.launch_counts()
    log(f"    launches (card routes): {counts}; max|card - plain| "
        f"{worst:.3e}")
    faster = [f for f in FNAMES if times[f][0] < times[f][1]]
    log(f"    spinner.single m=4096: the card route faster than the plain "
        f"route for {len(faster)} of {len(FNAMES)} f ({', '.join(faster)})")
    if counts["spinner"] <= 0 or counts["spinner_plain_on_cuda"]:
        raise AssertionError(f"estimators: spinner launches {counts}")
    for build in ("single", "hd_chain"):
        for f in FNAMES:
            if not errs[(build, 4096, f)] < errs[(build, 256, f)]:
                raise AssertionError(f"estimate {build} {f}: the error did "
                                     f"not fall from m=256 to m=4096")

    n = 128
    w = torch.randn((2, n), generator=gen, device=dev)
    w1, w2 = w / w.norm(dim=-1, keepdim=True)
    ops.reset_counts()
    log("    mc_error (kind, f, m, mean, std):")
    for kind in ("unstructured", "circulant", "toeplitz", "ldr"):
        for f in ("heaviside", "trig"):
            row = {}
            for m in (16, 64, 256, 1024):
                g = torch.Generator(device=dev).manual_seed(5)
                mean, std = estimators.mc_error(
                    g, spinner.single(kind, m=m, n=n, r=2), f, w1, w2,
                    n_trials=32)
                row[m] = (mean.item(), std.item())
            log(f"      {kind},{f}: " + "  ".join(
                f"m={m} {a:.5f}/{b:.5f}" for m, (a, b) in row.items()))
            if not row[1024][0] < row[16][0]:
                raise AssertionError(f"mc_error {kind} {f}: the error did "
                                     f"not fall from m=16 to m=1024")
    counts = ops.launch_counts()
    log(f"    mc_error launches: {counts} (ldr by the plain rule)")
    if counts["spinner"] <= 0 or \
            counts["spinner_plain_on_cuda"] != 2 * 4 * 32 * 2:
        raise AssertionError(f"mc_error: launches {counts}")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def serve_args(attn=None, arch="qwen3-4b", **kw):
    """The serve CLI's arguments: ``arch``, ``--attn`` only if given (the
    config's own ``full`` otherwise), then ``kw`` as flags."""
    from repro_torch.launch import serve
    argv = ["--arch", arch] + (["--attn", attn] if attn else [])
    for k, v in kw.items():
        if v is False:
            continue
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return serve.parser().parse_args(argv)


# reduced card-vs-CPU agreement: (label, attn, dtype, --quantize-kv)
REDUCED = [("srf", "srf", "float32", False),
           ("full-KV bf16 pages", "full", "bfloat16", False),
           ("full-KV int8 pages", "full", "float32", True)]


def phase_reduced_agreement():
    """Reduced qwen3-4b served on the card and on the CPU (plain
    versions), with SRF state, bf16 KV pages and int8 KV pages: the
    greedy tokens must be equal."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as model_lib
    for label, attn, dtype, quant in REDUCED:
        cfg = registry.reduced("qwen3-4b", attn_impl=attn, dtype=dtype)
        params = model_lib.init(cfg, seed=3, device="cpu")
        out = {}
        for device in ("cpu", "cuda"):
            args = serve_args(attn, reduced=True, requests=8, prompt_len=24,
                              max_new=6, slots=4, max_len=64, seed=3,
                              device=device, quantize_kv=quant)
            ops.reset_counts()
            res = serve.serve(args, cfg, _to(params, device))
            out[device] = {r.uid: r.out_tokens for r in res["done"]}
        if out["cpu"] != out["cuda"] or len(out["cuda"]) != 8:
            raise AssertionError(f"reduced {label}: greedy tokens differ "
                                 f"between card and CPU: {out}")
        counts = ops.launch_counts()
        if quant and (counts["paged_gather_dequant_kv"] == 0
                      or counts["paged_gather_dequant"]):
            raise AssertionError(f"reduced {label}: int8 pages not gathered "
                                 f"by paged_gather_dequant_kv alone: "
                                 f"{counts}")
        log(f"  reduced qwen3-4b {label}: card tokens == CPU tokens "
            f"({sum(len(t) for t in out['cuda'].values())} tokens)")


def _seeded(cfg):
    """``cfg`` with seeded SRF projections (one seed per layer and kv
    head), as the reference's tests build it: ``registry.reduced``
    rebuilds ``srf`` and would drop the flag."""
    return dataclasses.replace(cfg, srf=dataclasses.replace(cfg.srf,
                                                            seeded=True))


def _personalize(reqs):
    """embed_seed 0 for uids 0-3, a distinct non-zero seed for uids 4-7
    (2**32 - 1 among them); odd uids sampled (temperature 0.8, top_k 40,
    top_p 0.95), even uids greedy."""
    for r in reqs:
        r.embed_seed = 0 if r.uid < 4 else (2 ** 32 - 1 if r.uid == 7
                                            else 1000 + r.uid)
        if r.uid % 2:
            r.temperature, r.top_k, r.top_p = 0.8, 40, 0.95
    return reqs


def phase_reduced_seeded_agreement():
    """Reduced seeded-SRF qwen3-4b with mixed embed seeds and mixed greedy
    / sampled requests (engine seed 3), on the card and on the CPU: the
    tokens must be equal."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer as model_lib
    cfg = _seeded(registry.reduced("qwen3-4b", attn_impl="srf",
                                   dtype="float32"))
    params = model_lib.init(cfg, seed=3, device="cpu")
    out = {}
    for device in ("cpu", "cuda"):
        args = serve_args("srf", reduced=True, requests=8, prompt_len=24,
                          max_new=6, slots=4, max_len=64, seed=3,
                          device=device)
        res = serve.serve(args, cfg, _to(params, device),
                          reqs=_personalize(serve.requests(args, cfg)))
        out[device] = {r.uid: r.out_tokens for r in res["done"]}
    if out["cpu"] != out["cuda"] or len(out["cuda"]) != 8:
        raise AssertionError(f"reduced seeded SRF: tokens differ between "
                             f"card and CPU: {out}")
    log(f"  reduced qwen3-4b seeded SRF, mixed embed seeds, greedy + "
        f"sampled: card tokens == CPU tokens "
        f"({sum(len(t) for t in out['cuda'].values())} tokens)")


def _to(tree, device, copy=False):
    if isinstance(tree, dict):
        return {k: _to(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device, copy) for v in tree)
    return tree.to(device, copy=copy)


SHARED = 96                       # prompt tokens the prefix run shares
TRAFFIC = dict(requests=8, prompt_len=128, max_new=32, slots=8,
               max_len=256, seed=0, device="cuda")


def _check_serve(label, res, args, counts, expect):
    """Every request finished with max_new tokens, every logit row is
    finite, and the launches are as ``_expect_launches`` says."""
    eng = res["engine"]
    bad = [r.uid for r in res["done"] if len(r.out_tokens) != args.max_new]
    if len(res["done"]) != args.requests or bad:
        raise AssertionError(f"{label}: requests not finished with "
                             f"{args.max_new} tokens: {bad}")
    if eng.nonfinite_rows:
        raise AssertionError(f"{label}: {eng.nonfinite_rows} logit rows "
                             f"not finite")
    _expect_launches(label, counts, expect)


def _expect_launches(label, counts, expect):
    """Each kernel of ``expect`` launched exactly or at least as often as
    it says ({name: (n, exact)}); every other gather, fwht,
    circulant_project and the seeded spinner (kernel and plain route) 0,
    and the spinner's plain route never."""
    for name in ("paged_gather", "paged_gather_kv", "paged_gather_dequant",
                 "paged_gather_dequant_kv", "spinner_seeded",
                 "spinner_seeded_plain_on_cuda", "fwht", "fwht_plain_on_cuda",
                 "circulant_project"):
        expect.setdefault(name, (0, True))
    for name, (n, is_exact) in expect.items():
        got = counts[name]
        if (got != n) if is_exact else (got < n):
            raise AssertionError(f"{label}: {name} launched {got} times, "
                                 f"expected {'' if is_exact else '>= '}{n}")
    if counts["spinner_plain_on_cuda"]:
        raise AssertionError(f"{label}: spinner calls on the card took the "
                             f"plain version")


def _serve_line(label, res, steps, peak):
    eng = res["engine"]
    log(f"  {label}: served {len(res['done'])} requests, {res['tokens']} "
        f"tokens in {res['wall_s']:.3f} s: {res['tok_s']:.1f} tok/s, TTFT "
        f"p50 {res['ttft_s']['p50']:.4f} s, {eng.stats['prefill_steps']} "
        f"prefill + {eng.stats['decode_steps']} decode steps ({steps} in "
        f"the counted run), peak memory {peak:.2f} GiB")


def _steps(eng):
    return int(eng.stats["prefill_steps"] + eng.stats["decode_steps"])


def _describe(cfg, params, t0):
    n_params = sum(t.numel() for t in _leaves(params))
    attn = "" if cfg.family == "ssm" else (
        f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of {cfg.head_dim}, "
        f"attention {cfg.attn_impl}, ")
    ssd = (f"{cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, state "
           f"{cfg.ssm_state}, " if cfg.family in ("ssm", "hybrid") else "")
    log(f"  full-width {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {attn}{ssd}{cfg.dtype}, {n_params / 1e9:.3f} B "
        f"params; init {time.perf_counter() - t0:.1f} s")


def phase_serve_kv():
    """Full-width qwen3-4b with its default full attention: bf16 KV
    pages, int8 KV pages, and the prefix cache (a cold wave of 8 prompts
    sharing their first 96 tokens, then the same 8 prompts warm, in one
    engine). Returns {run: launch counts}."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve_args(**TRAFFIC)
    t0 = time.perf_counter()
    cfg, params = serve.build(args)
    torch.cuda.synchronize()
    _describe(cfg, params, t0)
    per_step = cfg.n_layers
    out = {}
    # bf16 pages: one paged_gather_kv launch a layer for K and V (36 a
    # step); int8 pages: one paged_gather_dequant_kv launch a layer
    for label, flags in (("bf16 pages", {}),
                         ("int8 pages", {"quantize_kv": True})):
        a = serve_args(**TRAFFIC, **flags)
        serve.warm(a, cfg, params)
        res = None                # free the previous run's engine first
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        res = serve.serve(a, cfg, params)
        counts = ops.launch_counts()
        steps = _steps(res["engine"])
        _serve_line(label, res, steps,
                    torch.cuda.max_memory_allocated() / 2 ** 30)
        log(f"    launches: {counts}")
        gathers = {("paged_gather_dequant_kv" if a.quantize_kv else
                     "paged_gather_kv"): (per_step * steps, True)}
        _check_serve(label, res, a, counts, {
            **gathers, "spinner": (0, True), "srf_decode": (0, True)})
        out[label] = counts

    a = serve_args(**TRAFFIC, prefix_cache=True, shared_prefix=SHARED)
    serve.warm(a, cfg, params)
    res = None
    gc.collect()
    eng = serve.engine(a, cfg, params)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    cold = serve.serve(a, eng=eng)
    warm = serve.serve(a, eng=eng)
    counts = ops.launch_counts()
    steps = _steps(eng)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _serve_line("prefix cache, cold + warm wave", warm, steps, peak)
    log(f"    cold wave {cold['tok_s']:.1f} tok/s, TTFT p50 "
        f"{cold['ttft_s']['p50']:.4f} s; warm wave {warm['tok_s']:.1f} "
        f"tok/s, TTFT p50 {warm['ttft_s']['p50']:.4f} s")
    log(f"    launches: {counts}")
    for res in (cold, warm):
        _check_serve("prefix cache", res, a, counts, {
            "paged_gather_kv": (per_step * steps, True),
            "spinner": (0, True), "srf_decode": (0, True)})
    v = eng.metrics.value_sum
    stats = {c: int(v(c)) for c in (
        "prefix_lookups_total", "prefix_hits_total",
        "prefix_hit_tokens_total", "prefix_cow_forks_total",
        "prefix_evictions_total", "engine_prefill_tokens_total")}
    same = sum(a_.out_tokens == b_.out_tokens for a_, b_ in zip(
        sorted(cold["done"], key=lambda r: r.uid),
        sorted(warm["done"], key=lambda r: r.uid)))
    log(f"    prefix counters: {stats}")
    log(f"    greedy agreement warm vs cold: {same} of {a.requests} "
        f"requests with identical tokens (not asserted: bf16 matmuls on "
        f"other chunk shapes may flip near-ties)")
    if stats["prefix_hit_tokens_total"] <= 0:
        raise AssertionError("prefix cache: no prompt token was served "
                             "from the cache")
    alloc = eng.sched.alloc
    if alloc.used_pages != eng.prefix.pages or \
            alloc.total_refs != eng.prefix.pages:
        raise AssertionError(f"prefix cache: pages leaked: used "
                             f"{alloc.used_pages}, refs {alloc.total_refs}, "
                             f"cache {eng.prefix.pages}")
    eng.prefix.drop_all()
    if alloc.used_pages or alloc.total_refs:
        raise AssertionError("prefix cache: pages left after drop_all")
    out["prefix cache"] = counts
    return out


class count_probes:
    """Counts the live quality probe's calls inside the block (the
    engine looks the probe up in ``obs.quality`` at each call), and the
    spinner launches they make (``spinner``)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.obs import quality
        self.calls, self.probe, self.spinner = 0, quality.srf_quality_probe, 0

        def probe(*a, **k):
            self.calls += 1
            before = ops.launch_counts()["spinner"]
            out = self.probe(*a, **k)
            self.spinner += ops.launch_counts()["spinner"] - before
            return out
        quality.srf_quality_probe = probe
        return self

    def __exit__(self, *exc):
        from repro_torch.obs import quality
        quality.srf_quality_probe = self.probe


def _check_probe(label, res, probes):
    """Exactly one probe sample in the run (the engine primes it for the
    first decode step; quality_every = 64 > 31 decode steps), both stats
    finite and under DRIFT_TOL in the engine's srf_quality gauge, no
    quality_drift event; prints the probe's host time, sync included."""
    from repro_torch.obs import quality
    eng = res["engine"]
    gauge = eng.metrics.snapshot()["gauges"].get("srf_quality", {})
    stats = {k.split('stat="')[1].rstrip('"'): v for k, v in gauge.items()}
    drift = [e for e in eng.metrics.events if e["event"] == "quality_drift"]
    if probes.calls != 1 or set(stats) != {"srf_row_mean_abs_max",
                                           "srf_row_var_err_max"}:
        raise AssertionError(f"{label}: {probes.calls} quality samples, "
                             f"gauge {stats}")
    if drift or not all(math.isfinite(v) and v < quality.DRIFT_TOL
                        for v in stats.values()):
        raise AssertionError(f"{label}: quality drifted: {stats}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quality.srf_quality_probe(eng.cfg, eng.params)
    ms = 1e3 * (time.perf_counter() - t0)
    log(f"    quality probe: 1 sample, {stats}, no drift; one probe "
        f"{ms:.2f} ms (host clock)")


def phase_serve_srf():
    """Full-width qwen3-4b with SRF attention, as in the first slice: the
    spinner and srf_decode kernels launch at least 72 per step and 36 per
    decode step, the gathers never."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve_args("srf", **TRAFFIC)
    t0 = time.perf_counter()
    cfg, params = serve.build(args)
    torch.cuda.synchronize()
    _describe(cfg, params, t0)
    serve.warm(args, cfg, params)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    with count_probes() as probes:
        res = serve.serve(args, cfg, params)
    counts = ops.launch_counts()
    eng = res["engine"]
    steps, dsteps = _steps(eng), int(eng.stats["decode_steps"])
    _serve_line("SRF", res, steps, torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"    launches: {counts}")
    _check_serve("SRF", res, args, counts, {
        "spinner": (2 * cfg.n_layers * steps, False),
        "srf_decode": (cfg.n_layers * dsteps, False)})
    _check_probe("SRF", res, probes)
    return counts


def phase_serve_seeded():
    """Full-width qwen3-4b with seeded SRF attention: per-request embed
    seeds and mixed greedy / sampled requests in one batch. The seeded
    spinner launches at least 72 per step, srf_decode exactly 36 per
    decode step, the materialized spinner, the seeded plain route and
    the gathers never."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as model_lib
    args = serve_args("srf", **TRAFFIC)
    cfg = _seeded(registry.get("qwen3-4b", attn_impl="srf"))
    t0 = time.perf_counter()
    params = model_lib.init(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    _describe(cfg, params, t0)
    serve.warm(args, cfg, params)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    with count_probes() as probes:
        res = serve.serve(args, cfg, params,
                          reqs=_personalize(serve.requests(args, cfg)))
    counts = ops.launch_counts()
    eng = res["engine"]
    steps, dsteps = _steps(eng), int(eng.stats["decode_steps"])
    _serve_line("seeded SRF", res, steps,
                torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"    launches: {counts}")
    _check_serve("seeded SRF", res, args, counts, {
        "spinner_seeded": (2 * cfg.n_layers * steps, False),
        "srf_decode": (cfg.n_layers * dsteps, True), "spinner": (0, True),
        "spinner_seeded_plain_on_cuda": (0, True)})
    _check_probe("seeded SRF", res, probes)
    seeded_bytes = sum(t.numel() * t.element_size() for blk in
                       params["segments"][0]["attn"]["srf"]
                       for t in blk.values())
    pipe = _unseeded_pipeline(cfg)
    mat_bytes = (cfg.n_layers * cfg.n_kv_heads * pipe.storage
                 * torch.finfo(model_lib.dtype_of(cfg)).bits // 8)
    log(f"    SRF projection bytes: seeded {seeded_bytes} (one int64 seed "
        f"per layer and kv head) against {mat_bytes} materialized "
        f"({pipe.storage} {cfg.dtype} values per head)")
    sampled = [r.uid for r in res["done"] if r.temperature > 0]
    log(f"    sampled requests {sampled}, embed seeds "
        f"{[r.embed_seed for r in sorted(res['done'], key=lambda r: r.uid)]}")
    return counts


# ---------------------------------------------------------------------------
# phase 4 (continued): the legacy per-slot engine
# ---------------------------------------------------------------------------

def _legacy_module():
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving import legacy
    return legacy


# reduced legacy cells: (label, config overrides, seeded SRF)
LEGACY_REDUCED = [("full KV", {}, False),
                  ("int8 KV cache", {"kv_cache_dtype": "int8"}, False),
                  ("SRF", {"attn_impl": "srf"}, False),
                  ("seeded SRF", {"attn_impl": "srf"}, True)]


def _mixed_requests(cfg, temperature):
    """8 mixed-length requests (tests/test_engine_parity.py's recipe: an
    enc-dec request's own features drawn before its prompt)."""
    from repro_torch.models import frontends
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    out = []
    for i in range(8):
        enc = (frontends.synthetic_audio_features(rng, cfg)
               if cfg.is_encdec else None)
        out.append(Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(
            rng.integers(2, 20))).astype(np.int32),
            max_new=int(rng.integers(3, 7)), temperature=temperature,
            enc_emb=enc))
    return out


def _drive(eng, reqs):
    """Submit ``reqs`` and run ``eng`` dry: {uid: tokens}."""
    for r in reqs:
        eng.submit(r)
    return {r.uid: r.out_tokens for r in eng.run()}


def phase_reduced_legacy():
    """Reduced qwen3-4b (f32, 2 layers) through the legacy engine, with
    full KV, an int8 KV cache, SRF and seeded SRF, greedy and sampled
    (temperature 0.8): its tokens on the card equal its tokens on the
    CPU; and on the card the paged engine gives the legacy engine's
    tokens (int8: int8 pages against the int8 cache, greedy only; the
    two quantize per token and per token and head, and sampled streams
    part in the reference too). Counts reset before each card run: the
    SRF cells must launch their spinner kernel and no plain route."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as model_lib
    from repro_torch.serving import Engine, PagedConfig
    legacy = _legacy_module()
    for label, over, seeded in LEGACY_REDUCED:
        cfg = registry.reduced("qwen3-4b", n_layers=2, **over)
        if seeded:
            cfg = _seeded(cfg)
        cpu = model_lib.init(cfg, seed=3, device="cpu")
        card = _to(cpu, "cuda")
        for t in (0.0, 0.8):
            kind = "sampled" if t else "greedy"
            want = _drive(legacy.Engine(cfg, cpu, batch_slots=4,
                                        max_len=64, seed=5, device="cpu"),
                          _mixed_requests(cfg, t))
            ops.reset_counts()
            got = _drive(legacy.Engine(cfg, card, batch_slots=4,
                                       max_len=64, seed=5, device="cuda"),
                         _mixed_requests(cfg, t))
            counts = ops.launch_counts()
            if got != want or len(got) != 8:
                raise AssertionError(f"reduced legacy {label} {kind}: card "
                                     f"tokens {got} != CPU {want}")
            key = "spinner_seeded" if seeded else "spinner"
            if "attn_impl" in over and (
                    counts[key] == 0 or counts["spinner_plain_on_cuda"]
                    or counts["spinner_seeded_plain_on_cuda"]):
                raise AssertionError(f"reduced legacy {label}: launches "
                                     f"{counts}")
            line = (f"  reduced legacy {label} {kind}: card tokens == CPU "
                    f"tokens ({sum(map(len, got.values()))} tokens)")
            if label == "int8 KV cache" and t > 0:
                log(line + "; paged not compared (per-token against "
                    "per-head quantization)")
                continue
            quant = PagedConfig(quantize_kv="kv_cache_dtype" in over)
            paged = _drive(Engine(cfg, card, batch_slots=4, max_len=64,
                                  seed=5, device="cuda", paged=quant),
                           _mixed_requests(cfg, t))
            if paged != got:
                diverge = {u: next((i for i, (a, b) in enumerate(zip(
                    paged[u], got[u])) if a != b), None) for u in got
                    if paged.get(u) != got[u]}
                raise AssertionError(f"reduced {label} {kind}: paged != "
                                     f"legacy on the card; first divergent "
                                     f"token by uid {diverge}")
            log(line + "; paged == legacy on the card")


LEGACY_TRAFFIC = dict(requests=8, prompt_len=128, max_new=16, slots=4,
                      max_len=256, seed=0, device="cuda")
# first-token logits, as a share of the row's largest |logit|, between
# the two bf16 engines: bf16 rounds 2^-9 a step through 36 layers of one
# 128-token prefill (legacy) against 8 or 4 chunks (paged); SRF's exp
# features span decades and its normalizer divides their sums, so its
# rounding travels further (a first card run: 0.070 between the engines,
# where full KV gave under 1e-5).
FIRST_LOGIT_TOL = {"full": 2e-2, "srf": 1.5e-1}
# each bf16 engine against the same prefill of an f32 copy of the
# weights: bf16's own distance from f32 (card: 0.0195 full KV, 0.115 and
# 0.120 SRF), bounded to catch a broken engine (an O(1) error), not to
# grade agreement, which the limit above does
F32_ANCHOR_TOL = {"full": 5e-2, "srf": 2.5e-1}


class first_logits:
    """Records each request's first-token logits (f32, on the host) from
    an engine's sampling call: the legacy engine's ``_pick`` or the paged
    engine's ``_sample_rows``, wrapped on the instance."""

    def __init__(self, eng):
        self.rows = {}
        if hasattr(eng, "_pick"):
            pick = eng._pick

            def wrapped(req, logits):
                if not req.out_tokens:
                    self.rows[req.uid] = logits.float().cpu()
                return pick(req, logits)
            eng._pick = wrapped
        else:
            sample = eng._sample_rows

            def wrapped(rows, seqs):
                for i, s in enumerate(seqs):
                    if s is not None and not s.req.out_tokens:
                        self.rows[s.req.uid] = rows[i].float().cpu()
                return sample(rows, seqs)
            eng._sample_rows = wrapped


def phase_serve_legacy():
    """Full-width qwen3-4b (bf16) cut to ``CUT_LAYERS`` (12) of its 36
    layers through the legacy engine, 8
    greedy requests (prompt 128, 16 new tokens, 4 slots, max_len 256),
    with full KV and then SRF; then the paged engine on the same
    requests and params. Every request finishes with 16 tokens and every
    logit row is finite; full KV launches no kernel, SRF the spinner at
    least 2 per layer and model call, its plain route never; first-token
    logits of the two engines agree within FIRST_LOGIT_TOL of each row's
    largest; tok/s, TTFT p50 and the share of equal generated tokens
    printed. Returns {attn: {"legacy": result, "paged": result}}."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    out = {}
    for attn in ("full", "srf"):
        largs = serve_args(attn, legacy=True, **LEGACY_TRAFFIC)
        pargs = serve_args(attn, **LEGACY_TRAFFIC)
        cfg, params = _build(largs)
        res, firsts = {}, {}
        for label, a in (("legacy", largs), ("paged", pargs)):
            serve.warm(a, cfg, params)
            eng = serve.engine(a, cfg, params)
            rec = first_logits(eng)
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_counts()
            r = serve.serve(a, eng=eng)
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            bad = [q.uid for q in r["done"] if len(q.out_tokens) != 16]
            if len(r["done"]) != 8 or bad or eng.nonfinite_rows:
                raise AssertionError(f"{attn} {label}: unfinished {bad} or "
                                     f"{eng.nonfinite_rows} non-finite rows")
            log(f"  {attn} {label}: {len(r['done'])} requests, "
                f"{r['tokens']} tokens in {r['wall_s']:.3f} s: "
                f"{r['tok_s']:.2f} tok/s, TTFT p50 "
                f"{r['ttft_s']['p50']:.4f} s, peak {peak:.2f} GiB")
            log(f"    launches: {counts}")
            if label == "legacy":
                calls = len(r["done"]) + sum(len(q.out_tokens) - 1
                                             for q in r["done"])
                if attn == "srf":
                    need = 2 * cfg.n_layers * calls
                    if counts["spinner"] < need or \
                            counts["spinner_plain_on_cuda"]:
                        raise AssertionError(
                            f"legacy SRF: spinner {counts['spinner']} < "
                            f"{need} ({calls} model calls) or plain calls")
                elif any(counts.values()):
                    raise AssertionError(f"legacy full KV launched a "
                                         f"kernel: {counts}")
                r["model_calls"] = calls
            r["counts"] = counts
            res[label], firsts[label] = r, rec.rows
        f32 = _f32_first_logits(cfg, params, largs)
        tols = {"legacy-paged": FIRST_LOGIT_TOL[attn],
                "legacy-f32": F32_ANCHOR_TOL[attn],
                "paged-f32": F32_ANCHOR_TOL[attn]}
        worst = dict.fromkeys(tols, 0.0)
        for uid, row in firsts["legacy"].items():
            pairs = {"legacy-paged": (row, firsts["paged"][uid]),
                     "legacy-f32": (f32[uid], row),
                     "paged-f32": (f32[uid], firsts["paged"][uid])}
            for k, (a, b) in pairs.items():
                rel = float((a - b).abs().max() / a.abs().max())
                worst[k] = max(worst[k], rel)
                if not rel <= tols[k]:
                    raise AssertionError(
                        f"{attn}: request {uid} first-token logits "
                        f"{k} differ by {rel:.4f} of the largest, above "
                        f"{tols[k]}")
        toks = {k: {q.uid: q.out_tokens for q in v["done"]}
                for k, v in res.items()}
        same = sum(a == b for u in toks["legacy"] for a, b in
                   zip(toks["legacy"][u], toks["paged"][u]))
        total = sum(map(len, toks["legacy"].values()))
        first_same = sum(toks["legacy"][u][0] == toks["paged"][u][0]
                         for u in toks["legacy"])
        log(f"    first-token logits, worst share of the row's largest "
            f"|logit|: " + ", ".join(
                f"{k} {v:.3e} (limit {tols[k]})" for k, v in worst.items())
            + "; "
            f"first tokens equal {first_same}/8; generated tokens equal "
            f"position by position {same}/{total} ({same / total:.3f})")
        res["agreement"] = same / total
        res["first_logit_worst"] = worst
        out[attn] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _f32_first_logits(cfg, params, args):
    """{uid: first-token logits (f32, host)} of each of ``args``'
    requests through ``transformer.prefill`` (batch 1, the legacy
    engine's call) on an f32 copy of the weights."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as model_lib
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _to_dtype(params, torch.float32)
    out = {}
    for r in serve.requests(args, cfg):
        cache = model_lib.init_serve_cache(cfg32, 1, args.max_len,
                                           device="cuda")
        batch = {"tokens": torch.as_tensor(r.prompt[None], device="cuda")}
        if r.enc_emb is not None:
            batch["enc_emb"] = torch.as_tensor(r.enc_emb[None],
                                               device="cuda")
        logits, _ = model_lib.prefill(p32, cfg32, batch, cache)
        out[r.uid] = logits[0, -1, :cfg.vocab].float().cpu()
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _to_dtype(tree, dtype):
    """Float leaves cast to ``dtype`` (integer leaves, seeds, kept)."""
    if isinstance(tree, dict):
        return {k: _to_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_dtype(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# phase 4 (continued): the request router and fault-tolerant serving
# ---------------------------------------------------------------------------

KINDS = ("raise", "hang", "reject", "oom")
# reduced router cells: (label, config overrides, int8 pages)
ROUTER_REDUCED = [("full KV", {}, False), ("int8 pages", {}, True),
                  ("SRF", {"attn_impl": "srf"}, False)]
SAMPLED = dict(temperature=0.9, top_k=50, top_p=0.95)
ROUTER_TRAFFIC = dict(requests=16, prompt_len=128, max_new=32, slots=4,
                      max_len=256, seed=0, device="cuda")
ROUTER_KINDS = {"full": KINDS, "srf": ("raise", "oom")}
# The depth of the full-width serve runs that ``_build`` makes: qwen3-4b
# at 12 of its 36 layers in the router, legacy and mesh phases (its
# other serve runs build it whole), and half of each family's stack.
# The host-bound runs' time goes largely a layer at a time, and the
# script, which must end within 1200 s, took 1110-1180 s at full depth
# on a slow host.
CUT_LAYERS = 12
SERVE_CUT = {"qwen3-4b": {"n_layers": CUT_LAYERS},
             "mamba2-2.7b": {"n_layers": 32},
             "hymba-1.5b": {"n_layers": 16},
             "moonshot-v1-16b-a3b": {"n_layers": 24},
             "seamless-m4t-large-v2": {"n_layers": 12, "enc_layers": 12}}
CHAOS_STEP = 12        # 4 prefill steps, then 8 decode steps into wave 1


def _steady(engines):
    """Step-time clocks that advance 5 ms a read, as
    tests/test_torch_ft.py sets them: the reduced cells hold the card's
    router counters to the CPU's, and on wall clocks the watchdog's slow
    flag on a busy replica races the stuck count of a replica whose
    steps turned into no-ops (oom, reject)."""
    for e in engines:
        ticks = itertools.count()
        e.clock = lambda ticks=ticks: 0.005 * next(ticks)
    return engines


def _router_counters(reg):
    return {k: int(reg.value_sum(f"router_{k}_total")) for k in (
        "quarantined", "rescued", "replayed", "failed")}


def _check_no_leaks(label, engines):
    """No page and no slot held on any replica."""
    for i, e in enumerate(engines):
        sched = e.sched
        slots = sched.slot_alloc.used_pages if sched.slot_alloc else 0
        if sched.alloc.used_pages or slots:
            raise AssertionError(f"{label}: replica {i} leaked "
                                 f"{sched.alloc.used_pages} pages and "
                                 f"{slots} slots")


def _check_done_once(label, reg, reqs):
    """Every request done exactly once (one ``done`` event a uid) and
    served, not failed, shed or timed out."""
    dones = {}
    for ev in reg.events:
        if ev["event"] == "done":
            dones[ev["uid"]] = dones.get(ev["uid"], 0) + 1
    bad = [r.uid for r in reqs if not r.done
           or r.finish_reason not in ("eos", "length")]
    if bad or dones != {r.uid: 1 for r in reqs}:
        raise AssertionError(f"{label}: not done exactly once: {bad}, "
                             f"done events {dones}")


def _undisturbed(cfg, params, device, blue, quant, **samp):
    """One engine of 2 slots (max_len 64, seed 0) on ``device`` serving
    the blueprints with 10 new tokens: {uid: tokens}."""
    from repro_torch.serving import Engine, PagedConfig, Request
    eng = Engine(cfg, params, batch_slots=2, max_len=64, seed=0,
                 device=device, paged=PagedConfig(quantize_kv=quant))
    reqs = [Request(uid=i, prompt=p.copy(), max_new=10, **samp)
            for i, p in enumerate(blue)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.uid: r.out_tokens for r in reqs}


def _check_path_launches(label, counts, path):
    """Every kernel of ``path`` launched, no other kernel and no plain
    route."""
    other = {"paged_gather", "paged_gather_kv", "paged_gather_dequant",
             "paged_gather_dequant_kv", "spinner", "srf_decode",
             "spinner_seeded", "spinner_plain_on_cuda",
             "spinner_seeded_plain_on_cuda"} - path
    if not all(counts[k] for k in path) or any(counts[k] for k in other):
        raise AssertionError(f"{label}: launches {counts}")


def _reduced_chaos(label, cfg, params, device, blue, kind, quant,
                   seeds=(0, 1), **samp):
    """tests/test_torch_ft.py's scenario on ``device``: 2 replicas of 2
    slots (max_len 64), replica 1 faulted at its 4th step,
    ``RouterConfig(migrate=False)``, ``FTConfig(grace_steps=2,
    stuck_rounds=3)``; then ``heal()``, ``revive(1)`` and two more
    requests. Returns the tokens, the extra requests' tokens, the router
    counters and the snapshot restores on the survivor."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import (Engine, FTConfig, PagedConfig,
                                     Request, Router, RouterConfig)
    from repro_torch.serving.chaos import ChaosEngine, ChaosPlan
    reg = MetricsRegistry()
    inner = _steady([Engine(cfg, params, batch_slots=2, max_len=64, seed=s,
                            metrics=reg, device=device,
                            paged=PagedConfig(quantize_kv=quant))
                     for s in seeds])
    engines = [inner[0], ChaosEngine(inner[1], ChaosPlan(kind, at_step=4))]
    router = Router(engines, cfg=RouterConfig(migrate=False), metrics=reg,
                    ft=FTConfig(grace_steps=2, stuck_rounds=3))
    reqs = [Request(uid=i, prompt=p.copy(), max_new=10, **samp)
            for i, p in enumerate(blue)]
    for r in reqs:
        router.submit(r)
    router.run()
    _check_done_once(label, reg, reqs)
    counters = _router_counters(reg)
    if counters["quarantined"] != 1 or router.dead != {1} or \
            counters["failed"] or not (counters["rescued"]
                                       + counters["replayed"]):
        raise AssertionError(f"{label}: router counters {counters}, dead "
                             f"{router.dead}")
    engines[1].heal()
    if not router.revive(1):
        raise AssertionError(f"{label}: revive(1) failed after heal()")
    extra = [Request(uid=100 + i, prompt=blue[i].copy(), max_new=10, **samp)
             for i in range(2)]
    for r in extra:
        router.submit(r)
    router.run()
    _check_no_leaks(label, inner)
    restored = sum(ev["event"] == "restored"
                   and ev["engine"] == inner[0].engine_id
                   for ev in reg.events)
    return {"tokens": {r.uid: r.out_tokens for r in reqs},
            "extra": {r.uid - 100: r.out_tokens for r in extra},
            "counters": counters, "restored": restored}


def _preempt_migrate(cfg, params, device):
    """tests/test_torch_router.py's preempt-then-migrate scenario: replica
    0's pool (9 pages of 4) preempts mid-decode, replica 1 (33 pages, one
    geometry) adopts the evicted, snapshot-carrying sequences through
    migration. Returns (migrated tokens, unmigrated tokens, preemptions,
    migrations, snapshot restores on replica 1)."""
    from repro_torch.serving import (Engine, Request, Router, RouterConfig,
                                     SchedConfig)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 3).astype(np.int32)
               for _ in range(4)]
    geo = dict(max_batch=4, prefill_batch=2, prefill_chunk=4, page_size=4,
               table_width=4)

    def mk():
        return [Request(uid=i, prompt=p.copy(), max_new=10)
                for i, p in enumerate(prompts)]
    solo = Engine(cfg, params, sched=SchedConfig(num_pages=33, **geo),
                  device=device)
    want = mk()
    for r in want:
        solo.submit(r)
    solo.run()
    e0 = Engine(cfg, params, sched=SchedConfig(num_pages=9, **geo),
                device=device)
    e1 = Engine(cfg, params, sched=SchedConfig(num_pages=33, **geo),
                device=device)
    router = Router([e0, e1], RouterConfig(migrate=True))
    reqs = mk()
    for r in reqs:
        e0.submit(r)
        router.home[r.uid] = 0
    router.run()
    _check_no_leaks("preempt-then-migrate", [e0, e1])
    restored = sum(ev["event"] == "restored" for ev in e1.metrics.events)
    return ({r.uid: r.out_tokens for r in reqs},
            {r.uid: r.out_tokens for r in want},
            int(e0.stats["preemptions"]), int(router.stats["migrations"]),
            restored)


def phase_reduced_router():
    """Reduced qwen3-4b (f32, 2 layers) through the router with a chaos
    fault on replica 1, on the card and on the CPU: full KV, int8 pages
    and SRF under raise, hang, reject and oom (12 cells). In every cell
    the card's tokens equal the undisturbed single engine's on the card
    and the CPU route's, the router counters equal the CPU run's, every
    request is done once, the two requests served after ``heal()`` and
    ``revive(1)`` equal the undisturbed ones, and no page or slot leaks;
    the card run launches its path's kernels and no plain route. Then a
    sampled cell (temperature 0.9, top_k 50, top_p 0.95, both replicas
    at seed 0): rescued == undisturbed bit for bit, on the card and on
    the CPU; and a preempted sequence migrated with its snapshot between
    like replicas: tokens equal to the unmigrated run, card == CPU.
    Returns the int8 cells' paged_gather_dequant_kv launches."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as model_lib
    rng = np.random.default_rng(0)
    blue = [rng.integers(1, 512, int(rng.integers(4, 20))).astype(np.int32)
            for _ in range(8)]
    dequant_kv = 0
    for label, over, quant in ROUTER_REDUCED:
        cfg = registry.reduced("qwen3-4b", n_layers=2, **over)
        cpu = model_lib.init(cfg, seed=3, device="cpu")
        card = _to(cpu, "cuda")
        want = _undisturbed(cfg, card, "cuda", blue, quant)
        if want != _undisturbed(cfg, cpu, "cpu", blue, quant):
            raise AssertionError(f"reduced router {label}: undisturbed "
                                 f"tokens differ between card and CPU")
        for kind in KINDS:
            name = f"reduced router {label} {kind}"
            c = _reduced_chaos(name, cfg, cpu, "cpu", blue, kind, quant)
            ops.reset_counts()
            g = _reduced_chaos(name, cfg, card, "cuda", blue, kind, quant)
            counts = ops.launch_counts()
            first = {i: want[i] for i in range(2)}
            if not (g["tokens"] == want == c["tokens"]
                    and g["extra"] == first == c["extra"]):
                raise AssertionError(f"{name}: tokens differ: card "
                                     f"{g['tokens']}, CPU {c['tokens']}, "
                                     f"undisturbed {want}")
            if g["counters"] != c["counters"] or \
                    g["restored"] != c["restored"]:
                raise AssertionError(f"{name}: card counters {g} != CPU "
                                     f"{c}")
            path = ({"spinner", "srf_decode"} if "attn_impl" in over else
                    {"paged_gather_dequant_kv"} if quant else
                    {"paged_gather_kv"})
            _check_path_launches(name, counts, path)
            dequant_kv += counts["paged_gather_dequant_kv"]
            log(f"  {name}: card tokens == CPU tokens == undisturbed "
                f"({sum(map(len, want.values()))} tokens), counters "
                f"{g['counters']} == CPU's, snapshot restores on the "
                f"survivor {g['restored']}; revived, 2 more requests "
                f"equal, no leaks; launches "
                f"{ {k: counts[k] for k in sorted(path)} }")
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    cpu = model_lib.init(cfg, seed=3, device="cpu")
    card = _to(cpu, "cuda")
    greedy = _undisturbed(cfg, card, "cuda", blue, False)
    want = _undisturbed(cfg, card, "cuda", blue, False, **SAMPLED)
    if want == greedy:
        raise AssertionError("sampled cell: sampling gave the greedy "
                             "streams; the cell is vacuous")
    devices = (("card", "cuda", card), ("CPU", "cpu", cpu))
    got = {lab: _reduced_chaos("reduced router sampled raise", cfg, p, dev,
                               blue, "raise", False, (0, 0), **SAMPLED)
           for lab, dev, p in devices}
    if not got["card"]["tokens"] == want == got["CPU"]["tokens"]:
        raise AssertionError("reduced router sampled raise: rescued "
                             "tokens != undisturbed")
    log(f"  reduced router sampled raise (temperature 0.9, top_k 50, "
        f"top_p 0.95): rescued == undisturbed bit for bit on the card and "
        f"on the CPU, counters {got['card']['counters']}")
    runs = {lab: _preempt_migrate(cfg, p, dev) for lab, dev, p in devices}
    moved, solo, pre, mig, restored = runs["card"]
    if moved != solo or runs["card"] != runs["CPU"] or not (pre and mig
                                                             and restored):
        raise AssertionError(f"reduced preempt-then-migrate: card "
                             f"{runs['card']} CPU {runs['CPU']}")
    log(f"  reduced preempt-then-migrate: {pre} preemptions, {mig} "
        f"migrations, {restored} snapshots restored on replica 1; tokens "
        f"== unmigrated, card == CPU")
    return dequant_kv


def _share(a, b):
    """Share of generated tokens equal position by position."""
    same = sum(x == y for u in a for x, y in zip(a[u], b[u]))
    return same / sum(map(len, a.values()))


def _router_run(label, args, cfg, params, chaos=None, meshes=None):
    """``args``' requests through ``launch.serve.router`` (2 replicas of
    ``args.slots`` slots, ``FTConfig()`` on wall clocks, one registry),
    with ``chaos`` (``KIND@STEP:REPLICA``) if given, and without pressure
    migration, as tests/test_ft_serving.py's matrix runs (with it, an oom
    replica's evicted sequences migrate off and the stuck detector never
    fires: a recovery, but not the quarantine path); the launch counts
    reset just before and read just after. Records the tokens at the
    quarantine and the round and time at which the last rescued or
    replayed request finished. Then ``heal()``, ``revive(1)`` and the
    leak check. ``meshes``: one mesh a replica (``Engine(mesh=)``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import RouterConfig
    a = copy.copy(args)
    a.replicas, a.ft, a.chaos = 2, True, chaos
    reg = MetricsRegistry()
    router = serve.router(a, cfg, params, metrics=reg, meshes=meshes)
    router.cfg = RouterConfig(migrate=False)
    reqs = serve.requests(a, cfg)
    by_uid = {r.uid: r for r in reqs}
    kill, back = {}, {}
    quarantine = router.quarantine

    def watched(idx, reason):
        if not kill:
            kill.update(replica=idx, reason=reason, t=time.perf_counter(),
                        round=int(router.stats["steps"]) + 1,
                        tokens={r.uid: list(r.out_tokens) for r in reqs})
        quarantine(idx, reason)
    router.quarantine = watched

    def on_step(rt):
        if not kill or back:
            return
        moved = {ev["uid"] for ev in reg.events
                 if ev["event"] in ("rescued", "replayed")}
        if moved and all(by_uid[u].done for u in moved):
            back.update(round=int(rt.stats["steps"]), t=max(
                by_uid[u].t_done for u in moved), moved=len(moved))
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    res = serve.serve(a, eng=router, reqs=reqs, on_step=on_step)
    counts = ops.launch_counts()
    res["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res.update(counts=counts, counters=_router_counters(reg), kill=kill,
               back=back, reg=reg, reqs=reqs)
    _check_done_once(label, reg, reqs)
    short = [r.uid for r in reqs if len(r.out_tokens) != a.max_new
             or r.finish_reason != "length"]
    bad_rows = sum(e.nonfinite_rows for e in router.engines)
    if short or bad_rows:
        raise AssertionError(f"{label}: requests short of {a.max_new} "
                             f"tokens {short}, {bad_rows} non-finite rows")
    engines = router.engines
    res["steps"] = sum(int(e.stats["prefill_steps"] + e.stats["decode_steps"])
                       for e in engines)
    res["dsteps"] = sum(int(e.stats["decode_steps"]) for e in engines)
    if chaos:
        engines[1].heal()
        if not router.revive(1):
            raise AssertionError(f"{label}: revive(1) failed after heal()")
    _check_no_leaks(label, [getattr(e, "_eng", e) for e in engines])
    res["tokens"] = {r.uid: r.out_tokens for r in reqs}
    res.pop("engine")
    return res


def _check_launches(label, cfg, res):
    """Kernel launches summed over the replicas' steps: full KV
    paged_gather_kv exactly 1 a layer a step; SRF the spinner at least 2
    a layer a step
    and srf_decode exactly 36 a decode step; every other kernel and the
    plain routes never."""
    steps, dsteps = res["steps"], res["dsteps"]
    n = cfg.n_layers
    if cfg.attn_impl == "srf":
        want = {"spinner": (2 * n * steps, False),
                "srf_decode": (n * dsteps, True)}
    else:
        want = {"paged_gather_kv": (n * steps, True), "spinner": (0, True),
                "srf_decode": (0, True)}
    _expect_launches(f"{label} ({steps} steps, {dsteps} decode)",
                     res["counts"], want)


def phase_serve_router(out_dir):
    """Full-width qwen3-4b cut to ``CUT_LAYERS`` (12) of its 36 layers
    (bf16, one set of params shared by every engine), 16 greedy requests
    of 128 + 32 tokens: (a) one engine
    of 8 slots; (b) an FT router over 2 replicas of 4 slots
    (``launch.serve.router``, ``FTConfig()``) with no fault; (c) the same
    router with replica 1 faulted at its step 12 (4 prefill steps, then 8
    decode steps into its first wave): full KV under raise, hang, reject
    and oom, SRF under raise and oom. Each run: every request done once
    with 32 tokens (``length``) and finite logit rows, no leak after
    ``heal()`` and ``revive(1)``, the launches of ``_check_launches``;
    (b) quarantines nothing; each (c) quarantines replica 1 once, fails
    nothing, rescues or replays at least one request, and every token
    emitted before the quarantine equals (b)'s at its position. Prints
    tok/s, TTFT p50, the router counters, the rounds and seconds from
    the kill to the last rescued request's end, and the share of tokens
    equal to (a) and to (b). Then ``launch.serve.main`` in process with
    ``--replicas 2 --ft --chaos raise@12:1`` and ``--metrics-out`` /
    ``--trace-out``. Returns {attn: {run: result}}."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    out = {}
    for attn, kinds in ROUTER_KINDS.items():
        args = serve_args(attn, **ROUTER_TRAFFIC)
        cfg, params = _build(args)
        single = copy.copy(args)
        single.slots = 2 * args.slots
        serve.warm(single, cfg, params)
        runs = {}
        gc.collect()
        ops.reset_counts()
        a = serve.serve(single, cfg, params)
        a["counts"], eng = ops.launch_counts(), a.pop("engine")
        a["steps"] = _steps(eng)
        a["dsteps"] = int(eng.stats["decode_steps"])
        if eng.nonfinite_rows or any(len(r.out_tokens) != args.max_new
                                     for r in a["done"]) or \
                len(a["done"]) != args.requests:
            raise AssertionError(f"{attn} single engine: unfinished "
                                 f"requests or non-finite rows")
        _check_launches(f"{attn} single engine", cfg, a)
        a["tokens"] = {r.uid: r.out_tokens for r in a["done"]}
        del eng
        runs["a"] = a
        log(f"  {attn} (a) one engine, 8 slots: {a['tok_s']:.2f} tok/s, "
            f"TTFT p50 {a['ttft_s']['p50']:.4f} s, {a['steps']} steps")
        b = _router_run(f"{attn} (b)", args, cfg, params)
        if b["kill"] or b["counters"]["quarantined"]:
            raise AssertionError(f"{attn} (b): a replica was quarantined "
                                 f"without a fault: {b['kill'].get('reason')}")
        _check_launches(f"{attn} (b)", cfg, b)
        runs["b"] = b
        log(f"  {attn} (b) router, 2 replicas x 4 slots, no fault: "
            f"{b['tok_s']:.2f} tok/s, TTFT p50 {b['ttft_s']['p50']:.4f} s, "
            f"{b['steps']} steps, counters {b['counters']}, peak "
            f"{b['peak']:.2f} GiB; tokens equal to (a) "
            f"{_share(b['tokens'], a['tokens']):.3f}")
        for kind in kinds:
            label = f"{attn} (c) {kind}@{CHAOS_STEP}:1"
            c = _router_run(label, args, cfg, params,
                            chaos=f"{kind}@{CHAOS_STEP}:1")
            k, cnt = c["kill"], c["counters"]
            if k.get("replica") != 1 or cnt["quarantined"] != 1 or \
                    cnt["failed"] or not (cnt["rescued"] + cnt["replayed"]):
                raise AssertionError(f"{label}: kill {k.get('replica')} "
                                     f"({k.get('reason')}), counters {cnt}")
            early = [u for u, t in k["tokens"].items()
                     if t != b["tokens"][u][:len(t)]]
            if early:
                raise AssertionError(f"{label}: tokens before the "
                                     f"quarantine differ from (b)'s for "
                                     f"uids {early}")
            _check_launches(label, cfg, c)
            back = c["back"]
            c["recover_rounds"] = back["round"] - k["round"] + 1
            c["recover_s"] = back["t"] - k["t"]
            runs[kind] = c
            log(f"  {label}: {c['tok_s']:.2f} tok/s, TTFT p50 "
                f"{c['ttft_s']['p50']:.4f} s, counters {cnt}; quarantined "
                f"in round {k['round']} ({k['reason']}), "
                f"{sum(map(len, k['tokens'].values()))} tokens emitted "
                f"before it, all equal to (b)'s; last of {back['moved']} "
                f"rescued/replayed requests done {c['recover_rounds']} "
                f"rounds, {c['recover_s']:.3f} s after the kill; tokens "
                f"equal to (a) {_share(c['tokens'], a['tokens']):.3f}, to "
                f"(b) {_share(c['tokens'], b['tokens']):.3f}; revived, no "
                f"leaks")
        for r in runs.values():
            for key in ("reg", "reqs", "done"):
                r.pop(key, None)
        out[attn] = runs
        del params
        gc.collect()
        torch.cuda.empty_cache()
    prom = out_dir / "metrics_router.prom"
    trace = out_dir / "trace_router.json"
    text, _ = _cli(["--arch", "qwen3-4b", "--replicas", "2", "--ft",
                    "--chaos", f"raise@{CHAOS_STEP}:1", "--requests", "8",
                    "--slots", "4", "--prompt-len", "128", "--max-new", "32",
                    "--max-len", "256", "--metrics-out", str(prom),
                    "--trace-out", str(trace)])
    import re
    series = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(router_\w+_total) (\S+)$", prom.read_text(), re.M)}
    if series.get("router_quarantined_total") != 1 or \
            series.get("router_failed_total", 0) != 0:
        raise AssertionError(f"serve --replicas 2 --ft --chaos: {series}")
    events = _check_trace(trace)
    pids = {e["pid"] for e in json.loads(trace.read_text())["traceEvents"]
            if e["ph"] in "BE"}
    if pids != {0, 1, 2}:
        raise AssertionError(f"{trace}: B/E events in process rows {pids}, "
                             f"expected 2 replicas and the router")
    log(f"    CLI --replicas 2 --ft --chaos raise@{CHAOS_STEP}:1: "
        f"{_tok_s(text):.1f} tok/s, {series}; trace {trace.name}: {events} "
        f"B/E events in 3 process rows, paired and monotone")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4 (continued): kernel timing and the Chrome trace, through the CLI
# ---------------------------------------------------------------------------

TIMING_ARGV = ["--arch", "qwen3-4b", "--requests", "4", "--max-new", "8"]


def _cli(argv):
    """``launch.serve.main(argv)`` in process -> (stdout, launch counts
    over the run); its lines are logged too."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    buf = io.StringIO()
    ops.reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    counts = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"serve {argv}: exit {rc}")
    for line in buf.getvalue().splitlines():
        log("    | " + line)
    return buf.getvalue(), counts


def _tok_s(text):
    import re
    return float(re.search(r"tok/s=([0-9.]+)", text).group(1))


def _prom_dispatch(path):
    """{kernel: {"count", "p50", "p99"}} from a metrics-out file."""
    import re
    out = {}
    for line in Path(path).read_text().splitlines():
        m = re.match(r'kernel_dispatch_seconds(_count)?\{kernel="(\w+)"'
                     r'(?:,quantile="([0-9.]+)")?\} (\S+)', line)
        if not m:
            continue
        rec = out.setdefault(m.group(2), {})
        if m.group(1):
            rec["count"] = int(float(m.group(4)))
        elif m.group(3) in ("0.5", "0.99"):
            rec["p50" if m.group(3) == "0.5" else "p99"] = float(m.group(4))
    return out


# launch-counter key -> kernel_dispatch_seconds kernel name
DISPATCH_NAMES = {"spinner": "spinner_project",
                  "spinner_seeded": "spinner_project_seeded",
                  "srf_decode": "srf_decode", "paged_gather": "paged_gather",
                  "paged_gather_kv": "paged_gather_kv",
                  "paged_gather_dequant": "paged_gather_dequant",
                  "paged_gather_dequant_kv": "paged_gather_dequant_kv",
                  "fwht": "fwht", "circulant_project": "circulant_project"}


def _check_trace(path):
    doc = json.loads(Path(path).read_text())
    by_pid = {}
    for e in doc["traceEvents"]:
        if e["ph"] in "BE":
            by_pid.setdefault(e["pid"], []).append(e)
    if not by_pid:
        raise AssertionError(f"{path}: no B/E events")
    for pid, seq in by_pid.items():
        if any(a["ts"] > b["ts"] for a, b in zip(seq, seq[1:])):
            raise AssertionError(f"{path}: ts not monotone in pid {pid}")
        stack = []
        for e in seq:
            if e["ph"] == "B":
                stack.append(e["name"])
            elif not stack or stack.pop() != e["name"]:
                raise AssertionError(f"{path}: unpaired E {e}")
        if stack:
            raise AssertionError(f"{path}: unclosed {stack}")
    return sum(len(v) for v in by_pid.values())


def phase_kernel_timing(out_dir):
    """``launch.serve.main`` in process at full width, ``--attn srf`` and
    then the default attention with ``--quantize-kv`` (4 requests, 8 new
    tokens): off, with ``--kernel-timing --metrics-out F --trace-out T``,
    off again. With timing, one kernel_dispatch_seconds series per
    kernel the run launched, each count equal to its launch counter
    (counts reset just before the run, read just after), and a trace of
    paired, monotone B/E events. Then one timed dispatch each of
    ops.fwht and ops.circulant_project at the library shapes. Returns
    {run: {kernel: {"count", "p50", "p99"}}} and the tok/s of each run."""
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry, profiling
    out = {}
    for label, flags in (("srf", ["--attn", "srf"]),
                         ("int8 pages", ["--quantize-kv"])):
        prom = out_dir / f"metrics_{label.split()[0]}.prom"
        trace = out_dir / f"trace_{label.split()[0]}.json"
        rates = []
        for timed in (False, True, False):
            extra = (["--kernel-timing", "--metrics-out", str(prom),
                      "--trace-out", str(trace)] if timed else [])
            text, counts = _cli(TIMING_ARGV + flags + extra)
            rates.append(_tok_s(text))
            gc.collect()
            torch.cuda.empty_cache()
            if not timed:
                continue
            series = _prom_dispatch(prom)
            launched = {DISPATCH_NAMES[k]: n for k, n in counts.items()
                        if k in DISPATCH_NAMES and n}
            if set(series) != set(launched) or any(
                    series[k]["count"] != n for k, n in launched.items()):
                raise AssertionError(f"{label}: dispatch series {series} "
                                     f"against launches {launched}")
            events = _check_trace(trace)
            for k, v in sorted(series.items()):
                log(f"    {label}: {k} dispatches {v['count']} (== "
                    f"launches), p50 {1e3 * v['p50']:.4f} ms, p99 "
                    f"{1e3 * v['p99']:.4f} ms (synced before and after)")
            log(f"    {label}: trace {trace.name} {events} B/E events, "
                f"paired and monotone")
            out[label] = {"series": series}
        out[label]["tok_s"] = rates
        log(f"    {label}: tok/s without timing {rates[0]:.2f}, with "
            f"--kernel-timing {rates[1]:.2f}, without again {rates[2]:.2f}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((8192, 1024), generator=gen, device="cuda")
    g = torch.randn((4, 1024), generator=gen, device="cuda")
    ops.fwht(x)
    ops.circulant_project(g, x, 4096)
    reg = MetricsRegistry()
    try:
        profiling.enable_kernel_timing(reg)
        ops.fwht(x)
        ops.circulant_project(g, x, 4096)
    finally:
        profiling.disable_kernel_timing()
    snap = reg.snapshot()["histograms"]["kernel_dispatch_seconds"]
    for k in ("fwht", "circulant_project"):
        v = snap[f'kernel="{k}"']
        log(f"    one timed dispatch: {k} {1e3 * v['sum']:.4f} ms at the "
            f"library shape (host clock, synced before and after)")
        out[f"library {k}"] = 1e3 * v["sum"]
    return out


# ---------------------------------------------------------------------------
# the SSD and hybrid families, and the other dense configs
# ---------------------------------------------------------------------------

# hymba-1.5b's serving shapes: 8 requests, 5 kv heads of 64 (25 q heads,
# a group of 5), SRF m = 256; KV rows of 5 x 64 = 320; 257 pages of 16
HYMBA = dict(rows=8, kv_heads=5, q_heads=25, hd=64, m=256, layers=32,
             pages=257, page=16, width=16)


def phase_hymba_kernels(gen):
    """Kernels 1, 2, 4 and 5 at the shapes hymba-1.5b's serving path gives
    them: the spinner (circulant n = 64, m = 256, G = 5 kv heads; decode
    query B = 8 requests x a group of 5 = 40 rows, identity; decode key
    B = 8, exp; bf16), srf_decode (B = 8, H = 25, m = 256, dv = 64, f32),
    paged_gather (bf16 rows of D = 320, R = 8, M = 16, P = 16, N = 257,
    32 layer pools cycled) and paged_gather_dequant_kv (int8 -> bf16, a
    layer's K and V in one launch): against their plain versions (the
    tolerance of phase 2; the gathers bit-equal), timed beside them and
    their bounds. Returns {kernel: record}."""
    h = HYMBA
    out = {}
    n, m, gsz = h["hd"], h["m"], h["kv_heads"]
    group = h["q_heads"] // gsz
    for label, bsz, epi in (("decode query", h["rows"] * group, "identity"),
                            ("decode key", h["rows"], "exp")):
        out[f"spinner {label}"] = _spinner_case(
            f"hymba spinner {label}", gsz, bsz, n, m, torch.bfloat16, epi,
            True, gen)
    out["srf_decode"] = _srf_decode_case("hymba", h["rows"], h["q_heads"],
                                         m, h["hd"], gen)
    nl, npg, pg = h["layers"], h["pages"], h["page"]
    d, r, w = h["kv_heads"] * h["hd"], h["rows"], h["width"]
    out["paged_gather"] = _gather_case("hymba K and V", nl, npg, pg, d, r, w,
                                       gen, d_b=d)
    out["paged_gather_dequant"] = _dequant_kv_case("hymba", nl, npg, pg, d,
                                                   r, w, gen)
    torch.cuda.empty_cache()
    return out


# the shapes the MoE and MLA configs' serving paths give kernels 1, 2, 4
# and 5 (8 requests): deepseek-v2-lite-16b's MLA-SRF feature maps (one
# P-model per query head, n = qk_nope + qk_rope = 192, no HD) and latent
# pages (c: kv_lora 512, kpe: qk_rope 64, 27 layers); moonshot-v1-16b-a3b's
# SRF feature maps (16 kv heads of 128, HD) and KV pages (16 x 128, 48
# layers); the SRF state of both (16 heads, m 256, dv 128)
MOE_MLA = dict(rows=8, heads=16, m=256, dv=128, mla_n=192, kv_n=128,
               prefill_rows=8 * 16, pages=257, page=16, width=16,
               mla_layers=27, kv_layers=48, kv_lora=512, rope=64)


def _spinner_case(label, gsz, bsz, n, m, dtype, epi, use_hd, gen):
    """One spinner shape against its plain version (``check_exp``), timed
    beside it and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import spinner as kspin
    x, p = spinner_inputs("circulant", gsz, bsz, n, m, dtype, gen,
                          use_hd=use_hd)
    args = ("circulant", p["g"], x, m)
    kw = dict(d0=p.get("d0"), d1=p.get("d1"), epilogue=epi,
              out_scale=m ** -0.5)
    err = check_exp(f"{label} {str(dtype)[6:]} (G={gsz}, B={bsz}, n={n}, "
                    f"m={m}, {'HD' if use_hd else 'no HD'}, {epi})",
                    kspin.spinner_project_cuda(*args, **kw),
                    ref.spinner_project_ref(*args, **kw), dtype, epi)
    k_ms = device_ms(lambda: kspin.spinner_project_cuda(*args, **kw))
    p_ms = device_ms(lambda: ref.spinner_project_ref(*args, **kw),
                     launches=10, repeats=3)
    b_ms, b_by = spinner_bound("circulant", gsz, bsz, n, m,
                               x.element_size(), p["g"][0].numel(), m,
                               use_hd)
    log(f"    kernel {k_ms:.5f} ms  plain {p_ms:.4f} ms  bound {b_ms:.6f} "
        f"ms ({b_by})")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def _gather_case(label, n_layers, npg, pg, d, r, w, gen, tables=None,
                 d_b=None):
    """The copy gather on bf16 rows of D: the one-pool kernel bit-equal to
    the plain version and to ``pool[tables]``, also on pool views 2 and 8
    bytes off 16-byte alignment. With ``d_b``, the layer's second pool
    (rows of ``d_b``; K and V: D): ``paged_gather_kv`` bit-equal to two
    plain calls, also with the second pool 8 bytes off, and timed beside
    two one-pool launches, two plain calls and two ``pool[tables]``
    (``_pair_times``); without, the one-pool kernel timed beside its
    plain version and ``pool[tables]``. Layer pools cycled; ``tables``:
    (R, M) page ids (default: drawn from 1..N-1)."""
    from repro_torch.kernels import ref
    kpg = _kernel_module("paged_gather")
    if tables is None:
        tables = torch.randint(1, npg, (r, w), generator=gen,
                               device="cuda")
    pools = _layer_pools(n_layers, npg, pg, d, torch.bfloat16, gen)
    what = f"(N={npg}, P={pg}, D={d}, R={r}, M={w})"
    for how, elems in (("aligned", 0), ("pool at +2 bytes", 1),
                       ("pool at +8 bytes", 4)):
        pool = _offset(pools[0], elems)
        got = kpg.paged_gather_cuda(pool, tables)
        exact(f"{label} paged_gather bf16 {what}, {how}", got,
              ref.paged_gather_ref(pool, tables))
        exact(f"{label} paged_gather bf16 {what}, {how}, against "
              f"pool[tables]", got, pool[tables].reshape(got.shape))
    if d_b is not None:
        others = _layer_pools(n_layers, npg, pg, d_b, torch.bfloat16, gen)
        for how, elems in (("aligned", 0), ("second pool at +8 bytes", 4)):
            _pair_exact(f"{label} bf16 {what} and D={d_b}, {how}", pools[0],
                        _offset(others[0], elems), tables)
        rec = _pair_times(label, tables, pools, others, pg, d, d_b)
        del pools, others
        return rec
    rows = r * w * pg
    g_ms = device_ms(_cycle(lambda a: kpg.paged_gather_cuda(a, tables),
                            pools))
    g_plain = device_ms(_cycle(lambda a: ref.paged_gather_ref(a, tables),
                               pools))
    g_lib = device_ms(_cycle(lambda a: a[tables], pools))
    g_b, g_by = kernel_bound("gather", rows, d, 2)
    log(f"    kernel {g_ms:.5f} ms  plain {g_plain:.5f} ms  pool[tables] "
        f"{g_lib:.5f} ms  bound {g_b:.5f} ms ({g_by})")
    del pools
    return dict(err=0.0, ms=g_ms, plain_ms=g_plain, library_ms=g_lib,
                bound_ms=g_b, bound_by=g_by)


def phase_moe_mla_kernels(gen):
    """Kernels 1, 2, 4 and 5 at the shapes the MoE and MLA configs'
    serving paths give them (``MOE_MLA``): the spinner at deepseek's
    MLA-SRF shape (circulant n = 192 without HD, m = 256: two circulant
    blocks of 192 rows, 256 kept; G = 16 query heads; decode query B = 8
    identity, decode key B = 8 exp, prefill B = 8 x 16 = 128 query and
    key; bf16 and f32; the route ``ops.kernel_takes`` picks for it must
    be the kernel) and at moonshot's (n = 128 with HD, G = 16 kv heads,
    decode query B = 8, bf16); srf_decode at (B = 8, H = 16, m = 256, dv =
    128, f32); paged_gather on bf16 rows of D = 512 (deepseek's latent c)
    and D = 64 (kpe: 128-byte rows), 27 layer pools cycled, and of D =
    2048 (moonshot's K or V), 48 pools; paged_gather_dequant_kv on int8
    rows of 2048 (R = 8, M = 16, P = 16, N = 257). Each against its plain
    version (the tolerance of phase 2; the gathers bit-equal, the bf16
    ones also against ``pool[tables]`` and on pool views off 16-byte
    alignment), timed beside it and its bound. Returns {kernel: record}."""
    from repro_torch.kernels import ops
    h = MOE_MLA
    out = {}
    n, m, gsz = h["mla_n"], h["m"], h["heads"]
    if not ops.kernel_takes("circulant", n, m, False):
        raise AssertionError(f"the MLA-SRF spinner (n={n}, no HD) would "
                             f"take the plain route on the card")
    for dtype in (torch.bfloat16, torch.float32):
        for label, bsz, epi in (
                ("decode query", h["rows"], "identity"),
                ("decode key", h["rows"], "exp"),
                ("prefill query", h["prefill_rows"], "identity"),
                ("prefill key", h["prefill_rows"], "exp")):
            out[(f"mla spinner {label}", dtype)] = _spinner_case(
                f"deepseek MLA-SRF spinner {label}", gsz, bsz, n, m, dtype,
                epi, False, gen)
    out[("moonshot spinner decode query", torch.bfloat16)] = _spinner_case(
        "moonshot SRF spinner decode query", gsz, h["rows"], h["kv_n"], m,
        torch.bfloat16, "identity", True, gen)
    out["srf_decode"] = _srf_decode_case("moe/mla", h["rows"], h["heads"],
                                         m, h["dv"], gen)
    npg, pg, r, w = h["pages"], h["page"], h["rows"], h["width"]
    for key, label, layers, d, d_b in (
            ("paged_gather c+kpe", "deepseek latents c and kpe",
             h["mla_layers"], h["kv_lora"], h["rope"]),
            ("paged_gather kv", "moonshot K and V", h["kv_layers"],
             gsz * h["kv_n"], gsz * h["kv_n"])):
        out[key] = _gather_case(label, layers, npg, pg, d, r, w, gen,
                                d_b=d_b)
    out["paged_gather_dequant"] = _dequant_kv_case(
        "moonshot", h["kv_layers"], npg, pg, gsz * h["kv_n"], r, w, gen)
    torch.cuda.empty_cache()
    return out


# the shapes the vision and enc-dec configs' serving paths give kernels
# 1, 2, 4 and 5 (8 requests): qwen2-vl-2b's SRF feature maps (2 kv heads
# of 128, HD; a group of 6 query heads a kv head) and KV pages (2 x 128,
# 28 layers); seamless-m4t-large-v2's (16 kv heads of 64, HD; KV rows of
# 16 x 64, 24 layers), its encoder's feature maps (one request's 1024
# frames) and its memory pool (one slot a request, a page of enc_len =
# 1024 rows of d_model = 1024, gathered through a width-1 table)
VLM_ENCDEC = dict(rows=8, m=256, pages=257, page=16, width=16,
                  vl_kv=2, vl_group=6, vl_hd=128, vl_layers=28,
                  sm_heads=16, sm_hd=64, sm_layers=24, enc_len=1024,
                  d_model=1024, mem_pools=8)


def _srf_decode_case(label, b, hq, m, dv, gen):
    """srf_decode at (B, H, m, dv), f32, against its plain version, timed
    beside it and its bound."""
    from repro_torch.kernels import ref
    kdec = _kernel_module("srf_decode")
    dev = "cuda"
    phi = lambda: torch.rand((b, hq, m), generator=gen, device=dev) / 16  # noqa
    s = torch.randn((b, hq, m, dv), generator=gen, device=dev) * 4
    z = phi() * 128
    pq, pk = phi(), phi()
    v = torch.randn((b, hq, dv), generator=gen, device=dev)
    want = ref.srf_decode_ref(s, z, pq, pk, v)
    got = kdec.srf_decode_cuda(s.clone(), z.clone(), pq, pk, v)
    err = max(check(f"{label} srf_decode {part} (B={b}, H={hq}, m={m}, "
                    f"dv={dv})", k, p_, torch.float32)
              for part, k, p_ in zip(("S'", "z'", "out"), got, want))
    s2, z2 = s.clone(), z.clone()
    k_ms = device_ms(lambda: kdec.srf_decode_cuda(s2, z2, pq, pk, v))
    p_ms = device_ms(lambda: ref.srf_decode_ref(s, z, pq, pk, v),
                     launches=20, repeats=3)
    b_ms, b_by = kernel_bound("srf_decode", b, hq, m, dv)
    log(f"    kernel {k_ms:.5f} ms  plain {p_ms:.4f} ms  bound {b_ms:.5f} "
        f"ms ({b_by})")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def _dequant_kv_case(label, nl, npg, pg, d, r, w, gen):
    """paged_gather_dequant_kv (int8 -> bf16, a layer's K and V in one
    launch) on rows of D, bit-equal to the plain version, timed cycling
    through ``nl`` layers' pools beside two plain calls and the bound."""
    from repro_torch.kernels import ref
    kpg = _kernel_module("paged_gather")
    dev = "cuda"
    tables = torch.randint(1, npg, (r, w), generator=gen, device=dev)
    q = _layer_pools(2 * nl, npg, pg, d, torch.int8, gen)
    sc = [torch.rand((npg, pg, 1), generator=gen, device=dev) / 127
          for _ in range(2 * nl)]
    pairs = [((q[2 * i], sc[2 * i]), (q[2 * i + 1], sc[2 * i + 1]))
             for i in range(nl)]
    _dequant_exact(f"{label} (N={npg}, P={pg}, D={d}, R={r}, M={w})",
                   q[0], sc[0], q[1], sc[1], tables)
    bf = torch.bfloat16
    kv_ms = device_ms(_cycle(lambda a: kpg.paged_gather_dequant_kv_cuda(
        a[0][0], a[0][1], a[1][0], a[1][1], tables, bf), pairs))
    kv_plain = device_ms(_cycle(lambda a: [
        ref.paged_gather_dequant_ref(qq, ss, tables, bf) for qq, ss in a],
        pairs))
    rows = r * w * pg
    kv_b, kv_by = kernel_bound("gather_dequant", rows, d, 2, pools=2)
    log(f"    {label} paged_gather_dequant_kv int8->bf16: kernel "
        f"{kv_ms:.5f} ms ({100 * kv_b / kv_ms:.0f}% of bound)  plain "
        f"{kv_plain:.5f} ms  bound {kv_b:.5f} ms ({kv_by})")
    del q, sc, pairs
    return dict(err=0.0, ms=kv_ms, plain_ms=kv_plain, library_ms=None,
                bound_ms=kv_b, bound_by=kv_by)


def phase_vlm_encdec_kernels(gen):
    """Kernels 1, 2, 4 and 5 at the shapes the vision and enc-dec configs'
    serving paths give them (``VLM_ENCDEC``): the spinner at qwen2-vl's
    decode query (circulant n = 128 with HD, m = 256, G = 2 kv heads, B = 8
    requests x a group of 6 = 48, identity) and key (B = 8, exp), at
    seamless's (n = 64 with HD, G = 16, B = 8) and at its encoder's (one
    request's B = 1024 frames, query identity and key exp); srf_decode at
    (B = 8, H = 12, m = 256, dv = 128) and (B = 8, H = 16, dv = 64);
    paged_gather on bf16 rows of D = 2 x 128 = 256 (28 layer pools
    cycled) and D = 16 x 64 = 1024 (24 pools), and on the memory pool (N
    = 9 slots, a page of P = 1024 rows of D = 1024, 2 MiB; R = 8 distinct
    slots, M = 1; 8 pools cycled, so pages come from HBM), bit-equal to
    the plain
    version and to ``pool[tables]``, also on pool views off 16-byte
    alignment; paged_gather_dequant_kv on int8 rows of 1024 (seamless's K
    and V). Each timed beside its plain version and its bound. Returns
    {kernel: record}."""
    h = VLM_ENCDEC
    out = {}
    r, m = h["rows"], h["m"]
    for key, label, gsz, bsz, n, epi in (
            ("qwen2vl spinner query", "qwen2-vl SRF spinner decode query",
             h["vl_kv"], r * h["vl_group"], h["vl_hd"], "identity"),
            ("qwen2vl spinner key", "qwen2-vl SRF spinner decode key",
             h["vl_kv"], r, h["vl_hd"], "exp"),
            ("seamless spinner query", "seamless SRF spinner decode query",
             h["sm_heads"], r, h["sm_hd"], "identity"),
            ("seamless spinner key", "seamless SRF spinner decode key",
             h["sm_heads"], r, h["sm_hd"], "exp"),
            ("seamless encoder query", "seamless encoder SRF spinner query",
             h["sm_heads"], h["enc_len"], h["sm_hd"], "identity"),
            ("seamless encoder key", "seamless encoder SRF spinner key",
             h["sm_heads"], h["enc_len"], h["sm_hd"], "exp")):
        out[key] = _spinner_case(label, gsz, bsz, n, m, torch.bfloat16, epi,
                                 True, gen)
    out["qwen2vl srf_decode"] = _srf_decode_case(
        "qwen2-vl", r, h["vl_kv"] * h["vl_group"], m, h["vl_hd"], gen)
    out["seamless srf_decode"] = _srf_decode_case(
        "seamless", r, h["sm_heads"], m, h["sm_hd"], gen)
    npg, pg, w = h["pages"], h["page"], h["width"]
    vl_d, sm_d = h["vl_kv"] * h["vl_hd"], h["sm_heads"] * h["sm_hd"]
    out["qwen2vl paged_gather"] = _gather_case(
        "qwen2-vl K and V", h["vl_layers"], npg, pg, vl_d, r, w, gen,
        d_b=vl_d)
    out["seamless paged_gather"] = _gather_case(
        "seamless K and V", h["sm_layers"], npg, pg, sm_d, r, w, gen,
        d_b=sm_d)
    # the 8 rows' slots are distinct, as a batch's requests' are; the
    # pools cycled hold 8 x 16 MiB read a call, past the 50 MB L2
    slots = (torch.randperm(r, generator=gen, device="cuda") + 1)[:, None]
    out["seamless memory gather"] = _gather_case(
        "seamless encoder memory", h["mem_pools"], r + 1, h["enc_len"],
        h["d_model"], r, 1, gen, tables=slots)
    out["seamless paged_gather_dequant"] = _dequant_kv_case(
        "seamless", h["sm_layers"], npg, pg, h["sm_heads"] * h["sm_hd"], r,
        w, gen)
    torch.cuda.empty_cache()
    return out


# reduced family cells: (label, arch, config overrides, int8 pages)
# (the MoE cells at capacity factor 8, as the reference's parity tests:
# a prefill chunk and a whole prompt drop no routing slot, so paged ==
# legacy holds)
CF8 = {"moe_capacity_factor": 8.0}
FAMILIES_REDUCED = [("mamba2 ssd", "mamba2-2.7b", {}, False),
                    ("hymba full KV", "hymba-1.5b", {}, False),
                    ("hymba int8 pages", "hymba-1.5b", {}, True),
                    ("hymba SRF", "hymba-1.5b", {"attn_impl": "srf"}, False),
                    ("moonshot full KV", "moonshot-v1-16b-a3b", CF8, False),
                    ("moonshot int8 pages", "moonshot-v1-16b-a3b", CF8,
                     True),
                    ("moonshot SRF", "moonshot-v1-16b-a3b",
                     {**CF8, "attn_impl": "srf"}, False),
                    ("deepseek MLA", "deepseek-v2-lite-16b", CF8, False),
                    ("deepseek MLA+SRF", "deepseek-v2-lite-16b",
                     {**CF8, "attn_impl": "srf"}, False),
                    ("qwen2-vl full KV", "qwen2-vl-2b", {}, False),
                    ("qwen2-vl SRF", "qwen2-vl-2b", {"attn_impl": "srf"},
                     False),
                    ("seamless full KV", "seamless-m4t-large-v2", {}, False),
                    ("seamless int8 pages", "seamless-m4t-large-v2", {},
                     True),
                    ("seamless SRF", "seamless-m4t-large-v2",
                     {"attn_impl": "srf"}, False)]
# the kernels each reduced cell's card run must launch (and no other)
FAMILY_PATHS = {"mamba2 ssd": set(), "hymba full KV": {"paged_gather_kv"},
                "hymba int8 pages": {"paged_gather_dequant_kv"},
                "hymba SRF": {"spinner", "srf_decode"},
                "moonshot full KV": {"paged_gather_kv"},
                "moonshot int8 pages": {"paged_gather_dequant_kv"},
                "moonshot SRF": {"spinner", "srf_decode"},
                "deepseek MLA": {"paged_gather_kv"},
                "deepseek MLA+SRF": {"spinner", "srf_decode"},
                "qwen2-vl full KV": {"paged_gather_kv"},
                "qwen2-vl SRF": {"spinner", "srf_decode"},
                # enc-dec: the memory pool's gather a step beside the rest
                "seamless full KV": {"paged_gather_kv", "paged_gather"},
                "seamless int8 pages": {"paged_gather_dequant_kv",
                                        "paged_gather"},
                "seamless SRF": {"spinner", "srf_decode", "paged_gather"}}
# reduced seeded-SRF cells with mixed embed seeds (``_personalize``), card
# == CPU: (label, arch, config overrides, the path's kernels)
SEEDED_REDUCED = [("deepseek MLA seeded SRF", "deepseek-v2-lite-16b", CF8,
                   {"spinner_seeded", "srf_decode"}),
                  ("seamless seeded SRF", "seamless-m4t-large-v2", {},
                   {"spinner_seeded", "srf_decode", "paged_gather"})]
PREFIX_SCENARIOS = ("hit", "partial", "miss", "evict", "cow")
PREFIX_COUNTERS = ("prefix_lookups_total", "prefix_hits_total",
                   "prefix_hit_tokens_total", "prefix_cow_forks_total",
                   "prefix_evictions_total", "prefix_inserted_pages_total",
                   "engine_prefill_tokens_total")


def _prefix_waves(cfg, scenario):
    """tests/test_prefix_serving.py's waves: a donor of 36 tokens, then 5
    requests that extend it (hit, evict, cow), diverge inside it
    (partial) or share nothing (miss)."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab, 36).astype(np.int32)
    tails = [rng.integers(1, cfg.vocab, 3 + i).astype(np.int32)
             for i in range(5)]
    donors = [Request(uid=100, prompt=shared.copy(), max_new=2)]
    if scenario == "partial":
        wave = [Request(uid=i, prompt=np.concatenate([shared[:20], t, t]),
                        max_new=6) for i, t in enumerate(tails)]
    elif scenario == "miss":
        wave = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, 20 + i)
                        .astype(np.int32), max_new=6) for i in range(5)]
    else:
        wave = [Request(uid=i, prompt=np.concatenate([shared, t]), max_new=6)
                for i, t in enumerate(tails)]
    return donors, wave


def _prefix_run(cfg, params, device, scenario, prefix):
    """The donor wave, then the measured wave, through one engine:
    (tokens, prefix counters, engine)."""
    from repro_torch.serving import (ChunkConfig, Engine, PrefixConfig,
                                     SchedConfig)
    kw = dict(batch_slots=4, max_len=64)
    if scenario == "evict":
        kw["sched"] = SchedConfig(max_batch=2, prefill_batch=2,
                                  prefill_chunk=16, page_size=8,
                                  num_pages=12, table_width=7)
    eng = Engine(cfg, params, device=device, **kw, prefix=PrefixConfig(
        chunk=ChunkConfig(chunk_tokens=16)) if prefix else None)
    donors, wave = _prefix_waves(cfg, scenario)
    _drive(eng, donors)
    toks = _drive(eng, wave)
    v = eng.metrics.value_sum
    return toks, {c: int(v(c)) for c in PREFIX_COUNTERS}, eng


def phase_reduced_families():
    """Reduced mamba2-2.7b, hymba-1.5b, moonshot-v1-16b-a3b and
    deepseek-v2-lite-16b (f32, 2 layers; hymba and moonshot with full KV,
    int8 pages and SRF, deepseek with MLA latent pages and MLA + SRF;
    ``FAMILIES_REDUCED``) on the card and on the CPU. (1) 8
    mixed-length requests through the paged engine and through the
    legacy engine, greedy and sampled (temperature 0.8, engine seed 5):
    card tokens equal CPU tokens, and on the card paged == legacy (int8
    pages: the legacy int8 cache held card == CPU only, as the reference's
    two engines part on hymba); the card's paged runs launch the cell's
    kernels (mamba2: none) and no plain route. (2) hymba's prefix-cache
    scenarios (hit, partial, miss, evict, cow): warm card tokens equal
    the cold engine's and the CPU's, the prefix counters equal the CPU
    run's, hit tokens only where a donor's state point lies inside the
    prompt, no page or slot left after ``drop_all``. (3) hymba's chaos
    cells (raise, hang, reject, oom at replica 1's 4th step; 2 replicas
    of 2 slots): tokens equal to the undisturbed engine's on the card and
    to the CPU route's, router counters equal the CPU run's."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as model_lib
    from repro_torch.serving import Engine, PagedConfig
    legacy = _legacy_module()
    for label, arch, over, quant in FAMILIES_REDUCED:
        cfg = registry.reduced(arch, n_layers=2, **over)
        cpu = model_lib.init(cfg, seed=3, device="cpu")
        card = _to(cpu, "cuda")
        lcfg = dataclasses.replace(cfg, kv_cache_dtype="int8") if quant \
            else cfg
        for t in ((0.0,) if quant else (0.0, 0.8)):
            kind = "sampled" if t else "greedy"
            got = {}
            for where, device, params in (("CPU", "cpu", cpu),
                                          ("card", "cuda", card)):
                ops.reset_counts()
                got[where] = _drive(Engine(
                    cfg, params, batch_slots=4, max_len=64, seed=5,
                    device=device, paged=PagedConfig(quantize_kv=quant)),
                    _mixed_requests(cfg, t))
                counts = ops.launch_counts()
                got[where + " legacy"] = _drive(legacy.Engine(
                    lcfg, params, batch_slots=4, max_len=64, seed=5,
                    device=device), _mixed_requests(cfg, t))
            _check_path_launches(f"reduced {label} {kind}", counts,
                                 FAMILY_PATHS[label])
            if got["card"] != got["CPU"] or len(got["card"]) != 8 or \
                    got["card legacy"] != got["CPU legacy"]:
                raise AssertionError(f"reduced {label} {kind}: card tokens "
                                     f"differ from the CPU's: {got}")
            if not quant and got["card"] != got["card legacy"]:
                raise AssertionError(f"reduced {label} {kind}: paged != "
                                     f"legacy on the card: {got}")
            log(f"  reduced {label} {kind}: paged and legacy card tokens == "
                f"CPU tokens ({sum(map(len, got['card'].values()))} tokens)"
                + ("" if quant else "; paged == legacy on the card"))

    cfg = registry.reduced("hymba-1.5b", n_layers=2)
    cpu = model_lib.init(cfg, seed=3, device="cpu")
    card = _to(cpu, "cuda")
    for scenario in PREFIX_SCENARIOS:
        cold, _, _ = _prefix_run(cfg, card, "cuda", scenario, False)
        want, want_c, _ = _prefix_run(cfg, cpu, "cpu", scenario, True)
        got, got_c, eng = _prefix_run(cfg, card, "cuda", scenario, True)
        hit = got_c["prefix_hit_tokens_total"]
        if got != want or got != cold or got_c != want_c or \
                (hit > 0) != (scenario in ("hit", "evict", "cow")):
            raise AssertionError(f"reduced hymba prefix {scenario}: card "
                                 f"{got} {got_c}, cold {cold}, CPU {want} "
                                 f"{want_c}")
        eng.prefix.drop_all()
        if eng.sched.alloc.used_pages or eng.sched.slot_alloc.used_pages:
            raise AssertionError(f"reduced hymba prefix {scenario}: leak")
        log(f"  reduced hymba prefix {scenario}: card tokens == cold == CPU, "
            f"counters == CPU's: {got_c}")

    rng = np.random.default_rng(0)
    blue = [rng.integers(1, cfg.vocab, int(rng.integers(4, 20)))
            .astype(np.int32) for _ in range(8)]
    base = _undisturbed(cfg, card, "cuda", blue, False)
    for kind in KINDS:
        ops.reset_counts()
        res = _reduced_chaos(f"reduced hymba chaos {kind}", cfg, card,
                             "cuda", blue, kind, False)
        counts = ops.launch_counts()
        ref = _reduced_chaos(f"reduced hymba chaos {kind} (CPU)", cfg, cpu,
                             "cpu", blue, kind, False)
        _check_path_launches(f"reduced hymba chaos {kind}", counts,
                             {"paged_gather_kv"})
        if res["tokens"] != base or res["tokens"] != ref["tokens"] or \
                res["counters"] != ref["counters"] or \
                res["extra"] != {i: base[i] for i in range(2)}:
            raise AssertionError(f"reduced hymba chaos {kind}: card {res}, "
                                 f"CPU {ref}, undisturbed {base}")
        log(f"  reduced hymba chaos {kind}: rescued == undisturbed == CPU, "
            f"counters {res['counters']} == CPU's")
    _reduced_new_families()


def _reduced_new_families():
    """``phase_reduced_families``' parts (4)-(6): seeded SRF with mixed
    embed seeds (``SEEDED_REDUCED``: deepseek's MLA-SRF and seamless,
    greedy and sampled rows in one batch) card == CPU, the path's kernels
    launched; seamless's prefix cache with two feature sets (a donor and
    a wave sharing its features hit, the same prompts with other
    features miss) card == CPU == cold, counters == CPU's; qwen2-vl's
    ``loss_fn`` on a batch whose ``pos3`` rows differ (a patch grid, then
    text), full and SRF, card within rtol 1e-4 of the CPU."""
    from repro_torch.configs import registry
    from repro_torch.data import synth
    from repro_torch.kernels import ops
    from repro_torch.models import frontends
    from repro_torch.models import transformer as model_lib
    from repro_torch.serving import (ChunkConfig, Engine, PrefixConfig,
                                     Request)
    for label, arch, over, path in SEEDED_REDUCED:
        cfg = _seeded(registry.reduced(arch, n_layers=2, attn_impl="srf",
                                       **over))
        cpu = model_lib.init(cfg, seed=3, device="cpu")
        got = {}
        for where, device, params in (("CPU", "cpu", cpu),
                                      ("card", "cuda", _to(cpu, "cuda"))):
            ops.reset_counts()
            got[where] = _drive(Engine(cfg, params, batch_slots=4,
                                       max_len=64, seed=5, device=device),
                                _personalize(_mixed_requests(cfg, 0.0)))
            counts = ops.launch_counts()
        _check_path_launches(f"reduced {label}", counts, path)
        if got["card"] != got["CPU"] or len(got["card"]) != 8:
            raise AssertionError(f"reduced {label}: card tokens differ from "
                                 f"the CPU's: {got}")
        log(f"  reduced {label}, mixed embed seeds, greedy + sampled: card "
            f"tokens == CPU tokens "
            f"({sum(map(len, got['card'].values()))} tokens)")

    cfg = registry.reduced("seamless-m4t-large-v2", n_layers=2)
    cpu = model_lib.init(cfg, seed=3, device="cpu")
    card = _to(cpu, "cuda")
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab, 36).astype(np.int32)
    feats = [frontends.synthetic_audio_features(rng, cfg) for _ in range(2)]
    tails = [rng.integers(1, cfg.vocab, 3 + i).astype(np.int32)
             for i in range(4)]

    def waves():
        donor = [Request(uid=100, prompt=shared.copy(), max_new=2,
                         enc_emb=feats[0])]
        wave = [Request(uid=i, prompt=np.concatenate([shared, tails[i % 4]]),
                        max_new=6, enc_emb=feats[i // 4]) for i in range(8)]
        return donor, wave

    def run(params, device, prefix):
        # 8 slots: the wave is admitted at once, so only the donor's
        # pages can be hit
        eng = Engine(cfg, params, batch_slots=8, max_len=64, device=device,
                     prefix=PrefixConfig(chunk=ChunkConfig(chunk_tokens=16))
                     if prefix else None)
        donor, wave = waves()
        _drive(eng, donor)
        toks = _drive(eng, wave)
        hit = [r.uid for r in wave if r.trace.count("prefix_hit")]
        v = eng.metrics.value_sum
        return toks, {c: int(v(c)) for c in PREFIX_COUNTERS}, eng, hit
    cold, _, _, _ = run(card, "cuda", False)
    want, want_c, _, _ = run(cpu, "cpu", True)
    got, got_c, eng, hit = run(card, "cuda", True)
    if got != want or got != cold or got_c != want_c or \
            hit != [0, 1, 2, 3] or got_c["prefix_hits_total"] != 4:
        raise AssertionError(f"reduced seamless prefix, two feature sets: "
                             f"card {got} {got_c}, cold {cold}, CPU {want} "
                             f"{want_c}")
    eng.prefix.drop_all()
    if eng.sched.alloc.used_pages or eng.sched.slot_alloc.used_pages:
        raise AssertionError("reduced seamless prefix: leak")
    log(f"  reduced seamless prefix, two feature sets: 4 hits (the donor's "
        f"features), none across features; card == cold == CPU, counters "
        f"== CPU's: {got_c}")

    for attn in ("full", "srf"):
        cfg = registry.reduced("qwen2-vl-2b", n_layers=2, attn_impl=attn)
        cpu = model_lib.init(cfg, seed=3, device="cpu")
        hb = synth.full_batch(cfg, 2, 32, 0)
        nv = hb["vision_emb"].shape[1]
        i = np.arange(nv)
        grid = np.stack([np.zeros(nv), i // 4, i % 4]).astype(np.int32)
        text = np.broadcast_to(grid.max() + 1 + np.arange(32 - nv),
                               (3, 32 - nv))
        hb["pos3"] = np.ascontiguousarray(np.broadcast_to(
            np.concatenate([grid, text], 1)[:, None], (3, 2, 32))
        ).astype(np.int32)
        losses = {}
        for device, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            ops.reset_counts()
            batch = {k: torch.from_numpy(v).to(device) for k, v in hb.items()}
            with torch.no_grad():
                losses[device] = float(model_lib.loss_fn(params, cfg,
                                                         batch)[0])
            counts = ops.launch_counts()
        if attn == "srf" and (not counts["spinner"]
                              or counts["spinner_plain_on_cuda"]):
            raise AssertionError(f"reduced qwen2-vl loss {attn}: {counts}")
        if not abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * losses["cpu"]:
            raise AssertionError(f"reduced qwen2-vl loss {attn}, M-RoPE "
                                 f"rows apart: card {losses['cuda']} != "
                                 f"CPU {losses['cpu']}")
        log(f"  reduced qwen2-vl {attn} loss_fn, a 16-patch grid then text "
            f"(pos3 rows apart): card {losses['cuda']:.6f} == CPU "
            f"{losses['cpu']:.6f} within rtol 1e-4")


def _pool_bytes(eng):
    """(slot-domain bytes, paged-domain bytes) of an engine's pools
    (global, for a sharded engine)."""
    from repro_torch.serving import paged_cache
    pools = paged_cache.global_view(eng.pools)

    def total(part):
        return sum(t.numel() * t.element_size()
                   for seg in pools[part] if seg is not None
                   for t in _leaves(seg))
    return total("slot"), total("paged")


FAMILY_TRAFFIC = dict(requests=8, prompt_len=128, max_new=32, slots=8,
                      max_len=256, seed=0, device="cuda")


def _agreement(a, b):
    """Share of generated positions with equal tokens, over the requests
    (uids) and positions both runs generated."""
    ta = {r.uid: r.out_tokens for r in a["done"]}
    tb = {r.uid: r.out_tokens for r in b["done"]}
    pairs = [(x, y) for u in ta.keys() & tb.keys()
             for x, y in zip(ta[u], tb[u])]
    return sum(x == y for x, y in pairs) / len(pairs)


def _family_run(label, a, cfg, params, expect=None, eng=None, reqs=None):
    """One counted serve run of ``a`` (counts set to 0 just before, read
    just after; ``reqs`` on ``eng`` when given): every request finished
    with ``a.max_new`` tokens, every logit row finite, the launches as
    ``expect`` says (``_expect_launches``) when given. Prints tok/s,
    TTFT, peak memory and the pools' bytes; returns the result with its
    counts and peak."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    res = serve.serve(a, cfg, params, eng=eng, reqs=reqs)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eng = res["engine"]
    n_req = a.requests if reqs is None else len(reqs)
    bad = [r.uid for r in res["done"] if len(r.out_tokens) != a.max_new]
    if len(res["done"]) != n_req or bad or eng.nonfinite_rows:
        raise AssertionError(f"{label}: requests not finished with "
                             f"{a.max_new} tokens {bad}, or "
                             f"{eng.nonfinite_rows} non-finite rows")
    if expect is not None:
        _expect_launches(label, counts, dict(expect))
    out = {k: res[k] for k in ("done", "tokens", "wall_s", "tok_s",
                                "ttft_s")}
    out.update(counts=counts, peak_gib=peak)
    if a.legacy:
        log(f"  {label}: {len(res['done'])} requests, {res['tokens']} "
            f"tokens in {res['wall_s']:.3f} s: {res['tok_s']:.2f} tok/s, "
            f"TTFT p50 {res['ttft_s']['p50']:.4f} s, peak {peak:.2f} GiB")
    else:
        slot_b, page_b = _pool_bytes(eng)
        _serve_line(label, res, _steps(eng), peak)
        log(f"    pools: slot domain {slot_b} B ({eng.sched.num_slots} "
            f"slots), paged domain {page_b} B; cache_report "
            f"{eng.cache_report()}")
        out.update(steps=_steps(eng),
                   decode_steps=int(eng.stats["decode_steps"]),
                   slot_bytes=slot_b, page_bytes=page_b)
    log(f"    launches: {counts}")
    return out


# first-token logits as a share of the row's largest |logit|: (the two
# bf16 engines against each other, each against an f32 copy's prefill).
# A first card run measured mamba2-2.7b 0.073 and 0.076-0.085 (64 SSD
# layers; the paged engine's chunks of 16 against one legacy chunk of
# 128), hymba-1.5b 0.031 and 0.034-0.035; the limits bound a broken
# engine (an O(1) error), at about twice those. deepseek-v2-lite-16b
# (MLA with MoE; no f32 anchor: an f32 copy does not fit beside the bf16
# weights) measured 0.296: besides bf16 rounding, expert capacity is a
# per-call rule, so the paged engine's prefill chunks (cap 8 an expert)
# and the legacy engine's whole prompt (cap 16) drop different routing
# slots.
FAMILY_LOGIT_TOL = {"ssm": (0.15, 0.2), "hybrid": (0.075, 0.1),
                    "mla": (0.6, None)}


def _first_logit_gap(label, paged, legacy, f32, family):
    """Worst, over requests, of max|a - b| over the row's largest |a| of
    the first-token logits of the two bf16 engines (``first_logits``
    records) against each other and, unless ``f32`` is None, against an
    f32 copy's prefill (``_f32_first_logits``): {pair: worst share}."""
    pairs = {"legacy-paged": (legacy.rows, paged.rows)}
    if f32 is not None:
        pairs.update({"f32-legacy": (f32, legacy.rows),
                      "f32-paged": (f32, paged.rows)})
    gaps = {k: max(float((a[u] - b[u]).abs().max() / a[u].abs().max())
                   for u in a) for k, (a, b) in pairs.items()}
    engines, anchor = FAMILY_LOGIT_TOL[family]
    limits = {"legacy-paged": engines, "f32-legacy": anchor,
              "f32-paged": anchor}
    log(f"    {label}: first-token logits, worst share of the row's largest "
        f"|logit|: " + ", ".join(f"{k} {v:.3e} (limit {limits[k]})"
                                 for k, v in gaps.items()))
    bad = {k: v for k, v in gaps.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{label}: first-token logits apart: {bad}")
    return gaps


def phase_serve_ssd():
    """Full-width mamba2-2.7b (32 of its 64 layers, ``SERVE_CUT``;
    d_model 2560, 80 SSD heads of
    64, state 128, bf16), 8 greedy requests of 128 + 32 tokens, 8 slots:
    the paged engine, then the legacy engine on the same params and the
    first 4 requests at 128 + 16 (``DENSE_TRAFFIC``: 6 tok/s, so the 8
    requests took ~40 s). Every
    request finishes with its tokens, no non-finite row, no kernel
    launched (the family has no attention and runs no TPU kernel), no
    page allocated; tok/s, TTFT p50, peak memory, the slot pool's bytes
    and the paged/legacy token agreement printed. Returns the results."""
    from repro_torch.launch import serve
    a = serve_args(arch="mamba2-2.7b", **FAMILY_TRAFFIC)
    cfg, params = _build(a)
    none = {"paged_gather": (0, True), "spinner": (0, True),
            "srf_decode": (0, True)}
    la = serve_args(arch="mamba2-2.7b", legacy=True, **DENSE_TRAFFIC)
    res, firsts = {}, {}
    for label, args in (("paged", a), ("legacy", la)):
        serve.warm(args, cfg, params)
        eng = serve.engine(args, cfg, params)
        firsts[label] = first_logits(eng)
        res[label] = _family_run(f"mamba2-2.7b {label}", args, cfg, params,
                                 none, eng=eng)
        del eng
    paged, leg = res["paged"], res["legacy"]
    paged["agreement"] = _agreement(paged, leg)
    paged["first_logit_gap"] = _first_logit_gap(
        "mamba2-2.7b", firsts["paged"], firsts["legacy"],
        _f32_first_logits(cfg, params, la), "ssm")
    log(f"    paged/legacy: generated tokens equal position by position "
        f"{paged['agreement']:.3f}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged": paged, "legacy": leg}


def phase_serve_hybrid():
    """Full-width hymba-1.5b (16 of its 32 layers, ``SERVE_CUT``;
    d_model 1600, 25 q / 5 kv heads
    of 64 beside 50 SSD heads of 64 with state 16, bf16), 8 greedy
    requests of 128 + 32 tokens, 8 slots: full KV on bf16 pages
    (paged_gather_kv exactly 32 a step), int8 pages
    (paged_gather_dequant_kv exactly 32 a step), SRF (the spinner at least 64 a step, srf_decode
    exactly 32 a decode step), each beside nothing else; with full KV
    also the legacy engine (no kernel; the first 4 requests at 128 + 16)
    and the prefix cache: a donor of
    the 96 shared tokens, then the 8 requests, each of which resumes at
    the donor's state point (96 hit tokens a request). Returns the
    results."""
    from repro_torch.launch import serve
    from repro_torch.serving import Request
    out = {}
    none = {"paged_gather": (0, True), "spinner": (0, True),
            "srf_decode": (0, True)}
    for attn, runs in (("full", (("full KV", {}),
                                 ("int8 pages", {"quantize_kv": True}))),
                       ("srf", (("SRF", {}),))):
        a = serve_args(attn, arch="hymba-1.5b", **FAMILY_TRAFFIC)
        cfg, params = _build(a)
        n = cfg.n_layers
        for label, flags in runs:
            ra = serve_args(attn, arch="hymba-1.5b", **FAMILY_TRAFFIC,
                            **flags)
            serve.warm(ra, cfg, params)
            eng = serve.engine(ra, cfg, params)
            rec = first_logits(eng)
            if label == "full KV":
                first_rec = rec
            res = _family_run(f"hymba-1.5b {label}", ra, cfg, params,
                              eng=eng)
            del eng
            steps, dec = res["steps"], res["decode_steps"]
            want = {"full KV": {"paged_gather_kv": (n * steps, True)},
                    "int8 pages": {"paged_gather_dequant_kv":
                                   (n * steps, True)},
                    "SRF": {"spinner": (2 * n * steps, False),
                            "srf_decode": (n * dec, True)}}[label]
            _expect_launches(f"hymba-1.5b {label}", res["counts"],
                             {**none, **want})
            out[label] = res
        if attn == "full":
            la = serve_args(arch="hymba-1.5b", legacy=True,
                            **DENSE_TRAFFIC)
            serve.warm(la, cfg, params)
            leng = serve.engine(la, cfg, params)
            lrec = first_logits(leng)
            out["legacy"] = _family_run("hymba-1.5b legacy full KV", la,
                                        cfg, params, none, eng=leng)
            del leng
            out["full KV"]["first_logit_gap"] = _first_logit_gap(
                "hymba-1.5b full KV", first_rec, lrec,
                _f32_first_logits(cfg, params, la), "hybrid")
            out["full KV"]["agreement"] = _agreement(out["full KV"],
                                                     out["legacy"])
            log(f"    paged/legacy full KV: generated tokens equal position "
                f"by position {out['full KV']['agreement']:.3f}")
            pa = serve_args(arch="hymba-1.5b", prefix_cache=True,
                            shared_prefix=SHARED, **FAMILY_TRAFFIC)
            serve.warm(pa, cfg, params)
            eng = serve.engine(pa, cfg, params)
            reqs = serve.requests(pa, cfg)
            serve.serve(pa, eng=eng, reqs=[Request(
                uid=100, prompt=reqs[0].prompt[:SHARED].copy(), max_new=2)])
            steps0 = _steps(eng)
            res = _family_run("hymba-1.5b prefix cache (a donor of the 96 "
                              "shared tokens, then the 8 requests)", pa, cfg,
                              params, eng=eng, reqs=reqs)
            _expect_launches("hymba-1.5b prefix cache", res["counts"], {
                **none, "paged_gather_kv": (n * (_steps(eng) - steps0),
                                            True)})
            v = eng.metrics.value_sum
            stats = {c: int(v(c)) for c in PREFIX_COUNTERS}
            log(f"    prefix counters: {stats}; the same 8 requests cold: "
                f"TTFT p50 {out['full KV']['ttft_s']['p50']:.4f} s")
            if stats["prefix_hit_tokens_total"] != SHARED * len(reqs):
                raise AssertionError(f"hymba prefix cache: expected "
                                     f"{SHARED * len(reqs)} hit tokens: "
                                     f"{stats}")
            eng.prefix.drop_all()
            if eng.sched.alloc.used_pages or \
                    eng.sched.slot_alloc.used_pages:
                raise AssertionError("hymba prefix cache: pages or slots "
                                     "left after drop_all")
            res["prefix"] = stats
            out["prefix cache"] = res
            del eng
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


DENSE_CONFIGS = ("qwen2.5-14b", "mistral-nemo-12b", "internlm2-20b")
DENSE_TRAFFIC = dict(requests=4, prompt_len=128, max_new=16, slots=4,
                     max_len=256, seed=0, device="cuda")


def phase_serve_dense_configs():
    """qwen2.5-14b, mistral-nemo-12b and internlm2-20b at full width
    (bf16, random weights), one after another, the params and pools of
    each freed before the next: full KV on bf16 pages, 4 greedy requests
    of 128 + 16 tokens, 4 slots. paged_gather_kv exactly 1 a layer a
    step, nothing else; tok/s, TTFT p50 and peak memory printed."""
    from repro_torch.launch import serve
    out = {}
    for arch in DENSE_CONFIGS:
        a = serve_args(arch=arch, **DENSE_TRAFFIC)
        t0 = time.perf_counter()
        cfg, params = serve.build(a)
        torch.cuda.synchronize()
        _describe(cfg, params, t0)
        serve.warm(a, cfg, params)
        res = _family_run(f"{arch} full KV", a, cfg, params)
        _expect_launches(arch, res["counts"], {
            "paged_gather_kv": (cfg.n_layers * res["steps"], True),
            "spinner": (0, True), "srf_decode": (0, True)})
        out[arch] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _srf_launches(label, cfg, res, probes):
    """An SRF run's launches, exactly: the spinner 2 a layer a step (a
    layer's query and key feature maps) plus the live quality probe's
    own (one sample a run, ``count_probes``), srf_decode 1 a layer a
    decode step, nothing else."""
    if probes.calls != 1:
        raise AssertionError(f"{label}: {probes.calls} quality samples")
    n = cfg.n_layers
    _expect_launches(label, res["counts"], {
        "spinner": (2 * n * res["steps"] + probes.spinner, True),
        "srf_decode": (n * res["decode_steps"], True),
        "paged_gather": (0, True)})
    log(f"    spinner {res['counts']['spinner']} = 2 x {n} layers x "
        f"{res['steps']} steps + {probes.spinner} in the quality probe; "
        f"srf_decode {res['counts']['srf_decode']} = {n} x "
        f"{res['decode_steps']} decode steps")


def _build(a):
    """Random full-width params for the serve arguments ``a``, at the
    depth ``SERVE_CUT`` gives the arch (whole where it names none),
    described; -> (cfg, params)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as model_lib
    t0 = time.perf_counter()
    cfg = dataclasses.replace(serve.config(a), **SERVE_CUT.get(a.arch, {}))
    params = model_lib.init(cfg, seed=a.seed, device=a.device)
    torch.cuda.synchronize()
    _describe(cfg, params, t0)
    log(f"    active params a token {cfg.active_param_count() / 1e9:.3f} B "
        f"of {cfg.param_count() / 1e9:.3f} B; memory after init "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    return cfg, params


def _free():
    """Return what the dropped params and engines held to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_moe():
    """Full-width moonshot-v1-16b-a3b cut to 24 of its 48 layers
    (``SERVE_CUT``: 1 dense, then 23 MoE of 64 experts, top-6, 2 shared;
    16 q / 16 kv heads of 128; bf16), random weights: full KV on bf16 pages, 8 greedy
    requests of 128 + 32 tokens, 8 slots (paged_gather_kv exactly 1 a
    layer a step); int8 pages, 4 requests of 128 + 16 (paged_gather_dequant_kv
    exactly 1 a layer a step); then, the params rebuilt with SRF
    attention, SRF at 4 x (128 + 16) (``_srf_launches``). Nothing else
    launched, no plain route; tok/s, TTFT p50, peak memory and pool
    bytes printed. Returns the results."""
    from repro_torch.launch import serve
    arch = "moonshot-v1-16b-a3b"
    out = {}
    for attn, runs in (("full", (("full KV", {}, FAMILY_TRAFFIC),
                                 ("int8 pages", {"quantize_kv": True},
                                  DENSE_TRAFFIC))),
                       ("srf", (("SRF", {}, DENSE_TRAFFIC),))):
        cfg, params = _build(serve_args(attn, arch=arch, **FAMILY_TRAFFIC))
        n = cfg.n_layers
        for label, flags, traffic in runs:
            a = serve_args(attn, arch=arch, **traffic, **flags)
            serve.warm(a, cfg, params)
            eng = serve.engine(a, cfg, params)
            with count_probes() as probes:
                res = _family_run(f"{arch} {label}", a, cfg, params, eng=eng)
            del eng
            steps = res["steps"]
            if label == "SRF":
                _srf_launches(f"{arch} SRF", cfg, res, probes)
            else:
                key = "paged_gather_kv" if label == "full KV" \
                    else "paged_gather_dequant_kv"
                _expect_launches(f"{arch} {label}", res["counts"], {
                    key: (n * steps, True),
                    "spinner": (0, True), "srf_decode": (0, True)})
            out[label] = res
        del params
        _free()
    return out


def phase_serve_mla():
    """Full-width deepseek-v2-lite-16b (27 layers: 1 dense, then 26 MoE;
    MLA with kv_lora 512, qk 128 + 64 rope, v 128, 16 heads; bf16; 15.7
    B params), random weights: MLA latent pages, 8 greedy requests of
    128 + 32 tokens, 8 slots (paged_gather_kv exactly 1 a layer a step:
    the latents c and kpe in one launch); the legacy engine on the first 4 of them, 128 +
    16 tokens, 4 slots (no kernel launched); then, the params rebuilt
    with SRF attention, MLA + SRF at 4 x (128 + 16) (``_srf_launches``).
    The two engines' first-token logits agree within
    ``FAMILY_LOGIT_TOL["mla"]``; no f32 anchor (an f32 copy of 15.7 B
    params, 63 GB, does not fit beside the bf16 weights). Returns the
    results."""
    from repro_torch.launch import serve
    arch = "deepseek-v2-lite-16b"
    none = {"paged_gather": (0, True), "spinner": (0, True),
            "srf_decode": (0, True)}
    out = {}
    cfg, params = _build(serve_args(arch=arch, **FAMILY_TRAFFIC))
    n = cfg.n_layers
    a = serve_args(arch=arch, **FAMILY_TRAFFIC)
    serve.warm(a, cfg, params)
    eng = serve.engine(a, cfg, params)
    prec = first_logits(eng)
    res = _family_run(f"{arch} MLA", a, cfg, params, eng=eng)
    del eng
    _expect_launches(f"{arch} MLA", res["counts"], {
        **none, "paged_gather_kv": (n * res["steps"], True)})
    out["MLA"] = res
    la = serve_args(arch=arch, legacy=True, **DENSE_TRAFFIC)
    serve.warm(la, cfg, params)
    leng = serve.engine(la, cfg, params)
    lrec = first_logits(leng)
    out["legacy"] = _family_run(f"{arch} legacy MLA", la, cfg, params, none,
                                eng=leng)
    del leng
    res["first_logit_gap"] = _first_logit_gap(f"{arch} MLA", prec, lrec,
                                              None, "mla")
    del params, prec, lrec
    _free()
    cfg, params = _build(serve_args("srf", arch=arch, **FAMILY_TRAFFIC))
    a = serve_args("srf", arch=arch, **DENSE_TRAFFIC)
    serve.warm(a, cfg, params)
    eng = serve.engine(a, cfg, params)
    with count_probes() as probes:
        res = _family_run(f"{arch} MLA+SRF", a, cfg, params, eng=eng)
    del eng
    _srf_launches(f"{arch} MLA+SRF", cfg, res, probes)
    out["MLA+SRF"] = res
    del params
    _free()
    return out


def phase_serve_vlm():
    """Full-width qwen2-vl-2b (28 layers, d_model 1536, 12 q / 2 kv heads
    of 128, bf16; served as a text LM with 1-D RoPE, as the reference's
    engines serve it), random weights, 8 greedy requests of 128 + 32
    tokens, 8 slots: full KV on bf16 pages (paged_gather_kv exactly 1 a
    layer a step), then, the params rebuilt with SRF attention, SRF
    (``_srf_launches``). Nothing else launched; tok/s, TTFT p50, peak
    memory and pool bytes printed. Returns the results."""
    from repro_torch.launch import serve
    arch = "qwen2-vl-2b"
    out = {}
    for attn, label in (("full", "full KV"), ("srf", "SRF")):
        cfg, params = _build(serve_args(attn, arch=arch, **FAMILY_TRAFFIC))
        a = serve_args(attn, arch=arch, **FAMILY_TRAFFIC)
        serve.warm(a, cfg, params)
        eng = serve.engine(a, cfg, params)
        with count_probes() as probes:
            res = _family_run(f"{arch} {label}", a, cfg, params, eng=eng)
        del eng
        if attn == "srf":
            _srf_launches(f"{arch} SRF", cfg, res, probes)
        else:
            _expect_launches(f"{arch} full KV", res["counts"], {
                "paged_gather_kv": (cfg.n_layers * res["steps"], True),
                "spinner": (0, True), "srf_decode": (0, True)})
        out[label] = res
        del params
        _free()
    return out


def _encode_ms(eng, reqs):
    """Device ms of one request's encoder pass (``Engine._encode``, batch
    1, as at admission): CUDA events around back-to-back calls, median
    of 5 repeats of 3."""
    feats = torch.as_tensor(reqs[0].enc_emb[None], device="cuda")
    return device_ms(lambda: eng._encode(eng.params, feats), launches=3,
                     repeats=5)


def _cross_ms(cfg, params, gen):
    """Device ms of a decode step's cross attention: one decoder layer's
    ``paged_cross_attention`` at the step's shapes (8 rows of 1 token over
    8 gathered memories of 1024 x 1024), times the layer count."""
    from repro_torch.models import attention as attn_lib
    p = {k: v[0] for k, v in params["segments"][0]["cross"].items()}
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    mem = torch.randn((8, cfg.enc_len, cfg.d_model), generator=gen,
                      device="cuda").to(torch.bfloat16)
    one = device_ms(lambda: attn_lib.paged_cross_attention(p, cfg, x, mem),
                    launches=10, repeats=5)
    return one * cfg.n_layers


# first-token logits of the enc-dec engines (bf16, 8 paged chunks of 32
# against one legacy prefill of 128, both after one batch-1 encoder
# pass): a first card run measured 0.0130 between the engines and
# 0.0142-0.0147 against an f32 copy's prefill; the limits are about twice
# that
FAMILY_LOGIT_TOL["audio"] = (0.03, 0.03)


def phase_serve_encdec():
    """Full-width seamless-m4t-large-v2 (cut to 12 of its 24 encoder and
    12 of its 24 decoder layers, ``SERVE_CUT``; d_model 1024, 16 heads of 64, vocab 256206, bf16), random weights, 8
    greedy requests of 128 + 32 tokens, 8 slots, each request with its
    own 1024 x 160 synthetic audio features (encoded once at admission,
    batch 1, into its slot of the memory pool): full KV on bf16 pages
    (paged_gather_kv exactly 1 a layer a step for K and V plus the
    one-pool paged_gather 1 a step for the memory), int8 pages (paged_gather_dequant_kv 1 a layer a step,
    paged_gather 1 a step), SRF (the spinner 2 a layer a step, 2 an
    encoder layer a request at admission, plus the probe's; srf_decode 1
    a layer a decode step; paged_gather 1 a step); the prefix cache (a
    donor of the 96 shared tokens with request 0's features, then the 8
    requests: 0-3 with the donor's features hit its 96 tokens, 4-7 with
    their own hit nothing); the legacy engine on the first 4 requests at
    128 + 32, 4 slots (no kernel; first-token logits within
    ``FAMILY_LOGIT_TOL["audio"]`` of the paged engine's and of an f32
    copy's prefill). Encode ms a request (``_encode_ms``) and the cross
    attention's device ms a step (``_cross_ms``) printed beside tok/s,
    TTFT p50, peak memory and the memory pool's bytes. Returns the
    results."""
    from repro_torch.launch import serve
    from repro_torch.serving import Request
    from repro_torch.serving import paged_cache
    arch = "seamless-m4t-large-v2"
    none = {"paged_gather": (0, True), "spinner": (0, True),
            "srf_decode": (0, True)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = {}
    for attn, runs in (("full", (("full KV", {}),
                                 ("int8 pages", {"quantize_kv": True}))),
                       ("srf", (("SRF", {}),))):
        cfg, params = _build(serve_args(attn, arch=arch, **FAMILY_TRAFFIC))
        n = cfg.n_layers
        for label, flags in runs:
            a = serve_args(attn, arch=arch, **FAMILY_TRAFFIC, **flags)
            serve.warm(a, cfg, params)
            eng = serve.engine(a, cfg, params)
            prec = first_logits(eng)
            with count_probes() as probes:
                res = _family_run(f"{arch} {label}", a, cfg, params, eng=eng)
            steps, dec = res["steps"], res["decode_steps"]
            mem_b = paged_cache.memory_bytes(eng.pools)
            res["memory_pool_bytes"] = mem_b
            res["encode_ms"] = _encode_ms(eng, serve.requests(a, cfg))
            log(f"    memory pool {mem_b} B ({eng.sched.num_slots} slots x "
                f"{cfg.enc_len} x {cfg.d_model}); encode "
                f"{res['encode_ms']:.3f} ms of device time a request "
                f"(batch 1)")
            del eng
            if label == "SRF":
                if probes.calls != 1:
                    raise AssertionError(f"{arch} SRF: {probes.calls} "
                                         f"quality samples")
                want = {"spinner": (2 * n * steps + 2 * cfg.enc_layers
                                    * a.requests + probes.spinner, True),
                        "srf_decode": (n * dec, True),
                        "paged_gather": (steps, True)}
            elif label == "int8 pages":
                want = {"paged_gather_dequant_kv": (n * steps, True),
                        "paged_gather": (steps, True)}
            else:
                want = {"paged_gather_kv": (n * steps, True),
                        "paged_gather": (steps, True)}
            _expect_launches(f"{arch} {label}", res["counts"],
                             {**none, **want})
            log(f"    launches as the path needs: {want}")
            out[label] = res
            if label == "full KV":
                first_rec = prec
                res["cross_ms"] = _cross_ms(cfg, params, gen)
                log(f"    cross attention: {res['cross_ms']:.3f} ms of device "
                    f"time a decode step ({n} layers x memory @ wk, wv over "
                    f"8 x {cfg.enc_len} rows)")
        if attn == "full":
            pa = serve_args(arch=arch, prefix_cache=True,
                            shared_prefix=SHARED, **FAMILY_TRAFFIC)
            serve.warm(pa, cfg, params)
            eng = serve.engine(pa, cfg, params)
            reqs = serve.requests(pa, cfg)
            for r in reqs[1:4]:
                r.enc_emb = reqs[0].enc_emb
            serve.serve(pa, eng=eng, reqs=[Request(
                uid=100, prompt=reqs[0].prompt[:SHARED].copy(), max_new=2,
                enc_emb=reqs[0].enc_emb)])
            steps0 = _steps(eng)
            res = _family_run(f"{arch} prefix cache (a donor of the 96 "
                              f"shared tokens, then 4 requests with its "
                              f"features and 4 with their own)", pa, cfg,
                              params, eng=eng, reqs=reqs)
            st = _steps(eng) - steps0
            _expect_launches(f"{arch} prefix cache", res["counts"], {
                **none, "paged_gather_kv": (n * st, True),
                "paged_gather": (st, True)})
            v = eng.metrics.value_sum
            stats = {c: int(v(c)) for c in PREFIX_COUNTERS}
            hit = sorted(r.uid for r in reqs if r.trace.count("prefix_hit"))
            log(f"    prefix counters: {stats}; hit uids {hit}; the 8 "
                f"requests cold: TTFT p50 "
                f"{out['full KV']['ttft_s']['p50']:.4f} s")
            if stats["prefix_hit_tokens_total"] != 4 * SHARED or \
                    stats["prefix_hits_total"] != 4 or hit != [0, 1, 2, 3]:
                raise AssertionError(f"{arch} prefix cache: expected 4 hits "
                                     f"of {SHARED} tokens (uids 0-3): "
                                     f"{stats}, {hit}")
            eng.prefix.drop_all()
            if eng.sched.alloc.used_pages or \
                    eng.sched.slot_alloc.used_pages:
                raise AssertionError(f"{arch} prefix cache: pages or slots "
                                     f"left after drop_all")
            res["prefix"] = stats
            out["prefix cache"] = res
            del eng
            la = serve_args(arch=arch, legacy=True,
                            **dict(FAMILY_TRAFFIC, requests=4, slots=4))
            serve.warm(la, cfg, params)
            leng = serve.engine(la, cfg, params)
            lrec = first_logits(leng)
            out["legacy"] = _family_run(f"{arch} legacy full KV", la, cfg,
                                        params, none, eng=leng)
            del leng
            out["full KV"]["first_logit_gap"] = _first_logit_gap(
                f"{arch} full KV", first_rec, lrec,
                _f32_first_logits(cfg, params, la), "audio")
        del params
        _free()
    return out


# ---------------------------------------------------------------------------
# the mesh: head-sharded paged serving on a mesh of the one card repeated
# ---------------------------------------------------------------------------

# qwen3-4b at TP 2 (a shard: 16 q / 4 kv heads of 128, a group of 4):
# 8 requests, KV rows of 4 x 128 = 512, SRF m = 256; seamless at TP 2 (a
# shard: 8 heads of 64): KV rows of 8 x 64 = 512
MESH = dict(tp=2, rows=8, kv_heads=4, group=4, hd=128, m=256, q_heads=16,
            layers=36, sm_layers=24, pages=257, page=16, width=16)


def _card_meshes(replicas, tp=MESH["tp"]):
    """``replicas`` ('data', 'model') meshes of ``tp`` positions, every
    position the one card (``launch.mesh.make_serving_meshes`` over
    ``cuda:0`` repeated)."""
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.make_serving_meshes(
        replicas, tp, devices=[torch.device("cuda", 0)] * (replicas * tp))


def _seeded_case(label, gsz, bsz, n, m, dtype, epi, gen):
    """One seeded-spinner shape against its plain version, timed beside it
    and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import spinner as kspin
    x = (torch.randn((gsz, bsz, n), generator=gen, device="cuda")
         * n ** -0.25).to(dtype)
    seeds = torch.randint(0, 2 ** 32, (gsz,), generator=gen, device="cuda",
                          dtype=torch.int64)
    kw = dict(use_hd=True, epilogue=epi, out_scale=m ** -0.5)
    err = check_exp(f"{label} {str(dtype)[6:]} (G={gsz}, B={bsz}, n={n}, "
                    f"m={m}, {epi})",
                    kspin.spinner_project_seeded_cuda("circulant", seeds, x,
                                                      m, **kw),
                    ref.spinner_project_seeded_ref("circulant", seeds, x, m,
                                                   **kw), dtype, epi)
    k_ms = device_ms(lambda: kspin.spinner_project_seeded_cuda(
        "circulant", seeds, x, m, **kw))
    p_ms = device_ms(lambda: ref.spinner_project_seeded_ref(
        "circulant", seeds, x, m, **kw), launches=10, repeats=3)
    b_ms, b_by = seeded_bound("circulant", gsz, bsz, n, m, x.element_size(),
                              m)
    log(f"    kernel {k_ms:.5f} ms  plain {p_ms:.4f} ms  bound {b_ms:.6f} "
        f"ms ({b_by})")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def phase_mesh_kernels(gen):
    """Kernels 1-5 at the per-shard shapes of qwen3-4b served at TP 2
    (``MESH``), which each shard launches on its own heads: the spinner at
    G = 4 kv heads (decode query B = 8 requests x a group of 4 = 32,
    identity; decode key B = 8, exp), the seeded spinner at the local
    seeds (G = 4 kv heads x 8 requests = 32 groups; query B = 4, key B =
    1), srf_decode at (B = 8, H = 16, m = 256, dv = 128), paged_gather on
    bf16 rows of D = 4 x 128 = 512 (36 layer pools cycled; seamless's D =
    8 x 64 = 512, 24 pools) and paged_gather_dequant_kv on int8 rows of
    512. Each against its plain version (phase 2's tolerance; the gathers
    bit-equal, also to ``pool[tables]``), timed beside it, its bound and
    (the gathers) ``pool[tables]``. Returns {kernel: record}."""
    h = MESH
    bf = torch.bfloat16
    out = {}
    g, n, m, r = h["kv_heads"], h["hd"], h["m"], h["rows"]
    out["spinner"] = _spinner_case("TP 2 shard spinner decode query", g,
                                   r * h["group"], n, m, bf, "identity",
                                   True, gen)
    out["spinner key"] = _spinner_case("TP 2 shard spinner decode key", g, r,
                                       n, m, bf, "exp", True, gen)
    out["seeded_spinner"] = _seeded_case(
        "TP 2 shard seeded spinner decode query", g * r, h["group"], n, m,
        bf, "identity", gen)
    out["seeded_spinner key"] = _seeded_case(
        "TP 2 shard seeded spinner decode key", g * r, 1, n, m, bf, "exp",
        gen)
    out["srf_decode"] = _srf_decode_case("TP 2 shard", r, h["q_heads"], m, n,
                                         gen)
    npg, pg, w = h["pages"], h["page"], h["width"]
    d = g * n
    out["paged_gather"] = _gather_case("qwen3-4b TP 2 shard K and V",
                                       h["layers"], npg, pg, d, r, w, gen,
                                       d_b=d)
    out["seamless paged_gather"] = _gather_case(
        "seamless TP 2 shard K and V", h["sm_layers"], npg, pg, d, r, w, gen,
        d_b=d)
    out["paged_gather_dequant"] = _dequant_kv_case(
        "qwen3-4b TP 2 shard", h["layers"], npg, pg, d, r, w, gen)
    torch.cuda.empty_cache()
    return out


# the reference's FAM matrix (tests/test_mesh_serving.py): (family, arch,
# overrides); the MoE-free configs, f32, 2 layers
MESH_FAMS = [("kv", "qwen3-4b", {}), ("srf", "qwen3-4b", {"attn_impl": "srf"}),
             ("mla", "deepseek-v2-lite-16b", CF8), ("ssd", "mamba2-2.7b", {}),
             ("hybrid", "hymba-1.5b", {}),
             ("encdec", "seamless-m4t-large-v2", {})]


def _mesh_work(cfg, n=16, seed=0):
    """The reference's FAM traffic: ``n`` requests of 2-19 prompt tokens
    and 3-7 new (enc-dec: each with its own features)."""
    from repro_torch.models import frontends
    rng = np.random.default_rng(seed)
    spec = [(int(rng.integers(2, 20)), int(rng.integers(3, 8)))
            for _ in range(n)]
    prompts = [rng.integers(0, cfg.vocab, pl).astype(np.int32)
               for pl, _ in spec]
    encs = [frontends.synthetic_audio_features(rng, cfg)
            if cfg.is_encdec else None for _ in spec]
    return [(p, mn, e) for (_, mn), p, e in zip(spec, prompts, encs)]


def _mesh_serve(eng, work):
    """{uid: tokens} of ``work`` served by ``eng`` (an engine or router)."""
    from repro_torch.serving import Request
    for i, (p, mn, e) in enumerate(work):
        eng.submit(Request(uid=i, prompt=p.copy(), max_new=mn, enc_emb=e))
    return {r.uid: list(r.out_tokens) for r in eng.run()}


def _mesh_launches(label, fam, cfg, counts, engines, tp):
    """The sharded path's launches summed over ``engines``' steps: each
    shard gathers its own K and V in one launch (TP a layer a step;
    enc-dec plus the replicated memory, 1 one-pool gather a step), int8
    pages one dequant launch a shard and layer, SRF srf_decode TP a layer
    a decode step and the spinner at least 2 x TP a layer a step; MLA
    latents and SSD degrade (1 gather of c and kpe a layer a step,
    nothing)."""
    steps = sum(_steps(e) for e in engines)
    dsteps = sum(int(e.stats["decode_steps"]) for e in engines)
    n = cfg.n_layers
    want = {"kv": {"paged_gather_kv": (tp * n * steps, True)},
            "int8": {"paged_gather_dequant_kv": (tp * n * steps, True),
                     "paged_gather_kv": (0, True)},
            "srf": {"spinner": (2 * tp * n * steps, False),
                    "srf_decode": (tp * n * dsteps, True)},
            "mla": {"paged_gather_kv": (n * steps, True)},
            "ssd": {},
            "hybrid": {"paged_gather_kv": (tp * n * steps, True)},
            "encdec": {"paged_gather_kv": (tp * n * steps, True),
                       "paged_gather": (steps, True)}}[fam]
    _expect_launches(f"{label} ({steps} steps)", counts, want)
    return steps


def phase_reduced_mesh():
    """The reference's mesh-serving cells on the card, f32, 2 layers, on
    meshes of the card repeated: (1) the FAM matrix (kv, srf, mla, ssd,
    hybrid, encdec): 16 requests through a router of 2 replicas x TP 2
    give the unsharded card engine's tokens and the CPU's, both replicas
    serve, ``pool_bytes_per_device`` * TP == ``pool_bytes`` for kv and srf,
    strictly between for hybrid and enc-dec, equal for the degraded MLA
    and SSD, the launches of ``_mesh_launches``; (2) a tight TP 2 pool
    preempts and gives a roomy unsharded engine's tokens, card == CPU;
    (3) int8 pages at TP 2 == int8 unsharded == CPU; (4) a preempted
    sequence migrates with its snapshot between sharded replicas, and a
    single-slot sharded replica's fresh backlog drains through another
    sharded one, tokens unchanged."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as model_lib
    from repro_torch.serving import (Engine, PagedConfig, Router,
                                     RouterConfig, SchedConfig)
    from repro_torch.serving.mesh import shard
    for fam, arch, over in MESH_FAMS:
        cfg = registry.reduced(arch, n_layers=2, **over)
        params = model_lib.init(cfg, seed=3, device="cpu")
        work = _mesh_work(cfg)
        cpu = _mesh_serve(Engine(cfg, params, batch_slots=8, max_len=64,
                                 device="cpu"), work)
        cparams = _to(params, "cuda")
        single = Engine(cfg, cparams, batch_slots=8, max_len=64,
                        device="cuda")
        want = _mesh_serve(single, work)
        meshes = _card_meshes(2)
        router = Router([Engine(cfg, cparams, batch_slots=8, max_len=64,
                                mesh=m) for m in meshes])
        ops.reset_counts()
        got = _mesh_serve(router, work)
        counts = ops.launch_counts()
        if not (got == want == cpu) or len(got) != 16:
            raise AssertionError(f"mesh {fam}: router x TP 2 tokens, "
                                 f"unsharded card tokens and CPU tokens "
                                 f"differ")
        if not all(e.stats["requests"] for e in router.engines):
            raise AssertionError(f"mesh {fam}: a replica served nothing")
        tp = shard.paged_tp(cfg, meshes[0])
        pbd = router.engines[0].cache_report()["pool_bytes_per_device"]
        pb = single.cache_report()["pool_bytes"]
        ok = {"hybrid": tp == 2 and pb / tp < pbd < pb,
              "encdec": tp == 2 and pb / tp < pbd < pb,
              "kv": tp == 2 and pbd * tp == pb,
              "srf": tp == 2 and pbd * tp == pb}.get(fam, tp == 1
                                                     and pbd == pb)
        if not ok:
            raise AssertionError(f"mesh {fam}: tp {tp}, pool bytes per "
                                 f"device {pbd} against {pb}")
        steps = _mesh_launches(f"mesh {fam}", fam, cfg, counts,
                               router.engines, tp)
        log(f"  mesh {fam} ({arch}, TP {tp}): 2 replicas x TP 2 tokens == "
            f"unsharded card == CPU ({sum(map(len, got.values()))} tokens, "
            f"{steps} steps, replicas served "
            f"{[int(e.stats['requests']) for e in router.engines]}); pool "
            f"bytes per device {pbd} of {pb}; launches {counts}")
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    params = model_lib.init(cfg, seed=3, device="cpu")
    cparams = _to(params, "cuda")
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, cfg.vocab, 3).astype(np.int32), 10, None)
            for _ in range(4)]
    geo = dict(max_batch=4, prefill_batch=2, prefill_chunk=4, page_size=4,
               table_width=4)

    def eng(n, mesh=None, device="cuda", p=cparams, **kw):
        return Engine(cfg, p, sched=SchedConfig(num_pages=n, **geo),
                      device=device, mesh=mesh, **kw)
    roomy = _mesh_serve(eng(33), work)
    tight = eng(9, _card_meshes(1)[0])
    got = _mesh_serve(tight, work)
    cpu = _mesh_serve(eng(33, device="cpu", p=params), work)
    if tight.stats["preemptions"] == 0 or not (got == roomy == cpu):
        raise AssertionError(f"mesh preemption: {tight.stats['preemptions']}"
                             f" preemptions, tokens equal "
                             f"{got == roomy}, card == CPU {roomy == cpu}")
    pc = PagedConfig(quantize_kv=True)
    iw = _mesh_work(cfg, n=6, seed=3)
    q1 = _mesh_serve(Engine(cfg, cparams, batch_slots=4, max_len=32,
                            paged=pc, device="cuda"), iw)
    ops.reset_counts()
    q2e = Engine(cfg, cparams, batch_slots=4, max_len=32, paged=pc,
                 mesh=_card_meshes(1)[0])
    q2 = _mesh_serve(q2e, iw)
    _mesh_launches("mesh int8", "int8", cfg, ops.launch_counts(), [q2e], 2)
    qc = _mesh_serve(Engine(cfg, params, batch_slots=4, max_len=32,
                            paged=pc, device="cpu"), iw)
    if not (q1 == q2 == qc):
        raise AssertionError("mesh int8: TP 2, unsharded and CPU int8 "
                             "tokens differ")
    meshes = _card_meshes(2)
    e0, e1 = eng(9, meshes[0]), eng(33, meshes[1])
    router = Router([e0, e1], RouterConfig(migrate=True))
    from repro_torch.serving import Request
    reqs = [Request(uid=i, prompt=p.copy(), max_new=mn)
            for i, (p, mn, _) in enumerate(work)]
    for r in reqs:
        e0.submit(r)
        router.home[r.uid] = 0
    router.run()
    restored = [ev["uid"] for ev in e1.metrics.events
                if ev["event"] == "restored"]
    migrated = {r.uid: list(r.out_tokens) for r in reqs}
    if not restored or migrated != roomy or not router.stats["migrations"]:
        raise AssertionError(f"mesh preempt-then-migrate: restored "
                             f"{restored}, tokens equal {migrated == roomy}")
    slot1 = SchedConfig(max_batch=1, prefill_batch=1, prefill_chunk=4,
                        page_size=4, num_pages=5, table_width=4)
    f0 = Engine(cfg, cparams, sched=slot1, mesh=meshes[0])
    f1 = Engine(cfg, cparams, batch_slots=4, max_len=16, mesh=meshes[1])
    fr = Router([f0, f1])
    for i, (p, mn, _) in enumerate(work):
        f0.submit(Request(uid=i, prompt=p.copy(), max_new=mn))
        fr.home[i] = 0
    fresh = {r.uid: list(r.out_tokens) for r in fr.run()}
    if fresh != roomy or not fr.stats["migrations"]:
        raise AssertionError("mesh fresh migration: tokens differ or no "
                             "migration")
    log(f"  mesh qwen3-4b: tight TP 2 pool {int(tight.stats['preemptions'])}"
        f" preemptions, tokens == roomy unsharded == CPU; int8 TP 2 == int8 "
        f"unsharded == CPU; preempt-then-migrate between TP 2 replicas: "
        f"{int(router.stats['migrations'])} migrations, restored {restored}; "
        f"fresh backlog {int(fr.stats['migrations'])} migrations; tokens "
        f"unchanged")


# first-token logits of the TP 2 engine against the TP 1 engine on the
# same requests, as a share of the row's largest |logit|. cuBLAS picks
# its algorithm by shape, so x @ wq[:, shard] need not give the columns
# of x @ wq bit for bit; the first card run measured 0 in all four cells
# (every first-token row bit-equal, every generated token equal). The
# limit sits below one bf16 spacing of the row's largest (2^-8).
MESH_LOGIT_TOL = 2e-3
MESH_RUNS = (("full KV", "full", False, False),
             ("int8 pages", "full", True, False),
             ("SRF", "srf", False, False),
             ("seeded SRF", "srf", False, True))


def _warm_mesh(a, cfg, params, mesh):
    """``serve.warm`` on an engine of its own over ``mesh`` (None: the
    plain engine): 2 requests of 16 + 2 tokens."""
    from repro_torch.launch import serve
    w = copy.copy(a)
    w.requests, w.prompt_len, w.max_new, w.seed = 2, 16, 2, a.seed + 1
    serve.serve(w, eng=serve.engine(w, cfg, params, mesh=mesh))


def _mesh_path(label, cfg, res, tp, probes=None):
    """The launches of one full-width run at TP ``tp`` (every shard's own):
    full KV paged_gather_kv TP a layer a step, int8 pages one
    ``paged_gather_dequant_kv`` a shard and layer a step, SRF the spinner
    (materialized or seeded) 2 x TP a layer a step plus the quality
    probe's and srf_decode TP a layer a decode step; nothing else."""
    n, steps, dsteps = cfg.n_layers, res["steps"], res["decode_steps"]
    if label == "full KV":
        want = {"paged_gather_kv": (tp * n * steps, True)}
    elif label == "int8 pages":
        want = {"paged_gather_dequant_kv": (tp * n * steps, True)}
    else:
        key = "spinner_seeded" if label == "seeded SRF" else "spinner"
        if probes.calls != 1:
            raise AssertionError(f"{label} TP {tp}: {probes.calls} quality "
                                 f"samples")
        want = {key: (2 * tp * n * steps + probes.spinner, True),
                "srf_decode": (tp * n * dsteps, True)}
        if key == "spinner_seeded":
            want["spinner"] = (0, True)
    want.setdefault("spinner", (0, True))
    want.setdefault("srf_decode", (0, True))
    _expect_launches(f"{label} TP {tp}", res["counts"], want)


def phase_serve_mesh():
    """Full-width qwen3-4b (bf16, random weights) cut to ``CUT_LAYERS``
    (12) of its 36 layers through ``Engine(mesh=)``
    at TP 2 on a mesh of the card repeated, and through the plain engine
    (TP 1) beside it on the same params and requests, 8 greedy requests
    of 128 + 32 tokens, 8 slots: full KV, int8 pages, SRF and seeded SRF
    (embed seeds on uids 4-7, odd uids sampled: ``_personalize``). Each
    run: every request done with 32 tokens, finite rows, exact launches
    (``_mesh_path``); TP 2 holds half the pools a position; the
    first-token logits of TP 2 and TP 1 within ``MESH_LOGIT_TOL``; tok/s,
    TTFT p50, peak and the share of equal tokens printed. Then the FT
    router over 2 replicas x TP 2 (4 slots each, 8 requests, wall clocks,
    no migration) with replica 1 raising at its step 12: one quarantine,
    no failed request. Then seamless-m4t-large-v2 at TP 2, full KV.
    Returns {run: {tp: result}}."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer as model_lib
    mesh = _card_meshes(1)[0]
    out = {}
    built = None
    for label, attn, quant, seeded in MESH_RUNS:
        a = serve_args(attn, quantize_kv=quant, **TRAFFIC)
        if built is None or built[0] != (attn, seeded):
            params = built = None
            _free()
            if seeded:
                t0 = time.perf_counter()
                cfg = _seeded(registry.get("qwen3-4b", attn_impl="srf",
                                           n_layers=CUT_LAYERS))
                params = model_lib.init(cfg, seed=a.seed, device="cuda")
                torch.cuda.synchronize()
                _describe(cfg, params, t0)
            else:
                cfg, params = _build(a)
            built = ((attn, seeded), cfg, params)
        _, cfg, params = built
        runs, rows = {}, {}
        for tp in (1, 2):
            m = mesh if tp == 2 else None
            _warm_mesh(a, cfg, params, m)
            eng = serve.engine(a, cfg, params, mesh=m)
            rec = first_logits(eng)
            reqs = serve.requests(a, cfg)
            if seeded:
                reqs = _personalize(reqs)
            with count_probes() as probes:
                res = _family_run(f"qwen3-4b {label} TP {tp}", a, cfg,
                                  params, eng=eng, reqs=reqs)
            _mesh_path(label, cfg, res, tp, probes)
            rep = eng.cache_report()
            res.update(pool_bytes=rep["pool_bytes"],
                       pool_bytes_per_device=rep["pool_bytes_per_device"])
            runs[tp], rows[tp] = res, rec.rows
            del eng
            _free()
        pbd, pb = runs[2]["pool_bytes_per_device"], runs[1]["pool_bytes"]
        # int8 pages: the values halve, the per-token scales replicate
        if not (pb / 2 < pbd < pb if quant else pbd * 2 == pb):
            raise AssertionError(f"{label}: TP 2 holds {pbd} B a position "
                                 f"of {pb}")
        gap = max(float((rows[1][u] - rows[2][u]).abs().max()
                        / rows[1][u].abs().max()) for u in rows[1])
        toks = [{r.uid: r.out_tokens for r in runs[tp]["done"]}
                for tp in (1, 2)]
        same = _share(toks[1], toks[0])
        first_same = sum(toks[0][u][0] == toks[1][u][0] for u in toks[0])
        log(f"    {label}: TP 2 {runs[2]['tok_s']:.2f} tok/s against TP 1 "
            f"{runs[1]['tok_s']:.2f} ({runs[2]['tok_s'] / runs[1]['tok_s']:.3f}"
            f"x); TTFT p50 {runs[2]['ttft_s']['p50']:.4f} against "
            f"{runs[1]['ttft_s']['p50']:.4f} s; pool bytes per position "
            f"{runs[2]['pool_bytes_per_device']} of "
            f"{runs[1]['pool_bytes']}; first-token logits {gap:.3e} of the "
            f"row's largest (limit {MESH_LOGIT_TOL}); first tokens "
            f"equal {first_same}/8, generated tokens {same:.3f}")
        if not gap <= MESH_LOGIT_TOL:
            raise AssertionError(f"{label}: TP 2 first-token logits "
                                 f"{gap:.4f} of the largest from TP 1's")
        for r in runs.values():
            r.pop("done")
        out[label] = dict(runs=runs, logit_gap=gap, agreement=same,
                          first_equal=first_same)
    params = built = None
    _free()
    a = serve_args("full", **dict(ROUTER_TRAFFIC, requests=8))
    cfg, params = _build(a)
    c = _router_run(f"full KV router 2 x TP 2 raise@{CHAOS_STEP}:1", a, cfg,
                    params, chaos=f"raise@{CHAOS_STEP}:1",
                    meshes=_card_meshes(2))
    cnt = c["counters"]
    if c["kill"].get("replica") != 1 or cnt["quarantined"] != 1 or \
            cnt["failed"]:
        raise AssertionError(f"mesh router: kill {c['kill'].get('replica')}"
                             f", counters {cnt}")
    _expect_launches("mesh router", c["counts"], {
        "paged_gather_kv": (2 * cfg.n_layers * c["steps"], True),
        "spinner": (0, True), "srf_decode": (0, True)})
    log(f"  full KV router, 2 replicas x TP 2 of 4 slots, 8 requests, "
        f"replica 1 raise@{CHAOS_STEP}: {c['tok_s']:.2f} tok/s, TTFT p50 "
        f"{c['ttft_s']['p50']:.4f} s, counters {cnt}, {c['steps']} steps, "
        f"peak {c['peak']:.2f} GiB; revived, no leaks")
    out["router"] = {k: c[k] for k in ("tok_s", "ttft_s", "counters",
                                       "steps", "counts")}
    del params
    _free()
    arch = "seamless-m4t-large-v2"
    a = serve_args("full", arch=arch, **FAMILY_TRAFFIC)
    cfg, params = _build(a)
    _warm_mesh(a, cfg, params, mesh)
    eng = serve.engine(a, cfg, params, mesh=mesh)
    res = _family_run(f"{arch} full KV TP 2", a, cfg, params, eng=eng)
    _mesh_launches(f"{arch} TP 2", "encdec", cfg, res["counts"], [eng], 2)
    rep = eng.cache_report()
    log(f"    pool bytes per position {rep['pool_bytes_per_device']} of "
        f"{rep['pool_bytes']} (memory pool {rep['memory_pool_bytes']}, "
        f"replicated)")
    res.pop("done")
    out["seamless"] = res
    del eng, params
    _free()
    return out


# ---------------------------------------------------------------------------
# phase 5: train
# ---------------------------------------------------------------------------

TRAIN_STEPS = 5
TRAIN_BATCH, TRAIN_SEQ = 8, 64        # the training launcher's defaults


def _train_step_fn(cfg, steps_total):
    """``launch.steps.make_train_step`` with the launcher's schedule for
    a run of ``steps_total`` steps at its default learning rate."""
    from repro_torch.launch import steps
    return steps.make_train_step(cfg, steps.TrainHyper(
        lr=3e-4, warmup=min(50, steps_total // 5 + 1),
        total_steps=steps_total))


def _loader(cfg, batch, seq, seed=0):
    from repro_torch.data import synth
    from repro_torch.data.loader import ShardedLoader
    return ShardedLoader(lambda step, shard: synth.full_batch(
        cfg, batch, seq, step, seed=seed, shard=shard))


def _train_run(attn, seeded=False, arch="qwen3-4b", batch_size=TRAIN_BATCH,
               seq=TRAIN_SEQ, n_steps=TRAIN_STEPS, over=None):
    """``n_steps`` steps of full-width ``arch`` (bf16, remat full; full
    depth unless ``over`` cuts it) as the Trainer takes them:
    ``make_train_step`` fed by ``ShardedLoader`` over ``synth.full_batch``
    (B = ``batch_size``, ``seq`` tokens), each step timed by
    ``profile_train.timed``. Counts are zeroed just before the steps and
    read just after. -> the run's record: cfg, per-step losses, xent,
    aux, grad norms and seconds, peak memory (GiB), launch counts."""
    from repro_torch.configs import registry
    from repro_torch.data.loader import device_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_train import timed
    from repro_torch.models import transformer as model_lib
    from repro_torch.optim import adamw
    cfg = registry.get(arch, attn_impl=attn, **(over or {}))
    if seeded:
        cfg = _seeded(cfg)
    t0 = time.perf_counter()
    params = model_lib.requires_grad(model_lib.init(cfg, seed=0,
                                                    device="cuda"))
    state = adamw.init(params)
    torch.cuda.synchronize()
    _describe(cfg, params, t0)
    fn = _train_step_fn(cfg, n_steps)
    loader = _loader(cfg, batch_size, seq)
    it = iter(loader)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    run = dict(cfg=cfg, losses=[], xent=[], aux=[], gnorms=[], times=[])
    for i in range(n_steps):
        step_i, host = next(it)
        assert step_i == i
        batch = device_batch(host, "cuda")
        (params, state, m), sec = timed(fn, params, state, i, batch)
        run["times"].append(sec)
        for key, name in (("losses", "loss"), ("xent", "xent"),
                          ("aux", "aux"), ("gnorms", "grad_norm")):
            run[key].append(float(m[name]))
    run["counts"] = ops.launch_counts()
    loader.stop()
    run["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, state, m
    _free()
    return run


TRAIN_RUNS = (("srf", False), ("srf", True), ("full", False))


def _attn_layers(cfg) -> int:
    """Layers whose self-attention runs in a training forward, from the
    layer plan (``transformer._layer_plan``: the segments whose layers
    own an "attn" state) and the enc-dec encoder's layers."""
    from repro_torch.models import transformer as model_lib
    return sum(count for _, count, comps in model_lib._layer_plan(cfg)
               if "attn" in comps) + cfg.enc_layers


def _train_checks(label, attn, seeded, r, batch_size, seq, n_steps,
                  predicted=None):
    """A training run's report and checks (``_train_run``'s record
    ``r``): every loss, xent, aux and gradient norm finite, the first
    xent within 0.5 of ln(V_pad) + 1/2 (xent, not the loss: an MoE loss
    adds 0.01 aux), an MoE run's aux > 0; SRF's spinner (materialized or
    seeded) launched 2 a self-attention layer (``_attn_layers``) in the
    forward and 2 in the recompute a step, its plain backward 2 a layer a
    step, nothing else (an SSD run nothing at all); step ms, tokens/s,
    bf16-peak share (active params) over the median of steps 2 on. With
    ``predicted`` (the dry run's peak bytes of the same call): the peak
    under the card's 80 GiB and within 0.9-1.1x of the prediction.
    Returns the record."""
    from repro_torch.launch.profile_train import step_rates
    cfg, losses, xent, aux, gnorms, times, peak, counts = (
        r[k] for k in ("cfg", "losses", "xent", "aux", "gnorms", "times",
                       "peak", "counts"))
    rates = step_rates(cfg, batch_size, seq, statistics.median(times[1:]))
    log(f"  train {label}: losses {[round(x, 4) for x in losses]}, xent "
        f"{[round(x, 4) for x in xent]}, aux {[round(x, 4) for x in aux]}, "
        f"grad norms {[round(x, 3) for x in gnorms]}")
    log(f"    step {rates['step_ms']:.1f} ms (median of steps 2-"
        f"{n_steps}; first {1e3 * times[0]:.1f} ms), "
        f"{rates['tokens_s']:.1f} training tokens/s, peak memory "
        f"{peak:.2f} GiB, 6*N*tokens/step at "
        f"{100 * rates['bf16_peak_share']:.2f}% of bf16 dense peak "
        f"(N = {cfg.active_param_count():,} active of "
        f"{cfg.param_count():,})")
    log(f"    launches: {counts}")
    if not all(math.isfinite(x) for x in losses + xent + aux + gnorms):
        raise AssertionError(f"train {label}: non-finite loss, xent, aux "
                             f"or grad norm: {losses} {xent} {aux} "
                             f"{gnorms}")
    centre = math.log(cfg.padded_vocab) + 0.5
    log(f"    first xent {xent[0]:.4f}: {xent[0] - centre:+.4f} from "
        f"ln(V_pad) + 1/2 = {centre:.4f}, "
        f"{xent[0] - math.log(cfg.vocab):+.4f} from ln(V) = "
        f"{math.log(cfg.vocab):.4f}")
    if not abs(xent[0] - centre) <= 0.5:
        raise AssertionError(f"train {label}: first xent {xent[0]} not "
                             f"within 0.5 of {centre}")
    if cfg.is_moe and not min(aux) > 0:
        raise AssertionError(f"train {label}: MoE aux {aux} not > 0")
    layers = _attn_layers(cfg)
    per_step = 2 * layers * (2 if cfg.remat == "full" else 1)
    key = "spinner_seeded" if seeded else "spinner"
    expect = {k: 0 for k in counts}
    if attn == "srf" and layers:
        expect[key] = per_step * n_steps
        expect[key + "_bwd"] = 2 * layers * n_steps
    bad = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"train {label}: launches (got, expected) "
                             f"{bad}")
    if expect.get(key):
        log(f"    {key}: {counts[key] // n_steps} forward launches "
            f"a step ({per_step // 2} in the forward, {per_step // 2} "
            f"in the recompute: 2 a layer of {layers} self-attention "
            f"layers), {counts[key + '_bwd'] // n_steps} plain backward "
            f"calls a step")
    else:
        log("    no kernel launched, as the path needs")
    out = dict(losses=losses, xent=xent, aux=aux, peak_gib=peak,
               counts=counts, **rates)
    if predicted is not None:
        ratio = peak * 2 ** 30 / predicted
        log(f"    peak {peak:.3f} GiB against the dry run's "
            f"{predicted / 2 ** 30:.3f} GiB for the same call (ratio "
            f"{ratio:.3f})")
        if not (peak < 80 and 0.9 <= ratio <= 1.1):
            raise AssertionError(f"train {label}: peak {peak:.3f} GiB, "
                                 f"predicted {predicted / 2 ** 30:.3f} GiB "
                                 f"(ratio {ratio:.3f}; limits 80 GiB and "
                                 f"0.9-1.1)")
        out.update(predicted_gib=predicted / 2 ** 30, peak_ratio=ratio)
    return out


def phase_train_full():
    """Full-width, full-depth qwen3-4b trains TRAIN_STEPS steps with SRF
    attention, with seeded SRF, then with full attention (freeing between
    runs). Every loss and gradient norm finite; the first xent within 0.5
    of ln(V_pad) + 1/2, the expected first loss of random weights (the
    head's N(0, 1/d) columns on unit-RMS rows give unit-variance logits:
    E[logsumexp] = ln V_pad + 1/2; ln(151936) = 11.93 alone sits 0.50
    below it). SRF: its spinner kernel (materialized or seeded) launched
    2 per layer in the forward and 2 per layer in the remat recompute,
    its plain backward once per forward launch of the first pass, no
    plain forward on the card, no launch of the other spinner. Step ms,
    training tokens/s and bf16-peak share by ``profile_train.step_rates``
    over the median of steps 2 on (``_train_checks``)."""
    out = {}
    for attn, seeded in TRAIN_RUNS:
        label = attn + (" seeded" if seeded else "")
        out[label] = _train_checks(label, attn, seeded,
                                   _train_run(attn, seeded), TRAIN_BATCH,
                                   TRAIN_SEQ, TRAIN_STEPS)
    return out


VLM_TRAIN = dict(arch="qwen2-vl-2b", batch_size=2, seq=2048, n_steps=3)


def phase_train_vlm():
    """Full-width, full-depth qwen2-vl-2b (28 layers, bf16, remat full)
    trains 3 steps at B = 2, seq = 2048 (``synth.full_batch``: a 1024-patch
    vision prefix through the adapter, 1024 labelled text tokens, M-RoPE
    over ``pos3``) with SRF attention (the spinner under autograd), then
    3 with full attention; ``_train_checks`` on each."""
    out = {}
    for attn in ("srf", "full"):
        out[attn] = _train_checks(
            f"qwen2-vl-2b {attn}", attn, False, _train_run(attn, **VLM_TRAIN),
            VLM_TRAIN["batch_size"], VLM_TRAIN["seq"], VLM_TRAIN["n_steps"])
    return out


# phase_train_families: (label, arch, attention, config overrides, B, seq).
# seq 4096 is the reference's train_4k length (configs/shapes.py) at a
# batch one card holds; seamless trains 1024 decoder tokens over its
# config's 1024 encoder frames. moonshot (28.4 B params) and deepseek
# (15.7 B) do not fit one card with grads and AdamW moments: full width,
# 8 layers (1 dense + 7 MoE). Width, heads, experts, top-k, vocabulary
# and ssm_chunk are never cut.
CUT8 = {"n_layers": 8}
FAMILY_TRAIN = [
    ("ssd", "mamba2-2.7b", "full", {}, 2, 4096),
    ("hybrid full", "hymba-1.5b", "full", {}, 2, 4096),
    ("hybrid srf", "hymba-1.5b", "srf", {}, 2, 4096),
    ("encdec full", "seamless-m4t-large-v2", "full", {}, 4, 1024),
    ("encdec srf", "seamless-m4t-large-v2", "srf", {}, 4, 1024),
    ("moe full", "moonshot-v1-16b-a3b", "full", CUT8, 2, 4096),
    ("moe srf", "moonshot-v1-16b-a3b", "srf", CUT8, 2, 4096),
    ("mla", "deepseek-v2-lite-16b", "full", CUT8, 2, 4096),
    ("mla srf", "deepseek-v2-lite-16b", "srf", CUT8, 2, 4096),
]
FAMILY_TRAIN_STEPS = 3
FIT_GIB = 76          # a run predicted above it halves its batch


def _train_prediction(run):
    """A grid worker: the dry run of a ``FAMILY_TRAIN`` run's train step
    (``dryrun.step_call(cfg, "train", B, seq, "meta")`` under
    ``cost_analysis.analyze``), its batch halved while the predicted
    peak (argument bytes + the peak of live bytes) exceeds ``FIT_GIB``.
    -> {label, batch, predicted bytes, the analysis, halvings}."""
    from repro_torch.configs import registry
    from repro_torch.launch import cost_analysis as H
    from repro_torch.launch import dryrun
    label, arch, attn, over, b, seq = run
    t0 = time.perf_counter()
    cfg = registry.get(arch, attn_impl=attn, **over)
    halved = []
    while True:
        fn, args = dryrun.step_call(cfg, "train", b, seq, "meta")
        an = H.analyze(fn, *args)
        del fn, args
        predicted = an["arg_bytes"] + an["peak_bytes"]
        if predicted <= FIT_GIB * 2 ** 30 or b == 1:
            break
        halved.append((b, predicted))
        b //= 2
    return dict(label=label, batch=b, predicted=predicted, analysis=an,
                halved=halved, run_s=time.perf_counter() - t0)


def phase_train_families(predictions):
    """Full-width training of the SSD, hybrid, enc-dec, MoE and MLA
    families (``FAMILY_TRAIN``; bf16, remat full, random weights from a
    seeded generator, 3 steps each, freed between runs): each run's batch
    and predicted peak from the dry run of the same call
    (``_train_prediction``, computed by the grid workers from the top of
    the script), then ``_train_run`` and ``_train_checks`` with that
    prediction: finite losses, xent, aux and grad norms, the first xent
    at ln(V_pad) + 1/2, MoE aux > 0, the spinner's forward, recompute and
    plain-backward launches by the layer plan (mamba2: no launch at
    all), the peak within 0.9-1.1x of the prediction and under 80 GiB;
    step ms, tokens/s and bf16-peak share (active params) printed.
    Returns the records."""
    t0 = time.perf_counter()
    preds = {p["label"]: p for p in predictions.get(timeout=900)}
    log(f"  dry-run predictions of the {len(preds)} runs (waited "
        f"{time.perf_counter() - t0:.1f} s)")
    out = {}
    for label, arch, attn, over, b, seq in FAMILY_TRAIN:
        pred = preds[label]
        cut = f", cut to {over}" if over else ""
        log(f"  {label}: {arch}, attention {attn}, B = {pred['batch']} x "
            f"{seq}{cut}; predicted peak {pred['predicted'] / 2 ** 30:.3f} "
            f"GiB (meta analysis {pred['run_s']:.1f} s)")
        for hb, hp in pred["halved"]:
            log(f"    B = {hb} predicted {hp / 2 ** 30:.3f} GiB > "
                f"{FIT_GIB} GiB: batch halved")
        r = _train_run(attn, arch=arch, batch_size=pred["batch"], seq=seq,
                       n_steps=FAMILY_TRAIN_STEPS, over=over)
        out[label] = _train_checks(f"{arch} {attn}{cut}", attn, False, r,
                                   pred["batch"], seq, FAMILY_TRAIN_STEPS,
                                   pred["predicted"])
        out[label].update(arch=arch, attn=attn, batch=pred["batch"],
                          seq=seq, over=dict(over),
                          meta_flops=pred["analysis"]["flops"])
    log(f"  {len(out)} family training runs in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_train_compressed(train_vlm):
    """``Trainer(mesh=...)`` with ``compress_dp`` (grad step, the
    structured-JL compressed mean over the mesh's ``pod`` axis, AdamW, the
    error state carried) on a (pod 2, data 1, model 1) mesh of the card
    repeated: reduced qwen3-4b (f32, 2 layers), 5 steps from the same
    params on the card and on the CPU, losses within rtol 1e-4; then
    full-width qwen2-vl-2b (bf16, full attention, B = 2 x 2048, remat
    full), 3 compressed steps of the Trainer's step beside
    ``phase_train_vlm``'s plain ones: step ms, peak memory and
    ``compression.wire_bytes``' ratio printed. Returns the record."""
    from repro_torch.configs import registry
    from repro_torch.data.loader import device_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.launch.profile_train import step_rates, timed
    from repro_torch.models import transformer as model_lib
    from repro_torch.optim import adamw
    from repro_torch.optim import compression as comp_lib
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def pods(device):
        return mesh_lib.make_mesh((2, 1, 1), ("pod", "data", "model"),
                                  devices=[torch.device(device)] * 2)
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    base = model_lib.init(cfg, seed=3, device="cpu")
    losses = {}
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cpu", "cuda"):
            tr = Trainer(cfg, TrainerConfig(
                num_steps=5, batch=4, seq=32, log_every=1, ckpt_every=100,
                ckpt_dir=os.path.join(tmp, device), device=device,
                compress_dp=True, hyper=steps.TrainHyper(
                    lr=1e-2, warmup=2, total_steps=5)),
                mesh=pods("cuda:0" if device == "cuda" else "cpu"))
            tr.params = model_lib.requires_grad(_to(base, device, copy=True))
            tr.opt_state = adamw.init(tr.params)
            tr.err = comp_lib.init_error(tr.params)
            losses[device] = [r["loss"] for r in tr.train()["log"]]
    for a, b in zip(losses["cuda"], losses["cpu"]):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"compressed training: card losses "
                                 f"{losses['cuda']} != CPU {losses['cpu']}")
    log(f"  reduced qwen3-4b, Trainer(mesh=pod 2) compress_dp, 5 steps: "
        f"card losses {[round(x, 6) for x in losses['cuda']]} == CPU "
        f"{[round(x, 6) for x in losses['cpu']]} within rtol 1e-4")
    v = VLM_TRAIN
    cfg = registry.get(v["arch"], attn_impl="full")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tr = Trainer(cfg, TrainerConfig(
            num_steps=v["n_steps"], batch=v["batch_size"], seq=v["seq"],
            ckpt_dir=tmp, device="cuda", compress_dp=True,
            hyper=steps.TrainHyper(lr=3e-4, warmup=1,
                                   total_steps=v["n_steps"])),
            mesh=pods("cuda:0"))
        torch.cuda.synchronize()
        _describe(cfg, tr.params, t0)
        raw, comp = comp_lib.wire_bytes(tr.params, tr.tcfg.compression)
        it = iter(tr.loader.reset(0))
        torch.cuda.reset_peak_memory_stats()
        times, ls = [], []
        for i in range(v["n_steps"]):
            step_i, host = next(it)
            batch = device_batch(host, "cuda")
            (tr.params, tr.opt_state, m), sec = timed(
                tr._step_fn, tr.params, tr.opt_state, i, batch)
            times.append(sec)
            ls.append(float(m["loss"]))
        tr.loader.stop()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        err_bytes = sum(t.numel() * t.element_size()
                        for t in _leaves(tr.err))
        del tr, m
        _free()
    if not all(math.isfinite(x) for x in ls):
        raise AssertionError(f"compressed qwen2-vl-2b: losses {ls}")
    rates = step_rates(cfg, v["batch_size"], v["seq"],
                       statistics.median(times[1:]))
    plain = train_vlm["full"]
    log(f"  qwen2-vl-2b full attention, compressed pod mean (pod 2 on one "
        f"card): losses {[round(x, 4) for x in ls]}, step "
        f"{rates['step_ms']:.1f} ms (median of steps 2-{v['n_steps']}; "
        f"first {1e3 * times[0]:.1f}) against plain {plain['step_ms']:.1f} "
        f"ms; peak {peak:.2f} GiB against {plain['peak_gib']:.2f}; error "
        f"state {err_bytes} B; wire bytes {raw} -> {comp} "
        f"({raw / comp:.3f}x)")
    return dict(losses=ls, peak_gib=peak, wire_raw=raw, wire_comp=comp,
                err_bytes=err_bytes, **rates)


def phase_train_resume():
    """The reference test ``tests/test_trainer_ft.py``'s crash-and-resume
    on the card, under deterministic algorithms: reduced qwen3-4b (2
    layers), run A uninterrupted for 30 steps, run B crashes at step 17,
    restarts and resumes from the step-10 checkpoint; the final params
    must be torch.equal. Full attention, then SRF (the spinner kernel's
    forward inside the check)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.train.trainer import CrashInjected, Trainer, TrainerConfig
    torch.use_deterministic_algorithms(True)
    try:
        for attn in ("full", "srf"):
            cfg = registry.reduced("qwen3-4b", n_layers=2, attn_impl=attn)
            with tempfile.TemporaryDirectory() as tmp:
                def tcfg(sub):
                    return TrainerConfig(
                        num_steps=30, batch=4, seq=32, ckpt_every=10,
                        log_every=5, ckpt_dir=os.path.join(tmp, sub),
                        device="cuda", hyper=steps.TrainHyper(
                            lr=1e-2, warmup=5, total_steps=30))
                ops.reset_counts()
                ta = Trainer(cfg, tcfg("a"))
                out_a = ta.train()
                tb = Trainer(cfg, tcfg("b"), crash_at=17)
                try:
                    tb.train()
                    raise AssertionError("crash_at=17 did not raise")
                except CrashInjected:
                    pass
                tb.ckpt.wait()
                tb2 = Trainer(cfg, tcfg("b"))
                if not tb2.try_resume() or tb2.step != 10:
                    raise AssertionError(f"resume {attn}: step {tb2.step}")
                out_b = tb2.train()
                counts = ops.launch_counts()
                same = all(torch.equal(a, b) for a, b in zip(
                    tree_lib.leaves(ta.params), tree_lib.leaves(tb2.params)))
                if not same or out_a["final_step"] != out_b["final_step"]:
                    raise AssertionError(f"resume {attn}: final params differ "
                                         f"from the uninterrupted run")
                if attn == "srf" and (counts["spinner"] == 0
                                      or counts["spinner_plain_on_cuda"]):
                    raise AssertionError(f"resume srf: launches {counts}")
                losses = [round(r["loss"], 4) for r in out_a["log"]]
                log(f"  crash at 17, resume from 10, reduced {attn}: final "
                    f"params bit-equal to the uninterrupted run (losses "
                    f"{losses}; spinner launches {counts['spinner']})")
    finally:
        torch.use_deterministic_algorithms(False)


def phase_train_agreement():
    """Reduced qwen3-4b (f32) with seeded SRF: 3 training steps on the card
    (the seeded spinner kernel forward, its plain backward) and on the
    CPU (plain versions) from the same params; the losses agree within
    rtol 1e-4."""
    from repro_torch.configs import registry
    from repro_torch.data import synth
    from repro_torch.data.loader import device_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as model_lib
    from repro_torch.optim import adamw
    cfg = _seeded(registry.reduced("qwen3-4b", attn_impl="srf",
                                   dtype="float32"))
    base = model_lib.init(cfg, seed=3, device="cpu")
    losses = {}
    for device in ("cpu", "cuda"):
        # a copy on either device: the step updates params in place
        params = model_lib.requires_grad(_to(base, device, copy=True))
        state = adamw.init(params)
        fn = _train_step_fn(cfg, 3)
        ops.reset_counts()
        losses[device] = []
        for i in range(3):
            batch = device_batch(synth.full_batch(cfg, 4, 32, i, seed=3),
                                 device)
            params, state, m = fn(params, state, i, batch)
            losses[device].append(float(m["loss"]))
        counts = ops.launch_counts()
    for a, b in zip(losses["cuda"], losses["cpu"]):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"seeded SRF training: card losses "
                                 f"{losses['cuda']} != CPU {losses['cpu']}")
    if counts["spinner_seeded"] != 3 * 2 * cfg.n_layers or \
            counts["spinner_seeded_bwd"] != 3 * 2 * cfg.n_layers or \
            counts["spinner_seeded_plain_on_cuda"] or counts["spinner"]:
        raise AssertionError(f"seeded SRF training: launches {counts}")
    log(f"  reduced seeded SRF, 3 steps: card losses {losses['cuda']} == CPU "
        f"{losses['cpu']} within rtol 1e-4; launches {counts}")


# ---------------------------------------------------------------------------
# phase 6: the dry run (launch/dryrun.py over launch/cost_analysis.py)
# ---------------------------------------------------------------------------

GRID_WORKERS = 4
DECODE_CACHE = 4096      # phase 6 (c): the decode step's cache positions


def _grid_init(src):
    """A grid worker: the lowest CPU priority (the card's phases run beside
    it on the host), one intra-op thread, the checkout's package."""
    os.nice(19)
    torch.set_num_threads(1)
    sys.path.insert(0, src)


def _grid_cell(cell):
    from repro_torch.launch import dryrun
    return dryrun.run_cell(*cell)


def start_grid():
    """The dry runs of ``phase_train_families``' nine train calls
    (``_train_prediction``, first: phase 5 waits for them), then the 40
    single-pod cells at full width on meta (``dryrun.run_cell``), in
    ``GRID_WORKERS`` spawned CPU processes that run beside the card's
    phases and make no CUDA context: -> (pool, async cells, async
    predictions). The cells' slowest first (train cells, then the SSD
    and hybrid families)."""
    import multiprocessing
    from repro_torch.configs import registry, shapes
    slow = ("mamba2-2.7b", "hymba-1.5b")
    cells = sorted(((a, s) for a in registry.ARCHS for s in shapes.SHAPES),
                   key=lambda c: (shapes.SHAPES[c[1]].step != "train",
                                  c[0] not in slow))
    pool = multiprocessing.get_context("spawn").Pool(
        GRID_WORKERS, _grid_init, (str(ROOT / "src"),))
    predictions = pool.map_async(_train_prediction, FAMILY_TRAIN,
                                 chunksize=1)
    return pool, pool.map_async(_grid_cell, cells, chunksize=1), predictions


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launched(label, counts, need, plain_ok=False):
    """Print a run's nonzero launch counts; fail unless every kernel in
    ``need`` launched and (unless ``plain_ok``) no plain route ran on the
    card."""
    got = {k: v for k, v in counts.items() if v}
    log(f"    {label}: launches {got}")
    missing = [k for k in need if not got.get(k)]
    plain = [k for k in got if "plain" in k]
    if missing or (plain and not plain_ok):
        raise AssertionError(f"{label}: kernels {missing} not launched or "
                             f"plain routes {plain} on the card: {got}")


SMOKE_KERNELS = {"pipeline": ("spinner",),
                 "serve_mesh": ("paged_gather_kv",),
                 "serve_chaos": ("paged_gather_kv",),
                 "serve_prefix": ("paged_gather_kv",),
                 "serve_seeded": ("spinner_seeded", "srf_decode")}


def _dryrun_card(out_dir):
    """(a) The five dry-run smokes on ``cuda:0`` (each ``ok``), then the
    five ``examples/torch_*.py`` on the card at their defaults (their own
    output in ``examples.log``), each run's launches printed: every smoke
    its path's kernels, quickstart and kernel_approx the spinner (ldr's
    plain route allowed), serve_lm full KV paged_gather_kv and SRF the
    spinner and srf_decode; train_lm's loss falls."""
    import contextlib
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    for name, fn in dryrun.SMOKES.items():
        ops.reset_counts()
        rec = fn(device="cuda:0") if name == "pipeline" \
            else fn("qwen3-4b", device="cuda:0")
        counts = ops.launch_counts()
        log(f"  smoke {name}: ok {rec['ok']} in {rec['total_s']} s")
        if not rec["ok"]:
            raise AssertionError(f"dry-run smoke {name} on cuda:0: {rec}")
        _launched(name, counts, SMOKE_KERNELS[name])
    with open(out_dir / "examples.log", "w") as f, \
            tempfile.TemporaryDirectory() as ckpt:
        runs = [("quickstart", ("spinner",), True,
                 lambda m: m.main(["--device", "cuda"])),
                ("kernel_approx", ("spinner",), True,
                 lambda m: m.main(["--device", "cuda"])),
                ("serve_lm full KV", ("paged_gather_kv",), False,
                 lambda m: m.run("full", "cuda")),
                ("serve_lm SRF", ("spinner", "srf_decode"), False,
                 lambda m: m.run("srf", "cuda")),
                ("train_lm", (), False,
                 lambda m: m.main(["--device", "cuda", "--ckpt-dir", ckpt])),
                ("grad_compression_demo", (), False,
                 lambda m: m.main(["--device", "cuda"]))]
        for label, need, plain_ok, call in runs:
            mod = _example(label.split()[0])
            ops.reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(f):
                out = call(mod)
            counts = ops.launch_counts()
            log(f"  example {label}: {time.perf_counter() - t0:.1f} s")
            _launched(label, counts, need, plain_ok)
            if label.startswith("serve_lm") and out["done"] != 16:
                raise AssertionError(f"{label}: {out}")
            if label == "train_lm":
                first, last = out["log"][0]["loss"], out["log"][-1]["loss"]
                log(f"    loss {first:.3f} -> {last:.3f}")


def _dryrun_grid(grid, out_dir):
    """(b) The 40 cells' records from the grid workers: one line each;
    any cell not ``ok`` fails. Written to ``dryrun_grid.jsonl``."""
    t0 = time.perf_counter()
    recs = grid[1].get(timeout=900)
    log(f"  grid: {len(recs)} cells at full width on meta (analysis over "
        f"datasheet peaks, not card timings; waited "
        f"{time.perf_counter() - t0:.1f} s at the end)")
    with open(out_dir / "dryrun_grid.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r, default=float) + "\n")
            if not r["ok"]:
                log(f"    {r['arch']} {r['shape']}: FAILED {r['error']}")
                continue
            log(f"    {r['arch']} {r['shape']}: flops {r['flops']:.4g}  "
                f"bytes {r['bytes']:.4g}  t_roofline {r['t_roofline']:.4g} s "
                f"({r['bottleneck']})  peak_bytes {r['peak_bytes']:.4g}  "
                f"fits_hbm {r['fits_hbm']}  ({r['run_s']} s)")
    bad = [(r["arch"], r["shape"]) for r in recs if not r["ok"]]
    if bad or len(recs) != 40:
        raise AssertionError(f"dry-run cells not ok: {bad}")
    return recs


def _step_ms(fn, args, calls=3):
    """Median CUDA-event time of one call of a step (synchronized)."""
    out = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def _dryrun_against_card():
    """(c) Full-width qwen3-4b: phase 5's train step (B = 8, seq 64, remat
    full, f32 moments) and a decode step at B = 8 over a cache of
    ``DECODE_CACHE`` positions, analyzed on meta and around the real step
    on the card (after one warm call): the flops must be equal; the
    predicted peak (argument bytes + the peak of live bytes) beside
    ``torch.cuda.max_memory_allocated`` over the analyzed call, and
    ``t_roofline`` beside the step's CUDA-event time (median of 3)."""
    from repro_torch.configs import registry
    from repro_torch.launch import cost_analysis as H
    from repro_torch.launch import dryrun
    cfg = registry.get("qwen3-4b")
    props = torch.cuda.get_device_properties(0)
    log(f"  card memory: total_memory {props.total_memory} B "
        f"({props.total_memory / 2 ** 30:.2f} GiB; dryrun.HBM_PER_CHIP "
        f"{dryrun.HBM_PER_CHIP}), {_card()}")
    out = {}
    for step, b, l in (("train", TRAIN_BATCH, TRAIN_SEQ),
                       ("decode", 8, DECODE_CACHE)):
        fn, args = dryrun.step_call(cfg, step, b, l, "meta")
        meta = H.analyze(fn, *args)
        del fn, args
        fn, args = dryrun.step_call(cfg, step, b, l, "cuda")
        fn(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with H.Analysis() as a:
            fn(*args)
        torch.cuda.synchronize()
        card = a.result()
        measured = torch.cuda.max_memory_allocated()
        ms = _step_ms(fn, args)
        del fn, args
        _free()
        predicted = meta["arg_bytes"] + meta["peak_bytes"]
        terms = H.roofline_terms(meta)
        log(f"  {step} (B={b}, {l} positions): flops meta {meta['flops']:.6g}"
            f" == card {card['flops']:.6g}; bytes meta {meta['bytes']:.6g}, "
            f"card {card['bytes']:.6g}")
        log(f"    peak predicted {predicted / 2 ** 30:.3f} GiB (arguments "
            f"{meta['arg_bytes'] / 2 ** 30:.3f} + live "
            f"{meta['peak_bytes'] / 2 ** 30:.3f}) vs max_memory_allocated "
            f"{measured / 2 ** 30:.3f} GiB (ratio "
            f"{predicted / measured:.3f})")
        log(f"    t_roofline {1e3 * terms['t_roofline']:.3f} ms "
            f"({terms['bottleneck']}) vs step {ms:.3f} ms (ratio "
            f"{1e3 * terms['t_roofline'] / ms:.4f})")
        if card["flops"] != meta["flops"]:
            raise AssertionError(f"{step}: meta flops {meta['flops']} != "
                                 f"card flops {card['flops']}")
        out[step] = dict(meta=meta, card=card, predicted=predicted,
                         measured=measured, ms=ms, **terms)
    return out


def phase_dryrun(grid, out_dir):
    """Phase 6: (a) the smokes and the examples on the card, (b) the cell
    grid from the workers started at the top, (c) the analysis against
    the card (``_dryrun_card``, ``_dryrun_grid``, ``_dryrun_against_card``)."""
    _dryrun_card(out_dir)
    _free()
    recs = _dryrun_grid(grid, out_dir)
    return recs, _dryrun_against_card()


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def _unseeded_pipeline(cfg):
    from repro_torch.models import attention as attn_lib
    return dataclasses.replace(attn_lib.srf_cfg(cfg), seeded=False).pipeline


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _record(name, source, replaces, launches, rec, shape):
    extra = {k: v for k, v in rec.items() if k.startswith((
        "one_pool_", "two_single_", "train_", "dispatch_", "router_",
        "hymba_", "dense_", "moonshot_", "deepseek_", "qwen2vl_",
        "seamless_", "tp2_", "prefill"))}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"), "shape": shape, **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    grid = start_grid()
    try:
        return run_phases(build, grid)
    finally:
        grid[0].terminate()
        grid[0].join()


def run_phases(build, grid) -> int:
    """Phases 1-6 and the result lines (``main``'s body, with the grid
    workers running)."""
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()

    def phase(title):
        log(f"{title} ({time.perf_counter() - t0:.1f} s into the phases)")

    def run(fn, *args):
        """``fn(*args)``, its seconds logged after it."""
        t = time.perf_counter()
        out = fn(*args)
        log(f"  [{fn.__name__}: {time.perf_counter() - t:.1f} s]")
        return out
    phase("phase 1: build")
    libs = build.build(["spinner", "srf_decode", "paged_gather", "fwht",
                        "circulant"])
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    phase("phase 2: kernels against their plain versions")
    spin = run(phase_spinner, gen)
    seeded = run(phase_seeded_spinner, gen)
    spin_train = run(phase_spinner_train, gen)
    dec = run(phase_srf_decode, gen)
    gather = run(phase_paged_gather, gen)
    fwht = run(phase_fwht, gen)
    circ = run(phase_circulant, gen)
    run(phase_sampler, gen)
    hymba_k = run(phase_hymba_kernels, gen)
    moe_k = run(phase_moe_mla_kernels, gen)
    vlm_k = run(phase_vlm_encdec_kernels, gen)
    mesh_k = run(phase_mesh_kernels, gen)

    phase("phase 3: the kernel-estimation library")
    run(phase_estimators, gen)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 4: serve")
    run(phase_reduced_agreement)
    run(phase_reduced_seeded_agreement)
    kv = run(phase_serve_kv)
    gc.collect()
    torch.cuda.empty_cache()
    srf = run(phase_serve_srf)
    gc.collect()
    torch.cuda.empty_cache()
    seeded_srf = run(phase_serve_seeded)
    gc.collect()
    torch.cuda.empty_cache()
    run(phase_reduced_legacy)
    run(phase_serve_legacy)
    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    router_int8 = run(phase_reduced_router)
    router = run(phase_serve_router, out_dir)
    timing = run(phase_kernel_timing, out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    run(phase_reduced_families)
    run(phase_serve_ssd)
    hybrid = run(phase_serve_hybrid)
    dense = run(phase_serve_dense_configs)
    gc.collect()
    torch.cuda.empty_cache()
    moe = run(phase_serve_moe)
    mla = run(phase_serve_mla)
    vlm = run(phase_serve_vlm)
    encdec = run(phase_serve_encdec)
    _free()
    run(phase_reduced_mesh)
    mesh = run(phase_serve_mesh)

    phase("phase 5: train")
    train = run(phase_train_full)
    train_vlm = run(phase_train_vlm)
    families = run(phase_train_families, grid[2])
    run(phase_train_compressed, train_vlm)
    run(phase_train_resume)
    run(phase_train_agreement)
    _free()

    phase("phase 6: the dry run")
    run(phase_dryrun, grid, out_dir)

    log(_card())
    src = "src/repro_torch/kernels/csrc/"
    decode = "R=8, M=16, P=16, D=8*128, N=257, 36 layer pools cycled"

    def train_extra(name, counts, key, run):
        """Training fields: the launches of a training run (its forward
        kernel launches and its plain backward calls) and the kernel at
        the training shapes (forward ms, plain ms, plain backward ms,
        bound)."""
        out = {"train_launches": counts[key],
               "train_bwd_launches": counts[key + "_bwd"],
               "train_launches_of": run,
               "train_shape": "G=8, n=128, m=256, bf16; query B=2048 "
                              "identity, key B=512 exp"}
        for label, *_ in TRAIN_SHAPES:
            rec = spin_train[(name, label)]
            tag = label.split()[1]
            out.update({f"train_{tag}_{k}": rec[k] for k in (
                "ms", "plain_ms", "bwd_ms", "bound_ms", "bound_by")})
            out[f"train_{tag}_max_abs_err"] = rec["err"]
        return out

    def train_families():
        """The spinner in the families' training runs: each SRF run's
        forward launches and plain backward calls, and the kernel at each
        family's training shapes (``_family_shapes``)."""
        out = {"train_families_launches": {
            label: {"forward": r["counts"]["spinner"],
                    "backward": r["counts"]["spinner_bwd"]}
            for label, r in families.items() if r["attn"] == "srf"},
            "train_families_of": f"phase_train_families, "
                                 f"{FAMILY_TRAIN_STEPS} steps a run, full "
                                 f"width (moonshot and deepseek at 8 "
                                 f"layers)"}
        for label, gsz, bsz, n, epi, hd in _family_shapes():
            rec = spin_train[("spinner", label)]
            tag = label.replace(" ", "_")
            out.update({f"train_{tag}_{k}": rec[k] for k in (
                "ms", "plain_ms", "bwd_ms", "bound_ms", "bound_by")})
            out[f"train_{tag}_max_abs_err"] = rec["err"]
            out[f"train_{tag}_shape"] = (f"G={gsz}, B={bsz}, n={n}, m=256, "
                                         f"{'HD' if hd else 'no HD'}, bf16, "
                                         f"{epi}")
        return out
    def dispatch(run, name):
        """kernel_dispatch_seconds of the timed serve run (ms; synced
        before and after each dispatch) or the one timed library call."""
        if run.startswith("library"):
            return {"dispatch_ms": timing[f"library {name}"],
                    "dispatch_of": "one timed call at the shape above"}
        v = timing[run]["series"][name]
        return {"dispatch_p50_ms": 1e3 * v["p50"],
                "dispatch_p99_ms": 1e3 * v["p99"],
                "dispatch_count": v["count"],
                "dispatch_of": f"serve --kernel-timing, {run}, 4 requests "
                               f"x 8 new tokens"}
    def routed(attn, key):
        """Launches of the full-width router run (b): 2 replicas, no
        fault."""
        return {"router_launches": router[attn]["b"]["counts"][key],
                "router_launches_of": f"full-width {attn} router run (b) at "
                                      f"{CUT_LAYERS} layers, 2 replicas "
                                      f"x 4 slots, 16 requests x (128 + "
                                      f"32) tokens, no fault"}
    def hymba(name, run, key, shape):
        """The kernel at hymba-1.5b's shapes (``phase_hymba_kernels``) and
        its launches in that serve run."""
        rec = hymba_k[name]
        out = {f"hymba_{k}": rec[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")}
        out["hymba_max_abs_err"] = rec["err"]
        out["hymba_library_ms"] = rec.get("library_ms")
        out["hymba_launches"] = hybrid[run]["counts"][key]
        out["hymba_launches_of"] = f"full-width hymba-1.5b at 16 of 32 " \
                                   f"layers, {run}, 8 requests x (128 + " \
                                   f"32) tokens"
        out["hymba_shape"] = shape
        return out
    hg = "R=8, M=16, P=16, D=5*64, N=257, 32 layer pools cycled"

    moe_of = "full-width serve runs (moonshot at 24 of 48 layers, " \
        "deepseek whole): 8 requests x (128 + 32) tokens (moonshot full " \
        "KV, deepseek MLA), 4 x (128 + 16) (int8 pages, SRF, MLA+SRF)"

    def family(prefix, rec, runs, shape, of=moe_of):
        """The kernel at a config's shape (``phase_moe_mla_kernels``,
        ``phase_vlm_encdec_kernels``) and its launches in that config's
        full-width serve runs ({run label: (result, launch key)}), which
        ``of`` describes."""
        out = {f"{prefix}_{k}": rec[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")}
        out[f"{prefix}_max_abs_err"] = rec["err"]
        out[f"{prefix}_library_ms"] = rec.get("library_ms")
        out[f"{prefix}_launches"] = {run: r["counts"][key]
                                     for run, (r, key) in runs.items()}
        out[f"{prefix}_launches_of"] = of
        out[f"{prefix}_shape"] = shape
        return out
    mg = "R=8, M=16, P=16, N=257"
    vl_of = "full-width qwen2-vl-2b serve runs, 8 requests x (128 + 32)"
    sm_of = "full-width seamless-m4t-large-v2 serve runs at 12 + 12 of " \
        "its 24 + 24 layers, 8 requests x (128 + 32), each with its own " \
        "1024 x 160 features"
    vl_g = mg + ", D=2*128, 28 layer pools cycled, bf16"
    sm_g = mg + ", D=16*64, 24 layer pools cycled"
    tp2_of = f"full-width qwen3-4b at {CUT_LAYERS} layers, TP 2 on a mesh " \
        f"of the card repeated (every shard's launches), 8 requests x " \
        f"(128 + 32)"

    def tp2(prefix, key, runs, kernel, shape):
        """The kernel at its TP 2 shard shape (``phase_mesh_kernels``)
        and its launches in the TP 2 serve runs (``phase_serve_mesh``)."""
        return family(prefix, mesh_k[key],
                      {run: (mesh[run]["runs"][2], kernel) for run in runs},
                      shape, tp2_of)
    kernels = [
        _record("spinner", src + "spinner.cu",
                "src/repro/kernels/spinner.py:111", srf["spinner"],
                {**spin[("decode query", torch.bfloat16)],
                 **train_extra("spinner", train["srf"]["counts"], "spinner",
                               f"full-width SRF training, {TRAIN_STEPS} "
                               f"steps"),
                 "qwen2vl_train_launches": train_vlm["srf"]["counts"][
                     "spinner"],
                 "qwen2vl_train_bwd_launches": train_vlm["srf"]["counts"][
                     "spinner_bwd"],
                 "qwen2vl_train_of": "full-width qwen2-vl-2b SRF training, "
                                     "3 steps of B=2 x 2048",
                 **train_families(),
                 **dispatch("srf", "spinner_project"),
                 **routed("srf", "spinner"),
                 **hymba("spinner decode query", "SRF", "spinner",
                         "decode query: G=5, B=40, n=64, m=256, bf16, "
                         "identity"),
                 **family("deepseek", moe_k[("mla spinner decode query",
                                             torch.bfloat16)],
                          {"MLA+SRF": (mla["MLA+SRF"], "spinner")},
                          "decode query: G=16 query heads, B=8, n=192, "
                          "m=256, no HD, bf16, identity"),
                 **family("moonshot", moe_k[("moonshot spinner decode "
                                             "query", torch.bfloat16)],
                          {"SRF": (moe["SRF"], "spinner")},
                          "decode query: G=16, B=8, n=128, m=256, HD, "
                          "bf16, identity"),
                 **family("qwen2vl", vlm_k["qwen2vl spinner query"],
                          {"SRF": (vlm["SRF"], "spinner")},
                          "decode query: G=2 kv heads, B=48 (8 requests x a "
                          "group of 6), n=128, m=256, HD, bf16, identity",
                          vl_of),
                 **family("qwen2vl_key", vlm_k["qwen2vl spinner key"],
                          {"SRF": (vlm["SRF"], "spinner")},
                          "decode key: G=2, B=8, n=128, m=256, HD, bf16, "
                          "exp", vl_of),
                 **family("seamless", vlm_k["seamless spinner query"],
                          {"SRF": (encdec["SRF"], "spinner")},
                          "decode query: G=16, B=8, n=64, m=256, HD, bf16, "
                          "identity", sm_of),
                 **family("seamless_key", vlm_k["seamless spinner key"],
                          {"SRF": (encdec["SRF"], "spinner")},
                          "decode key: G=16, B=8, n=64, m=256, HD, bf16, "
                          "exp", sm_of),
                 **family("seamless_encoder", vlm_k["seamless encoder query"],
                          {"SRF": (encdec["SRF"], "spinner")},
                          "encoder query: G=16, B=1024 (one request's "
                          "frames), n=64, m=256, HD, bf16, identity", sm_of),
                 **family("seamless_encoder_key",
                          vlm_k["seamless encoder key"],
                          {"SRF": (encdec["SRF"], "spinner")},
                          "encoder key: G=16, B=1024, n=64, m=256, HD, "
                          "bf16, exp", sm_of),
                 **tp2("tp2", "spinner", ("SRF",), "spinner",
                       "decode query: G=4 kv heads of a shard, B=32, n=128, "
                       "m=256, HD, bf16, identity"),
                 **tp2("tp2_key", "spinner key", ("SRF",), "spinner",
                       "decode key: G=4, B=8, n=128, m=256, HD, bf16, exp")},
                "decode query: G=8, B=32, n=128, m=256, bf16, identity"),
        _record("srf_decode", src + "srf_decode.cu",
                "src/repro/kernels/srf_decode.py:26", srf["srf_decode"],
                {**dec, **dispatch("srf", "srf_decode"),
                 **routed("srf", "srf_decode"),
                 **hymba("srf_decode", "SRF", "srf_decode",
                         "B=8, H=25, m=256, dv=64, f32"),
                 **family("moonshot", moe_k["srf_decode"],
                          {"SRF": (moe["SRF"], "srf_decode")},
                          "B=8, H=16, m=256, dv=128, f32"),
                 **family("deepseek", moe_k["srf_decode"],
                          {"MLA+SRF": (mla["MLA+SRF"], "srf_decode")},
                          "B=8, H=16, m=256, dv=128, f32"),
                 **family("qwen2vl", vlm_k["qwen2vl srf_decode"],
                          {"SRF": (vlm["SRF"], "srf_decode")},
                          "B=8, H=12, m=256, dv=128, f32", vl_of),
                 **family("seamless", vlm_k["seamless srf_decode"],
                          {"SRF": (encdec["SRF"], "srf_decode")},
                          "B=8, H=16, m=256, dv=64, f32", sm_of),
                 **tp2("tp2", "srf_decode", ("SRF", "seeded SRF"),
                       "srf_decode", "B=8, H=16 q heads of a shard, m=256, "
                       "dv=128, f32")},
                "B=8, H=32, m=256, dv=128, f32"),
        _record("paged_gather", src + "paged_gather.cu",
                "src/repro/kernels/paged_gather.py:28",
                kv["bf16 pages"]["paged_gather_kv"],
                {**gather["decode"]["paged_gather"],
                 "prefill": gather["prefill"]["paged_gather"],
                 **routed("full", "paged_gather_kv"),
                 **hymba("paged_gather", "full KV", "paged_gather_kv",
                         hg + ", bf16, K and V in one launch"),
                 "dense_launches": {a: dense[a]["counts"]["paged_gather_kv"]
                                    for a in DENSE_CONFIGS},
                 "dense_launches_of": "full width, 4 requests x (128 + "
                                      "16) tokens each",
                 **family("moonshot", moe_k["paged_gather kv"],
                          {"full KV": (moe["full KV"], "paged_gather_kv")},
                          mg + ", D=16*128, K and V in one launch, 48 layer "
                          "pools cycled, bf16"),
                 **family("deepseek", moe_k["paged_gather c+kpe"],
                          {"MLA": (mla["MLA"], "paged_gather_kv")},
                          mg + ", the latents c (D=512) and kpe (D=64) in "
                          "one launch, 27 layer pools cycled, bf16"),
                 **family("qwen2vl", vlm_k["qwen2vl paged_gather"],
                          {"full KV": (vlm["full KV"], "paged_gather_kv")},
                          vl_g + ", K and V in one launch", vl_of),
                 **family("seamless", vlm_k["seamless paged_gather"],
                          {run: (encdec[run], "paged_gather_kv") for run in
                           ("full KV", "prefix cache")},
                          sm_g + ", bf16, K and V in one launch",
                          sm_of + " (K and V: 1 a layer a step)"),
                 **family("seamless_memory",
                          vlm_k["seamless memory gather"],
                          {run: (encdec[run], "paged_gather") for run in
                           ("full KV", "int8 pages", "SRF",
                            "prefix cache")},
                          "the one-pool entry on the encoder-memory pool: "
                          "N=9 slots, P=1024 (enc_len), D=1024 (d_model), "
                          "R=8 distinct slots, M=1 (a 2 MiB page through a "
                          "width-1 table), 8 pools cycled, bf16",
                          sm_of + " (the memory gather: 1 a step)"),
                 **tp2("tp2", "paged_gather", ("full KV",),
                       "paged_gather_kv", mg + ", D=4*128 (a shard's kv "
                       "heads), K and V in one launch, 36 layer pools "
                       "cycled, bf16"),
                 **family("tp2_seamless", mesh_k["seamless paged_gather"],
                          {"full KV": (mesh["seamless"], "paged_gather_kv")},
                          mg + ", D=8*64 (a shard's heads), K and V in one "
                          "launch, 24 layer pools cycled, bf16",
                          "full-width seamless-m4t-large-v2 at TP 2, 8 "
                          "requests x (128 + 32): K and V of each shard "
                          "(the replicated memory: the one-pool entry)"),
                 "tp2_router_launches": mesh["router"]["counts"][
                     "paged_gather_kv"],
                 "tp2_router_launches_of": f"full-width full-KV router at "
                                           f"{CUT_LAYERS} layers, 2 replicas "
                                           f"x TP 2, 8 requests, replica 1 "
                                           f"raising at step 12"},
                decode + ", bf16, a layer's K and V in one launch "
                "(paged_gather_kv, as the bf16 serve run launches it); "
                "plain_ms and library_ms: two plain and two pool[tables] "
                "calls; one_pool_*: the one-pool entry (paged_gather) on K; "
                "prefill: R=32, M=64, N=2049"),
        _record("paged_gather_dequant", src + "paged_gather.cu",
                "src/repro/kernels/paged_gather.py:33",
                kv["int8 pages"]["paged_gather_dequant_kv"],
                {**gather["decode"]["paged_gather_dequant"],
                 **dispatch("int8 pages", "paged_gather_dequant_kv"),
                 "router_launches": router_int8,
                 "router_launches_of": "reduced int8-page router cells on "
                                       "the card (raise, hang, reject, "
                                       "oom)",
                 **hymba("paged_gather_dequant", "int8 pages",
                         "paged_gather_dequant_kv",
                         hg + ", int8 -> bf16, K and V in one launch"),
                 **family("moonshot", moe_k["paged_gather_dequant"],
                          {"int8 pages": (moe["int8 pages"],
                                          "paged_gather_dequant_kv")},
                          mg + ", D=16*128, 48 layer pools cycled, int8 "
                          "-> bf16, K and V in one launch"),
                 **family("seamless",
                          vlm_k["seamless paged_gather_dequant"],
                          {"int8 pages": (encdec["int8 pages"],
                                          "paged_gather_dequant_kv")},
                          sm_g + ", int8 -> bf16, K and V in one launch",
                          sm_of),
                 **tp2("tp2", "paged_gather_dequant", ("int8 pages",),
                       "paged_gather_dequant_kv", mg + ", D=4*128, 36 layer "
                       "pools cycled, int8 -> bf16, K and V in one launch")},
                decode + ", int8 -> bf16, a layer's K and V in one launch "
                "(paged_gather_dequant_kv, as the int8 serve run launches "
                "it); plain_ms: two plain calls; one_pool_*: the "
                "single-pool launch"),
        _record("seeded_spinner", src + "spinner.cu",
                "src/repro/kernels/spinner.py:249",
                seeded_srf["spinner_seeded"],
                {**seeded[("decode query", torch.bfloat16)],
                 **train_extra("seeded spinner",
                               train["srf seeded"]["counts"],
                               "spinner_seeded", f"full-width seeded-SRF "
                               f"training, {TRAIN_STEPS} steps"),
                 **tp2("tp2", "seeded_spinner", ("seeded SRF",),
                       "spinner_seeded", "decode query: G=32 (a shard's 4 kv "
                       "heads x 8 requests), B=4, n=128, m=256, bf16, "
                       "identity"),
                 **tp2("tp2_key", "seeded_spinner key", ("seeded SRF",),
                       "spinner_seeded", "decode key: G=32, B=1, n=128, "
                       "m=256, bf16, exp")},
                "decode query: G=64 (8 kv heads x 8 requests), B=4, n=128, "
                "m=256, bf16, identity"),
        _record("fwht", src + "fwht.cu", "src/repro/kernels/fwht.py:25",
                fwht["launches"], {**fwht, **dispatch("library", "fwht")},
                "B=8192, n=1024, f32, normalized; launches: phase_fwht's "
                "public-op run, (8192, 1024) and (4096, 16384) x f32, bf16"),
        _record("circulant_project", src + "circulant.cu",
                "src/repro/kernels/circulant.py:46", circ["launches"],
                {**circ, **dispatch("library", "circulant_project")},
                "g (4, 1024), x (8192, 1024), m=4096, f32, identity; "
                "launches: phase_circulant's public-op run, 5 epilogues x "
                "f32, bf16")]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
