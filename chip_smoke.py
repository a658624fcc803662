#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. The card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once).
3. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the served shapes, in bf16 and f32 (TF32 off for the plain versions):
   ``esffn_glu`` at qwen3-moe-30b-a3b's expert shapes (D 2048, E 128,
   F 768, top-8) for N = 8 (decode) and 16 (prefill chunk) at blk 16, and
   blk 128 once; ``paged_attention`` at B 8, Hq 32, Hkv 4, hd 128, page 16
   over ragged lengths (one of them 0) and a page two slots share, with and
   without a window and softcap, and at qwen3-moe-30b-a3b's 32,768-token
   context (``PAGED_LONG``: maxp 2048, lengths up to 32,768, pages in
   random order, 64 splits of 32 pages) in bf16, with no window and with a
   4,096-token window and softcap 30. Every paged case is checked over the
   whole output and slot by slot (``_check_slots``), empty slots exactly
   0, and two calls must be bitwise equal; the long case's negative
   control (the plain output with the longest slot's last split of pages
   left out) must fail the slot-by-slot check. Times are medians of
   CUDA-event-timed launches after warm-up, with the L2 cache flushed
   before each. Then untimed checks against the plain version:
   ``paged_attention`` at ``PAGED_CHECK_CASES`` (hd 64 with G 1, hd 256
   with G 2, hd 128 with G 16, 8-token pages, f32, and a slot whose every
   split but one lies behind the window), ``esffn_glu`` on the wgmma
   route at blk 128 and 64 over ragged D x F (``ESFFN_CHECK_WIDTHS``),
   and on the stream route at mixtral-8x7b's expert widths
   (``ESFFN_WIDE``) in bf16, f32 and int8.
   Q1. The 8-bit branches against their plain versions (which dequantize,
   then run the unquantized plain function), timed the same way with
   their bounds from the 8-bit bytes: ``esffn_glu`` with int8 and fp8
   experts at the decode (N 8) and prefill-chunk (N 16) shapes,
   ``paged_attention`` over int8 pools at the lengths above, at the long
   context (with its negative control) and at the int8
   ``PAGED_CHECK_CASES``, ``esmm``
   int8/fp8 at the LM expert shapes in both orientations (every call on
   the ``mma_tf32x3`` route: two TF32 products with bf16 xs, three with
   f32; with bf16 xs the bound is the bf16 one, since every product is
   exact in bf16, and the two TF32 products' stand beside it),
   ``esffn_mlp`` int8/fp8 at Swin-MoE-Small's stage 2.
   The weights' 128 x 128 tiles differ in magnitude, and per branch a
   negative control (the plain output with a scale grid read on the wrong
   axes) must fail the limit.
   S. Sampling: ``launch.sampling.sample_rows`` on the card against the
   same function on the CPU, on seeded f32 rows (8, 151,936) under seeds
   that reach 2^31, 2^32 + 5 and -1: the keys, the random bits and the
   uniforms bit for bit, the Gumbel draws within ``GUMBEL_ULP`` ulp of
   max(|g|, 1), the tokens equal at temperature 0.8, 1.3 and a greedy /
   sampled mix; the bits of a key off by one in ``fold_in``'s data must
   differ (the negative control); then timed at B 1 and 8, sampled and
   greedy, beside the bound of reading the rows once.
   J. The kernels at jamba-1.5-large-398b's shapes
   (``jamba_kernel_cases``): ``esffn_glu``'s 8-bit stream route at D
   8192, F 24,576, E 16, top-2, N 16 and 2, against the plain version at
   ``ESFFN_TOL`` with a transposed-scale-grid negative control, timed;
   ``paged_attention`` at B 8, Hq 64, Hkv 8, hd 128, page 16, checked as
   above and timed.
   3d. The same two kernels at the shapes of the five configurations of
   phases 4d-8d (``fullwidth_kernel_cases``): ``paged_attention`` at
   gemma-2b's 8/1 and gemma3-12b's 16/8 heads at hd 256, phi3-medium-
   14b's 40/10, starcoder2-15b's 48/4 and mixtral-8x7b's 32/8 at hd 128,
   over 5d's lengths on 8 slots with each one's local window, and at the
   crossing requests' lengths (1,116 with gemma3-12b's 1,024 window and
   without it, 4,216 with mixtral-8x7b's 4,096); ``esffn_glu``'s 8-bit
   stream route at mixtral-8x7b's experts (D 4096, F 14,336, E 8, top-2)
   for N 8 and 16; all checked and timed.
4. Reference phase: a 2-layer model at qwen3-moe-30b-a3b's full width in
   float32 serves 3 prompts through the dense ``BatchedServer`` on the GPU
   (the kernels); its greedy tokens must equal those of ``PagedServer`` and
   of the batch-1 ``reference_stream``, each on the GPU and on the CPU (the
   plain versions), from the same weights.
   4s. Speculative reference: the same model (other weights), 4 requests
   of 8 prompt and 6 new tokens, odd rids sampled at 0.8 with seed 1000 +
   rid, through ``PagedServer`` with ``SpecDecoder`` (k ``SPEC_K``): with
   ``NGramDrafter`` the streams equal those without it and the batch-1
   ``reference_stream``'s, on the card, and the CPU's speculative engine
   (the plain versions) gives the same; a drafter wrong by construction
   (``(true + 1) % V``) accepts no draft, rolls back every drafted row
   and keeps the streams; ``ModelDrafter`` with the target's own config
   and params accepts every draft of the greedy requests; the page pool
   is checked after every tick and drained; temperature 0.8 moves a
   stream off greedy.
   4p. Prefix sharing and robustness: the same model (other weights),
   ``PREFIX_REF_REQUESTS`` requests of a ``PREFIX_SHARED``-token shared
   prompt (four ``PREFIX_PAGE``-token pages) and 1-6 tokens of their own,
   4 new tokens, through ``PagedServer`` with ``audit=True``
   (``assert_page_invariants`` after every scheduler step), each run
   drained after ``drop_prefix_cache``. Against the plain engine's
   streams: ``prefix_cache=True`` (token-equal, at least the second
   wave's 64 hit tokens a request, fewer prefill chunks);
   ``disagg=True`` with half/half roles (token-equal, one transfer a
   request); and one ``runtime.faults.FaultPlan`` each: NaN logits at
   ``serve.logits`` with no retries (that request fails with the
   watchdog's reason, its batchmates' streams stand), an engine-level
   ``error`` at ``serve.decode`` (one recovery, token-equal), priority
   preemption (two low-priority requests hold the whole pool; the victim
   replays token-identically through the prefix cache) and a
   ``device_drop`` under a (2, 1) plan (the requests carry across the
   shrink, token-equal). Then ``steps.make_page_copy_step`` on bf16 and
   int8 pools: the copied page equals its source in every layer and pool,
   scale rows included, and no other page moves.
   Q2. The same with int8 experts and an int8 KV cache (greedy tokens
   equal); one loss forward and backward of it with the experts frozen
   (loss and every float grad leaf as phase 7; 5 int8 ``esmm`` launches a
   layer in the backward, all on ``mma_tf32x3``); one Swin-MoE-Small
   forward at full width and
   depth, 8 images, with int8 MoE experts (logits within
   ``SWIN_KERNEL_TOL``; one int8 ``esffn_mlp`` a MoE block).
   4j. jamba-1.5-large-398b in f32, one period, d_model 8192, Din 16384,
   64/8 heads, 16 experts top-2, vocab 65,536, its dense and expert FFNs
   cut to ``HYBRID_REF_FFN`` (about 23.6 GB): ``HYBRID_REF_REQUESTS``
   greedy requests of 8 prompt and ``HYBRID_REF_NEW`` new tokens through
   ``BatchedServer``, ``PagedServer`` and ``reference_stream`` on the card
   and ``PagedServer`` on the CPU (its first request: the host takes 2.2
   s a forward), 2 slots: every stream equal; the paged card run's
   launches exactly 4 ``esffn_glu`` (stream) and 1 ``paged_attention`` a
   forward; ``steps.make_prefill_step`` (the chunked scans) within
   ``ATTN_TOL`` of the token-wise path's last logits on the card and
   within ``ESFFN_TOL`` of its own on the CPU. 4x. xlstm-350m in f32, all
   24 layers: the same, every request on both CPU engines, the chunked
   mLSTM within the JAX suite's 3e-3 (``HYBRID_CHUNK_TOL``).
   4d. Each of ``FULLWIDTH``'s five (gemma-2b, gemma3-12b, phi3-medium-
   14b, starcoder2-15b, mixtral-8x7b) at full width in f32, cut to 2
   layers (gemma3-12b to one 6-layer 5:1 period, so a global layer is
   in; mixtral-8x7b's expert d_ff to ``HYBRID_REF_FFN``), seed 41: 2
   greedy requests of 8 + 4 on 2 slots through the card's
   ``BatchedServer`` and ``PagedServer`` and the CPU's ``PagedServer``,
   every stream equal, every card launch of ``paged_attention`` and
   ``esffn_glu`` held to its plain version (``_HeldToPlain``), the
   launches counted from 0 (``_expect_launches``). gemma3-12b and
   mixtral-8x7b then serve one request past their windows (1,100 + 8
   and 4,200 + 8 tokens; the paged engine in 256-token prefill chunks)
   on both card engines: the tokens equal, every paged launch held.
   P1. The paged engine on a 1-rank NCCL mesh (``paged_mesh_phase``;
   ``single_rank_nccl``, ``make_mesh((1, 1, 1), ("pod", "data",
   "model"))``): phase 4's model and prompts through ``PagedServer``
   mesh-less and on the mesh in each of ``PAGED_MESH_VARIANTS`` (plain,
   whose streams are phase 4's; the prefix cache on a 16-token shared
   page, hit; half/half disaggregated roles, 3 transfers; int8 pages;
   speculation with phase 4s's drafter that is wrong by construction,
   every draft rolled back): streams and the whole trace equal, the page
   books audited every step and drained, every kernel launch on the mesh
   held to its plain version (``_HeldToPlain``: ``ATTN_TOL`` /
   ``ESFFN_TOL`` x max|plain|), exactly one ``esffn_glu`` (stream) a
   layer a forward and one ``paged_attention`` a layer a decode step.
   Then the MLP-experts graft (``glu=False``, biases drawn) at phase 7's
   size: one loss forward and backward card vs CPU at phase 7's limits,
   every expert kernel's launches counted; 2 requests through the paged
   engine on the mesh (held to plain; one ``esffn_mlp`` a layer a
   forward on ``mma_tf32x3``) against the CPU's: streams equal.
5. Serve phase: qwen3-moe-30b-a3b at full width and depth (48 layers, about
   61 GB of bf16 weights from a seeded generator) serves 16 greedy requests
   (8-token prompts, 16 new tokens) through ``PagedServer`` with 8 slots and
   16-token pages. The kernels' launch counts are set to 0 just before and
   read just after; both must be positive. Then the same 16 requests run
   through the dense ``BatchedServer`` (8 slots, ``max_seq`` 128) on the
   same weights, ``esffn_glu``'s counts set to 0 just before: positive
   after, every launch on the stream route, 16 in-vocabulary tokens a
   request, and the dense KV rectangle's bytes larger than the page pool's.
   Its macro-step median, tok/s, TTFT and peak are printed, and how many
   of its bf16 streams equal the paged engine's (48 bf16 layers round the
   two attention paths differently, so equality is asserted in phase 4).
   5s. Speculative serve, on the same weights: ``SPEC_SERVE_REQUESTS`` of
   the same prompts (2, not 16: a greedy and a sampled one), odd rids
   sampled at 0.8, 16 new tokens,
   through ``PagedServer`` without and with ``SpecDecoder``
   (``NGramDrafter``, k ``SPEC_K``), in turn ``SPEC_SERVE_PAIRS`` times,
   ``esffn_glu``'s counts set to 0 just before each run and read just
   after: exactly one launch a layer a prefill chunk and a decode step or
   verify round, all on ``stream``; every request finishes with 16
   in-vocabulary tokens, the pool drains. Printed: tok/s, the decode-tick
   median, the verify-round median (one slot), acceptance, rolled-back
   rows, peak memory; bf16 streams with and without speculation are
   compared, not asserted (phase 4s asserts them in f32).
   5p. Prefix-sharing serve, on the same weights:
   ``PREFIX_SERVE_REQUESTS`` requests of a ``PREFIX_SHARED``-token shared
   prompt and ``PREFIX_OWN`` tokens of their own, ``PREFIX_NEW`` new
   tokens, 8 slots, 16-token pages and a pool that holds every slot's worst
   case: without the prefix cache, with it, and with ``disagg=True``, the
   kernels' counts set to 0 just before each run and read just after
   (positive, every ``esffn_glu`` on ``stream``); every request finishes
   with ``PREFIX_NEW`` in-vocabulary tokens, the pool drains, fewer
   prefill chunks with the cache than without, one transfer a request
   with roles. Printed: prefill chunks, hit rate, TTFT medians of the
   first and the second wave, the decode-tick median, tok/s, peak pages
   and peak memory, and how many bf16 streams equal the cache-off run's
   (not asserted: bf16 serving is not repeatable between calls).
   P2. On the same weights (no second copy: on one rank every block is
   the whole tensor), ``PAGED_MESH_P2`` requests of phase 5's prompts
   through ``PagedServer`` on the 1-rank NCCL mesh (8 slots): a warm-up
   with 2 new tokens a request, every launch held to its plain version,
   then the timed run, its launches exactly one ``esffn_glu`` (stream) a
   layer a forward and one ``paged_attention`` a layer a decode step; the
   decode step median, tok/s, TTFT, peak, pool and cache bytes beside
   phase 5's mesh-less median.
   Q3. The same serve with int8 expert weights (drawn and quantized layer
   by layer, about 32 GB) and int8 KV pages, then 4 requests with fp8
   experts: the 8-bit launch counts, set to 0 just before, must be one
   ``esffn_glu`` a layer per prefill chunk and decode step and one
   ``paged_attention`` a layer per decode step; the peak memory must stay
   under 3/4 of phase 5's.
   5j. jamba-1.5-large-398b, one 8-layer period (7 Mamba layers, 1
   attention layer; MoE FFNs on the odd layers, dense GLU FFNs of F
   24,576 on the even ones) at full width, bf16 with int8 experts drawn
   and quantized expert matrix by expert matrix (``JAMBA_WEIGHT_GB``):
   ``HYBRID_SERVE_REQUESTS`` greedy requests of 8 prompt and
   ``HYBRID_SERVE_NEW`` new tokens through ``PagedServer`` (8 slots,
   16-token pages, every slot's worst case in the pool; the prompt
   prefills token by token) and then ``BatchedServer`` (8 x 128), the
   counts set to 0 just before each run: exactly one ``esffn_glu`` a MoE
   layer a forward, all on the 8-bit stream route, and on the paged engine
   one bf16 ``paged_attention`` a forward; every stream full-length, in
   the vocabulary; weight GB, peaks, decode tick, tok/s and TTFT printed,
   the two engines' bf16 streams counted. 5x. xlstm-350m, 24 layers,
   bf16, the same traffic on both engines (no kernel on its path).
   5d. ``FULLWIDTH``'s five at full width and depth in bf16 (mixtral-
   8x7b whole with int8 experts, 48.3 GB, its paged run through the
   serve CLI with ``--quant int8 --paged``): 8 greedy requests of 8 + 16
   on ``PagedServer`` (8 slots) and ``BatchedServer`` (8 x 128), each
   after a warm-up whose first decode step is held to plain, the counts
   set to 0 just before and read just after; decode median against the
   byte bound of the weights read once, tok/s, TTFT, peak, weight and KV
   bytes printed, the bf16 streams of the engines counted. Then the
   crossing requests with 16 new tokens on the paged engine, their first
   2 decode steps held.
   O. Router telemetry and the serving half of obs (``serve_obs_phase``):
   the serve CLI on the paged engine, qwen3-moe-30b-a3b at full width cut
   to 4 layers, 8 slots, 8 requests of 8 + 16 tokens, without, with
   ``--metrics`` (``--metrics-interval 4``), ``--trace-out`` and
   ``--events-out``, and without again (deterministic algorithms on):
   greedy tokens equal, per-expert counts summing to
   top_k x the routed tokens, entropy in [0, ln E], no drop, TTFT from
   the trace equal to ``ttft_s``, one prefill chunk's counts equal to a
   host ``np.bincount`` of its routing, exact launch counts, and a short
   third run with every ``paged_attention``/``esffn_glu`` launch held to
   its plain version; the decode-step medians with and without telemetry
   and the drain's flush times printed (path ``serve_obs``).

The serve phases' weights are then freed, and the training slice runs:

6. Kernel phase at training shapes (qwen3-moe-30b-a3b, 4 x 1024 tokens,
   top-8, blk 128: Np 49,024 sorted rows), every shape the LM layer
   launches, on the kernels' routes (``_route``: ``wgmma``, bf16 on the
   tensor cores; ``mma_tf32x3``, f32 in 3xTF32 on the tensor cores;
   ``simt``, FMA): ``esmm`` (``ESMM_TRAIN_CASES``) in
   bf16 and f32 at (Np, 2048) x (128, 2048, 768), transposed at the same
   and at (Np, 768) x (128, 2048, 768)^T (the dX products), once with a
   bias, and in bf16 at blk 64 (wgmma) and blk 32 (simt); ``estmm``
   (``ESTMM_TRAIN_CASES``) at (Np, 2048) x (Np, 768) in bf16 and f32, at
   768 x 2048 (dWd), at blk 64 and 32, and once on a layout where 4
   experts have no rows, whose dW must be exactly 0; ``esffn_glu`` at
   N 4096, blk 128. Each call's route is read from the per-route launch
   counts and must be the expected one. Each against its plain version,
   timed as in phase 3, with the time of ``torch._grouped_mm`` (one
   PyTorch call computing the same grouped product) where the installed
   torch has it for the dtype. Negative controls on the head cases' data:
   the plain output with one 64-wide K step left out, and with one
   block's expert swapped for its neighbour's, must each fail the limit.
   Untimed, both kernels also run on the wgmma route at the small and
   ragged ``GEMM_CHECK_WIDTHS`` against their plain versions.
   6j. The same three kernels at the shapes phase 8j gives them
   (``jamba_train_kernel_cases``: Jamba's "train" cut width, D 4096,
   F 2048, 16 experts top-2, 4 x 1024 tokens, blk 128), bf16, each on
   wgmma: ``esffn_glu``, the five ``esmm`` products of its backward
   (the recomputed g and u, t, the two dX) and the three ``estmm`` dW
   products, each against its plain version on the same card inputs at
   ``ESFFN_TOL``/``GEMM_TOL``, timed beside its bound and
   ``torch._grouped_mm``; negative control: ``esffn_glu``'s plain output
   with one block on its neighbour's expert must fail the limit.
7. Training reference: one ``loss_fn`` forward and backward of a 2-layer
   model at full width in f32 (2 x 64 tokens, blk 16) on the GPU (the
   kernels) and on the CPU (the plain versions) from the same weights and
   batch: the losses must agree within ``TRAIN_LOSS_RTOL`` and every grad
   leaf within ``TRAIN_GRAD_TOL`` x its max |grad|; every ``esmm`` and
   ``estmm`` launch of the GPU run on ``mma_tf32x3`` (read from the route
   counts).
   7q. Quantization-aware training at phase 7's size and seed: each
   expert weight's int8 payload and scales on the card equal the CPU's
   (``quantize_blockwise``; every level and scale counted); one
   ``quant="int8"`` loss and its grads on the card and the CPU within
   ``TRAIN_LOSS_RTOL`` and ``TRAIN_GRAD_TOL``; and on one layer the QAT
   loss and grads equal, within the same limits, those of the plain loss
   with each expert weight replaced by ``dequant(quant(w))`` computed
   outside (the straight-through estimator).
   7b. The same in bf16 at blk 128, where every ``esmm`` and ``estmm``
   launch takes the wgmma route (read from ``launches_by_route``): the
   losses within ``BF16_REF_LOSS_RTOL`` and each grad leaf within
   ``BF16_REF_GRAD_TOL`` of its Frobenius norm; tokens whose router
   picks differ between the two runs are counted.
8. Train phase: qwen3-moe-30b-a3b at full width and 4 layers in bf16,
   AdamW with f32 masters, ``remat="block"``, the synthetic token stream
   at global batch 4 x 1024 tokens, blk 128: one warm-up step, then 3
   steps through ``make_train_step`` with the launch counts set to 0 just
   before and read just after (per step: 2 ``esffn_glu``, 5 ``esmm`` and
   3 ``estmm`` a layer, every ``esmm`` and ``estmm`` on the wgmma route).
   Every loss must be finite.
   8q. The same state trains quantization-aware, ``quant`` each of
   ``QAT_MODES`` in turn (the expert weights through ``fake_quant`` in
   each MoE layer, the round-tripped weights through the same kernels):
   one warm-up step, then ``QAT_STEPS`` steps with the counts set to 0
   just before and read just after, phase 8's launches exactly, all on
   wgmma, every loss finite; each mode's step median beside phase 8's.

F. The fault-tolerant train loop, through the train CLI's ``main`` in
   this process (``ft_train_phase``): qwen3-moe-30b-a3b at full width cut
   to ``FT_DEPTH`` layer (17.4 GB of bf16 weights, f32 masters and
   moments), phase 8's settings, ``FT_STEPS`` steps. Run (a) saves once
   (``--save-every 4``); run (b) saves every 2 steps with
   ``FTConfig.keep`` 1, and a ``train.step`` error at call
   ``FT_FAULT_AT`` makes it restore step 2 and replay; both write
   ``--metrics``, ``--trace-out`` and ``--events-out``. (b)'s losses and
   its step-4 checkpoint's crc32 list (every leaf of the final state)
   must equal (a)'s (both under ``torch.use_deterministic_algorithms``:
   without it the combine's bf16 ``index_add_`` makes two unfaulted runs
   differ from step 1); (b) records one recovery and the event
   ``train.recover``; exactly 2/5/3 ``esffn_glu``/``esmm``/``estmm`` a
   step that ran, on wgmma. The checkpoints go to a temporary directory
   under ``build/`` (removed at the end), whose free bytes must hold two
   checkpoints. Printed: the state's bytes, the D2H snapshot's ms
   (training blocked), the background write's and the restore's s, the
   step median with and without a write in flight, the span coverage and
   the event kinds. train_obs (``train_obs_phase``): the same model through
   the train CLI with ``--metrics`` for 2 steps: the per-expert router
   series in the dump, summing to top_k x the routed tokens, and exactly
   2/5/3 launches a step (path ``train_obs``).

The qwen training state is then freed, and phase L runs the MoE LM on a
1-rank NCCL mesh (``launch.mesh.single_rank_nccl``, ``make_mesh((1, 1,
1), ("pod", "data", "model"))``, every communicator made before anything
is timed), in each of ``MESH_MODES`` (``capacity_factor`` 8: ep drops
nothing):

L1. Phase 7's model (2 layers at full width, f32, seed 7, 2 x 64 tokens,
   blk 16): one ``make_loss_fn`` forward and backward mesh-less, then one
   on the mesh a mode; each total within ``TRAIN_LOSS_RTOL`` of the
   mesh-less one and of phase 7's CPU total (the plain versions), each
   gathered gradient leaf within ``TRAIN_GRAD_TOL`` x its max |grad|
   (``MESH_EP_TOL`` for ep's cuBLAS experts), the kernel modes' launches
   ``_f32_expert_routes`` exactly. Then ``LM_MESH_PROMPTS`` greedy
   requests of ``LM_MESH_PROMPT`` + ``LM_MESH_NEW`` tokens through
   ``BatchedServer`` (mode auto) mesh-less and on the mesh, with
   ``cache_layers`` 0 and ``LM_MESH_CACHE_LAYERS``: the streams equal,
   every macro-step's logits within ``ATTN_TOL["float32"]`` x max|logit|
   of the mesh-less uncached run's, the pipeline-shared cache's stats
   (at most ``LM_MESH_CACHE_LAYERS`` resident, a hit on the second
   layer) and one ``esffn_glu`` a layer a forward on ``stream``.
L2. Phase 8's state (4 layers, bf16, seed 0, its batches): a warm-up and
   ``TRAIN_STEPS`` timed steps a mode, each mode from the same weights
   (``train.build_state(mesh=)``); losses finite and within
   ``BF16_REF_LOSS_RTOL`` of phase 8's, ``LM_MESH_LAUNCHES`` a layer a
   step on wgmma in every kernel mode (none in ep); step median, tokens/s
   and peak beside phase 8's median. One layer's ``gather_ffn_params``
   on the mesh against a device copy of the same bytes (CUDA events).
   Then ``LM_MESH_DECODE_REQUESTS`` requests through ``BatchedServer``
   (``LM_MESH_DECODE_SLOTS`` slots) mesh-less, on the mesh, and on the
   mesh with the cache: decode step medians, the cache's peak gathered
   bytes, one ``esffn_glu`` a layer a forward on ``stream`` (bf16
   streams compared, not asserted). One rank moves nothing across chips:
   these times show the code path's copies and recompute only.
   L1 and L2 then decode again in the "auto" mode with ``cache_layers``
   ``LM_MESH_CACHE_LAYERS``, eager and with ``overlap_dispatch``, under
   auto's own chooser and forced to data-centric dispatch (each cache
   entry then a layer's whole expert weights, ``gather_ffn_params(
   collectives="all")``): tokens and every macro-step's logits bit for
   bit the eager run's, the residency bounded; the cache's stats and
   the decode step medians. The two-level "node" schedule needs a node
   extent above 1, so one rank cannot run it
   (``scripts/torch_lm_mesh_scaling.py --topology`` runs it on 4 cards).

Then every other LM family trains
(``train.frontend_batch`` builds each family's batches, as the train CLI
does):

7h. f32, card vs CPU (``_card_vs_cpu_loss``: one ``loss_fn`` forward and
   backward from the same weights, phase 7's ``TRAIN_LOSS_RTOL`` and
   ``TRAIN_GRAD_TOL`` on the total and every grad leaf), 2 x 64 tokens,
   blk 16: jamba-1.5-large-398b's layout (one 8-layer period of 7 Mamba
   and 1 attention layer, MoE FFNs of 16 experts top-2 on the odd layers,
   dense GLU FFNs on the even ones) at its "reference" cut width
   (``configs/jamba_1_5_large_398b.py::cut_config``: d_model 2048, 16/2
   heads, Din 4096, dt_rank 128, both FFN widths 1,024: about 0.9 B
   parameters), whose card run must
   launch exactly 2 ``esffn_glu`` (the forward and remat's recompute, on
   ``stream`` in f32), 5 ``esmm`` and 3 ``estmm`` a MoE layer, the latter
   two on ``mma_tf32x3``: the expert kernels inside a hybrid backward,
   between the Mamba layers' scans; then xlstm-350m whole (no kernel),
   under ``HYBRID_TRAIN_GRAD_TOL`` (at one seed), and once more with the
   sLSTM's bf16 rounding of h turned off on both sides
   (``xlstm.SLSTM_H_DTYPE`` f32), where it must meet phase 7's
   ``TRAIN_GRAD_TOL``: the witness that the rounding is the gap.
7f. paligemma-3b and musicgen-large at full width, cut to
   ``FRONTEND_REF_DEPTH`` layers, f32, card vs CPU: the loss and grads as
   7h (paligemma: 2 rows of 256 SigLIP patches + 8 tokens, the prefix
   bidirectional; musicgen: 2 x 64 EnCodec frames, 64 rows of T5
   conditioning, 4 codebook heads), then a dense ``make_prefill_step``
   (256 patches + ``FRONTEND_PREFILL`` tokens; ``FRONTEND_PREFILL``
   frames + 64 conditioning rows) and ``FRONTEND_DECODES``
   ``make_serve_step`` decodes (musicgen's cross-attention recomputes
   its K/V from the conditioning each step): each step's logits within
   ``ESFFN_TOL["float32"]`` x max|CPU| (4j's limit), the cache lengths
   advancing by one a decode.
8j. Jamba's layout at its "train" cut width (d_model 4096, 32/4 heads,
   Din 8192, dt_rank 256, both FFN widths 2,048: 3.02 B parameters,
   about 48 GB of bf16 weights, f32 masters and moments), bf16, AdamW,
   ``remat="block"``, blk 128, ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens: one
   warm-up step, then ``TRAIN_STEPS`` steps with the counts set to 0 just
   before and read just after: exactly 2 ``esffn_glu``, 5 ``esmm`` and 3
   ``estmm`` a MoE layer a step, every one on wgmma; every loss and grad
   norm finite; every leaf's f32 master (a strided sample of 4,096
   elements) moved and every leaf's first moment non-zero somewhere (its
   gradient reached it); step median, tokens/s and the peak.
8x, 8p, 8m. The same for xlstm-350m (one 8-layer period of its 24, one
   timed step (``FAMILY_TRAIN_STEPS``, as 8j), 7
   mLSTM and 1 sLSTM: the sLSTM's step loop paces the host),
   paligemma-3b (256 patches + 768 tokens a row) and musicgen-large
   (1,024 frames, 64 conditioning rows, 4 codebooks a row), at full width
   and (but 8x) depth, none launching an
   expert kernel; in 8m ``embed`` and ``head`` alone have a zero
   gradient, as in JAX (the inputs are frames and the 4 codebook heads
   replace the head): their first moments must be exactly 0; 8p and 8m then run a dense prefill and
   ``FRONTEND_DECODES`` decodes from the trained weights: logits finite,
   the lengths advancing.
8d. ``FULLWIDTH``'s five at full width, bf16, the same way: gemma-2b
   whole (18 layers), gemma3-12b 6, phi3-medium-14b and starcoder2-15b 4,
   mixtral-8x7b 2 (2 ``esffn_glu``, 5 ``esmm``, 3 ``estmm`` a layer a
   step on wgmma); state and peak printed, a peak past
   ``FULLWIDTH_PEAK_NOTE_GB`` reported.

N. The families on the 1-rank NCCL mesh against their mesh-less runs on
   the card (``mesh_families_phase``): N1 Jamba's layout at 7h's cut, f32,
   one loss and gradient, the total within ``TRAIN_LOSS_RTOL``, every
   gathered grad leaf within ``TRAIN_GRAD_TOL`` x its max |grad|, exactly
   ``_f32_expert_routes`` (the Mamba islands split their channels over
   "model"); N2 xlstm-350m whole in bf16, ``2 * LM_MESH_PROMPTS`` greedy
   requests through ``BatchedServer``: the streams equal, the decode tick
   printed; N3 paligemma-3b and musicgen-large at 7f's cut, the loss
   within ``TRAIN_LOSS_RTOL``.

The training states are then freed, and the Swin-MoE slice runs (Swin-MoE-
Small, the paper's own benchmark: 8 experts top-1, f32, blk 128):

9. Kernel phase at the Swin train shapes, global batch 128 at 224^2: stage 2
   (N 25,088 tokens, D 384, F 1536: Np 26,112 sorted rows) and stage 3
   (N 6,272, D 768, F 3072: Np 7,296). ``esffn_mlp`` with both biases,
   ``esfk`` and ``ess`` at each (dW1/db1 and dW2/db2 operands), also on a
   layout where 3 experts have no rows (their dW and db exactly 0; two
   ``esfk`` calls give the same bits), with the time of the unfused
   ``estmm`` + ``ess`` pair beside ``esfk``'s and of f32 ``estmm`` alone
   (``mma_tf32x3``: esfk's kernel without db, so its dW must be esfk's
   bits, its empty experts 0, two calls equal), and ``esmm`` in f32 with
   a bias (the z recompute) and transposed (t, dX);
   ``esffn_mlp`` once in bf16. Timed as phase 3, against the plain
   versions; ``torch.segment_reduce`` is the library yardstick for ``ess``.
   ``esffn_mlp``, ``esmm`` and ``esfk`` run on the tensor cores: f32 on
   their ``mma_tf32x3`` routes (the bound is 3 x the FLOPs at the TF32
   peak, with the f32 FMA bound beside it), bf16 ``esffn_mlp`` on
   ``mma_bf16``, each call's route read from ``launches_by_route``.
   Negative controls, each of which must fail its limit: the plain
   ``esffn_mlp`` output with one 8-deep K step of x W1 left out
   (``SWIN_KERNEL_TOL``), the plain transposed ``esmm`` output with one
   8-deep K step left out (``GEMM_TOL``), the plain ``esfk`` dW with one
   32-row step of one expert left out (``SWIN_KERNEL_TOL``), the plain
   ``estmm`` dW without one expert's rows (``GEMM_TOL``). Then untimed
   checks at ragged widths (``MLP_CHECK_WIDTHS``) and blk 8, 16, 64 and
   128 (``MLP_CHECK_BLKS``): ``esffn_mlp`` in f32, bf16 and with int8
   weights; ``esmm`` in both orientations in f32, bf16 and with int8
   weights under f32 and bf16 xs, also at ``ODD_CHECK_WIDTHS`` (rows not
   whole 16-byte copies: the simt kernel); ``esfk`` in f32 and bf16,
   twice each, and again with ``ESFK_CHECK_SPLITS`` CTAs an expert's rows
   (the merge through the workspace; twice, the same bits); ``esfk``
   must refuse the odd widths; f32 ``estmm`` at every width and blk
   (``mma_tf32x3``, esfk's dW bits; ``simt`` at the odd widths).
10. Swin reference: Swin-MoE-Small at full width, depth cut to (2, 2, 2, 2)
   (one MoE block each in stages 2 and 3), f32, 2 images: one
   ``make_train_step`` loss and its grads on the GPU (the kernels) and on
   the CPU (the plain versions) from the same weights must agree within
   ``SWIN_LOSS_RTOL`` and ``SWIN_GRAD_TOL``.
11. Swin train: Swin-MoE-Small at full width and depth, global batch
   ``SWIN_BATCH`` of seeded 224^2 images and labels, AdamW
   (``master_fp32=False``): one warm-up step, then ``SWIN_STEPS`` steps
   whose launch counts must be exactly 10 ``esffn_mlp``, 30 ``esmm``, 20
   ``esfk`` and 0 ``ess`` a step, every ``esffn_mlp``, ``esmm`` and
   ``esfk`` on ``mma_tf32x3``.
   Then one forward and backward of the same loss from the same state
   with ``set_fused_backward(True)`` and with ``(False)`` (the paper's
   Fig. 12 ablation: 0 ``esfk``, 20 ``estmm`` on ``mma_tf32x3``, 20
   ``ess``): the grads must agree within ``SWIN_ABLATION_TOL``; then
   ``SWIN_STEPS`` more train steps with the unfused backward, timed and
   counted as the fused ones (the ablation a step).
   T7/8. The paper's Tables 7/8: first one MoE layer at Swin stage 2
   (batch ``T78_BATCH``, top-2, one fixed ``RouterOutput``), whose output
   and grads through megablocks must match hexa's within
   ``SWIN_KERNEL_TOL``, through tutel at an ample capacity megablocks' bit
   for bit, and through tutel at a tight capacity megablocks' with the
   dropped copies' gates 0 (the bytes each forward keeps for its backward
   are recorded); then Swin-MoE-Small (Base ran through PR 28) at full
   width and depth, f32, at every point of ``T78_AXES`` (8 experts,
   top-1/2, batch 64; Table 8's 4 experts at top-k 1, 2 and 4, batch
   32), each
   through hexa, tutel (capacity factor 1.25) and megablocks
   (``make_train_step(..., moe_impl=...)``): a fresh seeded state a cell
   and its peak predicted (a cell predicted past ``T78_PEAK_LIMIT_GB`` is
   listed as not run), one warm-up step (counting the rows the expert
   GEMMs compute, the copies tutel drops, each MoE block's top-1 picks and
   the bytes allocated at the end of its forward), then ``T78_STEPS``
   timed steps, with the measured peak and the allocator's peaks; every
   loss finite, hexa's and megablocks' first losses within
   ``T78_LOSS_RTOL``; hexa's speed-up over each baseline and its share of
   their peaks at each point, and along each axis how they grow from the
   first point to the last; then tutel and megablocks on Small at top-1
   with TF32 allowed in cuBLAS. The baselines launch no hand-written
   kernel.

The Swin state is then freed, and the flash-attention slice runs (no model
path of either package calls it, so its public entry point is its path):

12. ``flash_attention`` at the ``FLASH_CASES`` (qwen3-moe-30b-a3b's
   attention width at the LM train batch, the head case, and at S 4096;
   gemma3-12b, musicgen-large and gemma-2b heads; one f32 full case): each
   case through the entry point once with the launch counts set to 0 before
   and read after (bf16 on the ``wgmma`` route, f32 on ``simt``), then
   against ``flash_attention_plain`` (bf16 element by
   element within one output ulp, ``FLASH_BF16_RTOL`` and
   ``FLASH_BF16_ATOL``; f32 within ``FLASH_F32_TOL`` x max|plain|; the head
   case also against the port's ``chunked_attention``), timed as phase 3,
   with ``scaled_dot_product_attention`` as the library yardstick (the
   backend that ran is recorded, and its output is read by the same
   check); the head case's plain output with p rounded to bf16 before
   P V must fail that check (the negative control of the kernel's split
   P V); then the untimed ``FLASH_CHECK_CASES`` (f32 causal at the head
   shape and at hd 256, and S that leaves partial tiles on both routes
   at hd 64, 128 and 256) against the plain version.

13. Phase M, the mesh step: a 1-rank NCCL group on the card
   (``torch.distributed``, a ``FileStore`` rendezvous, ``device_id``
   cuda:0) and ``launch.mesh.make_mesh((1, 1, 1), ("pod", "data",
   "model"))``. Swin-MoE-Small at full width and depth, f32, global batch
   128, phase 11's seeded weights and batches: 3 AdamW steps mesh-less,
   then 3 on the mesh in each of model_centric, data_centric
   (``cache_policy`` shared_cache and janus), hybrid, auto and ep
   (capacity 8: nothing dropped), each from the same weights. Each step's
   loss within ``SWIN_LOSS_RTOL`` of the mesh-less step's and the
   gathered parameters within ``MESH_PARAM_TOL`` of its (``MESH_EP_TOL``
   for ep, whose experts are cuBLAS products, not the kernels); the step
   median, images/s, peak memory and the expert kernels' launches of each
   mode and policy. One rank moves nothing across chips: the gathers are
   copies on the card, which is what shows the cache's memory effect.
   Then the baselines on the mesh (``_mesh_baselines``): 3 steps through
   ``moe_impl="tutel"`` (capacity factor 1.25: copies drop) and
   ``"megablocks"`` mesh-less and on the mesh, each from the same
   weights: losses within ``SWIN_LOSS_RTOL``, the gathered parameters
   within ``MESH_PARAM_TOL``, the copies each step drops equal (tutel
   some, megablocks none); a step median each.
14. Phase H, heterogeneous execution: ``parallel.hetero_exec.
   HeteroExecutor`` at Swin-MoE-Small's stage-3 MoE layer (D 384, F 1536,
   8 experts top-1, 25,088 tokens, f32, MLP experts) and at
   qwen3-moe-30b-a3b's expert layer (D 2048, F 768, 128 experts top-8,
   4,096 tokens, bf16, GLU). For each, data- and model-centric, uniform
   against proportional, at the paper's Table 3 proxy latencies and at a
   2x skew, and once with a device class at ``expert_bits`` 8: each device
   program's time (CUDA events) and the simulated-skew step latency. After
   each timed run (and outside its launch counts) each device program's
   output is held to its plain version, and the combined output to the
   unsplit layer but for the 8-bit class, which computes another layer.
15. Phase R, roofline constants: the card's bf16 peak (the median of a
   8192^3 ``torch.matmul``) and memory rate (a device copy of 2 GiB) beside
   ``parallel.autotune.H100_SXM``'s, which must agree within 10 %; and
   ``crossover_tokens`` at the Swin-Small and qwen widths for TP 2/4/8.
16. ``optim.compression.compressed_psum`` on a 1-rank NCCL mesh over a
   256 MiB f32 gradient: bit for bit the local quantise-dequantise, 3
   error-feedback steps likewise, and its time.

The CPU sides of the reference phases (4, 4s, Q2, 4j, 4x, 4d, 7, 7q, 7b,
and all of 7h's but one, and 7f) run on the CPU lane (``_CpuLane``): one
worker thread that runs them, checks included, while the card's phases go
on; its jobs print ``[cpu-lane] NAME Ns``. The script waits for the lane
before phase O and T7/8 (each turns on a module global the lane's runs
would see) and before its result: a failed CPU check fails the run there.

It then prints the kernels' JSON line (the 8-bit branches as entries of
their own), and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): the least-time bound of a kernel
# is max(bytes / HBM rate, FLOPs / compute rate of its operand type).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
# A route's work in the operations of another peak: 3xTF32 does three TF32
# products for each f32 one, on the tensor cores. (With bf16 activations
# and 8-bit weights every product is exact in bf16, so such a case's bound
# is the bf16 one, and its route's two TF32 products stand beside it.)
ROUTE_PEAK = {"mma_tf32x3": ("tf32", 3), "mma_tf32x2": ("tf32", 2)}

ESFFN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # x max|plain|
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-5}    # x max|plain|
# ESMM/ESTMM sum in f32 in another order than cuBLAS; bf16 outputs may
# then round one ulp (2^-8 relative) apart.
GEMM_TOL = {"bfloat16": 1e-2, "float32": 1e-5}    # x max|plain|
# GPU vs CPU in f32 differ by summation order only: measured 0 on the loss
# and 3.7e-6 x max|grad| on the worst grad leaf (H100, 700 W).
TRAIN_LOSS_RTOL = 1e-6
TRAIN_GRAD_TOL = 1e-4                             # x max|grad| of the leaf
SERVE_DEPTH = 48
# Sampled and speculative decoding (phases S, 4s, 5s). Gumbel draws on the
# card and on the CPU: each of the two ``log``s agrees within 1 ulp, which
# moves g by at most ulp(1) through the inner one and ulp(g) through the
# outer, so 2 ulp of max(|g|, 1) (measured: 2.0 between XLA and torch on
# the CPU, tests/test_torch_sampling.py).
GUMBEL_ULP = 2
SAMPLE_VOCAB = 151936
SAMPLE_SEEDS = (1000, 1001, 1003, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, -1, 7)
SAMPLE_STEPS = (0, 1, 5, 15, 300, 2, 9, 123)
SPEC_K = 4
SPEC_SERVE_REQUESTS = 2          # a greedy and a sampled request, for
                                 # the script's time (8 -> 4 -> 2)
# The CPU sides of the reference phases (4, 4s, Q2, 4j, 4x, 4d, P1's
# graft, 7, 7q, 7b, 7h, 7f: the plain versions, 1-3 s a forward at these
# widths) run on the CPU lane (``_CpuLane``) beside the card's phases:
# LANE_THREADS intra-op threads of an H100 host's 8 cores at niceness
# LANE_NICE, so the thread that drives the card (and its NCCL and driver
# threads) keeps two cores; with all 8 the lane's jobs took 1.4-1.8 x as
# long and phase P 2.2 x (H100 80GB HBM3, 700 W). The jobs of LANE_FULL's
# configurations keep the host's default count, as the main thread ran
# them: their f32 sums split by thread count, and xlstm-350m's 24
# recurrent layers carry that to 4x's card-vs-CPU logits (3.1e-4 of a
# 2.9e-4 limit with 6 threads, 1.9e-4 with 8). At most LANE_GB of host
# tensors queued (the host has 96 GiB; at 48 the card's thread waited
# ~65 s for room in 4d).
LANE_THREADS, LANE_NICE, LANE_GB = 6, 10, 64.0
LANE_FULL = ("xlstm-350m",)
# one off/on pair, to hold the script's time as the mesh phases grew
SPEC_SERVE_PAIRS = 1
# Phases 4p and 5p, the prefix-sharing paged engine: requests opening with
# one PREFIX_SHARED-token prompt (four PREFIX_PAGE-token pages) and a tail
# of their own; 4p in f32 at 2 layers (equalities asserted), 5p at phase
# 5's 48 bf16 layers.
PREFIX_PAGE, PREFIX_SHARED = 16, 64
PREFIX_REF_REQUESTS, PREFIX_REF_SLOTS = 6, 3
# PREFIX_NEW 8 and 10 requests (the second wave of the 8 slots cut to 2),
# to hold the script's time as the mesh phases and phase F grew
# and 9 requests (one in the second wave; 10 before phases 3d-8d came)
PREFIX_SERVE_REQUESTS, PREFIX_OWN, PREFIX_NEW = 9, 8, 8
# Phase 8q: quantization-aware training on phase 8's state, one warm-up
# and QAT_STEPS timed steps a mode; 7q holds it to the CPU at phase 7's
# size with phase 7's limits.
QAT_MODES = ("int8", "fp8")
QAT_STEPS = 2
TRAIN_DEPTH = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3
# Phase F, the fault-tolerant train loop: one full-width qwen3 layer (17.4
# GB of state, three checkpoints written), 4 steps, a step error at call 3
FT_DEPTH, FT_STEPS, FT_FAULT_AT = 1, 4, 3
# Swin: the f32 kernels sum in another order than the plain versions'
# cuBLAS products (TF32 off): 1e-4 x max|plain| as ESFFN_TOL in f32.
SWIN_KERNEL_TOL = 1e-4
SWIN_LOSS_RTOL = 1e-5
SWIN_GRAD_TOL = 1e-4                              # x max|grad| of the leaf
# fused vs unfused backward on the card: dW is the same sum (ESTMM's f32
# route is ESFK's kernel without db, at the same splits: the same bits);
# db is summed in another order (ESFK's two row lanes vs ESS's 32), and the
# relative-position tables' grads take atomic adds in no fixed order. (With
# ESTMM's f32 FMA kernel the dW gap was 0.035 of this limit in
# tests/test_torch_tf32x3.py's model at the stage-2 widths.)
SWIN_ABLATION_TOL = 1e-5                          # x max|grad| of the leaf
SWIN_BATCH, SWIN_STEPS = 128, 3
# Phase M: the mesh step on a 1-rank mesh runs the mesh-less step's kernels
# on the same operands (the gathers are copies), so its parameters may
# part only by the clip norm's summation order (the sharded norm sums the
# dense and the MoE leaves apart): an ulp of the update a step.
# ep runs its experts as cuBLAS products (TF32 off) in place of the
# kernels: its first loss (the same weights) is held to SWIN_LOSS_RTOL;
# after that a gradient near 0 may change sign, and an Adam update is
# about lr in size whatever the gradient's, so two runs' parameters may
# part by up to 2 x the lr of each step taken (3e-6, 6e-6, 9e-6 at steps
# 1-3 of OptimizerConfig's warmup), taken x 1.5 for the update's excess
# over 1 in the first steps (measured on an H100: 1.2e-5 on the third
# loss, 2.8e-5 on a parameter).
MESH_MODES = (("model_centric", "none"), ("data_centric", "shared_cache"),
              ("data_centric", "janus"), ("hybrid", "shared_cache"),
              ("auto", "shared_cache"), ("ep", "none"))
MESH_PARAM_TOL = 1e-7
MESH_EP_TOL = 1.5 * 2 * (3e-6 + 6e-6 + 9e-6)
MESH_EP_LOSS_RTOL = 1e-4
# Phase L: the LM on the 1-rank mesh. L1 (phase 7's f32 model) decodes
# LM_MESH_NEW greedy tokens for LM_MESH_PROMPTS prompts of LM_MESH_PROMPT
# tokens through BatchedServer; L2's decode (phase 8's 4 layers, bf16)
# serves LM_MESH_DECODE_REQUESTS requests of LM_MESH_PROMPT + LM_MESH_NEW
# on LM_MESH_DECODE_SLOTS slots. Under remat="block" every kernel mode
# launches phase 8's 2 esffn_glu, 5 esmm and 3 estmm a layer a step: the
# block's recompute already runs the island again in the backward, and
# the cache policies' own checkpoint nested in it recomputes nothing more
# (ep runs its experts as cuBLAS products: none).
LM_MESH_PROMPTS, LM_MESH_PROMPT, LM_MESH_NEW = 2, 8, 8
LM_MESH_DECODE_SLOTS, LM_MESH_DECODE_REQUESTS = 8, 8
LM_MESH_CACHE_LAYERS = 2
# L2's timed steps a mode (TRAIN_STEPS before phases 3d-8d came: cut for
# the script's time)
LM_MESH_STEPS = 2
LM_MESH_LAUNCHES = {"esffn_glu": 2, "esmm": 5, "estmm": 3}
# Phase H: the paper's Table 3 proxy latencies (benchmarks/hetero_alloc.py
# PAPER_CASES: two GPUs at 100/300 W power limits) and a 2x skew.
HETERO_LATENCIES = {"paper_case1_100W_300W": (4.58, 3.06),
                    "paper_case2_300W_300W": (3.20, 3.18),
                    "paper_case3_300W_100W": (3.28, 9.42),
                    "skew_2x": (1.0, 2.0)}
HETERO_WIDTHS = {
    "swin_small_stage3": dict(d=384, f=1536, e=8, k=1, n=SWIN_BATCH * 196,
                              dtype="float32", glu=False, act="gelu"),
    "qwen3_moe_30b_a3b": dict(d=2048, f=768, e=128, k=8, n=4096,
                              dtype="bfloat16", glu=True, act="silu")}
HETERO_ROUNDS = 5
# the one route each 8-bit branch runs on (kernels/esffn.py `_route`,
# `_mlp_route`); phase H checks it on every 8-bit program
HETERO_QUANT_ROUTE = {"esffn_glu": "stream", "esffn_mlp": "mma_tf32x3"}
ROOFLINE_TOL = 0.10
# Phase P: the paged engine on a 1-rank NCCL mesh. P1's variants on phase
# 4's model (each mesh-less and on the mesh); P2's requests (8-token
# prompts from phase 5's) on phase 5's weights.
PAGED_MESH_VARIANTS = ("plain", "prefix", "disagg", "int8", "spec")
PAGED_MESH_P2 = {"requests": 8, "new": 8}
SWIN_REF_DEPTHS, SWIN_REF_BATCH = (2, 2, 2, 2), 2
# Phase T7/8, the paper's Tables 7/8 on the card: Swin-MoE-Small (and
# -Base through PR 28) at full width and depth, f32, blk 128, hexa against tutel (capacity
# factor 1.25) and megablocks, along these axes, each a list of points
# (config, experts, top-k, batch): the first grid (8 experts, top-1 and top-2,
# batch 64: every activation is kept, and megablocks' buffer of E N k rows
# a MoE block adds about 229 MB (Small) or 305 MB (Base) x batch x k);
# Table 8's latency grid (benchmarks/latency_table.py: Small, 4 experts,
# top-k 1, 2 and 4 (3 cut for time), batch 32) and its batch axis (top-1 at batch 16, 32, 64 and
# 128; the batch-32 point is the grid's cell); Table 7's memory against
# top-k (benchmarks/memory_table.py: 8 experts, top-k 1, 2, 4, 8, batch 16).
# The batch axis and Table 7's top-k axis are not run, to hold the script
# well under its time limit as the mesh phases grew.
# Base's Table-7 grid ran through PR 28; cut to keep the script's time
# with phase P (``swin_moe_base`` stays in ``T78_ACT_GB_PER_IMAGE``).
T78_CONFIGS = ("swin_moe_small",)
T78_TOP_K = (1, 2)
T78_IMPLS = ("hexa", "tutel", "megablocks")
# T78_STEPS timed steps a cell (3 before phases 3d-8d came: cut for the
# script's time)
T78_EXPERTS, T78_BATCH, T78_STEPS = 8, 64, 2
T78_AXES = {
    **{f"table7_batch64_{c[9:]}": [(c, T78_EXPERTS, k, T78_BATCH)
                                   for k in T78_TOP_K] for c in T78_CONFIGS},
    "table8_topk": [("swin_moe_small", 4, k, 32) for k in (1, 2, 4)],
}
# A cell whose predicted peak passes this is not run (the card holds 80 GB):
# it is printed and listed as "not run", the analogue of an out-of-memory
# entry in the paper's tables.
T78_PEAK_LIMIT_GB = 72.0
# Predicted peak memory of a cell (GB), from what each path keeps for its
# backward: 16 bytes a parameter (weights, grads, AdamW m and v); the
# activations outside the expert FFNs, an image; each MoE block's kept
# expert rows: hexa none (its fused FFN saves x, the router's input, which
# is kept anyway, and the row maps; z and h are recomputed in the
# backward), tutel and megablocks E C (D + 2F) x 4 bytes (the dispatch
# buffer, the pre- and post-activation h) + N k D x 4 (the combine's
# gathered copies); and the largest MoE block's backward transient: hexa
# N k (2D + 4F) x 4 (xs, dxs, z, h, t, dz), the baselines E C F x 4 (their
# backward frees each kept tensor as it makes the grad that replaces it).
# The per-image figure is Swin-MoE-Small's peak at batch 128 on an H100 in
# phase 11 (27.82 GB) less its state (2.51 GB) and its hexa transient
# (0.69 GB), over 128 images; Base's is that times its 4/3 wider channels.
# (An earlier form charged hexa N k (2D + 2F) x 4 a MoE block as well, and
# took that charge out of the per-image figure: PERF.md §7.)
T78_ACT_GB_PER_IMAGE = {"swin-moe-small": 0.1923, "swin-moe-base": 0.2564}
# Set before the first run. Layer level (Swin stage 2 at batch 64, top-2,
# one fixed RouterOutput): megablocks vs hexa, output and every grad within
# SWIN_KERNEL_TOL (the same products: cuBLAS f32 FMA against the 3xTF32
# kernels); tutel at an ample capacity (C = N k) equal to megablocks bit
# for bit (the same buffer, the same calls); tutel at a tight capacity
# (factor 1.0, which drops) vs megablocks with the dropped copies' gates
# set to 0 within SWIN_KERNEL_TOL (cuBLAS may sum the smaller buffer in
# another order). Step level: every loss finite, and the first step's loss
# of hexa and megablocks (the same weights and images) within
# T78_LOSS_RTOL: they differ by summation order (about 1e-6) and by tokens
# whose router pick flips on that noise, each of which moves one image's
# loss by far less than 1/64 of this limit at these random-init logits.
T78_LOSS_RTOL = 1e-4
# flash attention: kernel and plain version both compute in f32 (in
# another order: 6e-7 apart at most in f32 on an H100) and round once, so
# in bf16 they differ by at most one output ulp (<= 2^-7 |plain|), element
# by element; the 2^-14 floor is for outputs near 0, where an ulp is below
# the f32 noise. Rounding p to bf16 before PV (barred by the kernel's
# contract) moves outputs by more. f32 as tests/test_flash_kernel.py.
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -7, 2.0 ** -14
FLASH_F32_TOL = 2e-5                              # x max|plain|
# (case, B, S, Hq, Hkv, hd, dtype, causal); the first is the head case
FLASH_CASES = (
    ("qwen3-moe-30b-a3b train batch", 4, 1024, 32, 4, 128, "bfloat16", True),
    ("qwen3-moe-30b-a3b long context", 1, 4096, 32, 4, 128, "bfloat16", True),
    ("gemma3-12b heads", 2, 2048, 16, 8, 256, "bfloat16", True),
    ("musicgen-large heads (MHA)", 4, 1024, 32, 32, 64, "bfloat16", True),
    ("gemma-2b heads (MQA)", 4, 1024, 8, 1, 256, "bfloat16", True),
    ("qwen3 width, f32, full", 1, 1024, 32, 4, 128, "float32", False),
)
# The quantized slice (phases Q1-Q3). The 8-bit branches compute the f32
# products of the dequantized weights (and KV rows) that their plain
# versions compute, in another order, so Q1 holds them to the unquantized
# kernels' limits (ESFFN_TOL, ATTN_TOL, GEMM_TOL, SWIN_KERNEL_TOL) and Q2
# to phase 7's (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL) and the Swin kernels'.
QUANT_SWIN_BATCH = 8
QUANT_FP8_REQUESTS = 4
QUANT_INT8_REQUESTS = 8          # one wave (16 before phases 3d-8d)
# Phase 7b (bf16, blk 128: the wgmma route, GPU vs CPU), set before its
# first run. bf16 rounds every activation to 8 mantissa bits (2^-8) at
# other places on the two sides, and a token whose router top-k picks
# differ sends its grads to another expert: some 1/sqrt(1024) of a leaf's
# norm a pick (1,024 token-expert pairs a layer). So the total loss
# within 5e-3 relative, and each grad leaf within 0.1 of its Frobenius
# norm: a 64-wide K step left out of a GEMM moves a leaf by about
# 1/sqrt(32) = 0.18 (phase 6's negative control), a wrong expert tile by
# about 1.
BF16_REF_LOSS_RTOL = 5e-3
BF16_REF_GRAD_TOL = 0.1                           # x |grad| (Frobenius)
# Phases 4j/4x/5j/5x: the stacks with recurrent mixers and dense FFN
# layers. jamba-1.5-large-398b is cut to one 8-layer period (its least
# depth); 4j also cuts its dense and expert d_ff to HYBRID_REF_FFN (f32 at
# full FFN width would be 180 GB). 4j/4x: card vs CPU last-token logits
# within ESFFN_TOL["float32"] x max|CPU| (the f32 kernels' limit: the
# same products summed in another order); the chunked prefill's against
# the token-wise path's on the card within HYBRID_CHUNK_TOL x max: for
# Jamba ATTN_TOL["float32"] (the selective scan's chunked and token-wise
# forms are the same recurrence summed in another order), for xLSTM the
# JAX suite's own bound for mLSTM's chunkwise form against its recurrent
# one (tests/test_recurrent.py, 3e-3: another algorithm, whose stabiliser
# m takes other values; 6.5e-5 x max at 24 layers on an H100). On the
# CPU, 23.5 GB of f32 weights take an H100 machine's host 2.2 s a
# forward (the whole mix on both CPU engines took 204 s there), so 4j's
# CPU side is the paged engine on HYBRID_CPU's first request and the
# chunked prefill; 4x runs every request on both CPU engines (both on the
# CPU lane).
JAMBA_DEPTH = 8
HYBRID_REF_FFN = 1024
HYBRID_REF_REQUESTS, HYBRID_REF_NEW = 4, 4   # 6 new tokens, cut for time
HYBRID_CHUNK_TOL = {"jamba-1.5-large-398b": ATTN_TOL["float32"],
                    "xlstm-350m": 3e-3}
HYBRID_CPU = {"jamba-1.5-large-398b": (("paged",), 1),
              "xlstm-350m": (("paged", "reference_stream"),
                             HYBRID_REF_REQUESTS)}
# 5j/5x: one wave of the 8 slots (16 requests before phases 3d-8d came:
# cut for the script's time)
HYBRID_SERVE_REQUESTS, HYBRID_SERVE_NEW = 8, 16
JAMBA_WEIGHT_GB = (51.4, 52.4)     # predicted 51.9 +- 0.5 (int8 experts)
# Phases 7h/7f/8j/8x/8p/8m: training every LM family. jamba-1.5-large-398b
# cannot train on one 80 GB card at full width (one period is 45.2 B
# parameters, 16 bytes each with AdamW), so its layout runs at the cut
# widths of ``configs/jamba_1_5_large_398b.py::CUT_WIDTHS``: 7h in f32 at
# "reference" (about 0.9 B parameters), 6j and 8j in bf16 at "train"
# (3.02 B, about 48 GB of weights, f32 masters and moments). 7f cuts
# paligemma-3b and musicgen-large to FRONTEND_REF_DEPTH layers at full
# width; its dense steps prefill FRONTEND_PREFILL tokens (after 256
# patches) or frames and decode FRONTEND_DECODES times.
# 7h's grads card vs CPU: phase 7's TRAIN_GRAD_TOL, but for xlstm-350m
# one bf16 ulp (2^-8) x max|grad|: its sLSTM emits each step's h rounded
# to bf16 whatever the model dtype (as the JAX scan does), so the f32
# sides' summation-order differences flip some of those roundings by an
# ulp, and the flips reach every leaf before and in the sLSTM layers
# (measured 9.5e-4 on the embedding, H100, 700 W; the Jamba layout's
# worst leaf 1.4e-5 against TRAIN_GRAD_TOL). 7h holds xlstm-350m at
# HYBRID_TRAIN_SEEDS, and at the first once more with that rounding off
# on both sides, under TRAIN_GRAD_TOL.
HYBRID_TRAIN_GRAD_TOL = {"xlstm-350m": 2.0 ** -8}
HYBRID_TRAIN_SEEDS = (7,)        # a second seed cut for the script's time
# 8j/8x/8p/8m: the leaves whose gradient is zero in JAX too (musicgen's
# inputs are frames, and its codebook heads replace the head).
ZERO_GRAD_LEAVES = {"musicgen-large": ("embed", "head")}
# 8x trains one period of xlstm-350m's layer pattern: its 24 layers took
# 17.7 s a step on an H100 80GB HBM3 at 700 W (3 sLSTM step loops of
# 1,024 host-paced steps each). 8j/8x/8p/8m time FAMILY_TRAIN_STEPS
# steps after the warm-up (TRAIN_STEPS before phases 3d-8d came: cut for
# the script's time)
XLSTM_TRAIN_DEPTH, FAMILY_TRAIN_STEPS = 8, 1
FRONTEND_REF_DEPTH = 2
FRONTEND_PREFILL, FRONTEND_DECODES = 8, 4
FLASH_CHECK_CASES = (                  # (B, S, Hq, Hkv, hd, dtype, causal)
    (4, 1024, 32, 4, 128, "float32", True),
    (2, 2048, 16, 8, 256, "float32", True),
    (1, 200, 4, 2, 256, "float32", True),
    (2, 200, 8, 2, 128, "float32", True),
    (2, 200, 8, 2, 128, "float32", False),
    (1, 96, 4, 1, 256, "bfloat16", True),
    (1, 80, 4, 4, 64, "float32", True),
    (2, 200, 8, 2, 128, "bfloat16", True),
    (2, 200, 8, 2, 128, "bfloat16", False),
    (1, 80, 4, 4, 64, "bfloat16", True),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call;
    the L2 is flushed before each (and gives the host time to enqueue)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype: str, route=None):
    """(least ms, what bounds it): the bytes at the memory's rate, or the
    operations at the peak of the dtype (or of the route's units, as
    ROUTE_PEAK says), whichever takes longer."""
    peak, times = ROUTE_PEAK.get(route, (dtype, 1))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = times * flops / PEAK_FLOPS[peak] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _fma_bound(route, nbytes, flops):
    """On a 3xTF32 route, the f32 FMA bound to stand beside the route's own
    (as {"bound_fma_ms": ms}); on any other route, nothing."""
    if route != "mma_tf32x3":
        return {}
    return {"bound_fma_ms": bound(nbytes, flops, "float32")[0]}


def esffn_cases(torch, flush):
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route
    from repro_torch.kernels import esffn

    d, e, f, k = 2048, 128, 768, 8
    gen = torch.Generator(device="cuda").manual_seed(1)
    w32 = [torch.randn(shape, generator=gen, device="cuda") * 0.02
           for shape in ((e, d, f), (e, d, f), (e, f, d))]
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    cases = []
    for n, blk, dtype in ((8, 16, "bfloat16"), (8, 16, "float32"),
                          (16, 16, "bfloat16"), (16, 16, "float32"),
                          (16, 128, "bfloat16")):
        td = getattr(torch, dtype)
        ws = [w.to(td) for w in w32]
        x = torch.randn((n, d), generator=gen, device="cuda").to(td)
        r = route(x, router, k)
        ri = build_reindex(r.expert_idx, r.gates, e, blk)
        args = (x, ri.row_token, ri.row_gate, ri.block_expert, *ws)
        plain = esffn.esffn_glu_plain(*args)
        kern, kroute = _routed(torch, lambda: esffn.esffn_glu(*args),
                               esffn.esffn_glu)
        want = "wgmma" if blk == 128 and dtype == "bfloat16" else "stream"
        if kroute != want:
            raise AssertionError(f"esffn_glu N={n} blk={blk} {dtype}: took "
                                 f"the {kroute} route, not {want}")
        if not torch.isfinite(kern).all():
            raise AssertionError(f"esffn_glu N={n} blk={blk} {dtype}: non-finite")
        err = (kern.float() - plain.float()).abs().max().item()
        tol = ESFFN_TOL[dtype] * plain.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"esffn_glu N={n} blk={blk} {dtype}: max abs "
                                 f"err {err} > {tol}")
        live = (ri.row_gate.reshape(-1, blk) != 0).any(dim=1)
        experts = torch.unique(ri.block_expert[live]).numel()
        itemsize = x.element_size()
        np_rows = ri.row_token.numel()
        nbytes = (n * d * itemsize + experts * 3 * d * f * itemsize
                  + np_rows * (4 + 4) + ri.block_expert.numel() * 4
                  + np_rows * d * itemsize)
        flops = 6 * int((ri.row_gate != 0).sum()) * d * f
        b_ms, b_by = bound(nbytes, flops, dtype)
        cases.append({
            "shape": {"N": n, "D": d, "E": e, "F": f, "top_k": k, "blk": blk,
                      "Np": np_rows, "live_blocks": int(live.sum()),
                      "experts_read": experts},
            "dtype": dtype, "kernel_route": kroute, "max_abs_err": err,
            "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: esffn.esffn_glu(*args), flush),
            "plain_ms": time_ms(torch, lambda: esffn.esffn_glu_plain(*args),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by})
        del ws, plain, kern
    return cases


def _paged_inputs(torch, gen, b, hq, hkv, hd, page, lengths_l, maxp, dtype,
                  kv=None):
    """q, K/V pools and a page table for slots of the given lengths: each
    slot's pages in random order, and (with 4 or more slots) slot 2's first
    page shared with slot 3's. kv "int8": int8 pools with f32 row scales
    whose magnitudes differ by row and head (2^-2 .. 2^2). Returns the
    call's positional arguments and its scale keywords."""
    from repro_torch.quant.core import quantize_rows

    need = [-(-n // page) for n in lengths_l]
    npages = 1 + sum(need)
    perm = torch.randperm(npages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros((b, maxp), dtype=torch.int32, device="cuda")
    at = 0
    for i, c in enumerate(need):
        table[i, :c] = perm[at:at + c]
        at += c
    if b > 3 and need[2] and need[3]:
        table[2, 0] = table[3, 0]       # a page two slots share
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    td = getattr(torch, dtype)
    q = torch.randn((b, 1, hq, hd), generator=gen, device="cuda").to(td)
    shape = (npages, page, hkv, hd)
    if kv == "int8":
        def rows():
            mag = torch.exp2(torch.rand((npages, page, hkv, 1), generator=gen,
                                        device="cuda") * 4 - 2)
            return quantize_rows(torch.randn(shape, generator=gen,
                                             device="cuda") * mag)
        (kp, ks), (vp, vs) = rows(), rows()
        return (q, kp, vp, table, lengths), {"k_scale": ks, "v_scale": vs}
    kp = torch.randn(shape, generator=gen, device="cuda").to(td)
    vp = torch.randn(shape, generator=gen, device="cuda").to(td)
    return (q, kp, vp, table, lengths), {}


def _paged_work(args, scaled, window):
    """(bytes, FLOPs) that one call needs: q read and the output written,
    the table and lengths, and the K/V rows (and, ``scaled``, the int8 row
    scales) of the live tokens only (the kernel reads no other row)."""
    q, kp, _, table, lengths = args
    b, _, hq, hd = q.shape
    hkv = kp.shape[2]
    tokens = 0
    for n in lengths.tolist():
        tokens += n - (max(n - window, 0) if window else 0)
    row = hd * kp.element_size() + (4 if scaled else 0)
    nbytes = (2 * q.numel() * q.element_size() + table.numel() * 4 + b * 4
              + 2 * tokens * hkv * row)
    return nbytes, 4 * tokens * hq * hd


def _check_slots(name, kern, plain, tol_rel):
    """Each slot's output within ``tol_rel`` x that slot's own max|plain|
    (an empty slot exactly 0): where slots' outputs differ in size by 100
    x, as short and 32,768-token slots do, a check against the largest
    cannot see a fault in the longest. Returns the worst err / limit."""
    if not bool(kern.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    worst = 0.0
    for i in range(plain.shape[0]):
        err = (kern[i].float() - plain[i].float()).abs().max().item()
        lim = tol_rel * plain[i].float().abs().max().item()
        if not err <= lim:
            raise AssertionError(f"{name}: slot {i}: max abs err {err} > "
                                 f"{lim}")
        worst = max(worst, err / lim if lim else 0.0)
    return worst


def _last_split_left_out(lengths, maxp, page):
    """The lengths with the longest slot's last split of pages left out:
    the negative control of the kernel's split merge."""
    from repro_torch.kernels.paged_attention import pages_per_split

    pps = pages_per_split(maxp)
    cut = lengths.clone()
    i = int(lengths.argmax())
    last_page = (int(lengths[i]) - 1) // page
    cut[i] = last_page // pps * pps * page
    return cut


def _paged_check(torch, name, args, kw, dtype):
    """The kernel against its plain version: ATTN_TOL over the whole
    output and slot by slot, empty slots exactly 0, and two calls bitwise
    equal. Returns (kernel output, plain output, max abs err, limit, worst
    per-slot err / limit)."""
    from repro_torch.kernels import paged_attention as pa

    plain = pa.paged_attention_ref(*args, **kw)
    kern = pa.paged_attention(*args, **kw)
    again = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    for i, n in enumerate(args[4].tolist()):
        if n == 0 and not torch.equal(kern[i], torch.zeros_like(kern[i])):
            raise AssertionError(f"{name}: empty slot {i} not zero")
    if not torch.equal(kern, again):
        raise AssertionError(f"{name}: two calls differ")
    err, tol = _check(name, kern, plain, ATTN_TOL[dtype])
    worst = _check_slots(name, kern, plain, ATTN_TOL[dtype])
    return kern, plain, err, tol, worst


# phase 3 (kv None) and Q1 (kv "int8"), untimed: (name, B, Hq, Hkv, hd,
# page, lengths, maxp, q dtype, kv, window, softcap). maxp 64 makes splits
# of 4 pages; with a window of 60, slot 3's 1,024 tokens leave every split
# but its last behind the window.
PAGED_CHECK_LENGTHS = (0, 33, 700, 1000)
PAGED_CHECK_CASES = (
    ("hd 64, G 1", 4, 8, 8, 64, 16, PAGED_CHECK_LENGTHS, 64, "bfloat16",
     None, None, 0.0),
    ("hd 256, G 2", 4, 4, 2, 256, 16, PAGED_CHECK_LENGTHS, 64, "bfloat16",
     None, None, 0.0),
    ("hd 128, G 16", 4, 32, 2, 128, 16, PAGED_CHECK_LENGTHS, 64, "bfloat16",
     None, None, 0.0),
    ("page 8", 4, 32, 4, 128, 8, PAGED_CHECK_LENGTHS, 128, "bfloat16", None,
     100, 30.0),
    ("f32", 4, 32, 4, 128, 16, PAGED_CHECK_LENGTHS, 64, "float32", None,
     None, 0.0),
    ("f32, hd 256, G 2", 4, 4, 2, 256, 16, PAGED_CHECK_LENGTHS, 64,
     "float32", None, 70, 0.0),
    ("one live split, the rest behind the window", 4, 32, 4, 128, 16,
     (0, 5, 1000, 1024), 64, "bfloat16", None, 60, 0.0),
    ("int8", 4, 32, 4, 128, 16, PAGED_CHECK_LENGTHS, 64, "bfloat16", "int8",
     None, 0.0),
    ("int8, hd 64, G 1", 4, 8, 8, 64, 16, PAGED_CHECK_LENGTHS, 64,
     "bfloat16", "int8", None, 0.0),
    ("int8, f32 q, page 8", 4, 32, 4, 128, 8, PAGED_CHECK_LENGTHS, 128,
     "float32", "int8", 100, 30.0),
    ("int8, one live split", 4, 32, 4, 128, 16, (0, 5, 1000, 1024), 64,
     "bfloat16", "int8", 60, 0.0),
)
# qwen3-moe-30b-a3b at its 32,768-token context: 8 slots, 16-token pages
PAGED_LONG = dict(b=8, hq=32, hkv=4, hd=128, page=16, maxp=2048,
                  lengths=(0, 1, 511, 2048, 4097, 8192, 16385, 32768))


def paged_check_cases(torch, kv):
    """The untimed PAGED_CHECK_CASES of one pool kind (None or "int8")."""
    out = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for (name, b, hq, hkv, hd, page, lengths_l, maxp, dtype, kv_, window,
         softcap) in PAGED_CHECK_CASES:
        if kv_ != kv:
            continue
        args, scales = _paged_inputs(torch, gen, b, hq, hkv, hd, page,
                                     lengths_l, maxp, dtype, kv)
        kw = dict(scales, window=window, softcap=softcap)
        _, _, err, tol, worst = _paged_check(
            torch, f"paged_attention check {name}", args, kw, dtype)
        out.append({"case": name, "B": b, "Hq": hq, "Hkv": hkv, "hd": hd,
                    "page": page, "lengths": list(lengths_l), "maxp": maxp,
                    "dtype": dtype, "kv": kv or dtype, "window": window,
                    "softcap": softcap, "max_abs_err": err, "tolerance": tol,
                    "worst_slot_err_over_tol": worst})
        del args, scales
    return out


def paged_long_case(torch, flush, kv=None):
    """The long-context case (PAGED_LONG), bf16 q, with no window and then
    a 4,096-token window with softcap 30: checked slot by slot, two calls
    bitwise equal, timed; and its negative control, the plain output with
    the longest slot's last split of pages left out, must fail the
    slot-by-slot check. Returns (cases, negative control)."""
    from repro_torch.kernels import paged_attention as pa

    c = PAGED_LONG
    gen = torch.Generator(device="cuda").manual_seed(6)
    args, scales = _paged_inputs(torch, gen, c["b"], c["hq"], c["hkv"],
                                 c["hd"], c["page"], c["lengths"], c["maxp"],
                                 "bfloat16", kv)
    cases, neg = [], None
    for window, softcap in ((None, 0.0), (4096, 30.0)):
        kw = dict(scales, window=window, softcap=softcap)
        name = (f"paged_attention long context {kv or 'bfloat16'} "
                f"window={window}")
        _, plain, err, tol, worst = _paged_check(torch, name, args, kw,
                                                 "bfloat16")
        if window is None:
            cut = _last_split_left_out(args[4], c["maxp"], c["page"])
            wrong = pa.paged_attention_ref(*args[:4], cut, **kw)
            try:
                _check_slots(name + " last split left out", wrong, plain,
                             ATTN_TOL["bfloat16"])
            except AssertionError:
                i = int(args[4].argmax())
                lim = ATTN_TOL["bfloat16"] * plain[i].float().abs().max()
                neg = {"kernel": "paged_attention",
                       "fault": "the longest slot's last split of pages "
                                "left out (checked slot by slot)",
                       "err_over_tol": float((wrong[i].float() - plain[i]
                                              .float()).abs().max() / lim)}
            else:
                raise AssertionError(f"negative control {name}: the plain "
                                     f"output without the last split "
                                     f"passed the limit")
            del wrong
        del plain
        nbytes, flops = _paged_work(args, bool(scales), window)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        cases.append({
            "case": "qwen3-moe-30b-a3b long context",
            "shape": {"B": c["b"], "Hq": c["hq"], "Hkv": c["hkv"],
                      "hd": c["hd"], "page": c["page"], "maxp": c["maxp"],
                      "lengths": list(c["lengths"]), "window": window,
                      "softcap": softcap,
                      "splits": pa.num_splits(c["maxp"]),
                      "pages_per_split": pa.pages_per_split(c["maxp"])},
            "dtype": "bfloat16", "kv": kv or "bfloat16", "max_abs_err": err,
            "tolerance": tol, "worst_slot_err_over_tol": worst,
            "deterministic": True,
            "kernel_ms": time_ms(torch, lambda: pa.paged_attention(
                *args, **kw), flush),
            "plain_ms": time_ms(torch, lambda: pa.paged_attention_ref(
                *args, **kw), flush, iters=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "library_ms": None,
            "library": "none: no one call takes the paged layout"})
    del args, scales
    torch.cuda.empty_cache()
    return cases, neg


def paged_attention_cases(torch, flush):
    """Phase 3's paged attention: the serve lengths (timed; the head case
    first), the long-context case and the untimed checks. Returns (timed
    cases, checks, negative control)."""
    from repro_torch.kernels import paged_attention as pa

    b, hq, hkv, hd, page = 8, 32, 4, 128, 16
    lengths_l = [0, 1, 9, 16, 17, 24, 100, 250]
    maxp = 16
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dtype in ("bfloat16", "float32"):
        args, _ = _paged_inputs(torch, gen, b, hq, hkv, hd, page, lengths_l,
                                maxp, dtype)
        for window, softcap in ((None, 0.0), (32, 30.0)):
            kw = dict(window=window, softcap=softcap)
            _, _, err, tol, worst = _paged_check(
                torch, f"paged_attention {dtype} window={window}", args, kw,
                dtype)
            nbytes, flops = _paged_work(args, {}, window)
            b_ms, b_by = bound(nbytes, flops, dtype)
            cases.append({
                "case": "serve lengths",
                "shape": {"B": b, "Hq": hq, "Hkv": hkv, "hd": hd,
                          "page": page, "maxp": maxp, "lengths": lengths_l,
                          "window": window, "softcap": softcap,
                          "splits": pa.num_splits(maxp)},
                "dtype": dtype, "max_abs_err": err, "tolerance": tol,
                "worst_slot_err_over_tol": worst,
                "kernel_ms": time_ms(torch, lambda: pa.paged_attention(
                    *args, **kw), flush),
                "plain_ms": time_ms(torch, lambda: pa.paged_attention_ref(
                    *args, **kw), flush),
                "bound_ms": b_ms, "bound_by": b_by})
    long_cases, neg = paged_long_case(torch, flush)
    return cases + long_cases, paged_check_cases(torch, None), neg


def _sorted_layout(torch, n, empty_experts=0, seed=5, blk=128):
    """qwen3-moe-30b-a3b's routing of n random tokens (top-8 of 128
    experts) on the sorted layout of block size ``blk``; with
    ``empty_experts`` every pick of the first few experts moves to the
    expert ``empty_experts`` places on, so those experts get no rows."""
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route

    d, e, k = 2048, 128, 8
    gen = torch.Generator(device="cuda").manual_seed(seed)
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    x = torch.randn((n, d), generator=gen, device="cuda")
    r = route(x, router, k)
    idx = r.expert_idx
    if empty_experts:
        idx = torch.where(idx < empty_experts, idx + empty_experts, idx)
    return x, build_reindex(idx, r.gates, e, blk), gen


def _check(name, kern, plain, tol_rel):
    if not bool(kern.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (kern.float() - plain.float()).abs().max().item()
    tol = tol_rel * plain.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err, tol


def _flash_err(kern, plain, dtype):
    """(max abs err, worst err / limit, limit): bf16 element by element
    within FLASH_BF16_RTOL |plain| + FLASH_BF16_ATOL, f32 within
    FLASH_F32_TOL x max|plain|. Passes where the worst ratio is <= 1."""
    diff = (kern.float() - plain.float()).abs()
    err = diff.max().item()
    if dtype == "bfloat16":
        lim = FLASH_BF16_RTOL * plain.float().abs() + FLASH_BF16_ATOL
        return err, (diff / lim).max().item(), (
            f"{FLASH_BF16_RTOL} x |plain| + {FLASH_BF16_ATOL}, elementwise")
    tol = FLASH_F32_TOL * plain.float().abs().max().item()
    return err, err / tol, tol


def _check_flash(name, kern, plain, dtype):
    if not bool(kern.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err, ratio, lim = _flash_err(kern, plain, dtype)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: max abs err {err}, {ratio} x the "
                             f"limit {lim}")
    return err, ratio, lim


def _library_ms(torch, flush, fn, dtype):
    """Time of ``torch._grouped_mm`` computing the same grouped product,
    or (None, reason) where this torch has none for the dtype."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch has no _grouped_mm"
    if dtype != "bfloat16":
        return None, "torch._grouped_mm takes bf16 operands only"
    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError as err:   # the library refused these operands
        return None, f"torch._grouped_mm refused the operands: {err}"
    return time_ms(torch, fn, flush), "torch._grouped_mm"


def _routed(torch, fn, kernel):
    """Call ``fn`` once and return (its output, the route it launched on,
    read from the kernel's per-route counts)."""
    before = dict(kernel.launches_by_route)
    out = fn()
    torch.cuda.synchronize()
    moved = [r for r, n in kernel.launches_by_route.items() if n != before[r]]
    if len(moved) != 1:
        raise AssertionError(f"{kernel.__name__}: one call moved the route "
                             f"counts {moved}")
    return out, moved[0]


def _must_fail(name, wrong, plain, tol_rel):
    """Negative control: ``wrong`` (the plain output with a tile-mapping
    fault put in) must fail ``_check`` at the limit the kernels meet.
    Returns its error over the limit."""
    try:
        _check(name, wrong, plain, tol_rel)
    except AssertionError:
        err = (wrong.float() - plain.float()).abs().max().item()
        return err / (tol_rel * plain.float().abs().max().item())
    raise AssertionError(f"negative control {name} passed the limit")


def _rates(case, nbytes, flops):
    """TFLOP/s and GB/s the kernel reached (the bound's bytes and flops
    over its time)."""
    case["tflops"] = flops / case["kernel_ms"] / 1e9
    case["gb_per_s"] = nbytes / case["kernel_ms"] / 1e6
    return case


# Phase 6 cases (dtype, transpose_rhs, bias, K, N, blk, route): every
# shape the LM layer launches (g/u at K 2048 -> N 768, t transposed at the
# same, the two dX products transposed at K 768 -> N 2048), f32 on the
# 3xTF32 tensor-core route, and the 64- and 32-row instances.
ESMM_TRAIN_CASES = (
    ("bfloat16", False, False, 2048, 768, 128, "wgmma"),
    ("float32", False, False, 2048, 768, 128, "mma_tf32x3"),
    ("bfloat16", True, False, 2048, 768, 128, "wgmma"),
    ("float32", True, False, 2048, 768, 128, "mma_tf32x3"),
    ("bfloat16", False, True, 2048, 768, 128, "wgmma"),
    ("bfloat16", True, False, 768, 2048, 128, "wgmma"),
    ("bfloat16", False, False, 2048, 768, 64, "wgmma"),
    ("bfloat16", False, False, 2048, 768, 32, "simt"),
)
# (dtype, empty experts, D1, D2, blk, route): dWg/dWu at 2048 x 768, dWd
# at 768 x 2048; f32 on the 3xTF32 tensor-core route (esfk's kernel
# without db).
ESTMM_TRAIN_CASES = (
    ("bfloat16", 0, 2048, 768, 128, "wgmma"),
    ("float32", 0, 2048, 768, 128, "mma_tf32x3"),
    ("bfloat16", 4, 2048, 768, 128, "wgmma"),
    ("bfloat16", 0, 768, 2048, 128, "wgmma"),
    ("bfloat16", 0, 2048, 768, 64, "wgmma"),
    ("bfloat16", 0, 2048, 768, 32, "simt"),
)


# Untimed bf16 checks at small and ragged widths on the wgmma route:
# (K, N) for esmm and (D1, D2) for estmm, each at blk 128 and 64, both
# weight orientations, with and without a bias; width 8 is the least the
# route takes, 136 and 200 leave partial K steps and N / D tiles.
GEMM_CHECK_WIDTHS = ((8, 8), (136, 200), (200, 136))


def gemm_check_cases(torch):
    """Phase 6, untimed: esmm and estmm on the wgmma route at the
    GEMM_CHECK_WIDTHS over a random top-2 layout of 8 experts, two of them
    empty, against the plain versions within GEMM_TOL."""
    from repro_torch.core.reindex import build_reindex
    from repro_torch.kernels import esmm, estmm

    gen = torch.Generator(device="cuda").manual_seed(13)
    e, worst, n_cases = 8, 0.0, 0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for blk in (128, 64):
        idx = torch.randint(2, e, (300, 2), generator=gen, device="cuda")
        lay = build_reindex(idx.int(), torch.rand((300, 2), generator=gen,
                                                  device="cuda"), e, blk)
        be, pc, np_rows = lay.block_expert, lay.padded_counts, \
            lay.row_token.numel()
        for a, b in GEMM_CHECK_WIDTHS:
            for trans in (False, True):
                for bias in (False, True):
                    xs = randn(np_rows, a).bfloat16()
                    w = (randn(e, b, a) if trans else randn(e, a, b)).bfloat16()
                    bv = randn(e, b) if bias else None
                    kern, route = _routed(torch, lambda: esmm.esmm(
                        xs, w, bv, be, transpose_rhs=trans), esmm.esmm)
                    name = (f"esmm check blk {blk} K {a} N {b} trans={trans} "
                            f"bias={bias}")
                    if route != "wgmma":
                        raise AssertionError(f"{name}: took {route}")
                    err, tol = _check(name, kern, esmm.esmm_plain(
                        xs, w, bv, be, transpose_rhs=trans),
                        GEMM_TOL["bfloat16"])
                    worst, n_cases = max(worst, err / tol), n_cases + 1
            x1, x2 = randn(np_rows, a).bfloat16(), randn(np_rows, b).bfloat16()
            kern, route = _routed(torch, lambda: estmm.estmm(x1, x2, be, pc),
                                  estmm.estmm)
            name = f"estmm check blk {blk} D1 {a} D2 {b}"
            if route != "wgmma":
                raise AssertionError(f"{name}: took {route}")
            err, tol = _check(name, kern, estmm.estmm_plain(x1, x2, be, pc),
                              GEMM_TOL["bfloat16"])
            if not torch.equal(kern[pc == 0], torch.zeros_like(kern[pc == 0])):
                raise AssertionError(f"{name}: empty experts not exactly 0")
            worst, n_cases = max(worst, err / tol), n_cases + 1
    print(f"[kernel-train] {n_cases} untimed esmm/estmm wgmma checks at widths "
          f"{GEMM_CHECK_WIDTHS}: worst err {worst:.3f} x the limit")
    return {"cases": n_cases, "worst_err_over_tol": worst}


# Untimed esffn_glu checks against esffn_glu_plain: (D, F) on the wgmma
# route at blk 128 and 64 (one and two consumer warpgroups) over a top-2
# layout of 8 experts, two of them empty, with the dead rows of every
# group's last block; 24 x 40 and 200 x 136 leave partial D steps and F
# tiles. And the stream route at mixtral-8x7b's expert widths (D 4096,
# F 14336, 8 experts, top-2, blk 16 as served) in bf16, f32 and int8.
ESFFN_CHECK_WIDTHS = ((24, 40), (200, 136), (2048, 768))
ESFFN_WIDE = (4096, 14336, 8, 2)


def esffn_check_cases(torch):
    """Phase 3, untimed: esffn_glu at ESFFN_CHECK_WIDTHS on the wgmma
    route and at ESFFN_WIDE on the stream route, each route read from the
    per-route counts, within ESFFN_TOL of the plain version."""
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route
    from repro_torch.kernels import esffn
    from repro_torch.quant.core import quantize_blockwise

    gen = torch.Generator(device="cuda").manual_seed(17)
    worst, names = 0.0, []

    def check(name, want, args, **kw):
        nonlocal worst
        kern, kroute = _routed(torch, lambda: esffn.esffn_glu(*args, **kw),
                               esffn.esffn_glu)
        if kroute != want:
            raise AssertionError(f"{name}: took the {kroute} route, not "
                                 f"{want}")
        dtype = str(args[0].dtype).removeprefix("torch.")
        err, tol = _check(name, kern, esffn.esffn_glu_plain(*args, **kw),
                          ESFFN_TOL[dtype])
        worst = max(worst, err / tol)
        names.append(name)

    e = 8
    for blk in (128, 64):
        idx = torch.randint(2, e, (300, 2), generator=gen, device="cuda")
        lay = build_reindex(idx.int(), torch.rand((300, 2), generator=gen,
                                                  device="cuda"), e, blk)
        for d, f in ESFFN_CHECK_WIDTHS:
            x = torch.randn((300, d), generator=gen, device="cuda").bfloat16()
            ws = [(torch.randn(sh, generator=gen, device="cuda")
                   / sh[1] ** 0.5).bfloat16()
                  for sh in ((e, d, f), (e, d, f), (e, f, d))]
            check(f"esffn_glu check blk {blk} D {d} F {f}", "wgmma",
                  (x, lay.row_token, lay.row_gate, lay.block_expert, *ws))
            del x, ws

    d, f, e, k = ESFFN_WIDE
    w32 = [_tiled_weights(torch, gen, sh) for sh in ((e, d, f), (e, d, f),
                                                    (e, f, d))]
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    x = torch.randn((8, d), generator=gen, device="cuda")
    r = route(x, router, k)
    lay = build_reindex(r.expert_idx, r.gates, e, 16)
    maps = (lay.row_token, lay.row_gate, lay.block_expert)
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        check(f"esffn_glu check mixtral width {dtype}", "stream",
              (x.to(td), *maps, *(w.to(td) for w in w32)))
    qs = [quantize_blockwise(w, mode="int8") for w in w32]
    del w32
    check("esffn_glu check mixtral width int8 bfloat16", "stream",
          (x.bfloat16(), *maps, *(q for q, _ in qs)),
          w_scales=tuple(s for _, s in qs))
    del qs
    torch.cuda.empty_cache()
    print(f"[kernel] {len(names)} untimed esffn_glu checks (wgmma at "
          f"{ESFFN_CHECK_WIDTHS}, blk 128 and 64; stream at mixtral's "
          f"D {d} F {f}): worst err {worst:.3f} x the limit")
    return {"cases": len(names), "worst_err_over_tol": worst}


def _neighbour_swap(be):
    """block_expert with the first block whose neighbour belongs to
    another expert moved to that expert."""
    i = int((be[1:] != be[:-1]).nonzero()[0, 0])
    wrong = be.clone()
    wrong[i] = be[i + 1]
    return wrong


def _group_offsets(torch, lay):
    """``torch._grouped_mm``'s row offsets for a sorted layout: the tail
    blocks belong to expert E-1."""
    offs = torch.cumsum(lay.padded_counts, 0).to(torch.int32)
    offs[-1] = lay.row_token.numel()
    return offs


def train_kernel_cases(torch, flush):
    """Phase 6: esmm, estmm and esffn_glu at the train phase's shapes."""
    from repro_torch.core.reindex import gather_rows
    from repro_torch.kernels import esffn, esmm, estmm

    n, d, e, f = TRAIN_BATCH * TRAIN_SEQ, 2048, 128, 768
    x, ri, gen = _sorted_layout(torch, n)
    layouts = {128: ri}
    for blk in (64, 32):
        layouts[blk] = _sorted_layout(torch, n, blk=blk)[1]
    res = {"esmm": [], "estmm": [], "esffn_glu": [], "negative_controls": [],
           "checks": gemm_check_cases(torch)}

    def shape_of(lay, blk):
        return {"N": n, "D": d, "E": e, "F": f, "top_k": 8, "blk": blk,
                "Np": lay.row_token.numel(),
                "experts_with_rows": int((lay.padded_counts > 0).sum())}

    for i, (dtype, trans, bias, k_dim, n_dim, blk, want) in enumerate(
            ESMM_TRAIN_CASES):
        td = getattr(torch, dtype)
        lay = layouts[blk]
        be, np_rows, nblk = lay.block_expert, lay.row_token.numel(), \
            lay.block_expert.numel()
        experts = int((lay.padded_counts > 0).sum())
        w = (torch.randn((e, n_dim, k_dim) if trans else (e, k_dim, n_dim),
                         generator=gen, device="cuda") * 0.02).to(td)
        b = ((torch.randn((e, n_dim), generator=gen, device="cuda") * 0.1)
             .to(td) if bias else None)
        # K 2048: the tokens' rows; K 768: a dg-like operand, zero on
        # padding rows as the backward gives it
        xs = (gather_rows(x.to(td), lay.row_token) if k_dim == d else
              (torch.randn((np_rows, k_dim), generator=gen, device="cuda")
               * (lay.row_gate != 0)[:, None]).to(td))
        args = (xs, w, b, be)
        kw = dict(transpose_rhs=trans)
        name = (f"esmm {dtype} trans={trans} bias={bias} K {k_dim} N {n_dim} "
                f"blk {blk}")
        plain = esmm.esmm_plain(*args, **kw)
        kern, route = _routed(torch, lambda: esmm.esmm(*args, **kw),
                              esmm.esmm)
        if route != want:
            raise AssertionError(f"{name}: took the {route} route, not {want}")
        err, tol = _check(name, kern, plain, GEMM_TOL[dtype])
        if i == 0:      # the head case: faults a tile mapping makes
            k0 = 1024
            xs_cut = xs.clone()
            xs_cut[:, k0:k0 + 64] = 0
            res["negative_controls"].append({
                "kernel": "esmm", "fault": f"K step [{k0}, {k0 + 64}) left out",
                "err_over_tol": _must_fail(
                    name + " without one K step",
                    esmm.esmm_plain(xs_cut, w, b, be, **kw), plain,
                    GEMM_TOL[dtype])})
            res["negative_controls"].append({
                "kernel": "esmm", "fault": "one block on its neighbour's expert",
                "err_over_tol": _must_fail(
                    name + " with a block's expert swapped",
                    esmm.esmm_plain(xs, w, b, _neighbour_swap(be), **kw),
                    plain, GEMM_TOL[dtype])})
            del xs_cut
        s_ = xs.element_size()
        nbytes = (np_rows * k_dim * s_ + experts * k_dim * n_dim * s_
                  + (experts * n_dim * s_ if bias else 0) + nblk * 4
                  + np_rows * n_dim * s_)
        flops = 2 * np_rows * k_dim * n_dim
        b_ms, b_by = bound(nbytes, flops, dtype, route)
        wl = w.transpose(1, 2) if trans else w
        offs = _group_offsets(torch, lay)
        lib_ms, lib_note = _library_ms(
            torch, flush, lambda: torch._grouped_mm(xs, wl, offs=offs), dtype)
        res["esmm"].append(_rates({
            "shape": {**shape_of(lay, blk), "K": k_dim, "Nout": n_dim,
                      "transpose_rhs": trans, "bias": bias},
            "dtype": dtype, "kernel_route": route, "max_abs_err": err,
            "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: esmm.esmm(*args, **kw), flush),
            "plain_ms": time_ms(torch, lambda: esmm.esmm_plain(*args, **kw),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by, **_fma_bound(
                route, nbytes, flops), "library_ms": lib_ms,
            "library": lib_note}, nbytes, flops))
        del w, b, xs, plain, kern

    for i, (dtype, empty, d1, d2, blk, want) in enumerate(ESTMM_TRAIN_CASES):
        td = getattr(torch, dtype)
        lay_x, lay = (x, layouts[blk]) if not empty else _sorted_layout(
            torch, n, empty_experts=empty, seed=6, blk=blk)[:2]
        lpc, lbe = lay.padded_counts, lay.block_expert
        live = (lay.row_gate != 0)[:, None]
        # D1 2048: the tokens' rows (dWg, dWu); D1 768: an h-like operand
        x1 = (gather_rows(lay_x.to(td), lay.row_token) if d1 == d else
              (torch.randn((live.shape[0], d1), generator=gen, device="cuda")
               * live).to(td))
        x2 = (torch.randn((x1.shape[0], d2), generator=gen, device="cuda")
              * live).to(td)
        args = (x1, x2, lbe, lpc)
        name = f"estmm {dtype} empty={empty} D1 {d1} D2 {d2} blk {blk}"
        plain = estmm.estmm_plain(*args)
        kern, route = _routed(torch, lambda: estmm.estmm(*args), estmm.estmm)
        if route != want:
            raise AssertionError(f"{name}: took the {route} route, not {want}")
        err, tol = _check(name, kern, plain, GEMM_TOL[dtype])
        n_empty = int((lpc == 0).sum())
        if empty and (n_empty < empty
                      or not torch.equal(kern[lpc == 0],
                                         torch.zeros_like(kern[lpc == 0]))):
            raise AssertionError(f"{name}: {n_empty} empty experts, dW not "
                                 f"exactly 0")
        if i == 0:      # the head case: faults a tile mapping makes
            r0 = int(torch.cumsum(lpc, 0)[0])    # expert 1's run starts here
            x1_cut = x1.clone()
            x1_cut[r0:r0 + 64] = 0
            res["negative_controls"].append({
                "kernel": "estmm",
                "fault": f"K step of rows [{r0}, {r0 + 64}) left out",
                "err_over_tol": _must_fail(
                    name + " without one K step",
                    estmm.estmm_plain(x1_cut, x2, lbe, lpc), plain,
                    GEMM_TOL[dtype])})
            res["negative_controls"].append({
                "kernel": "estmm",
                "fault": "one block on its neighbour's expert",
                "err_over_tol": _must_fail(
                    name + " with a block's expert swapped",
                    estmm.estmm_plain(x1, x2, _neighbour_swap(lbe), lpc),
                    plain, GEMM_TOL[dtype])})
            del x1_cut
        rows = _rows_read(lpc, x1.shape[0])
        s_ = x1.element_size()
        nbytes = rows * (d1 + d2) * s_ + e * 4 + e * d1 * d2 * 4
        flops = 2 * rows * d1 * d2
        b_ms, b_by = bound(nbytes, flops, dtype, route)
        loffs = _group_offsets(torch, lay)
        lib_ms, lib_note = _library_ms(      # writes bf16, not f32
            torch, flush, lambda: torch._grouped_mm(x1.t(), x2, offs=loffs),
            dtype)
        res["estmm"].append(_rates({
            "shape": {**shape_of(lay, blk), "D1": d1, "D2": d2,
                      "empty_experts": n_empty, "rows_read": rows},
            "dtype": dtype, "kernel_route": route, "max_abs_err": err,
            "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: estmm.estmm(*args), flush),
            "plain_ms": time_ms(torch, lambda: estmm.estmm_plain(*args),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by,
            **_fma_bound(route, nbytes, flops), "library_ms": lib_ms,
            "library": lib_note}, nbytes, flops))
        del x1, x2, plain, kern

    be, np_rows, nblk = ri.block_expert, ri.row_token.numel(), \
        ri.block_expert.numel()
    experts = int((ri.padded_counts > 0).sum())
    td = torch.bfloat16
    ws = [(torch.randn(sh, generator=gen, device="cuda") * 0.02).to(td)
          for sh in ((e, d, f), (e, d, f), (e, f, d))]
    xb = x.to(td)
    args = (xb, ri.row_token, ri.row_gate, be, *ws)
    name = "esffn_glu N 4096 blk 128"
    plain = esffn.esffn_glu_plain(*args)
    kern, kroute = _routed(torch, lambda: esffn.esffn_glu(*args),
                           esffn.esffn_glu)
    if kroute != "wgmma":
        raise AssertionError(f"{name}: took the {kroute} route, not wgmma")
    err, tol = _check(name, kern, plain, ESFFN_TOL["bfloat16"])
    # faults a tile mapping of the wgmma route makes, on the plain side
    k0 = 1024
    x_cut = xb.clone()
    x_cut[:, k0:k0 + 64] = 0
    res["negative_controls"].append({
        "kernel": "esffn_glu", "fault": f"D step [{k0}, {k0 + 64}) left out",
        "err_over_tol": _must_fail(
            name + " without one D step",
            esffn.esffn_glu_plain(x_cut, *args[1:]), plain,
            ESFFN_TOL["bfloat16"])})
    res["negative_controls"].append({
        "kernel": "esffn_glu", "fault": "one block on its neighbour's expert",
        "err_over_tol": _must_fail(
            name + " with a block's expert swapped",
            esffn.esffn_glu_plain(xb, ri.row_token, ri.row_gate,
                                  _neighbour_swap(be), *ws), plain,
            ESFFN_TOL["bfloat16"])})
    del x_cut
    live = int((ri.row_gate != 0).sum())
    nbytes = (n * d * 2 + experts * 3 * d * f * 2 + np_rows * 8 + nblk * 4
              + np_rows * d * 2)
    b_ms, b_by = bound(nbytes, 6 * live * d * f, "bfloat16")
    res["esffn_glu"].append({
        "shape": {**shape_of(ri, 128), "live_rows": live},
        "dtype": "bfloat16", "kernel_route": kroute, "max_abs_err": err,
        "tolerance": tol,
        "kernel_ms": time_ms(torch, lambda: esffn.esffn_glu(*args), flush),
        "plain_ms": time_ms(torch, lambda: esffn.esffn_glu_plain(*args),
                            flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no one PyTorch call computes it"})
    return res


def jamba_train_kernel_cases(torch, flush):
    """Phase 6j: ``esffn_glu``, ``esmm`` and ``estmm`` at the shapes phase
    8j gives them: Jamba's "train" cut width (D 4096, F 2048, 16 experts
    top-2), ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens routed by a random
    router, blk 128, bf16, every call on wgmma. The forward
    ``esffn_glu`` and each product of its backward (``kernels/ops.py``):
    the recomputed g and u, t, the two dX (``esmm``) and dW_down, dW_gate,
    dW_up (``estmm``), on operands zero on the padding rows as the
    backward gives them, each against its plain version within
    ESFFN_TOL/GEMM_TOL, timed beside its bound and ``torch._grouped_mm``.
    Negative control: ``esffn_glu``'s plain output with one block on its
    neighbour's expert."""
    from repro_torch.configs import jamba_1_5_large_398b as jamba
    from repro_torch.core.reindex import build_reindex, gather_rows
    from repro_torch.core.routing import route
    from repro_torch.kernels import esffn, esmm, estmm

    cfg = jamba.cut_config("train", "bfloat16")
    n, d, f = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, cfg.moe.d_ff
    e, k, blk = cfg.moe.num_experts, cfg.moe.top_k, 128
    td = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(41)
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    x = torch.randn((n, d), generator=gen, device="cuda").to(td)
    r = route(x, router, k)
    lay = build_reindex(r.expert_idx, r.gates, e, blk)
    be, pc = lay.block_expert, lay.padded_counts
    np_rows, nblk = lay.row_token.numel(), be.numel()
    experts = int((pc > 0).sum())
    live = (lay.row_gate != 0)[:, None]
    shape = {"N": n, "D": d, "E": e, "F": f, "top_k": k, "blk": blk,
             "Np": np_rows, "experts_with_rows": experts,
             "live_rows": int(live.sum())}
    wg, wu, wd = [(torch.randn(sh, generator=gen, device="cuda") * 0.02)
                  .to(td) for sh in ((e, d, f), (e, d, f), (e, f, d))]

    def rows(width):
        return (torch.randn((np_rows, width), generator=gen, device="cuda")
                * live).to(td)

    xs, dys, dg, du, h = gather_rows(x, lay.row_token), rows(d), rows(f), \
        rows(f), rows(f)
    offs = _group_offsets(torch, lay)
    res = {"esffn_glu": [], "esmm": [], "estmm": [], "negative_controls": []}

    def routed(name, fn, kernel):
        out, kroute = _routed(torch, fn, kernel)
        if kroute != "wgmma":
            raise AssertionError(f"{name}: took the {kroute} route, not wgmma")
        return out, kroute

    args = (x, lay.row_token, lay.row_gate, be, wg, wu, wd)
    name = f"esffn_glu jamba train N {n} blk {blk}"
    plain = esffn.esffn_glu_plain(*args)
    kern, kroute = routed(name, lambda: esffn.esffn_glu(*args),
                          esffn.esffn_glu)
    err, tol = _check(name, kern, plain, ESFFN_TOL["bfloat16"])
    res["negative_controls"].append({
        "kernel": "esffn_glu",
        "fault": "one block on its neighbour's expert (jamba train shape)",
        "err_over_tol": _must_fail(
            name + " with a block's expert swapped",
            esffn.esffn_glu_plain(x, lay.row_token, lay.row_gate,
                                  _neighbour_swap(be), wg, wu, wd), plain,
            ESFFN_TOL["bfloat16"])})
    nbytes = (n * d * 2 + experts * 3 * d * f * 2 + np_rows * 8 + nblk * 4
              + np_rows * d * 2)
    b_ms, b_by = bound(nbytes, 6 * shape["live_rows"] * d * f, "bfloat16")
    res["esffn_glu"].append({
        "case": "jamba train forward", "shape": shape, "dtype": "bfloat16",
        "kernel_route": kroute, "max_abs_err": err, "tolerance": tol,
        "kernel_ms": time_ms(torch, lambda: esffn.esffn_glu(*args), flush),
        "plain_ms": time_ms(torch, lambda: esffn.esffn_glu_plain(*args),
                            flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no one PyTorch call computes it"})
    del plain, kern

    for case, lhs, w, trans in (("g = xs Wg", xs, wg, False),
                                ("u = xs Wu", xs, wu, False),
                                ("t = dys Wd^T", dys, wd, True),
                                ("dX_g = dg Wg^T", dg, wg, True),
                                ("dX_u = du Wu^T", du, wu, True)):
        kw = dict(transpose_rhs=trans)
        k_dim, m_dim = lhs.shape[1], w.shape[1] if trans else w.shape[2]
        name = f"esmm jamba train {case}"
        plain = esmm.esmm_plain(lhs, w, None, be, **kw)
        kern, kroute = routed(name, lambda: esmm.esmm(lhs, w, None, be, **kw),
                              esmm.esmm)
        err, tol = _check(name, kern, plain, GEMM_TOL["bfloat16"])
        nbytes = (np_rows * k_dim * 2 + experts * k_dim * m_dim * 2
                  + nblk * 4 + np_rows * m_dim * 2)
        flops = 2 * np_rows * k_dim * m_dim
        b_ms, b_by = bound(nbytes, flops, "bfloat16", kroute)
        wl = w.transpose(1, 2) if trans else w
        lib_ms, lib_note = _library_ms(
            torch, flush, lambda: torch._grouped_mm(lhs, wl, offs=offs),
            "bfloat16")
        res["esmm"].append(_rates({
            "case": f"jamba train {case}",
            "shape": {**shape, "K": k_dim, "Nout": m_dim,
                      "transpose_rhs": trans, "bias": False},
            "dtype": "bfloat16", "kernel_route": kroute, "max_abs_err": err,
            "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: esmm.esmm(
                lhs, w, None, be, **kw), flush),
            "plain_ms": time_ms(torch, lambda: esmm.esmm_plain(
                lhs, w, None, be, **kw), flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": lib_note}, nbytes, flops))
        del plain, kern

    rows_read = _rows_read(pc, np_rows)
    for case, x1, x2 in (("dW_down = h^T dys", h, dys),
                         ("dW_gate = xs^T dg", xs, dg),
                         ("dW_up = xs^T du", xs, du)):
        d1, d2 = x1.shape[1], x2.shape[1]
        name = f"estmm jamba train {case}"
        plain = estmm.estmm_plain(x1, x2, be, pc)
        kern, kroute = routed(name, lambda: estmm.estmm(x1, x2, be, pc),
                              estmm.estmm)
        err, tol = _check(name, kern, plain, GEMM_TOL["bfloat16"])
        nbytes = rows_read * (d1 + d2) * 2 + e * 4 + e * d1 * d2 * 4
        flops = 2 * rows_read * d1 * d2
        b_ms, b_by = bound(nbytes, flops, "bfloat16", kroute)
        lib_ms, lib_note = _library_ms(      # writes bf16, not f32
            torch, flush, lambda: torch._grouped_mm(x1.t(), x2, offs=offs),
            "bfloat16")
        res["estmm"].append(_rates({
            "case": f"jamba train {case}",
            "shape": {**shape, "D1": d1, "D2": d2, "rows_read": rows_read},
            "dtype": "bfloat16", "kernel_route": kroute, "max_abs_err": err,
            "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: estmm.estmm(x1, x2, be, pc),
                                 flush),
            "plain_ms": time_ms(torch, lambda: estmm.estmm_plain(
                x1, x2, be, pc), flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": lib_note}, nbytes, flops))
        del plain, kern
    return res


def train_reference_phase(torch):
    """Phase 7: one loss_fn forward + backward of a 2-layer full-width f32
    model on the GPU (kernels) and the CPU (plain versions)
    (``_card_vs_cpu_loss``, the CPU side on the CPU lane as job "7"); the
    GPU run's expert kernels exactly ``_f32_expert_routes``: every f32
    esmm and estmm on mma_tf32x3."""
    from repro_torch import configs as cfglib
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    batch = TokenSource(DataConfig(seq_len=64, global_batch=2,
                                   vocab_size=cfg.vocab_size,
                                   seed=7)).batch(0)
    r = _card_vs_cpu_loss(torch, "7", cfg, ParallelConfig(blk=16), params,
                          batch)
    want = _f32_expert_routes(cfg.num_layers)
    if r["launches_by_route"] != want:
        raise AssertionError(f"train reference: routes "
                             f"{r['launches_by_route']}, expected {want}")
    print(f"[train-reference] 2-layer full-width f32, 2 x 64 tokens: loss "
          f"GPU {r['loss_gpu']!r}, total GPU {r['total_gpu']!r} (the CPU's "
          f"on the lane, job 7); routes {r['launches_by_route']}")
    return r


def train_qat_reference_phase(torch):
    """Phase 7q: phase 7's model (2 layers at full width, f32, 2 x 64
    tokens, blk 16, seed 7) with ``quant="int8"``. Every expert weight's
    int8 payload and scales on the card equal the CPU's; one QAT
    ``loss_fn`` forward and backward on the card and on the CPU (plain
    versions) agree within ``TRAIN_LOSS_RTOL`` and ``TRAIN_GRAD_TOL``
    (the CPU sides on the CPU lane, ``_qat_reference_cpu``);
    and on one layer the QAT loss and grads equal those of the plain loss
    with each expert weight replaced by ``dequant(quant(w))`` computed
    outside (the straight-through estimator: the master weight's grad is
    the dequantized weight's)."""
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.quant import core as qcore

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    pcfg = ParallelConfig(blk=16, remat="none", quant="int8")
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    payloads = [[qcore.quantize_blockwise(layer["ffn"][name], mode="int8")
                 for name in qcore.EXPERT_WEIGHT_KEYS if name in layer["ffn"]]
                for layer in params["layers"]]
    payloads = [[(q.cpu(), sc.cpu()) for q, sc in layer]
                for layer in payloads]
    batch = TokenSource(DataConfig(seq_len=64, global_batch=2,
                                   vocab_size=cfg.vocab_size,
                                   seed=7)).batch(0)
    loss_fn = steps.make_loss_fn(cfg, pcfg)
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    total, _ = loss_fn(p, batch_to(batch, "cuda"))
    grads = torch.autograd.grad(total, tree_leaves(p), allow_unused=True)
    tg, gg = (float(total.detach()),
              [None if g is None else g.cpu() for g in grads])
    del p, grads
    cpu = tree_map(lambda t: t.cpu(), params)
    _LANE.submit("7q", 2 * _host_bytes(cpu), _qat_reference_cpu, cfg, pcfg,
                 cpu, payloads, batch, tg, gg)
    del cpu, payloads, gg
    # the straight-through estimator, on one layer
    one = dataclasses.replace(cfg, num_layers=1)
    params1 = {**params, "layers": params["layers"][:1]}
    qat = tree_map(lambda t: t.detach().requires_grad_(), params1)
    dq = tree_map(lambda t: t.detach(), params1)
    ffn = dict(dq["layers"][0]["ffn"])
    for name in qcore.EXPERT_WEIGHT_KEYS:
        if name in ffn:
            ffn[name] = qcore.dequantize_blockwise(
                *qcore.quantize_blockwise(ffn[name], mode="int8"),
                dtype=ffn[name].dtype)
    dq["layers"] = [{**dq["layers"][0], "ffn": ffn}]
    dq = tree_map(lambda t: t.requires_grad_(), dq)
    cuda_batch = batch_to(batch, "cuda")
    res = []
    for p, c in ((qat, pcfg), (dq, dataclasses.replace(pcfg, quant="none"))):
        total, _ = steps.make_loss_fn(one, c)(p, cuda_batch)
        res.append((float(total.detach()), torch.autograd.grad(
            total, tree_leaves(p), allow_unused=True)))
    (lq, gq), (ld, gd) = res
    if not abs(lq - ld) <= TRAIN_LOSS_RTOL * abs(ld):
        raise AssertionError(f"QAT STE: loss {lq} vs {ld} on dequant(quant)")
    ste_worst = 0.0
    for i, (a, b) in enumerate(zip(gq, gd)):
        if a is None or b is None:
            continue
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"QAT STE: grad leaf {i} {tuple(b.shape)} "
                                 f"err {err} > {TRAIN_GRAD_TOL} x {scale}")
        ste_worst = max(ste_worst, err / scale if scale else 0.0)
    seconds = time.perf_counter() - t_phase
    print(f"[qat-reference] 2-layer full-width f32, int8: loss GPU {tg!r} "
          f"(the CPU's payloads, scales, loss and grads on the lane); one "
          f"layer, QAT == plain on dequant(quant(w)): loss {lq!r} vs "
          f"{ld!r}, worst grad {ste_worst:.3e}; {seconds:.1f}s")
    return {"loss_gpu": tg, "ste_loss": [lq, ld],
            "ste_worst_grad_rel": ste_worst, "seconds": seconds}


def _qat_reference_cpu(cfg, pcfg, cpu, payloads, batch, tg, gg):
    """Phase 7q's CPU side (the plain versions): every expert weight's
    int8 payload and scales equal the card's, and the QAT loss and grads
    are within phase 7's limits of the card's."""
    import torch
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to
    from repro_torch.quant import core as qcore

    levels, blocks = 0, 0
    for layer, card in zip(cpu["layers"], payloads):
        names = [n for n in qcore.EXPERT_WEIGHT_KEYS if n in layer["ffn"]]
        for name, (qg, sg) in zip(names, card):
            qc, sc = qcore.quantize_blockwise(layer["ffn"][name],
                                              mode="int8")
            levels += int((qg != qc).sum())
            blocks += int((sg != sc).sum())
    if levels or blocks:
        raise AssertionError(f"QAT reference: {levels} int8 levels and "
                             f"{blocks} scales differ between card and CPU")
    p = tree_map(lambda t: t.detach().requires_grad_(), cpu)
    total, _ = steps.make_loss_fn(cfg, pcfg)(p, batch_to(batch, "cpu"))
    gc = torch.autograd.grad(total, tree_leaves(p), allow_unused=True)
    tc = float(total.detach())
    if not abs(tg - tc) <= TRAIN_LOSS_RTOL * abs(tc):
        raise AssertionError(f"QAT reference: GPU loss {tg} vs CPU {tc}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gg, gc)):
        if (a is None) != (b is None):
            raise AssertionError(f"QAT reference: grad leaf {i} missing")
        if a is None:
            continue
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"QAT reference: grad leaf {i} "
                                 f"{tuple(b.shape)} err {err} > "
                                 f"{TRAIN_GRAD_TOL} x {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    print(f"[qat-reference] CPU (plain versions): payloads and scales card "
          f"== CPU; loss GPU {tg!r} CPU {tc!r} (rel diff "
          f"{abs(tg - tc) / abs(tc):.3e}), worst grad max |diff| / max "
          f"|grad| {worst:.3e}")


def train_phase(torch):
    """Phase 8: 4 full-width layers, bf16, AdamW, remat="block"."""
    import math
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.kernels import esffn, esmm, estmm
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to, build_state
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = cfglib.get_config("qwen3-moe-30b-a3b")
    print(f"[train] depth cut: {cfg.num_layers} -> {TRAIN_DEPTH} layers")
    cfg = dataclasses.replace(cfg, num_layers=TRAIN_DEPTH)
    pcfg = ParallelConfig(blk=min(128, max(16, TRAIN_SEQ // 4)),
                          remat="block")
    opt_cfg = adamw.OptimizerConfig(peak_lr=3e-4, warmup_steps=20,
                                    decay_steps=40, master_fp32=True)
    t0 = time.perf_counter()
    params, opt_state = build_state(cfg, opt_cfg, 0, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    state_gb = sum(t.numel() * t.element_size() for t in
                   tree_leaves(params) + tree_leaves(opt_state)
                   if t is not None) / 1e9
    print(f"[train] {cfg.name}: {TRAIN_DEPTH} layers at full width, "
          f"{n_params / 1e9:.3f} B parameters, {state_gb:.2f} GB of bf16 "
          f"weights + f32 masters and moments, built in "
          f"{time.perf_counter() - t0:.1f}s; blk {pcfg.blk}, remat "
          f"{pcfg.remat}")
    source = TokenSource(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    vocab_size=cfg.vocab_size, seed=0))
    train_step = steps.make_train_step(cfg, pcfg, opt_cfg)

    def run(step, fn=train_step):
        batch = batch_to(source.batch(step), "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = fn(params, opt_state, batch)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    m, dt = run(0)                        # warm-up, unmeasured
    print(f"[train] warm-up step: loss {m['loss']:.4f} ({dt:.2f}s)")
    torch.cuda.reset_peak_memory_stats()
    for fn in (esffn.esffn_glu, esmm.esmm, estmm.estmm):
        fn.launches = 0
    for fn in (esffn.esffn_glu, esmm.esmm, estmm.estmm):
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
    times, log = [], []
    for step in range(1, TRAIN_STEPS + 1):
        m, dt = run(step)
        times.append(dt)
        log.append(m)
        print(f"[train] step {step}: loss {m['loss']:.6f} aux "
              f"{m['aux_loss']:.6f} z {m['z_loss']:.4f} grad norm "
              f"{m['grad_norm']:.6f} lr {m['lr']:.2e} ({dt:.3f}s)")
    launches = {"esffn_glu": esffn.esffn_glu.launches,
                "esmm": esmm.esmm.launches, "estmm": estmm.estmm.launches}
    routes = {"esffn_glu": dict(esffn.esffn_glu.launches_by_route),
              "esmm": dict(esmm.esmm.launches_by_route),
              "estmm": dict(estmm.estmm.launches_by_route)}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in log):
        raise AssertionError(f"train: non-finite loss or grad norm {log}")
    want = {"esffn_glu": 2, "esmm": 5, "estmm": 3}
    want = {k: v * TRAIN_DEPTH * TRAIN_STEPS for k, v in want.items()}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want}")
    # every expert GEMM and FFN of the bf16 LM step on wgmma
    idle = {"esffn_glu": ("stream",), "esmm": ("simt", "mma_tf32x3"),
            "estmm": ("simt", "mma_tf32x3")}
    want_routes = {k: {**dict.fromkeys(idle[k], 0), "wgmma": want[k]}
                   for k in routes}
    if routes != want_routes:
        raise AssertionError(f"train: routes {routes}, expected "
                             f"{want_routes}")
    med = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens: step median {med * 1e3:.1f}ms, {tokens / med:.1f} "
          f"tokens/s; peak allocated {peak / 1e9:.2f} GB; launches "
          f"{launches}; routes {routes}")
    qat = qat_train_phase(torch, cfg, pcfg, opt_cfg, run, TRAIN_STEPS + 1,
                          med)
    return launches, {"steps": log, "step_times_s": times,
                      "launches_by_route": routes,
                      "step_median_ms": med * 1e3,
                      "tokens_per_s": tokens / med,
                      "peak_allocated_gb": peak / 1e9,
                      "layers": TRAIN_DEPTH, "params": n_params,
                      "state_gb": state_gb, "qat": qat}


def qat_train_phase(torch, cfg, pcfg, opt_cfg, run, first_step, plain_med):
    """Phase 8q: quantization-aware training on phase 8's state, each of
    ``QAT_MODES`` in turn: the expert weights through block-wise
    ``fake_quant`` inside each MoE layer (twice a step: ``remat="block"``
    runs the forward again in the backward), the round-tripped weights
    through the same kernels as phase 8. One warm-up step, then
    ``QAT_STEPS`` timed steps with the launch counts set to 0 just before
    and read just after: every loss finite, phase 8's 2 ``esffn_glu``, 5
    ``esmm`` and 3 ``estmm`` a layer a step, all on wgmma."""
    import math
    from repro_torch.kernels import esffn, esmm, estmm
    from repro_torch.launch import steps

    fns = (esffn.esffn_glu, esmm.esmm, estmm.estmm)
    want = {k: v * TRAIN_DEPTH * QAT_STEPS
            for k, v in {"esffn_glu": 2, "esmm": 5, "estmm": 3}.items()}
    idle = {"esffn_glu": ("stream",), "esmm": ("simt", "mma_tf32x3"),
            "estmm": ("simt", "mma_tf32x3")}
    step_no, out = first_step, {}
    for mode in QAT_MODES:
        qstep = steps.make_train_step(
            cfg, dataclasses.replace(pcfg, quant=mode), opt_cfg)
        m, dt = run(step_no, qstep)             # warm-up, unmeasured
        step_no += 1
        torch.cuda.reset_peak_memory_stats()
        for fn in fns:
            fn.launches = 0
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
        times, log = [], []
        for _ in range(QAT_STEPS):
            m, dt = run(step_no, qstep)
            step_no += 1
            times.append(dt)
            log.append(m)
        launches = {fn.__name__: fn.launches for fn in fns}
        routes = {fn.__name__: dict(fn.launches_by_route) for fn in fns}
        if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                   for m in log):
            raise AssertionError(f"QAT {mode}: non-finite loss {log}")
        want_routes = {k: {**dict.fromkeys(idle[k], 0), "wgmma": want[k]}
                       for k in routes}
        if launches != want or routes != want_routes:
            raise AssertionError(f"QAT {mode}: launches {launches}, routes "
                                 f"{routes}, expected {want_routes}")
        med = statistics.median(times)
        out[mode] = {"steps": log, "step_times_s": times,
                     "step_median_ms": med * 1e3,
                     "over_plain_ms": (med - plain_med) * 1e3,
                     "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
                     "peak_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                     "launches": launches, "launches_by_route": routes}
        print(f"[train-qat] {mode}: {QAT_STEPS} steps, losses "
              f"{[round(m['loss'], 6) for m in log]}, step median "
              f"{med * 1e3:.1f}ms against phase 8's {plain_med * 1e3:.1f}ms "
              f"(+{(med - plain_med) * 1e3:.1f}); peak allocated "
              f"{out[mode]['peak_allocated_gb']:.2f} GB; launches "
              f"{launches}, every one on wgmma")
    return out


# ---------------------------------------------------------------------------
# phases 7h, 7f, 8j, 8x, 8p, 8m: training every LM family
# ---------------------------------------------------------------------------

def _ft_state_bytes(torch, cfg):
    """Bytes of the train state of ``cfg`` as the train CLI holds it: the
    parameters, an f32 master for each non-f32 floating leaf, f32 m and
    v, the step count (a checkpoint's leaves)."""
    from repro_torch.common import tree_leaves
    from repro_torch.models import lm

    meta = lm.init_params(cfg, generator=torch.Generator(), device="meta")
    total = 4
    for t in tree_leaves(meta):
        n = t.numel()
        total += n * (t.element_size() + 8)
        if t.is_floating_point() and t.dtype != torch.float32:
            total += 4 * n
    return total


def _ft_spans(events, name):
    return [e for e in events if e["ph"] == "X" and e["name"] == name]


def _ft_run(torch, train, obs, argv, keep, d, tag):
    """One train CLI run of phase F in this process; its log, wall time,
    spans, event kinds, recoveries, span coverage and the step-4
    checkpoint's crc32 list."""
    paths = {k: os.path.join(d, f"{tag}.{k}")
             for k in ("prom", "trace.json", "events.jsonl")}
    t0 = time.perf_counter()
    log = train.main(argv + ["--ckpt-dir", os.path.join(d, tag),
                             "--metrics", paths["prom"],
                             "--trace-out", paths["trace.json"],
                             "--events-out", paths["events.jsonl"]],
                     keep=keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = list(obs.tracer.events)
    fam = obs.registry.families.get("repro_ft_recoveries_total")
    with open(os.path.join(d, tag, f"step_{FT_STEPS:08d}",
                           "manifest.json")) as f:
        crcs = json.load(f)["crc32"]
    return {"log": log, "wall_s": wall, "events": events,
            "kinds": [r["kind"] for r in obs.events.records],
            "recoveries": 0 if fam is None else int(fam.labels().value),
            "coverage": obs.span_coverage(events), "crc32": crcs}


def ft_train_phase(torch, deterministic=True):
    """Phase F: the fault-tolerant train loop, through the train CLI
    (``repro_torch.launch.train.main``) in this process:
    qwen3-moe-30b-a3b at full width cut to ``FT_DEPTH`` layer, phase 8's
    bf16, AdamW and ``remat="block"``, ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens. Run (a): ``FT_STEPS`` steps, ``--save-every 4`` (one
    checkpoint). Run (b): ``--save-every 2``, ``FTConfig.keep`` 1 and a
    ``train.step`` error at call ``FT_FAULT_AT``: it restores step 2 and
    replays. Both take ``--metrics``, ``--trace-out`` and ``--events-out``.
    (b)'s per-step losses must equal (a)'s and the two step-4 checkpoints'
    crc32 lists must be equal, leaf by leaf (the final states, bit for
    bit). The free bytes of the checkpoint directory (a temporary one
    under the git-ignored ``build/``, removed at the end) must hold two
    checkpoints; (a)'s is removed before (b) starts. The expert kernels'
    counts are set to 0 just before (a) and read just after (b): 2/5/3
    ``esffn_glu``/``esmm``/``estmm`` a layer a step that ran, on wgmma.
    Both runs train under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` (``deterministic``): without it the bf16
    ``index_add_`` of the MoE combine and of its dX adds a token's rows
    in the atomics' order, and two unfaulted runs already differ at step
    1's loss. Returns (launches, routes, result)."""
    import shutil
    import tempfile

    from repro_torch import configs as cfglib
    from repro_torch import obs
    from repro_torch.kernels import esffn, esmm, estmm
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=FT_DEPTH)
    state_bytes = _ft_state_bytes(torch, cfg)
    need = 2 * state_bytes
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="ft_ckpt_", dir=ROOT / "build")
    fns = (esffn.esffn_glu, esmm.esmm, estmm.estmm)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        free = shutil.disk_usage(d).free
        print(f"[train-ft] checkpoint directory {d}: {free / 1e9:.1f} GB "
              f"free, {need / 1e9:.1f} GB needed (two checkpoints of "
              f"{state_bytes / 1e9:.2f} GB while the newer is written)")
        if free < need:
            raise RuntimeError(
                f"phase F: {free / 1e9:.1f} GB free under {d}, "
                f"{need / 1e9:.1f} GB needed for two checkpoints")
        base = ["--arch", "qwen3-moe-30b-a3b", "--layers", str(FT_DEPTH),
                "--steps", str(FT_STEPS), "--global-batch", str(TRAIN_BATCH),
                "--seq-len", str(TRAIN_SEQ), "--lr", "3e-4", "--warmup",
                "20", "--device", "cuda"]
        fault = json.dumps({"faults": [{"site": "train.step",
                                        "kind": "error",
                                        "at": FT_FAULT_AT}]})
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        for fn in fns:
            fn.launches = 0
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
        a = _ft_run(torch, train, obs, base + ["--save-every", "4"], None,
                    d, "a")
        shutil.rmtree(os.path.join(d, "a"))      # room for (b)'s two
        _release(torch)
        b = _ft_run(torch, train, obs, base + ["--save-every", "2",
                                               "--fault-spec", fault], 1,
                    d, "b")
        launches = {"esffn_glu": esffn.esffn_glu.launches,
                    "esmm": esmm.esmm.launches, "estmm": estmm.estmm.launches}
        routes = {"esffn_glu": dict(esffn.esffn_glu.launches_by_route),
                  "esmm": dict(esmm.esmm.launches_by_route),
                  "estmm": dict(estmm.estmm.launches_by_route)}
        left = sorted(os.listdir(os.path.join(d, "b")))
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        shutil.rmtree(d, ignore_errors=True)
        obs.configure(metrics=False, tracing=False, event_log=False,
                      reset=True)
    by_a = {m["step"]: m["loss"] for m in a["log"]}
    by_b = {m["step"]: m["loss"] for m in b["log"]}
    steps_b = [m["step"] for m in b["log"]]
    if steps_b != [1, 2, 3, 3, 4] or left != [f"step_{FT_STEPS:08d}"]:
        raise AssertionError(f"train_ft: run (b) logged steps {steps_b}, "
                             f"left {left}")
    if b["recoveries"] != 1 or b["kinds"] != ["train.recover"] \
            or a["kinds"] or a["recoveries"]:
        raise AssertionError(f"train_ft: recoveries {a['recoveries']}/"
                             f"{b['recoveries']}, events {a['kinds']}/"
                             f"{b['kinds']}")
    differ = [i for i, (x, y) in enumerate(zip(a["crc32"], b["crc32"]))
              if x != y]
    if by_a != by_b or differ or len(a["crc32"]) != len(b["crc32"]):
        names = _ft_leaf_names(torch, cfg)
        raise AssertionError(
            f"train_ft: run (b) is not run (a) bit for bit: losses "
            f"{by_a} vs {by_b}; {len(differ)} leaves differ: "
            f"{[names[i] for i in differ[:12]]}")
    snap = [e["dur"] for e in _ft_spans(b["events"], "ckpt.snapshot")]
    writes = [(e["t"], e["t"] + e["dur"])
              for e in _ft_spans(b["events"], "ckpt.write")]
    restore = [e["dur"] for e in _ft_spans(b["events"], "ckpt.restore")]
    # step spans: each run's first (warm-up) and (b)'s faulted call left out
    steps_busy, steps_quiet = [], []
    for r in (a, b):
        spans = _ft_spans(r["events"], "train.step")
        if r is b:
            del spans[FT_FAULT_AT]
        for e in spans[1:]:
            lo, hi = e["t"], e["t"] + e["dur"]
            (steps_busy if any(lo < w1 and w0 < hi for w0, w1 in writes)
             else steps_quiet).append(e["dur"])
    res = {
        "layers": FT_DEPTH, "state_bytes": state_bytes,
        "deterministic_algorithms": deterministic,
        "losses": [by_a[k] for k in sorted(by_a)],
        "final_state_crc32_equal": True, "leaves": len(a["crc32"]),
        "snapshot_ms": [x * 1e3 for x in snap],
        "snapshot_gb_per_s": [state_bytes / x / 1e9 for x in snap],
        "write_s": [w1 - w0 for w0, w1 in writes],
        "write_a_s": [e["dur"] for e in _ft_spans(a["events"], "ckpt.write")],
        "restore_s": restore,
        "step_median_ms_quiet": statistics.median(steps_quiet) * 1e3,
        "step_median_ms_write_in_flight": (
            statistics.median(steps_busy) * 1e3 if steps_busy else None),
        "steps_quiet": len(steps_quiet), "steps_write_in_flight":
            len(steps_busy),
        "recoveries": b["recoveries"], "span_coverage": {
            "a": a["coverage"], "b": b["coverage"]},
        "event_kinds": {"a": a["kinds"], "b": b["kinds"]},
        "wall_s": {"a": a["wall_s"], "b": b["wall_s"]},
        "launches": launches, "launches_by_route": routes,
        "seconds": time.perf_counter() - t_phase}
    print(f"[train-ft] state {state_bytes / 1e9:.3f} GB; D2H snapshot "
          f"{', '.join(f'{x:.0f}' for x in res['snapshot_ms'])} ms "
          f"(training blocked); background write "
          f"{', '.join(f'{x:.1f}' for x in res['write_s'])} s; restore "
          f"{', '.join(f'{x:.1f}' for x in restore)} s; step median "
          f"{res['step_median_ms_quiet']:.1f} ms without a write in flight "
          f"({len(steps_quiet)} steps), "
          f"{res['step_median_ms_write_in_flight'] or float('nan'):.1f} ms "
          f"with one ({len(steps_busy)}); recoveries {b['recoveries']}; "
          f"span coverage {a['coverage']:.3f}/{b['coverage']:.3f}; events "
          f"{res['event_kinds']}; losses and final state of (b) equal "
          f"(a)'s bit for bit; launches {launches}; "
          f"{res['seconds']:.1f}s")
    # (a)'s steps, then (b)'s up to the faulted call and its replay from
    # the step-2 checkpoint
    ran = FT_STEPS + FT_FAULT_AT + FT_STEPS - 2
    want = {k: v * FT_DEPTH * ran for k, v in
            {"esffn_glu": 2, "esmm": 5, "estmm": 3}.items()}
    if launches != want:
        raise AssertionError(f"train_ft: launches {launches}, expected "
                             f"{want} ({ran} steps)")
    idle = {"esffn_glu": ("stream",), "esmm": ("simt", "mma_tf32x3"),
            "estmm": ("simt", "mma_tf32x3")}
    want_routes = {k: {**dict.fromkeys(idle[k], 0), "wgmma": want[k]}
                   for k in routes}
    if routes != want_routes:
        raise AssertionError(f"train_ft: routes {routes}, expected "
                             f"{want_routes}")
    return launches, routes, res


def _ft_leaf_names(torch, cfg):
    """The dotted names of the train state's checkpoint leaves, in their
    order (None masters left out)."""
    from repro_torch.common import tree_map
    from repro_torch.models import lm

    p = lm.init_params(cfg, generator=torch.Generator(), device="meta")
    master = tree_map(lambda t: t if t.is_floating_point()
                      and t.dtype != torch.float32 else None, p)
    state = {"params": p, "opt": {"m": p, "v": p, "master": master,
                                  "step": 0}}
    return [n for n, t in _named_leaves(state) if t is not None]


def _family_batch(cfg, batch, seq, seed):
    """The train CLI's batch of ``cfg`` (``train.frontend_batch``, numpy):
    ``batch`` rows of ``seq`` tokens from the synthetic stream."""
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch.train import frontend_batch

    src = TokenSource(DataConfig(seq_len=seq, global_batch=batch,
                                 vocab_size=cfg.vocab_size, seed=seed))
    return frontend_batch(cfg, src.batch(seed), seed)


def _expert_fns():
    from repro_torch.kernels import esffn, esmm, estmm

    return (esffn.esffn_glu, esmm.esmm, estmm.estmm)


def _reset_expert_counts():
    for fn in _expert_fns():
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def _expert_counts():
    return ({fn.__name__: fn.launches for fn in _expert_fns()},
            {fn.__name__: dict(fn.launches_by_route) for fn in _expert_fns()})


def _card_vs_cpu_loss(torch, tag, cfg, pcfg, params, batch,
                      grad_tol=TRAIN_GRAD_TOL, label=None, lane=True):
    """One ``loss_fn`` forward and backward from ``params`` (on the card)
    and from their copy on the CPU (the plain versions) on ``batch``: the
    totals within TRAIN_LOSS_RTOL and every grad leaf within ``grad_tol``
    x its max |grad| (every leaf is measured before any is judged). The
    CPU side (``_cpu_loss_check``) runs on the CPU lane as job ``label``
    (default ``tag``), or here with ``lane=False``. Returns the card run's
    numbers and its expert kernels' launches and routes, counted from
    0 (with ``lane=False`` the CPU side's numbers too)."""
    from repro_torch.common import tree_map

    t0 = time.perf_counter()
    _reset_expert_counts()
    lg, tg, gg = _loss_grads(cfg, pcfg, params, batch, "cuda")
    torch.cuda.synchronize()
    launches, routes = _expert_counts()
    card = {"grad_tol": grad_tol, "loss_gpu": lg, "total_gpu": tg,
            "launches": launches, "launches_by_route": routes,
            "wall_s": {"cuda": time.perf_counter() - t0}}
    names = [n for n, _ in _named_leaves(params)]
    cpu_params = tree_map(lambda t: t.detach().cpu(), params)
    job = (tag, label or tag, cfg, pcfg, cpu_params, batch, names, tg, gg,
           grad_tol)
    if not lane:
        return {**card, **_cpu_loss_check(*job)}
    _LANE.submit(label or tag, 2 * _host_bytes(cpu_params), _cpu_loss_check,
                 *job, full=cfg.name in LANE_FULL)
    return card


def _loss_grads(cfg, pcfg, params, batch, device):
    """``loss_fn``'s loss and total and the grads of every leaf (host, or
    None where unused) from a copy of ``params`` on ``device``."""
    import torch
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to

    p = tree_map(lambda t: t.detach().to(device).requires_grad_(), params)
    total, metrics = steps.make_loss_fn(cfg, pcfg)(p, batch_to(batch, device))
    grads = torch.autograd.grad(total, tree_leaves(p), allow_unused=True)
    return (float(metrics["loss"].detach()), float(total.detach()),
            [None if g is None else g.cpu() for g in grads])


def _cpu_loss_check(tag, label, cfg, pcfg, cpu_params, batch, names, tg, gg,
                    grad_tol):
    """``_card_vs_cpu_loss``'s CPU side: the CPU's loss and grads against
    the card's total ``tg`` and grads ``gg``. Prints and returns the CPU's
    numbers."""
    t0 = time.perf_counter()
    lc, tc, gc = _loss_grads(cfg, pcfg, cpu_params, batch, "cpu")
    rel = abs(tg - tc) / abs(tc)
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"phase {tag}: GPU total {tg} vs CPU {tc} "
                             f"(rel {rel})")
    worst, worst_leaf, by_kind, bad = 0.0, None, {}, []
    for name, a, b in zip(names, gg, gc):
        if (a is None) != (b is None):
            raise AssertionError(f"phase {tag}: grad {name} missing")
        if a is None:
            continue
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not err <= grad_tol * scale:
            bad.append(f"{name} {tuple(b.shape)} err {err} > {grad_tol} x "
                       f"{scale}")
        r = err / scale if scale else 0.0
        kind = (".".join(name.split(".")[2:]) if name.startswith("layers.")
                else name)
        by_kind[kind] = max(by_kind.get(kind, 0.0), r)
        if r > worst:
            worst, worst_leaf = r, name
    if bad:
        raise AssertionError(f"phase {tag} {cfg.name}: {len(bad)} grad "
                             f"leaves past the limit, worst {worst} at "
                             f"{worst_leaf}: {bad[:4]}; by part "
                             f"{json.dumps(by_kind)}")
    out = {"loss_cpu": lc, "total_cpu": tc, "total_rel_diff": rel,
           "grad_leaves": len(gc), "worst_grad_rel": worst,
           "worst_leaf": worst_leaf, "worst_grad_rel_by_part": by_kind,
           "cpu_s": time.perf_counter() - t0}
    print(f"[{label}] {cfg.name}, {cfg.num_layers} layers, CPU (plain "
          f"versions): total GPU {tg!r} CPU {tc!r} (rel {rel:.3e}); "
          f"{len(gc)} grad leaves, worst max |diff| / max |grad| "
          f"{worst:.3e} at {worst_leaf} (limit {grad_tol:.3g}); by part "
          f"{json.dumps(by_kind)}")
    return out


def _moe_layers(cfg):
    return sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))


def _f32_expert_routes(n_moe):
    """The expert kernels' launches by route in one f32 ``loss_fn``
    forward and backward (``remat="block"``) over ``n_moe`` MoE layers: 2
    ``esffn_glu`` a layer (the forward and remat's recompute) on
    ``stream``, 5 ``esmm`` and 3 ``estmm`` on ``mma_tf32x3``."""
    return {"esffn_glu": {"stream": 2 * n_moe, "wgmma": 0},
            "esmm": {"simt": 0, "wgmma": 0, "mma_tf32x3": 5 * n_moe},
            "estmm": {"simt": 0, "wgmma": 0, "mma_tf32x3": 3 * n_moe}}


def hybrid_train_reference_phase(torch):
    """Phase 7h: one ``loss_fn`` forward and backward in f32, card vs CPU
    (``_card_vs_cpu_loss``, phase 7's limits), of Jamba's layout at its
    "reference" cut width (about 0.9 B parameters) and of xlstm-350m
    whole, 2 x 64 tokens, blk 16. Jamba's expert kernels on the card,
    counted from 0: per MoE layer 2 ``esffn_glu`` (the forward and remat's
    recompute; f32: ``stream``), 5 ``esmm`` and 3 ``estmm``, all on
    ``mma_tf32x3``; xlstm-350m launches none. xlstm-350m runs at each of
    ``HYBRID_TRAIN_SEEDS`` under ``HYBRID_TRAIN_GRAD_TOL``, then at the
    first with ``xlstm.SLSTM_H_DTYPE`` f32 on both sides (no bf16
    rounding of h) under ``TRAIN_GRAD_TOL``. The CPU sides run on the CPU
    lane but that one's, which swaps the global: it runs first, here,
    once the lane is empty."""
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves
    from repro_torch.configs import jamba_1_5_large_398b as jamba
    from repro_torch.models import lm, xlstm
    from repro_torch.parallel.sharding import ParallelConfig

    xl = dataclasses.replace(cfglib.get_config("xlstm-350m"), dtype="float32")
    # the run that swaps the global first, while the lane is likely idle
    runs = [("xlstm-350m", xl, HYBRID_TRAIN_SEEDS[0], False)]
    runs += [("jamba-1.5-large-398b", jamba.cut_config("reference",
                                                      "float32"), 7, True)]
    runs += [("xlstm-350m", xl, seed, True) for seed in HYBRID_TRAIN_SEEDS]
    res = {}
    for arch, cfg, seed, h_bf16 in runs:
        key = (f"{arch} h f32" if not h_bf16 else arch
               if seed == HYBRID_TRAIN_SEEDS[0] or arch != "xlstm-350m"
               else f"{arch} seed {seed}")
        t0 = time.perf_counter()
        pcfg = ParallelConfig(blk=16)
        params = lm.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda")
        n_params = sum(t.numel() for t in tree_leaves(params))
        tol = (HYBRID_TRAIN_GRAD_TOL.get(arch, TRAIN_GRAD_TOL) if h_bf16
               else TRAIN_GRAD_TOL)
        if not h_bf16:
            _LANE.drain()       # no lane job may see the swapped global
        xlstm.SLSTM_H_DTYPE = torch.bfloat16 if h_bf16 else torch.float32
        try:
            r = _card_vs_cpu_loss(torch, "7h", cfg, pcfg, params,
                                  _family_batch(cfg, 2, 64, seed),
                                  grad_tol=tol, label=f"7h {key}",
                                  lane=h_bf16)
        finally:
            xlstm.SLSTM_H_DTYPE = torch.bfloat16
        n = _moe_layers(cfg)
        want = _f32_expert_routes(n)
        if r["launches_by_route"] != want:
            raise AssertionError(f"phase 7h {arch}: routes "
                                 f"{r['launches_by_route']}, expected {want}")
        r.update(arch=arch, seed=seed, slstm_h_bf16=h_bf16, params=n_params,
                 moe_layers=n, d_model=cfg.d_model,
                 seconds=time.perf_counter() - t0)
        print(f"[7h] {key}, {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters, f32, 2 x "
              f"64 tokens, seed {seed}: total GPU {r['total_gpu']!r}"
              + (f" CPU {r['total_cpu']!r}" if "total_cpu" in r else
                 " (the CPU's on the lane)")
              + f"; launches {r['launches']}; {r['seconds']:.1f}s")
        res[key] = r
        del params
        _release(torch)
    return res


def _frontend_inputs(cfg, batch, rng, decode=False):
    """Dense prefill (``FRONTEND_PREFILL``) or one-token decode inputs of
    a frontend config, numpy: paligemma patches + tokens (decode:
    tokens), musicgen frames + ``COND_ROWS`` rows of conditioning."""
    import numpy as np
    from repro_torch.launch.train import COND_ROWS

    n = 1 if decode else FRONTEND_PREFILL
    if cfg.frontend == "encodec":
        return {"embeds": rng.normal(size=(batch, n, cfg.frontend_dim))
                .astype(np.float32),
                "cond": rng.normal(size=(batch, COND_ROWS, cfg.cross_d))
                .astype(np.float32)}
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, n)).astype(np.int32)
    if decode:
        return {"tokens": tokens}
    return {"patches": rng.normal(size=(batch, cfg.prefix_len,
                                        cfg.frontend_dim)).astype(np.float32),
            "tokens": tokens}


def _frontend_serve(torch, cfg, pcfg, params, device, batch, seed):
    """A dense ``make_prefill_step`` and ``FRONTEND_DECODES``
    ``make_serve_step`` decodes (the same draws for every device):
    each step's logits (CPU, f32) and the cache lengths after it."""
    import numpy as np
    from repro_torch.launch import steps
    from repro_torch.models import lm

    rng = np.random.default_rng(seed)
    to = lambda d: {k: torch.from_numpy(v).to(device)  # noqa: E731
                    for k, v in d.items()}
    prefill = _frontend_inputs(cfg, batch, rng)
    total = sum(v.shape[1] for k, v in prefill.items()
                if k in ("patches", "tokens", "embeds"))
    cache = lm.init_cache(cfg, batch, total + FRONTEND_DECODES, device)
    logits, cache = steps.make_prefill_step(cfg, pcfg)(params, to(prefill),
                                                       cache)
    out, lens = [logits.float().cpu()], [cache["len"].tolist()]
    step = steps.make_serve_step(cfg, pcfg)
    for _ in range(FRONTEND_DECODES):
        d = _frontend_inputs(cfg, batch, rng, decode=True)
        if "cond" in prefill:
            d["cond"] = prefill["cond"]
        logits, cache = step(params, to(d), cache)
        out.append(logits.float().cpu())
        lens.append(cache["len"].tolist())
    if lens != [[total + i] * batch for i in range(FRONTEND_DECODES + 1)]:
        raise AssertionError(f"{cfg.name}: cache lengths {lens}")
    return out, total


def frontend_reference_phase(torch):
    """Phase 7f: paligemma-3b and musicgen-large at full width, cut to
    ``FRONTEND_REF_DEPTH`` layers, f32, card vs CPU: one ``loss_fn``
    forward and backward under phase 7's limits (paligemma: 2 rows of 256
    patches + 8 tokens; musicgen: 2 x 64 frames, 64 conditioning rows, 4
    codebooks), then a dense ``make_prefill_step`` (paligemma: 256 patches
    + ``FRONTEND_PREFILL`` tokens; musicgen: ``FRONTEND_PREFILL`` frames +
    64 conditioning rows) and ``FRONTEND_DECODES`` ``make_serve_step``
    decodes: every step's logits within ESFFN_TOL["float32"] x max|CPU|
    (4j's limit) and the cache lengths advancing by one a decode. The CPU
    sides run on the CPU lane."""
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    res = {}
    for arch in ("paligemma-3b", "musicgen-large"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(cfglib.get_config(arch),
                                  num_layers=FRONTEND_REF_DEPTH,
                                  dtype="float32")
        pcfg = ParallelConfig(blk=16)
        params = lm.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(11), device="cuda")
        n_params = sum(t.numel() for t in tree_leaves(params))
        seq = FRONTEND_PREFILL + cfg.prefix_len if cfg.prefix_len else 64
        r = _card_vs_cpu_loss(torch, "7f", cfg, pcfg, params,
                              _family_batch(cfg, 2, seq, 11),
                              label=f"7f {arch}")
        if any(r["launches"].values()):
            raise AssertionError(f"phase 7f {arch}: expert kernels launched "
                                 f"{r['launches']}")
        card, total = _frontend_serve(torch, cfg, pcfg, params, "cuda", 2, 12)
        cpu = tree_map(lambda t: t.cpu(), params)
        _LANE.submit(f"7f {arch} steps", _host_bytes(cpu), _frontend_cpu,
                     torch, arch, cfg, pcfg, cpu, card)
        r.update(arch=arch, layers=FRONTEND_REF_DEPTH, params=n_params,
                 prefill_rows=total, decodes=FRONTEND_DECODES,
                 logits_shape=list(card[0].shape),
                 seconds=time.perf_counter() - t0)
        print(f"[7f] {arch}, {FRONTEND_REF_DEPTH} layers at full width, "
              f"{n_params / 1e9:.3f} B parameters, f32: loss batch 2 x {seq}"
              f" rows: total GPU {r['total_gpu']!r}; dense prefill of "
              f"{total} rows and {FRONTEND_DECODES} decodes, logits "
              f"{r['logits_shape']} (the CPU's loss, grads and steps on the "
              f"lane); {r['seconds']:.1f}s")
        res[arch] = r
        del params, cpu
        _release(torch)
    return res


def _frontend_cpu(torch, arch, cfg, pcfg, cpu_params, card):
    """Phase 7f's dense steps on the CPU (the plain versions): every
    step's logits within ESFFN_TOL["float32"] x max|CPU| of the card's."""
    steps_out, _ = _frontend_serve(torch, cfg, pcfg, cpu_params, "cpu", 2, 12)
    errs = []
    for i, (a, b) in enumerate(zip(card, steps_out)):
        err, tol = _check(f"phase 7f {arch}: step {i} logits", a, b,
                          ESFFN_TOL["float32"])
        errs.append(err / tol)
    print(f"[7f] {arch}: dense prefill and {FRONTEND_DECODES} decodes, card "
          f"vs CPU logits, worst err / limit {max(errs):.3g}")


def _family_train(torch, tag, cfg, batch, seq, *, expect=None,
                  n_steps=TRAIN_STEPS, serve=False):
    """Phases 8j/8x/8p/8m: ``cfg`` in bf16, AdamW with f32 masters,
    ``remat="block"``, blk 128, the train CLI's batches of ``batch`` x
    ``seq`` rows: one warm-up step, then ``n_steps`` steps with the expert
    kernels' counts set to 0 just before and read just after (``expect``:
    per-step launches of each, all on wgmma; else none). Every loss and
    grad norm finite; every leaf's f32 master (the leaf itself where it is
    f32; a strided sample of 4,096 elements) moved, and every leaf's first
    moment is non-zero somewhere, but those ``ZERO_GRAD_LEAVES`` names,
    whose first moments must be exactly 0. ``serve``: then a dense
    prefill and FRONTEND_DECODES decodes from the trained weights, every
    logit finite, the cache lengths advancing."""
    import math
    from repro_torch.common import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to, build_state
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig

    t_phase = time.perf_counter()
    pcfg = ParallelConfig(blk=128, remat="block")
    opt_cfg = adamw.OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                                    decay_steps=40, master_fp32=True)
    params, opt_state = build_state(cfg, opt_cfg, 0, "cuda")
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    state_gb = sum(t.numel() * t.element_size() for t in
                   leaves + tree_leaves(opt_state) if t is not None) / 1e9
    names = [n for n, _ in _named_leaves(params)]
    masters = [m if m is not None else p for (_, m), p in zip(
        _named_leaves(opt_state["master"]), leaves)]

    def sample(t):
        return t.detach().flatten()[::max(1, t.numel() // 4096)][
            :4096].float().clone()

    before = [sample(t) for t in masters]
    train_step = steps.make_train_step(cfg, pcfg, opt_cfg)
    batches = [_family_batch(cfg, batch, seq, i)
               for i in range(n_steps + 1)]

    def run(i):
        b = batch_to(batches[i], "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = train_step(params, opt_state, b)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    m, warm = run(0)
    torch.cuda.reset_peak_memory_stats()
    _reset_expert_counts()
    times, log = [], []
    for i in range(1, n_steps + 1):
        m, dt = run(i)
        times.append(dt)
        log.append(m)
    launches, routes = _expert_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
               for x in log):
        raise AssertionError(f"phase {tag}: non-finite loss {log}")
    still = [n for n, b, t in zip(names, before, masters)
             if torch.equal(b, sample(t))]
    moved = len(leaves) - len(still)
    no_grad = [n for n, (_, m) in zip(names, _named_leaves(opt_state["m"]))
               if not bool((m != 0).any())]
    zero_ok = list(ZERO_GRAD_LEAVES.get(cfg.name, ()))
    if still or no_grad != zero_ok:
        raise AssertionError(f"phase {tag}: masters not moved {still}; "
                             f"leaves with no gradient {no_grad}, expected "
                             f"{zero_ok}")
    want = {k: (expect or {}).get(k, 0) * n_steps for k in launches}
    idle = {"esffn_glu": ("stream",), "esmm": ("simt", "mma_tf32x3"),
            "estmm": ("simt", "mma_tf32x3")}
    want_routes = {k: {**dict.fromkeys(idle[k], 0), "wgmma": want[k]}
                   for k in routes}
    if launches != want or routes != want_routes:
        raise AssertionError(f"phase {tag}: launches {launches} routes "
                             f"{routes}, expected {want_routes}")
    med = statistics.median(times)
    res = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": n_params, "state_gb": state_gb,
           "batch": batch, "seq": seq, "warmup_s": warm, "steps": log,
           "step_times_s": times, "step_median_ms": med * 1e3,
           "rows_per_s": batch * seq / med, "peak_allocated_gb": peak,
           "launches": launches, "launches_by_route": routes,
           "leaves_moved": moved, "leaves": len(leaves),
           "zero_grad_leaves": no_grad}
    print(f"[{tag}] {cfg.name}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters, {state_gb:.2f}"
          f" GB of state, bf16, {batch} x {seq} rows: losses "
          f"{[round(x['loss'], 5) for x in log]}, step median "
          f"{med * 1e3:.1f}ms ({batch * seq / med:.1f} rows/s; warm-up "
          f"{warm:.2f}s), peak allocated {peak:.2f} GB; launches "
          f"{launches}; {moved}/{len(leaves)} masters moved, zero-gradient "
          f"leaves {no_grad}")
    if serve:
        outs, total = _frontend_serve(torch, cfg, pcfg, params, "cuda", batch,
                                   13)
        if not all(torch.isfinite(o).all() for o in outs):
            raise AssertionError(f"phase {tag}: non-finite serve logits")
        res.update(serve_prefill_rows=total, serve_decodes=FRONTEND_DECODES,
                   serve_logits_shape=list(outs[0].shape))
        print(f"[{tag}] dense prefill of {batch} x {total} rows and "
              f"{FRONTEND_DECODES} decodes from the trained weights: logits "
              f"{list(outs[0].shape)} finite, lengths advancing")
    res["seconds"] = time.perf_counter() - t_phase
    del params, opt_state, train_step
    _release(torch)
    return res


def family_train_phase(torch):
    """Phases 8j (Jamba's layout at its "train" cut width, 3.02 B
    parameters: per step 2 ``esffn_glu``, 5 ``esmm`` and 3 ``estmm`` a MoE
    layer, all on wgmma), 8x (xlstm-350m, XLSTM_TRAIN_DEPTH layers), 8p
    and 8m (paligemma-3b and musicgen-large at full width and depth, then
    their dense serve steps), each at TRAIN_BATCH x TRAIN_SEQ rows
    (``_family_train``), FAMILY_TRAIN_STEPS timed steps each."""
    from repro_torch import configs as cfglib

    from repro_torch.configs import jamba_1_5_large_398b as jamba_cfg

    jamba = jamba_cfg.cut_config("train", "bfloat16")
    n = _moe_layers(jamba)
    out = {"8j": _family_train(
        torch, "8j", jamba, TRAIN_BATCH, TRAIN_SEQ,
        expect={"esffn_glu": 2 * n, "esmm": 5 * n, "estmm": 3 * n},
        n_steps=FAMILY_TRAIN_STEPS)}
    xlstm = dataclasses.replace(cfglib.get_config("xlstm-350m"),
                                num_layers=XLSTM_TRAIN_DEPTH)
    for tag, cfg in (("8x", xlstm),
                     ("8p", cfglib.get_config("paligemma-3b")),
                     ("8m", cfglib.get_config("musicgen-large"))):
        out[tag] = _family_train(
            torch, tag, cfg, TRAIN_BATCH, TRAIN_SEQ,
            n_steps=FAMILY_TRAIN_STEPS,
            serve=tag in ("8p", "8m"))
    return out


def _swin_layout(torch, n, d, empty_experts=0, seed=8):
    """Swin-MoE-Small's routing of n random tokens of width d (top-1 of 8
    experts, blk 128); with ``empty_experts`` the picks of the first few
    experts move to the expert that many places on, so those get no rows."""
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route

    gen = torch.Generator(device="cuda").manual_seed(seed)
    router = torch.randn((d, 8), generator=gen, device="cuda") * 0.02
    x = torch.randn((n, d), generator=gen, device="cuda")
    r = route(x, router, 1)
    idx = r.expert_idx
    if empty_experts:
        idx = torch.where(idx < empty_experts, idx + empty_experts, idx)
    return x, build_reindex(idx, r.gates, 8, 128), gen


def _rows_read(pc, np_rows):
    """Rows of the non-empty experts' runs (the tail belongs to E-1)."""
    return int(pc.sum()) + (np_rows - int(pc.sum()) if int(pc[-1]) > 0 else 0)


def swin_kernel_cases(torch, flush):
    """Phase 9: esffn_mlp, esfk, ess and f32 biased esmm at the Swin train
    shapes (stage 2 and stage 3 of Swin-MoE-Small at global batch 128)."""
    from repro_torch.core.reindex import gather_rows
    from repro_torch.kernels import esffn, esfk, esmm, ess, estmm

    res = {"esffn_mlp": [], "esfk": [], "ess": [], "esmm": [], "estmm": [],
           "negative_controls": []}
    e = 8
    for stage, n, d in ((2, SWIN_BATCH * 196, 384), (3, SWIN_BATCH * 49, 768)):
        f = 4 * d
        for empty in (0, 3):
            x, ri, gen = _swin_layout(torch, n, d, empty, seed=8 + stage)
            np_rows, nblk = ri.row_token.numel(), ri.block_expert.numel()
            be, pc, rg = ri.block_expert, ri.padded_counts, ri.row_gate
            experts = int((pc > 0).sum())
            n_empty = int((pc == 0).sum())
            if empty and n_empty < empty:
                raise AssertionError(f"swin layout: {n_empty} empty experts")
            live = int((rg != 0).sum())
            rows = _rows_read(pc, np_rows)
            shape = {"stage": stage, "N": n, "D": d, "F": f, "E": e,
                     "top_k": 1, "blk": 128, "Np": np_rows,
                     "live_rows": live, "empty_experts": n_empty}

            def randn(*sh, scale=1.0, g=gen):
                return torch.randn(sh, generator=g, device="cuda") * scale

            w1, w2 = randn(e, d, f, scale=0.02), randn(e, f, d, scale=0.02)
            b1, b2 = randn(e, f, scale=0.1), randn(e, d, scale=0.1)
            dtypes = ("float32", "bfloat16") if stage == 2 and not empty \
                else ("float32",)
            for dtype in dtypes:
                td = getattr(torch, dtype)
                args = (x.to(td), ri.row_token, rg, be, w1.to(td), b1,
                        w2.to(td), b2)
                name = f"esffn_mlp stage {stage} {dtype} empty={n_empty}"
                plain = esffn.esffn_mlp_plain(*args)
                kern, kroute = _routed(torch, lambda: esffn.esffn_mlp(*args),
                                       esffn.esffn_mlp)
                want = "mma_tf32x3" if dtype == "float32" else "mma_bf16"
                if kroute != want:
                    raise AssertionError(f"{name}: took the {kroute} route, "
                                         f"not {want}")
                tol_rel = SWIN_KERNEL_TOL if dtype == "float32" \
                    else ESFFN_TOL["bfloat16"]
                err, tol = _check(name, kern, plain, tol_rel)
                if not torch.equal(kern[rg == 0], torch.zeros_like(
                        kern[rg == 0])):
                    raise AssertionError(f"{name}: padding rows not 0")
                if stage == 2 and not empty and dtype == "float32":
                    # one 8-deep K step of x W1 (an mma k8 step) left out
                    w1_cut = w1.clone()
                    w1_cut[:, 8:16] = 0.0
                    res["negative_controls"].append({
                        "kernel": "esffn_mlp",
                        "fault": "one 8-deep K step of x W1 left out",
                        "err_over_tol": _must_fail(
                            name + " without K 8..15", esffn.esffn_mlp_plain(
                                args[0], *args[1:4], w1_cut, *args[5:]),
                            plain, SWIN_KERNEL_TOL)})
                    del w1_cut
                s_ = x.to(td).element_size()
                nbytes = (n * d * s_ + experts * 2 * d * f * s_
                          + experts * (d + f) * 4 + np_rows * 8 + nblk * 4
                          + np_rows * d * s_)
                flops = 4 * live * d * f
                b_ms, b_by = bound(nbytes, flops, dtype, kroute)
                res["esffn_mlp"].append({
                    "shape": shape, "dtype": dtype, "kernel_route": kroute,
                    "max_abs_err": err, "tolerance": tol,
                    "bound_route": (
                        "3 x FLOPs at 495 TFLOP/s (TF32 tensor cores)"
                        if kroute == "mma_tf32x3" else
                        "FLOPs at 989 TFLOP/s (bf16 tensor cores)"),
                    "bound_fma_ms": bound(nbytes, flops, "float32")[0],
                    "kernel_ms": time_ms(torch, lambda: esffn.esffn_mlp(
                        *args), flush),
                    "plain_ms": time_ms(torch, lambda: esffn.esffn_mlp_plain(
                        *args), flush),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "library": "none: no one PyTorch call computes it"})
                del plain, kern

            # the backward's operands: xs (Np, D) with dz (Np, F) for
            # (dW1, db1), h (Np, F) with dys (Np, D) for (dW2, db2); zero
            # on padding rows, as the backward gives them
            on = (rg != 0)[:, None]
            xs = gather_rows(x, ri.row_token)
            hs, dz, dys = randn(np_rows, f) * on, randn(np_rows, f) * on, \
                randn(np_rows, d) * on
            for x1, x2, what in ((xs, dz, "dW1,db1"), (hs, dys, "dW2,db2")):
                args = (x1, x2, be, pc)
                name = f"esfk stage {stage} {what} empty={n_empty}"
                pw, pb = esfk.esfk_plain(*args)
                (kern_w, kern_b), kroute = _routed(
                    torch, lambda: esfk.esfk(*args), esfk.esfk)
                if kroute != "mma_tf32x3":
                    raise AssertionError(f"{name}: took the {kroute} route")
                err_w, tol_w = _check(name + " dW", kern_w, pw,
                                      SWIN_KERNEL_TOL)
                err_b, tol_b = _check(name + " db", kern_b, pb,
                                      SWIN_KERNEL_TOL)
                z = pc == 0
                if not (torch.equal(kern_w[z], torch.zeros_like(kern_w[z]))
                        and torch.equal(kern_b[z],
                                        torch.zeros_like(kern_b[z]))):
                    raise AssertionError(f"{name}: empty experts not 0")
                again_w, again_b = esfk.esfk(*args)
                torch.cuda.synchronize()
                if not (torch.equal(again_w, kern_w)
                        and torch.equal(again_b, kern_b)):
                    raise AssertionError(f"{name}: two calls differ")
                del again_w, again_b
                if stage == 2 and not empty and what == "dW1,db1":
                    # one 32-row step (a stage of the kernel's ring) of the
                    # first expert with rows left out
                    first = int((pc > 0).nonzero()[0])
                    r0 = int(pc[:first].sum()) + 32
                    x1_cut = x1.clone()
                    x1_cut[r0:r0 + 32] = 0.0
                    res["negative_controls"].append({
                        "kernel": "esfk",
                        "fault": "one 32-row step of one expert left out",
                        "err_over_tol": _must_fail(
                            name + " without 32 rows", esfk.esfk_plain(
                                x1_cut, *args[1:])[0], pw, SWIN_KERNEL_TOL)})
                    del x1_cut
                d1, d2 = x1.shape[1], x2.shape[1]
                nbytes = rows * (d1 + d2) * 4 + e * 4 + e * d1 * d2 * 4 \
                    + e * d2 * 4
                flops = 2 * rows * d1 * d2 + rows * d2
                b_ms, b_by = bound(nbytes, flops, "float32", kroute)
                res["esfk"].append({
                    "shape": {**shape, "D1": d1, "D2": d2, "grads": what,
                              "rows_read": rows},
                    "dtype": "float32", "kernel_route": kroute,
                    "max_abs_err": max(err_w, err_b),
                    "tolerance": min(tol_w, tol_b),
                    "kernel_ms": time_ms(torch, lambda: esfk.esfk(*args),
                                         flush),
                    "plain_ms": time_ms(torch, lambda: esfk.esfk_plain(*args),
                                        flush),
                    # the paper's Fig. 12 ablation at the kernel level: the
                    # unfused pair the backward runs instead of ESFK
                    "unfused_estmm_ess_ms": time_ms(torch, lambda: (
                        estmm.estmm(*args), ess.ess(x2, be, pc)), flush),
                    "bound_ms": b_ms, "bound_by": b_by,
                    **_fma_bound(kroute, nbytes, flops), "library_ms": None,
                    "library": "none: no one PyTorch call computes dW and db"})
                # the unfused backward's dW alone: f32 estmm on mma_tf32x3,
                # esfk's kernel without db at the same splits, so the same
                # bits as esfk's dW; empty experts exactly 0, two calls equal
                name = f"estmm f32 stage {stage} {what[:3]} empty={n_empty}"
                kern, eroute = _routed(torch, lambda: estmm.estmm(*args),
                                       estmm.estmm)
                if eroute != "mma_tf32x3":
                    raise AssertionError(f"{name}: took the {eroute} route")
                err, tol = _check(name, kern, pw, GEMM_TOL["float32"])
                again = estmm.estmm(*args)
                torch.cuda.synchronize()
                if not torch.equal(again, kern):
                    raise AssertionError(f"{name}: two calls differ")
                if not torch.equal(kern, kern_w):
                    raise AssertionError(f"{name}: dW not esfk's bits")
                if not torch.equal(kern[z], torch.zeros_like(kern[z])):
                    raise AssertionError(f"{name}: empty experts not 0")
                del again
                if stage == 2 and not empty and what == "dW1,db1":
                    # one expert's rows left out of the plain dW
                    first = int((pc > 0).nonzero()[0])
                    r0 = int(pc[:first].sum())
                    x1_cut = x1.clone()
                    x1_cut[r0:r0 + int(pc[first])] = 0.0
                    res["negative_controls"].append({
                        "kernel": "estmm",
                        "fault": "one expert's rows left out",
                        "err_over_tol": _must_fail(
                            name + " without one expert's rows",
                            estmm.estmm_plain(x1_cut, *args[1:]), pw,
                            GEMM_TOL["float32"])})
                    del x1_cut
                if not empty:
                    nbytes = rows * (d1 + d2) * 4 + e * 4 + e * d1 * d2 * 4
                    flops = 2 * rows * d1 * d2
                    b_ms, b_by = bound(nbytes, flops, "float32", eroute)
                    res["estmm"].append({
                        "shape": {**shape, "D1": d1, "D2": d2,
                                  "grads": what[:3], "rows_read": rows},
                        "dtype": "float32", "kernel_route": eroute,
                        "max_abs_err": err, "tolerance": tol,
                        "kernel_ms": time_ms(torch, lambda: estmm.estmm(
                            *args), flush),
                        "plain_ms": time_ms(torch, lambda: estmm.estmm_plain(
                            *args), flush),
                        "bound_ms": b_ms, "bound_by": b_by,
                        **_fma_bound(eroute, nbytes, flops),
                        "library_ms": None,
                        "library": "none: torch._grouped_mm takes bf16 only"})
                del kern

                args = (x2, be, pc)
                name = f"ess stage {stage} D {d2} empty={n_empty}"
                plain = ess.ess_plain(*args)
                kern = ess.ess(*args)
                torch.cuda.synchronize()
                err, tol = _check(name, kern, plain, SWIN_KERNEL_TOL)
                if not torch.equal(kern[z], torch.zeros_like(kern[z])):
                    raise AssertionError(f"{name}: empty experts not 0")
                # the library call: one segment sum over the expert runs
                # (the tail rows go to E-1), then the empty-expert mask
                lengths = pc.clone()
                lengths[-1] += np_rows - int(pc.sum())
                lib = torch.segment_reduce(x2, "sum", lengths=lengths)
                torch.cuda.synchronize()
                _check(name + " segment_reduce", torch.where(
                    (pc > 0)[:, None], lib, 0.0), plain, SWIN_KERNEL_TOL)
                b_ms, b_by = bound(rows * d2 * 4 + e * 4 + e * d2 * 4,
                                   rows * d2, "float32")
                res["ess"].append({
                    "shape": {**shape, "D": d2, "rows_read": rows},
                    "dtype": "float32", "max_abs_err": err, "tolerance": tol,
                    "kernel_ms": time_ms(torch, lambda: ess.ess(*args), flush),
                    "plain_ms": time_ms(torch, lambda: ess.ess_plain(*args),
                                        flush),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": time_ms(torch, lambda: torch.segment_reduce(
                        x2, "sum", lengths=lengths), flush),
                    "library": "torch.segment_reduce"})

            if empty:
                continue
            # f32 ESMM of the MLP backward: z = xs W1 + b1, t = dys W2^T,
            # dX = dz W1^T
            for xa, w, b, trans, what in ((xs, w1, b1, False, "z"),
                                          (dys, w2, None, True, "t"),
                                          (dz, w1, None, True, "dX")):
                args = (xa, w, b, be)
                kw = dict(transpose_rhs=trans)
                name = f"esmm f32 stage {stage} {what}"
                plain = esmm.esmm_plain(*args, **kw)
                kern, route = _routed(torch, lambda: esmm.esmm(*args, **kw),
                                      esmm.esmm)
                if route != "mma_tf32x3":
                    raise AssertionError(f"{name}: took the {route} route")
                err, tol = _check(name, kern, plain, GEMM_TOL["float32"])
                if stage == 2 and what == "t":
                    # one 8-deep K step (an mma k8 step) of W^T left out
                    w_cut = w.clone()
                    w_cut[:, :, 8:16] = 0.0
                    res["negative_controls"].append({
                        "kernel": "esmm",
                        "fault": "one 8-deep K step of the transposed W "
                                 "left out",
                        "err_over_tol": _must_fail(
                            name + " without K 8..15", esmm.esmm_plain(
                                xa, w_cut, b, be, **kw), plain,
                            GEMM_TOL["float32"])})
                    del w_cut
                k_dim, n_dim = xa.shape[1], kern.shape[1]
                nbytes = (np_rows * k_dim * 4 + experts * k_dim * n_dim * 4
                          + (experts * n_dim * 4 if b is not None else 0)
                          + nblk * 4 + np_rows * n_dim * 4)
                flops = 2 * np_rows * k_dim * n_dim
                b_ms, b_by = bound(nbytes, flops, "float32", route)
                res["esmm"].append({
                    "shape": {**shape, "K": k_dim, "Nout": n_dim,
                              "transpose_rhs": trans, "bias": b is not None,
                              "product": what},
                    "dtype": "float32", "kernel_route": route,
                    "max_abs_err": err, "tolerance": tol,
                    "kernel_ms": time_ms(torch, lambda: esmm.esmm(*args, **kw),
                                         flush),
                    "plain_ms": time_ms(torch, lambda: esmm.esmm_plain(
                        *args, **kw), flush),
                    "bound_ms": b_ms, "bound_by": b_by,
                    **_fma_bound(route, nbytes, flops), "library_ms": None,
                    "library": "none: torch._grouped_mm takes bf16 only"})
                del plain, kern
            del x, xs, hs, dz, dys, w1, w2, b1, b2
    return res


# phase 9, untimed: esffn_mlp at ragged D x F and every tile height
MLP_CHECK_WIDTHS = ((24, 40), (200, 136))
MLP_CHECK_BLKS = (8, 16, 64, 128)


def esffn_mlp_check_cases(torch):
    """esffn_mlp against its plain version at the ragged MLP_CHECK_WIDTHS
    and blk 8, 16, 64 and 128 (an 8-row block in a 16-row tile, and 16-,
    64- and 128-row tiles), in f32, bf16 and with int8 weights (quant tiles
    of 8 where 128 does not divide a width), 320 tokens top-1 of 8
    experts: each call on its route, padding rows exactly 0."""
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route
    from repro_torch.kernels import esffn
    from repro_torch.quant.core import quantize_blockwise

    out = []
    gen = torch.Generator(device="cuda").manual_seed(12)
    e, n = 8, 320
    for d, f in MLP_CHECK_WIDTHS:
        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        x, router = randn(n, d), randn(d, e)
        w1, w2 = randn(e, d, f, scale=0.05), randn(e, f, d, scale=0.05)
        b1, b2 = randn(e, f, scale=0.1), randn(e, d, scale=0.1)
        r = route(x, router, 1)
        tile = 128 if all(w <= 128 or w % 128 == 0 for w in (d, f)) else 8
        for blk in MLP_CHECK_BLKS:
            ri = build_reindex(r.expert_idx, r.gates, e, blk)
            rg = ri.row_gate
            for dtype, mode in (("float32", None), ("bfloat16", None),
                                ("float32", "int8")):
                td = getattr(torch, dtype)
                kw = {}
                if mode is None:
                    ws = (w1.to(td), w2.to(td))
                else:
                    (q1, s1), (q2, s2) = (quantize_blockwise(w, mode=mode,
                                                             tile=tile)
                                          for w in (w1, w2))
                    ws, kw = (q1, q2), {"w_scales": (s1, s2)}
                args = (x.to(td), ri.row_token, rg, ri.block_expert, ws[0],
                        b1, ws[1], b2)
                name = (f"esffn_mlp check D {d} F {f} blk {blk} {dtype} "
                        f"weights {mode or dtype}")
                plain = esffn.esffn_mlp_plain(*args, **kw)
                kern, kroute = _routed(torch, lambda: esffn.esffn_mlp(
                    *args, **kw), esffn.esffn_mlp)
                want = "mma_bf16" if dtype == "bfloat16" else "mma_tf32x3"
                if kroute != want:
                    raise AssertionError(f"{name}: took the {kroute} route")
                err, tol = _check(name, kern, plain, SWIN_KERNEL_TOL
                                  if dtype == "float32"
                                  else ESFFN_TOL["bfloat16"])
                if not torch.equal(kern[rg == 0],
                                   torch.zeros_like(kern[rg == 0])):
                    raise AssertionError(f"{name}: padding rows not 0")
                out.append({"D": d, "F": f, "blk": blk, "dtype": dtype,
                            "weights": mode or dtype, "route": kroute,
                            "max_abs_err": err, "tolerance": tol})
    return out


# esmm's checks also take rows that are not whole 16-byte copies: they run
# the simt kernel in f32, bf16 and with 8-bit weights; esfk refuses them.
ODD_CHECK_WIDTHS = ((18, 30),)
# esfk at the ragged widths with an expert's rows split over this many CTAs
# (320 tokens give _plan 1), the merge through the workspace included
ESFK_CHECK_SPLITS = 3


def esmm_esfk_check_cases(torch):
    """Phase 9, untimed: esmm and esfk against their plain versions at the
    ragged MLP_CHECK_WIDTHS and ODD_CHECK_WIDTHS (as (K, N) and (D1, D2))
    and blk 8, 16, 64 and 128, over 320 tokens top-1 of 8 experts: esmm in
    both orientations with a bias, in f32 (mma_tf32x3; simt at the odd
    widths), bf16 (wgmma at blk 64 and 128, else simt) and with int8
    weights under f32 and bf16 xs (mma_tf32x3, simt at the odd widths;
    quant tiles of 8 where 128 does not divide a width); esfk in f32
    (mma_tf32x3) and bf16 (mma_bf16), twice each (the same bits), the
    experts with no rows exactly 0, once more with ESFK_CHECK_SPLITS
    splits (twice, the same bits), and refusing the odd widths. Each
    call's route is read from its launch counts. f32 estmm runs once at
    each width and blk (mma_tf32x3, whose dW must be esfk's bits; simt at
    the odd widths), its empty experts exactly 0."""
    from repro_torch.core.reindex import build_reindex, gather_rows
    from repro_torch.core.routing import route
    from repro_torch.kernels import esfk, esmm, estmm
    from repro_torch.quant.core import quantize_blockwise

    out = []
    gen = torch.Generator(device="cuda").manual_seed(13)
    e, n = 8, 320
    for k, nd in MLP_CHECK_WIDTHS + ODD_CHECK_WIDTHS:
        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        x, router = randn(n, k), randn(k, e)
        w, wt = randn(e, k, nd, scale=0.05), randn(e, nd, k, scale=0.05)
        b = randn(e, nd, scale=0.1)
        r = route(x, router, 1)
        tile = 128 if all(v <= 128 or v % 128 == 0 for v in (k, nd)) else 8
        for blk in MLP_CHECK_BLKS:
            ri = build_reindex(r.expert_idx, r.gates, e, blk)
            be, pc = ri.block_expert, ri.padded_counts
            xs = gather_rows(x, ri.row_token)
            for dtype, mode in (("float32", None), ("bfloat16", None),
                                ("float32", "int8"), ("bfloat16", "int8")):
                td = getattr(torch, dtype)
                for trans, wm in ((False, w), (True, wt)):
                    kw = {"transpose_rhs": trans}
                    if mode is None:
                        wa = wm.to(td)
                    else:
                        wa, kw["w_scales"] = quantize_blockwise(
                            wm, mode=mode, tile=tile)
                    args = (xs.to(td), wa, b, be)
                    name = (f"esmm check K {k} N {nd} blk {blk} {dtype} "
                            f"weights {mode or dtype} trans={trans}")
                    want = esmm._route(td, blk, k, nd, mode is not None)
                    plain = esmm.esmm_plain(*args, **kw)
                    kern, kroute = _routed(torch, lambda: esmm.esmm(
                        *args, **kw), esmm.esmm)
                    if kroute != want:
                        raise AssertionError(f"{name}: took the {kroute} "
                                             f"route, not {want}")
                    err, tol = _check(name, kern, plain, GEMM_TOL[dtype])
                    out.append({"kernel": "esmm", "K": k, "N": nd,
                                "blk": blk, "dtype": dtype,
                                "weights": mode or dtype,
                                "transpose_rhs": trans, "route": kroute,
                                "max_abs_err": err, "tolerance": tol})
            x2 = randn(xs.shape[0], nd) * (ri.row_gate != 0)[:, None]
            z = pc == 0
            # f32 estmm: mma_tf32x3 (esfk's kernel without db: esfk's dW
            # bits), simt at the odd widths; empty experts exactly 0
            args = (xs, x2, be, pc)
            name = f"estmm check D1 {k} D2 {nd} blk {blk} float32"
            plain = estmm.estmm_plain(*args)
            kern, kroute = _routed(torch, lambda: estmm.estmm(*args),
                                   estmm.estmm)
            want = estmm._route(torch.float32, blk, k, nd)
            if kroute != want:
                raise AssertionError(f"{name}: took the {kroute} route, not "
                                     f"{want}")
            err, tol = _check(name, kern, plain, GEMM_TOL["float32"])
            if kern[z].any():
                raise AssertionError(f"{name}: empty experts not 0")
            if kroute == "mma_tf32x3" and not torch.equal(
                    kern, esfk.esfk(*args)[0]):
                raise AssertionError(f"{name}: dW not esfk's bits")
            out.append({"kernel": "estmm", "D1": k, "D2": nd, "blk": blk,
                        "dtype": "float32", "route": kroute,
                        "empty_experts": int(z.sum()), "max_abs_err": err,
                        "tolerance": tol})
            for dtype in ("float32", "bfloat16"):
                td = getattr(torch, dtype)
                args = (xs.to(td), x2.to(td), be, pc)
                name = f"esfk check D1 {k} D2 {nd} blk {blk} {dtype}"
                if (k, nd) in ODD_CHECK_WIDTHS:
                    before = dict(esfk.esfk.launches_by_route)
                    try:
                        esfk.esfk(*args)
                    except ValueError:
                        pass
                    else:
                        raise AssertionError(f"{name}: not refused")
                    if esfk.esfk.launches_by_route != before:
                        raise AssertionError(f"{name}: refused, but counted")
                    out.append({"kernel": "esfk", "D1": k, "D2": nd,
                                "blk": blk, "dtype": dtype,
                                "route": "refused"})
                    continue
                pw, pb = esfk.esfk_plain(*args)
                (kw_, kb), kroute = _routed(torch, lambda: esfk.esfk(*args),
                                            esfk.esfk)
                want = "mma_tf32x3" if dtype == "float32" else "mma_bf16"
                if kroute != want:
                    raise AssertionError(f"{name}: took the {kroute} route")
                err_w, tol_w = _check(name + " dW", kw_, pw, SWIN_KERNEL_TOL)
                err_b, tol_b = _check(name + " db", kb, pb, SWIN_KERNEL_TOL)
                again = esfk.esfk(*args)
                torch.cuda.synchronize()
                if not (torch.equal(again[0], kw_) and torch.equal(
                        again[1], kb)):
                    raise AssertionError(f"{name}: two calls differ")
                if kw_[z].any() or kb[z].any():
                    raise AssertionError(f"{name}: empty experts not 0")
                # the same through the split-and-merge (a check: uncounted)
                sp = ESFK_CHECK_SPLITS
                sw, sb = esfk._launch(*args[:2], pc, kroute, sp)
                err_sw, _ = _check(f"{name} {sp} splits dW", sw, pw,
                                   SWIN_KERNEL_TOL)
                err_sb, _ = _check(f"{name} {sp} splits db", sb, pb,
                                   SWIN_KERNEL_TOL)
                again = esfk._launch(*args[:2], pc, kroute, sp)
                torch.cuda.synchronize()
                if not (torch.equal(again[0], sw) and torch.equal(
                        again[1], sb)):
                    raise AssertionError(f"{name} {sp} splits: two calls "
                                         f"differ")
                if sw[z].any() or sb[z].any():
                    raise AssertionError(f"{name} {sp} splits: empty "
                                         f"experts not 0")
                out.append({"kernel": "esfk", "D1": k, "D2": nd, "blk": blk,
                            "dtype": dtype, "route": kroute,
                            "empty_experts": int(z.sum()),
                            "max_abs_err": max(err_w, err_b),
                            "max_abs_err_splits": {sp: max(err_sw, err_sb)},
                            "tolerance": min(tol_w, tol_b)})
    return out


def _swin_grads(torch, params, loss_fn, images, labels):
    """(loss, grads of every leaf) of one forward and backward."""
    from repro_torch.common import tree_leaves, tree_map

    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    total, _ = loss_fn(tree_map(lambda _: next(it), params), images, labels)
    return float(total.detach()), torch.autograd.grad(total, leaves)


def _grad_err(a_grads, b_grads, tol_rel, what):
    worst = 0.0
    for i, (a, b) in enumerate(zip(a_grads, b_grads)):
        a, b = a.float().cpu(), b.float().cpu()
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not err <= tol_rel * scale:
            raise AssertionError(f"{what}: grad leaf {i} {tuple(b.shape)} err "
                                 f"{err} > {tol_rel} x {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def swin_reference_phase(torch):
    """Phase 10: Swin-MoE-Small at full width, cut depth, f32: one loss and
    its grads on the GPU (kernels) and the CPU (plain versions)."""
    from repro_torch.common import tree_map
    from repro_torch.configs import swin_moe_small
    from repro_torch.models import swin
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(swin_moe_small.CONFIG, depths=SWIN_REF_DEPTHS)
    pcfg = ParallelConfig(blk=128)
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = swin.init_swin(cfg, generator=gen, device="cuda")
    # non-zero biases, so that the bias paths carry signal
    params = tree_map(lambda t: t + 0.02 * torch.randn(
        t.shape, generator=gen, device="cuda") if t.ndim <= 2 else t, params)
    images, labels = swin.synthetic_batch(cfg, SWIN_REF_BATCH, generator=gen,
                                          device="cuda")
    loss_fn = swin.make_loss_fn(cfg, pcfg)
    out = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), params)
        out[device] = _swin_grads(torch, p, loss_fn, images.to(device),
                                  labels.to(device))
        del p
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    if not abs(lg - lc) <= SWIN_LOSS_RTOL * abs(lc):
        raise AssertionError(f"swin reference: GPU loss {lg} vs CPU {lc}")
    worst = _grad_err(gg, gc, SWIN_GRAD_TOL, "swin reference")
    print(f"[swin-reference] Swin-MoE-Small full width, depths "
          f"{SWIN_REF_DEPTHS}, f32, {SWIN_REF_BATCH} images: loss GPU {lg!r} "
          f"CPU {lc!r} (rel diff {abs(lg - lc) / abs(lc):.3e}); {len(gc)} "
          f"grad leaves, worst max |diff| / max |grad| {worst:.3e}")
    return {"loss_gpu": lg, "loss_cpu": lc,
            "loss_rel_diff": abs(lg - lc) / abs(lc), "worst_grad_rel": worst,
            "depths": list(SWIN_REF_DEPTHS), "images": SWIN_REF_BATCH}


def swin_train_phase(torch):
    """Phase 11: Swin-MoE-Small at full width and depth, f32, AdamW."""
    import math
    from repro_torch.common import tree_leaves
    from repro_torch.configs import swin_moe_small
    from repro_torch.kernels import esffn, esfk, esmm, ess, estmm, ops
    from repro_torch.models import swin
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = swin_moe_small.CONFIG
    pcfg = ParallelConfig(blk=128)
    opt_cfg = adamw.OptimizerConfig(master_fp32=False)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = swin.init_swin(cfg, generator=gen, device="cuda")
    opt_state = adamw.init_opt_state(params, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_moe = sum(t.numel() for st in params["stages"] for b in st["blocks"]
                if "moe" in b for t in tree_leaves(b["moe"]))
    print(f"[swin] {cfg.name}: depths {cfg.depths}, dims {cfg.dims}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
          f"{n_params / 1e6:.2f} M parameters ({n_moe / 1e6:.2f} M in the MoE "
          f"blocks), f32, built in {time.perf_counter() - t0:.1f}s; global "
          f"batch {SWIN_BATCH} at {cfg.img_size}^2, blk {pcfg.blk}")
    batches = [swin.synthetic_batch(cfg, SWIN_BATCH, generator=gen,
                                    device="cuda")
               for _ in range(SWIN_STEPS + 1)]
    train_step = swin.make_train_step(cfg, pcfg, opt_cfg)
    kernels = {"esffn_mlp": esffn.esffn_mlp, "esmm": esmm.esmm,
               "esfk": esfk.esfk, "ess": ess.ess, "estmm": estmm.estmm}

    def run(i):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = train_step(params, opt_state, *batches[i])
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    def reset():
        for fn in kernels.values():
            fn.launches = 0
        for fn in (esmm.esmm, estmm.estmm, esffn.esffn_mlp, esfk.esfk):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)

    def routes():
        return {"esmm": dict(esmm.esmm.launches_by_route),
                "estmm": dict(estmm.estmm.launches_by_route),
                "esffn_mlp": dict(esffn.esffn_mlp.launches_by_route),
                "esfk": dict(esfk.esfk.launches_by_route)}

    m, dt = run(0)                        # warm-up, unmeasured
    print(f"[swin] warm-up step: loss {m['loss']:.4f} ({dt:.2f}s)")
    torch.cuda.reset_peak_memory_stats()
    reset()
    times, log = [], []
    for step in range(1, SWIN_STEPS + 1):
        m, dt = run(step)
        times.append(dt)
        log.append(m)
        print(f"[swin] step {step}: loss {m['loss']:.6f} ce {m['ce']:.6f} aux "
              f"{m['aux_loss']:.6f} grad norm {m['grad_norm']:.6f} lr "
              f"{m['lr']:.2e} ({dt:.3f}s)")
    launches = {k: fn.launches for k, fn in kernels.items()}
    train_routes = routes()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in log):
        raise AssertionError(f"swin train: non-finite loss or grad norm {log}")
    want = {"esffn_mlp": 10, "esmm": 30, "esfk": 20, "ess": 0, "estmm": 0}
    want = {k: v * SWIN_STEPS for k, v in want.items()}
    if launches != want:
        raise AssertionError(f"swin train: launches {launches}, expected "
                             f"{want}")
    # the f32 Swin step: every expert kernel on the 3xTF32 tensor cores
    def on_tf32x3(esmm_n, estmm_n, mlp_n, esfk_n):
        return {"esmm": {"simt": 0, "wgmma": 0, "mma_tf32x3": esmm_n},
                "estmm": {"simt": 0, "wgmma": 0, "mma_tf32x3": estmm_n},
                "esffn_mlp": {"mma_tf32x3": mlp_n, "mma_bf16": 0},
                "esfk": {"mma_tf32x3": esfk_n, "mma_bf16": 0}}

    if train_routes != on_tf32x3(want["esmm"], 0, want["esffn_mlp"],
                                 want["esfk"]):
        raise AssertionError(f"swin train: routes {train_routes}")
    med = statistics.median(times)
    print(f"[swin] {SWIN_STEPS} steps of {SWIN_BATCH} images: step median "
          f"{med * 1e3:.1f}ms, {SWIN_BATCH / med:.1f} images/s; peak "
          f"allocated {peak / 1e9:.2f} GB; launches {launches}; routes "
          f"{train_routes}")

    # Fig. 12 ablation: the same loss's grads, fused and unfused backward
    loss_fn = swin.make_loss_fn(cfg, pcfg)
    ablation = {}
    for fused in (True, False):
        ops.set_fused_backward(fused)
        try:
            reset()
            loss, grads = _swin_grads(torch, params, loss_fn, *batches[0])
            torch.cuda.synchronize()
        finally:
            ops.set_fused_backward(True)
        ablation[fused] = (loss, grads,
                           {k: fn.launches for k, fn in kernels.items()},
                           routes())
        del grads
    (lf, gf, cf, rf), (lu, gu, cu, ru) = ablation[True], ablation[False]
    # unfused: estmm's 20 f32 dW launches on mma_tf32x3 too
    if (rf, ru) != (on_tf32x3(30, 0, 10, 20), on_tf32x3(30, 20, 10, 0)):
        raise AssertionError(f"swin backward: routes {rf} fused, {ru} "
                             f"unfused")
    if cf != {"esffn_mlp": 10, "esmm": 30, "esfk": 20, "ess": 0, "estmm": 0}:
        raise AssertionError(f"swin fused backward: launches {cf}")
    if cu != {"esffn_mlp": 10, "esmm": 30, "esfk": 0, "ess": 20, "estmm": 20}:
        raise AssertionError(f"swin unfused backward: launches {cu}")
    if lf != lu:
        raise AssertionError(f"swin ablation: loss {lf} fused vs {lu} unfused")
    worst = _grad_err(gu, gf, SWIN_ABLATION_TOL, "swin ablation")
    print(f"[swin] unfused backward (ESTMM + ESS): launches {cu}; loss equal "
          f"({lf!r}); worst grad max |diff| / max |grad| {worst:.3e} against "
          f"the fused (ESFK) backward")

    # the Fig. 12 ablation a step: SWIN_STEPS train steps more with the
    # unfused backward, timed as the fused ones
    ops.set_fused_backward(False)
    try:
        reset()
        u_times, u_log = [], []
        for step in range(1, SWIN_STEPS + 1):
            m, dt = run(step)
            u_times.append(dt)
            u_log.append(m)
    finally:
        ops.set_fused_backward(True)
    u_launches, u_routes = ({k: fn.launches for k, fn in kernels.items()},
                            routes())
    if not all(math.isfinite(m["loss"]) for m in u_log):
        raise AssertionError(f"swin unfused train: non-finite loss {u_log}")
    u_want = {k: v * SWIN_STEPS for k, v in cu.items()}
    if u_launches != u_want or u_routes != on_tf32x3(
            30 * SWIN_STEPS, 20 * SWIN_STEPS, 10 * SWIN_STEPS, 0):
        raise AssertionError(f"swin unfused train: launches {u_launches}, "
                             f"routes {u_routes}")
    u_med = statistics.median(u_times)
    print(f"[swin] {SWIN_STEPS} steps with the unfused backward: step median "
          f"{u_med * 1e3:.1f}ms ({SWIN_BATCH / u_med:.1f} images/s) against "
          f"the fused {med * 1e3:.1f}ms; launches {u_launches}")
    launches_by_path = {"swin_train": launches, "swin_unfused_backward": cu,
                        "swin_unfused_train": u_launches}
    return launches_by_path, {
        "launches_by_route": {"swin_train": train_routes,
                              "swin_unfused_backward": ru,
                              "swin_unfused_train": u_routes},
        "config": cfg.name, "params": n_params, "moe_params": n_moe,
        "batch": SWIN_BATCH, "steps": log, "step_times_s": times,
        "step_median_ms": med * 1e3, "images_per_s": SWIN_BATCH / med,
        "unfused_step_times_s": u_times,
        "unfused_step_median_ms": u_med * 1e3,
        "unfused_images_per_s": SWIN_BATCH / u_med,
        "peak_allocated_gb": peak / 1e9,
        "ablation_worst_grad_rel": worst}


def _t78_layer_checks(torch):
    """Phase T7/8's layer check: one MoE layer's forward and backward at
    Swin-MoE-Small's stage 2 (batch T78_BATCH, top-2 of 8, blk 128) from
    one fixed RouterOutput, through hexa (``espec.moe_mlp``: the kernels),
    megablocks and tutel (``core.baselines``: cuBLAS). Returns each
    comparison's worst error over its limit."""
    from repro_torch.common import ACTIVATIONS
    from repro_torch.core import baselines, espec
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import RouterOutput, route

    n, d, e, k = T78_BATCH * 196, 384, T78_EXPERTS, 2
    f = 4 * d
    gen = torch.Generator(device="cuda").manual_seed(14)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x0 = randn(n, d)
    r0 = route(x0, randn(d, e, scale=0.02), k)
    ws0 = (randn(e, d, f, scale=0.02), randn(e, f, scale=0.1),
           randn(e, f, d, scale=0.02), randn(e, d, scale=0.1))
    cot = randn(n, d)
    gelu = ACTIVATIONS["gelu"]
    names = ("y", "dx", "dw1", "db1", "dw2", "db2", "dgates")

    kept = {}

    def run(impl, **kw):
        """(y, grads of sum(y * cot) by x, w1, b1, w2, b2, gates). The
        first call of each impl records the bytes its forward leaves
        allocated besides y: what the layer keeps for its backward."""
        x = x0.clone().requires_grad_()
        ws = [w.clone().requires_grad_() for w in ws0]
        gates = r0.gates.clone().requires_grad_()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        if impl == "hexa":
            ri = build_reindex(r0.expert_idx, gates, e, 128)
            y = espec.moe_mlp(x, ri, *ws)
        else:
            g = gates * kw.pop("keep", 1.0)
            r = RouterOutput(r0.expert_idx, g, None, None, None)
            fn = (baselines.grouped_dense_moe if impl == "megablocks"
                  else baselines.dispatch_combine_moe)
            y = fn(x, r, *ws, act=gelu, **kw)
        torch.cuda.synchronize()
        kept.setdefault(impl, torch.cuda.memory_allocated() - before
                        - y.numel() * y.element_size())
        grads = torch.autograd.grad((y * cot).sum(), [x, *ws, gates])
        torch.cuda.synchronize()
        return [y.detach(), *grads]

    def worst_of(what, got, want):
        """The worst err / limit over the output and grads (raises past
        the limit)."""
        return max(err / tol for err, tol in (
            _check(f"T7/8 layer {what} {nm}", b, a, SWIN_KERNEL_TOL)
            for nm, a, b in zip(names, want, got)))

    hexa, mega = run("hexa"), run("megablocks")
    worst = {"megablocks_vs_hexa": worst_of("megablocks", mega, hexa)}
    ample = run("tutel", capacity_factor=float(e))   # C = N k / E * E
    for nm, a, b in zip(names, mega, ample):
        if not torch.equal(a, b):
            raise AssertionError(f"T7/8 layer: tutel at C = N k differs from "
                                 f"megablocks in {nm}")
    worst["tutel_ample_vs_megablocks"] = 0.0
    cap = baselines.tutel_capacity(n, k, e, 1.0)
    rank, _ = baselines._dispatch_ranks(r0.expert_idx, e)
    keep = rank < cap
    dropped = int((~keep).sum())
    if not dropped:
        raise AssertionError("T7/8 layer: the tight capacity dropped nothing")
    tight = run("tutel", capacity=cap)
    mega0 = run("megablocks", keep=keep.float())
    worst["tutel_tight_vs_megablocks_gates_0"] = worst_of(
        f"tutel C {cap}", tight, mega0)
    # T78_ACT_GB_PER_IMAGE's kept bytes at this layer: hexa none, the
    # baselines E C (D + 2F) + N k D floats (tutel at C = N k, as megablocks)
    formula = {"hexa": 0, "megablocks": (e * n * k * (d + 2 * f)
                                         + n * k * d) * 4}
    formula["tutel"] = formula["megablocks"]
    print(f"[t78] layer checks at stage 2 (N {n}, D {d}, F {f}, top-{k} of "
          f"{e}): worst err / limit {worst}; tutel at C {cap} drops "
          f"{dropped} of {n * k} copies; bytes the forward keeps for the "
          f"backward (measured / formula, MB): "
          + ", ".join(f"{i} {kept[i] / 1e6:.1f} / {formula[i] / 1e6:.1f}"
                      for i in ("hexa", "tutel", "megablocks")))
    return {**worst, "tight_capacity": cap, "tight_dropped": dropped,
            "kept_bytes": kept, "kept_bytes_formula": formula}


def _t78_predicted_gb(cfg, impl, n_params, batch):
    """The cell's predicted peak (GB), as T78_ACT_GB_PER_IMAGE says."""
    from repro_torch.core.baselines import tutel_capacity

    e, k = cfg.moe.num_experts, cfg.moe.top_k
    kept = transient = 0
    for s, depth in enumerate(cfg.depths):
        blocks = sum(cfg.is_moe_block(s, b) for b in range(depth))
        if not blocks:
            continue
        side = cfg.img_size // cfg.patch_size >> s
        n, d = batch * side * side, cfg.dims[s]
        f = int(cfg.mlp_ratio * d)
        if impl == "hexa":
            transient = max(transient, n * k * (2 * d + 4 * f) * 4)
            continue
        cap = n * k if impl == "megablocks" else tutel_capacity(n, k, e,
                                                                 1.25)
        kept += blocks * (e * cap * (d + 2 * f) + n * k * d) * 4
        transient = max(transient, e * cap * f * 4)
    return (16 * n_params + kept + transient) / 1e9 \
        + T78_ACT_GB_PER_IMAGE[cfg.name] * batch


def _t78_cell(torch, cfg, impl, batch):
    """One cell: a fresh seeded state and its predicted peak (a cell
    predicted past T78_PEAK_LIMIT_GB is not run); one warm-up step with the
    counting spies on (rows the expert GEMMs compute, the copies tutel
    drops, each MoE block's top-1 picks, the bytes allocated before the
    step and at the end of its forward), then T78_STEPS timed steps; the
    allocator's peaks (``torch.cuda.memory_stats``) at the end."""
    import math
    from repro_torch.common import tree_leaves
    from repro_torch.core import baselines, espec
    from repro_torch.models import swin
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pcfg = ParallelConfig(blk=128)
    opt_cfg = adamw.OptimizerConfig(master_fp32=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = swin.init_swin(cfg, generator=gen, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    predicted = _t78_predicted_gb(cfg, impl, n_params, batch)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    tag = (f"{cfg.name} {cfg.moe.num_experts} experts top-{cfg.moe.top_k} "
           f"batch {batch} {impl}{' (TF32 cuBLAS)' if tf32 else ''}")
    cell = {"config": cfg.name, "experts": cfg.moe.num_experts,
            "top_k": cfg.moe.top_k, "impl": impl, "tf32": tf32,
            "batch": batch, "params": n_params,
            "predicted_peak_gb": predicted}
    if predicted > T78_PEAK_LIMIT_GB:
        print(f"[t78] {tag}: not run: predicted {predicted:.2f} GB")
        return {**cell, "not_run": f"predicted {predicted:.2f} GB"}
    print(f"[t78] {tag}: predicted peak {predicted:.2f} GB")
    opt_state = adamw.init_opt_state(params, opt_cfg)
    batches = [swin.synthetic_batch(cfg, batch, generator=gen, device="cuda")
               for _ in range(T78_STEPS + 1)]
    anatomy = {}
    real_loss = swin.make_loss_fn

    def make_loss_fn(*a, **kw):
        fn = real_loss(*a, **kw)

        def loss_fn(*a, **kw):
            out = fn(*a, **kw)
            if "saved_gb" not in anatomy:          # the warm-up's forward
                torch.cuda.synchronize()
                anatomy["saved_gb"] = (torch.cuda.memory_allocated() / 1e9
                                       - anatomy["state_gb"])
            return out

        return loss_fn

    swin.make_loss_fn = make_loss_fn
    try:
        train_step = swin.make_train_step(cfg, pcfg, opt_cfg, moe_impl=impl)
    finally:
        swin.make_loss_fn = real_loss

    def run(i):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = train_step(params, opt_state, *batches[i])
        m = {key: float(v) for key, v in m.items()}
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    count = {"rows": 0, "dropped": 0, "picks": []}
    real = (espec.route, swin.route, espec.build_reindex,
            baselines.dispatch_combine_moe)

    def picking(*a, **kw):
        r = real[0](*a, **kw)
        count["picks"].append(r.expert_idx[:, 0].cpu())
        return r

    def reindexing(*a, **kw):
        ri = real[2](*a, **kw)
        count["rows"] += int(ri.padded_counts.sum())
        return ri

    def dispatching(x, r, w1, *a, capacity=None, capacity_factor=1.25,
                    **kw):
        n, k = r.expert_idx.shape
        e = w1.shape[0]
        cap = capacity or baselines.tutel_capacity(n, k, e, capacity_factor)
        rank, _ = baselines._dispatch_ranks(r.expert_idx, e)
        count["rows"] += e * cap
        count["dropped"] += int((rank >= cap).sum())
        return real[3](x, r, w1, *a, capacity=cap, **kw)

    espec.route = swin.route = picking
    espec.build_reindex = reindexing
    baselines.dispatch_combine_moe = dispatching
    try:
        torch.cuda.synchronize()
        anatomy["state_gb"] = torch.cuda.memory_allocated() / 1e9
        first, _ = run(0)                 # warm-up, counted, untimed
        anatomy["warmup_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        (espec.route, swin.route, espec.build_reindex,
         baselines.dispatch_combine_moe) = real
    times, log = [], [first]
    for i in range(1, T78_STEPS + 1):
        m, dt = run(i)
        times.append(dt)
        log.append(m)
    peak = torch.cuda.max_memory_allocated() / 1e9
    stats = torch.cuda.memory_stats()
    anatomy.update({f"{key.split('_bytes')[0]}_peak_gb":
                    stats.get(f"{key}.all.peak", 0) / 1e9 for key in (
                        "allocated_bytes", "requested_bytes",
                        "reserved_bytes", "inactive_split_bytes")})
    anatomy["alloc_retries"] = stats.get("num_alloc_retries", 0)
    if not all(math.isfinite(m["loss"]) for m in log):
        raise AssertionError(f"T7/8 {tag}: non-finite loss {log}")
    med = statistics.median(times)
    del params, opt_state, batches
    return {**cell, "step_median_ms": med * 1e3, "step_times_s": times,
            "images_per_s": batch / med, "peak_allocated_gb": peak,
            "memory": anatomy,
            "expert_rows_per_step": count["rows"],
            "dropped_copies_per_step": count["dropped"],
            "first_loss": first["loss"], "losses": [m["loss"] for m in log],
            "picks": count["picks"]}


def _t78_point(torch, cfg, batch):
    """One grid point through the three implementations: their cells, and
    hexa's speed-up over and memory share of each baseline that ran; hexa's
    and megablocks' first losses (the same weights and images) within
    T78_LOSS_RTOL where both ran."""
    row = {}
    for impl in T78_IMPLS:
        c = row[impl] = _t78_cell(torch, cfg, impl, batch)
        if "not_run" not in c:
            print(f"[t78] {cfg.name} top-{cfg.moe.top_k} batch {batch} "
                  f"{impl}: step {c['step_median_ms']:.1f} ms, "
                  f"{c['images_per_s']:.1f} images/s, peak "
                  f"{c['peak_allocated_gb']:.2f} GB (predicted "
                  f"{c['predicted_peak_gb']:.2f}; state "
                  f"{c['memory']['state_gb']:.2f}, kept by the forward "
                  f"{c['memory']['saved_gb']:.2f}), expert rows a step "
                  f"{c['expert_rows_per_step']}, dropped copies "
                  f"{c['dropped_copies_per_step']}, first loss "
                  f"{c['first_loss']!r}")
    h, mb = row["hexa"], row["megablocks"]
    s_ = {"config": cfg.name, "experts": cfg.moe.num_experts,
          "top_k": cfg.moe.top_k, "batch": batch,
          "not_run": [i for i, c in row.items() if "not_run" in c]}
    if "not_run" not in h and "not_run" not in mb:
        rel = abs(h["first_loss"] - mb["first_loss"]) / abs(mb["first_loss"])
        if len(h["picks"]) != len(mb["picks"]) or not rel <= T78_LOSS_RTOL:
            raise AssertionError(f"T7/8 {cfg.name} top-{cfg.moe.top_k} batch "
                                 f"{batch}: first loss hexa "
                                 f"{h['first_loss']} vs megablocks "
                                 f"{mb['first_loss']} (rel {rel})")
        s_["first_loss_rel_diff_hexa_megablocks"] = rel
        s_["top1_flips_per_moe_block"] = [
            int((a != b).sum()) for a, b in zip(h["picks"], mb["picks"])]
    for b in ("tutel", "megablocks"):
        if "not_run" in h or "not_run" in row[b]:
            continue
        s_[f"speedup_vs_{b}"] = (row[b]["step_median_ms"]
                                 / h["step_median_ms"])
        s_[f"memory_share_of_{b}"] = (h["peak_allocated_gb"]
                                      / row[b]["peak_allocated_gb"])
    parts = [f"hexa {s_[f'speedup_vs_{b}']:.3f} x {b}'s speed and "
             f"{s_[f'memory_share_of_{b}']:.3f} of its peak"
             for b in ("tutel", "megablocks") if f"speedup_vs_{b}" in s_]
    if "top1_flips_per_moe_block" in s_:
        parts.append(f"first losses "
                     f"{s_['first_loss_rel_diff_hexa_megablocks']:.3e} apart,"
                     f" tokens whose top-1 pick differs a MoE block "
                     f"{s_['top1_flips_per_moe_block']}")
    if s_["not_run"]:
        parts.append(f"not run: {s_['not_run']}")
    print(f"[t78] {cfg.name} {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k} batch {batch}: " + "; ".join(parts))
    return row, s_


def _t78_axis(points):
    """An axis's hexa-vs-baseline ratios at each point, and each ratio's
    growth from the first to the last point that has it."""
    out = {}
    for key in ("speedup_vs_tutel", "speedup_vs_megablocks",
                "memory_share_of_tutel", "memory_share_of_megablocks"):
        vals = [p.get(key) for p in points]
        have = [v for v in vals if v is not None]
        out[key] = vals
        out[f"{key}_last_over_first"] = (have[-1] / have[0]
                                         if len(have) > 1 else None)
    return out


def tables78_phase(torch):
    """Phase T7/8: the paper's Tables 7/8 (peak memory and step time of
    hexa against tutel and megablocks) on the card: Swin-MoE-Small (and
    -Base where T78_CONFIGS names it) at full width and depth, f32, at
    every point of T78_AXES (a
    point shared by two axes runs once); every cell one warm-up and
    T78_STEPS timed steps; then tutel and megablocks on Small at 8 experts,
    top-1, batch 64 once more with TF32 allowed in cuBLAS. The layer checks
    run first."""
    from repro_torch.configs import swin_moe_base, swin_moe_small

    t0 = time.perf_counter()
    layer = _t78_layer_checks(torch)
    torch.cuda.empty_cache()
    models = {"swin_moe_small": swin_moe_small.CONFIG,
              "swin_moe_base": swin_moe_base.CONFIG}
    points, cells, axes = {}, [], {}
    for axis, grid in T78_AXES.items():
        for key, e, k, batch in grid:
            if (key, e, k, batch) not in points:
                cfg = swin_moe_small.with_experts(models[key], e, k)
                row, s_ = _t78_point(torch, cfg, batch)
                points[key, e, k, batch] = s_
                cells += row.values()
        axes[axis] = _t78_axis([points[p] for p in grid])
        print(f"[t78] axis {axis} {[p[1:] for p in grid]} (experts, top-k, "
              f"batch): " + "; ".join(
                  f"{key} {[v and round(v, 3) for v in axes[axis][key]]} "
                  f"(last / first {axes[axis][f'{key}_last_over_first']:.3f})"
                  for key in ("speedup_vs_tutel", "speedup_vs_megablocks",
                              "memory_share_of_tutel",
                              "memory_share_of_megablocks")
                  if axes[axis][f"{key}_last_over_first"] is not None))
    small1 = swin_moe_small.with_experts(models["swin_moe_small"],
                                         T78_EXPERTS, 1)
    tf32_prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for impl in ("tutel", "megablocks"):
            c = _t78_cell(torch, small1, impl, T78_BATCH)
            cells.append(c)
            if "not_run" not in c:
                print(f"[t78] {small1.name} top-1 {impl} with TF32 cuBLAS: step "
                      f"{c['step_median_ms']:.1f} ms, "
                      f"{c['images_per_s']:.1f} images/s, peak "
                      f"{c['peak_allocated_gb']:.2f} GB")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_prev
    for c in cells:
        c.pop("picks", None)
    ran = [c for c in cells if "not_run" not in c]
    print(f"[t78] {len(ran)} cells run, {len(cells) - len(ran)} not run "
          f"(predicted past {T78_PEAK_LIMIT_GB} GB), in "
          f"{time.perf_counter() - t0:.1f}s")
    return {"layer_checks": layer, "cells": cells,
            "summary": list(points.values()), "axes": axes}


def _sdpa_ms(torch, flush, q, k, v, causal):
    """The library yardstick: ``scaled_dot_product_attention`` on (B, H, S,
    hd) views, under the first backend of flash, efficient, cuDNN and math
    that takes these inputs. Returns (output, ms, backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel(backend), warnings.catch_warnings():
            warnings.simplefilter("ignore")   # a refusal warns, then raises
            try:
                out = call()
                torch.cuda.synchronize()
            except RuntimeError:       # this backend refused the inputs
                continue
            return out.transpose(1, 2), time_ms(torch, call, flush), \
                backend.name
    raise AssertionError("scaled_dot_product_attention: no backend ran")


def _flash_route(dtype):
    """The route phase 12 expects: bf16 on the tensor cores, f32 on FMA."""
    return "wgmma" if dtype == "bfloat16" else "simt"


def _flash_p_bf16(torch, q, k, v, causal):
    """The negative control of the split P V: softmax attention with f32
    logits, m and l, but p rounded to bf16 before P V (no lo term)."""
    from repro_torch.kernels.flash_attention import NEG_INF

    s, hd = q.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(g, 2).transpose(1, 2)
              for t in (k, v))
    logits = qf @ kf.transpose(-1, -2) * hd ** -0.5
    if causal:
        logits.masked_fill_(torch.ones((s, s), dtype=torch.bool,
                                       device=q.device).triu(1), NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    del logits
    return ((p.bfloat16().float() @ vf) / l).to(q.dtype).transpose(1, 2)


def flash_cases(torch, flush):
    """Phase 12: flash_attention at full attention widths. Its public entry
    point is its path (no model path runs it): each case goes through it
    once with the launch counts set to 0 before and read after (bf16 on
    the wgmma route, f32 on simt); then each output is held against the
    plain version, and timed; the head case's plain output with p in bf16
    (no lo term) must fail the check the kernel meets."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import chunked_attention

    gen = torch.Generator(device="cuda").manual_seed(12)
    fn = fa.flash_attention

    def inputs(b, s, hq, hkv, hd, dtype):
        td = getattr(torch, dtype)
        return [torch.randn((b, s, h, hd), generator=gen, device="cuda")
                .to(td) for h in (hq, hkv, hkv)]

    def check_route(what, dtype, route):
        if route != _flash_route(dtype):
            raise AssertionError(f"{what}: took the {route} route, not "
                                 f"{_flash_route(dtype)}")

    args = [inputs(*c[1:7]) for c in FLASH_CASES]
    fn.launches = 0
    fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
    outs, case_routes = [], []
    for a, c in zip(args, FLASH_CASES):
        before = dict(fn.launches_by_route)
        outs.append(fn(*a, causal=c[7]))
        case_routes.append(next(r for r in before
                                if fn.launches_by_route[r] != before[r]))
    torch.cuda.synchronize()
    launches, routes = fn.launches, dict(fn.launches_by_route)
    if launches != len(FLASH_CASES):
        raise AssertionError(f"flash_attention: {launches} launches for "
                             f"{len(FLASH_CASES)} calls")
    want = {r: sum(_flash_route(c[6]) == r for c in FLASH_CASES)
            for r in routes}
    if routes != want:
        raise AssertionError(f"flash_attention: routes {routes}, expected "
                             f"{want}")
    negative = []

    cases = []
    for i, ((name, b, s, hq, hkv, hd, dtype, causal), (q, k, v), kern) in \
            enumerate(zip(FLASH_CASES, args, outs)):
        what = f"flash_attention {name}"
        check_route(what, dtype, case_routes[i])
        plain = fa.flash_attention_plain(q, k, v, causal=causal)
        err, ratio, lim = _check_flash(what, kern, plain, dtype)
        extra = {}
        if i == 0:                     # the head case
            with torch.no_grad():
                chunked = chunked_attention(q, k, v, causal=causal)
            extra["chunked_attention_err"], extra[
                "chunked_attention_err_over_tol"], _ = _check_flash(
                    what + " vs chunked_attention", kern, chunked, dtype)
            wrong = _flash_p_bf16(torch, q, k, v, causal)
            neg_err, neg_ratio, _ = _flash_err(wrong, plain, dtype)
            if not neg_ratio > 1.0:
                raise AssertionError(f"negative control {what} with p in "
                                     f"bf16 passed the limit ({neg_ratio})")
            negative.append({"kernel": "flash_attention",
                             "fault": "p rounded to bf16 before P V (no lo "
                                      "term)", "err_over_tol": neg_ratio})
            del chunked, wrong
        lib, lib_ms, backend = _sdpa_ms(torch, flush, q, k, v, causal)
        # SDPA read by the same check, for the record (it is no port)
        extra["library_max_abs_err"], extra["library_err_over_tol"], _ = \
            _flash_err(lib, plain, dtype)
        itemsize = q.element_size()
        pairs = s * (s + 1) // 2 if causal else s * s     # live (q, k) pairs
        b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * itemsize,
                           4 * b * hq * pairs * hd, dtype)
        cases.append({
            "shape": {"case": name, "B": b, "S": s, "Hq": hq, "Hkv": hkv,
                      "hd": hd, "causal": causal},
            "dtype": dtype, "kernel_route": case_routes[i],
            "max_abs_err": err, "err_over_tol": ratio, "tolerance": lim,
            "kernel_ms": time_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=causal), flush),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=causal), flush, iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": f"torch scaled_dot_product_attention ({backend})",
            **extra})
        print(f"[flash] {name}: err {err:.3g} ({ratio:.3f} x limit), "
              f"SDPA {extra['library_err_over_tol']:.3f} x limit")
        del plain, lib

    # untimed: f32 causal at the head shape and at hd 256 (each kernel
    # instance of hd 256 runs), and S not a multiple of the kernels' q
    # blocks or kv tiles, on both routes and every head dim
    for b, s, hq, hkv, hd, dtype, causal in FLASH_CHECK_CASES:
        q, k, v = inputs(b, s, hq, hkv, hd, dtype)
        what = f"flash_attention B {b} S {s} hd {hd} {dtype} causal={causal}"
        kern, route = _routed(torch, lambda: fa.flash_attention(
            q, k, v, causal=causal), fn)
        check_route(what, dtype, route)
        err, ratio, _ = _check_flash(
            what, kern, fa.flash_attention_plain(q, k, v, causal=causal),
            dtype)
        print(f"[flash] B {b} S {s} {hq}/{hkv} heads hd {hd} {dtype} "
              f"causal={causal}, {route}: err {err:.3g} ({ratio:.3f} x "
              f"limit)")
        del q, k, v
    return launches, routes, cases, negative


# ---------------------------------------------------------------------------
# the quantized serving slice: int8/fp8 expert weights, int8 KV pages
# ---------------------------------------------------------------------------

_NO_LIBRARY_Q = ("none: torch._scaled_mm takes fp8 operands with one "
                 "per-tensor or row-wise scale and no expert index; no one "
                 "PyTorch call computes it")


def _tiled_weights(torch, gen, shape, tile=128):
    """Random expert weights whose 128 x 128 tiles differ in magnitude
    (2^-2 .. 2^2 of 0.02): a scale read from another tile then shows."""
    e, a, b = shape
    w = torch.randn(shape, generator=gen, device="cuda") * 0.02
    f = torch.exp2(torch.rand((e, -(-a // tile), -(-b // tile)),
                              generator=gen, device="cuda") * 4 - 2)
    return w * f.repeat_interleave(tile, 1)[:, :a].repeat_interleave(
        tile, 2)[:, :, :b]


def _scale_transposed(s):
    """A block-scale grid read on the wrong axes: its transpose, reshaped
    back to its shape (the negative control of every 8-bit branch)."""
    return s.transpose(1, 2).reshape(s.shape).contiguous()


def _quant_counts(*fns):
    return {fn.__name__: dict(fn.launches_quant) for fn in fns}


def _reset_quant(*fns):
    for fn in fns:
        fn.launches_quant = dict.fromkeys(fn.launches_quant, 0)


def quant_kernel_cases(torch, flush):
    """Phase Q1: each 8-bit branch against its plain version on the card:
    esffn_glu int8/fp8 at the serve decode and prefill-chunk shapes,
    paged_attention over int8 pools at the serve phase's lengths, esmm
    int8/fp8 in both orientations at the LM expert shapes (simt route),
    esffn_mlp int8 at Swin-MoE-Small's stage 2; and per branch a negative
    control: the plain output with a scale grid read on the wrong axes
    must fail the limit."""
    from repro_torch.core.reindex import build_reindex, gather_rows
    from repro_torch.core.routing import route
    from repro_torch.kernels import esffn, esmm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.quant.core import quantize_blockwise

    res = {"esffn_glu": [], "paged_attention": [], "esmm": [],
           "esffn_mlp": [], "negative_controls": []}

    def neg(kernel, fault, name, wrong, plain, tol_rel):
        res["negative_controls"].append({
            "kernel": kernel, "fault": fault,
            "err_over_tol": _must_fail(name, wrong, plain, tol_rel)})

    # esffn_glu: qwen3-moe-30b-a3b's experts, top-8, blk 16 (as served)
    d, e, f, k = 2048, 128, 768, 8
    gen = torch.Generator(device="cuda").manual_seed(21)
    w32 = [_tiled_weights(torch, gen, s) for s in ((e, d, f), (e, d, f),
                                                   (e, f, d))]
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    for i, (n, blk, dtype, mode) in enumerate((
            (8, 16, "bfloat16", "int8"), (8, 16, "bfloat16", "fp8"),
            (16, 16, "bfloat16", "int8"), (16, 16, "bfloat16", "fp8"),
            (8, 16, "float32", "int8"))):
        td = getattr(torch, dtype)
        qs = [quantize_blockwise(w, mode=mode) for w in w32]
        wq, sc = [q for q, _ in qs], tuple(s for _, s in qs)
        x = torch.randn((n, d), generator=gen, device="cuda").to(td)
        r = route(x, router, k)
        ri = build_reindex(r.expert_idx, r.gates, e, blk)
        args = (x, ri.row_token, ri.row_gate, ri.block_expert, *wq)
        name = f"esffn_glu {mode} N={n} blk={blk} {dtype}"
        plain = esffn.esffn_glu_plain(*args, w_scales=sc)
        before = dict(esffn.esffn_glu.launches_quant)
        kern, kroute = _routed(torch, lambda: esffn.esffn_glu(
            *args, w_scales=sc), esffn.esffn_glu)
        if esffn.esffn_glu.launches_quant[mode] != before[mode] + 1:
            raise AssertionError(f"{name}: not counted as an {mode} launch")
        if kroute != "stream":
            raise AssertionError(f"{name}: took the {kroute} route")
        err, tol = _check(name, kern, plain, ESFFN_TOL[dtype])
        if i == 0:
            neg("esffn_glu", "w_down's scale grid transposed",
                name + " with sd transposed", esffn.esffn_glu_plain(
                    *args, w_scales=sc[:2] + (_scale_transposed(sc[2]),)),
                plain, ESFFN_TOL[dtype])
        live = (ri.row_gate.reshape(-1, blk) != 0).any(dim=1)
        experts = torch.unique(ri.block_expert[live]).numel()
        s_, np_rows = x.element_size(), ri.row_token.numel()
        nbytes = (n * d * s_ + experts * 3 * d * f
                  + experts * sum(s[0].numel() for s in sc) * 4
                  + np_rows * 8 + ri.block_expert.numel() * 4
                  + np_rows * d * s_)
        flops = 6 * int((ri.row_gate != 0).sum()) * d * f
        b_ms, b_by = bound(nbytes, flops, dtype)
        res["esffn_glu"].append({
            "shape": {"N": n, "D": d, "E": e, "F": f, "top_k": k, "blk": blk,
                      "Np": np_rows, "live_blocks": int(live.sum()),
                      "experts_read": experts},
            "dtype": dtype, "weights": mode, "kernel_route": kroute,
            "max_abs_err": err, "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: esffn.esffn_glu(
                *args, w_scales=sc), flush),
            "plain_ms": time_ms(torch, lambda: esffn.esffn_glu_plain(
                *args, w_scales=sc), flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": _NO_LIBRARY_Q})
        del qs, wq, sc, plain, kern
    del w32

    # paged_attention: phase 3's slots, lengths and shared page, int8 rows
    # whose magnitudes differ by row and head (2^-2 .. 2^2)
    b, hq, hkv, hd, page = 8, 32, 4, 128, 16
    lengths_l = [0, 1, 9, 16, 17, 24, 100, 250]
    maxp = 16
    for i, dtype in enumerate(("bfloat16", "float32")):
        args, scales = _paged_inputs(torch, gen, b, hq, hkv, hd, page,
                                     lengths_l, maxp, dtype, "int8")
        ks, vs = scales["k_scale"], scales["v_scale"]
        for window, softcap in ((None, 0.0), (32, 30.0)):
            kw = dict(scales, window=window, softcap=softcap)
            name = f"paged_attention int8 {dtype} window={window}"
            kern, plain, err, tol, worst = _paged_check(torch, name, args, kw,
                                                        dtype)
            if i == 0 and window is None:
                neg("paged_attention", "the kv heads' scales swapped",
                    name + " with the heads' scales rolled",
                    pa.paged_attention_ref(
                        *args, **{**kw, "k_scale": ks.roll(1, 2),
                                  "v_scale": vs.roll(1, 2)}),
                    plain, ATTN_TOL[dtype])
            nbytes, flops = _paged_work(args, True, window)
            b_ms, b_by = bound(nbytes, flops, dtype)
            res["paged_attention"].append({
                "case": "serve lengths",
                "shape": {"B": b, "Hq": hq, "Hkv": hkv, "hd": hd,
                          "page": page, "maxp": maxp, "lengths": lengths_l,
                          "window": window, "softcap": softcap},
                "dtype": dtype, "kv": "int8", "max_abs_err": err,
                "tolerance": tol, "worst_slot_err_over_tol": worst,
                "kernel_ms": time_ms(torch, lambda: pa.paged_attention(
                    *args, **kw), flush),
                "plain_ms": time_ms(torch, lambda: pa.paged_attention_ref(
                    *args, **kw), flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library": "none: no one call takes the paged int8 layout"})
    del args, scales, ks, vs, kern, plain
    long_cases, long_neg = paged_long_case(torch, flush, kv="int8")
    res["paged_attention"] += long_cases
    res["negative_controls"].append(long_neg)
    res["paged_attention_checks"] = paged_check_cases(torch, "int8")

    # esmm: the LM expert GEMMs of the quantized backward (4 x 1024 tokens,
    # top-8, blk 128): g/u (K 2048 -> N 768), t = dys Wd^T (the same,
    # transposed) and dX = dg Wg^T (K 768 -> N 2048, transposed)
    n = TRAIN_BATCH * TRAIN_SEQ
    x, ri, _ = _sorted_layout(torch, n)
    np_rows, nblk = ri.row_token.numel(), ri.block_expert.numel()
    experts = int((ri.padded_counts > 0).sum())
    on = (ri.row_gate != 0)[:, None]
    wg = _tiled_weights(torch, gen, (e, d, f))
    wd = _tiled_weights(torch, gen, (e, f, d))
    for i, (dtype, mode, trans, w, k_dim, n_dim) in enumerate((
            ("bfloat16", "int8", False, wg, d, f),
            ("bfloat16", "int8", True, wd, d, f),
            ("bfloat16", "int8", True, wg, f, d),
            ("bfloat16", "fp8", False, wg, d, f),
            ("float32", "int8", False, wg, d, f),
            ("float32", "int8", True, wg, f, d))):
        td = getattr(torch, dtype)
        wq, sw = quantize_blockwise(w, mode=mode)
        xs = (gather_rows(x.to(td), ri.row_token) if k_dim == d else
              (torch.randn((np_rows, k_dim), generator=gen, device="cuda")
               * on).to(td))
        args, kw = (xs, wq, None, ri.block_expert), dict(
            w_scales=sw, transpose_rhs=trans)
        name = f"esmm {mode} {dtype} trans={trans} K {k_dim} N {n_dim}"
        plain = esmm.esmm_plain(*args, **kw)
        kern, route = _routed(torch, lambda: esmm.esmm(*args, **kw),
                              esmm.esmm)
        if route != "mma_tf32x3":
            raise AssertionError(f"{name}: took the {route} route, not "
                                 f"mma_tf32x3")
        err, tol = _check(name, kern, plain, GEMM_TOL[dtype])
        if i == 0:
            neg("esmm", "W's scale grid transposed",
                name + " with the scale grid transposed",
                esmm.esmm_plain(*args, w_scales=_scale_transposed(sw),
                                transpose_rhs=trans), plain, GEMM_TOL[dtype])
        s_ = xs.element_size()
        nbytes = (np_rows * k_dim * s_ + experts * k_dim * n_dim
                  + experts * sw[0].numel() * 4 + nblk * 4
                  + np_rows * n_dim * s_)
        flops = 2 * np_rows * k_dim * n_dim
        # f32 xs: the route's 3xTF32 bound. bf16 xs: int8 / e4m3 and bf16
        # values are exact in bf16, so one bf16 pass with f32 sums a scale
        # block computes the function: its bound is the bf16 one, and the
        # route's own work (lo(x) = 0: two TF32 products) stands beside it.
        if dtype == "float32":
            b_ms, b_by = bound(nbytes, flops, dtype, route)
            beside = {}
        else:
            b_ms, b_by = bound(nbytes, flops, dtype)
            beside = {"bound_tf32x2_ms": bound(nbytes, flops, dtype,
                                               "mma_tf32x2")[0]}
        res["esmm"].append(_rates({
            "shape": {"N": n, "D": d, "E": e, "F": f, "top_k": 8, "blk": 128,
                      "Np": np_rows, "experts_with_rows": experts,
                      "K": k_dim, "Nout": n_dim, "transpose_rhs": trans},
            "dtype": dtype, "weights": mode, "kernel_route": route,
            "tf32_products": 3 if dtype == "float32" else 2,
            "max_abs_err": err, "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: esmm.esmm(*args, **kw),
                                 flush),
            "plain_ms": time_ms(torch, lambda: esmm.esmm_plain(*args, **kw),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by,
            **beside, **_fma_bound(route, nbytes, flops),
            "library_ms": None,
            "library": _NO_LIBRARY_Q}, nbytes, flops))
        del wq, sw, xs, plain, kern
    del x, ri, wg, wd

    # esffn_mlp: Swin-MoE-Small stage 2 at batch 128 (N 25,088, D 384,
    # F 1536, 8 experts top-1, blk 128), f32, both biases
    n, d2 = SWIN_BATCH * 196, 384
    f2 = 4 * d2
    x, ri, g2 = _swin_layout(torch, n, d2, seed=10)
    np_rows, nblk = ri.row_token.numel(), ri.block_expert.numel()
    experts = int((ri.padded_counts > 0).sum())
    live = int((ri.row_gate != 0).sum())
    w1, w2 = (_tiled_weights(torch, g2, s) for s in ((8, d2, f2),
                                                     (8, f2, d2)))
    b1 = torch.randn((8, f2), generator=g2, device="cuda") * 0.1
    b2 = torch.randn((8, d2), generator=g2, device="cuda") * 0.1
    for i, mode in enumerate(("int8", "fp8")):
        (q1, s1), (q2, s2) = (quantize_blockwise(w, mode=mode)
                              for w in (w1, w2))
        args = (x, ri.row_token, ri.row_gate, ri.block_expert, q1, b1, q2, b2)
        kw = dict(w_scales=(s1, s2))
        name = f"esffn_mlp {mode} stage 2 float32"
        plain = esffn.esffn_mlp_plain(*args, **kw)
        kern, kroute = _routed(torch, lambda: esffn.esffn_mlp(*args, **kw),
                               esffn.esffn_mlp)
        if kroute != "mma_tf32x3":
            raise AssertionError(f"{name}: took the {kroute} route")
        err, tol = _check(name, kern, plain, SWIN_KERNEL_TOL)
        if i == 0:
            neg("esffn_mlp", "W1's scale grid transposed",
                name + " with s1 transposed", esffn.esffn_mlp_plain(
                    *args, w_scales=(_scale_transposed(s1), s2)),
                plain, SWIN_KERNEL_TOL)
        nbytes = (n * d2 * 4 + experts * 2 * d2 * f2
                  + experts * (s1[0].numel() + s2[0].numel() + d2 + f2) * 4
                  + np_rows * 8 + nblk * 4 + np_rows * d2 * 4)
        flops = 4 * live * d2 * f2
        b_ms, b_by = bound(nbytes, flops, "float32", kroute)
        res["esffn_mlp"].append({
            "shape": {"stage": 2, "N": n, "D": d2, "F": f2, "E": 8,
                      "top_k": 1, "blk": 128, "Np": np_rows,
                      "live_rows": live},
            "dtype": "float32", "weights": mode, "kernel_route": kroute,
            "max_abs_err": err, "tolerance": tol,
            "bound_fma_ms": bound(nbytes, flops, "float32")[0],
            "kernel_ms": time_ms(torch, lambda: esffn.esffn_mlp(*args, **kw),
                                 flush),
            "plain_ms": time_ms(torch, lambda: esffn.esffn_mlp_plain(
                *args, **kw), flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": _NO_LIBRARY_Q})
        del plain, kern
    return res


def quant_reference_phase(torch):
    """Phase Q2: the quantized paths on the GPU against the CPU plain
    versions: a 2-layer full-width qwen3-moe-30b-a3b in f32 with int8
    experts and an int8 KV cache (greedy tokens equal); one loss forward
    and backward of it with the experts frozen (dX reaches the embeddings
    and routers through the 8-bit esmm backward); one Swin-MoE-Small
    forward at full width and depth with int8 MoE experts. The launches of
    each path are counted from 0. The CPU sides run on the CPU lane
    (``_quant_reference_cpu``)."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_map
    from repro_torch.configs import swin_moe_small
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.kernels import esffn, esmm, paged_attention
    from repro_torch.models import lm, swin
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.quant.core import quantize_ffn

    out = {"launches": {}}
    kernels = (esffn.esffn_glu, esffn.esffn_mlp, esmm.esmm,
               paged_attention.paged_attention)
    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(23)
    params = lm.init_params(cfg, generator=gen, device="cuda", quant="int8")
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(3)]
    _reset_quant(*kernels)
    served_tokens = _quant_reference_serve(cfg, params, "cuda", prompts)
    out["launches"]["reference_serve"] = _quant_counts(*kernels)
    if len(served_tokens) != 3 or any(len(o) != 4
                                      for o in served_tokens.values()):
        raise AssertionError(f"quant reference: GPU tokens {served_tokens}")
    served = out["launches"]["reference_serve"]
    if served["esffn_glu"]["int8"] <= 0 or \
            served["paged_attention"]["int8"] <= 0:
        raise AssertionError(f"quant reference: launches {served}")
    print(f"[quant-reference] 2-layer full-width f32, int8 experts + int8 "
          f"KV: GPU greedy tokens {served_tokens} (the CPU's on the lane); "
          f"launches {served}")

    # one loss forward + backward, experts frozen: grads of every float
    # leaf but the scales (embeddings, attention, norms, routers, head)
    batch = TokenSource(DataConfig(seq_len=64, global_batch=2,
                                   vocab_size=cfg.vocab_size,
                                   seed=25)).batch(0)
    _reset_quant(*kernels)
    esmm.esmm.launches_by_route = dict.fromkeys(
        esmm.esmm.launches_by_route, 0)
    tg, gg, leaf_names = _quant_reference_grads(cfg, params, batch, "cuda")
    torch.cuda.synchronize()
    out["launches"]["reference_backward"] = _quant_counts(*kernels)
    esmm_routes = dict(esmm.esmm.launches_by_route)
    back = out["launches"]["reference_backward"]
    # a layer: esffn_glu in the forward and again in remat's recompute,
    # esmm for g, u, t and the two dX products of the backward
    want = {"esffn_glu": 2 * cfg.num_layers, "esmm": 5 * cfg.num_layers}
    if {k: back[k]["int8"] for k in want} != want:
        raise AssertionError(f"quant reference backward: launches {back}, "
                             f"expected {want} int8")
    # every 8-bit esmm of the backward on the 3xTF32 tensor cores
    if esmm_routes != {"simt": 0, "wgmma": 0, "mma_tf32x3": want["esmm"]}:
        raise AssertionError(f"quant reference backward: esmm routes "
                             f"{esmm_routes}")
    out["esmm_routes_backward"] = esmm_routes
    print(f"[quant-reference] loss + grads, 2 x 64 tokens, int8 experts "
          f"frozen: total GPU {tg!r} ({len(gg)} grad leaves, incl. "
          f"{sum(n.endswith('router') for n in leaf_names)} routers; the "
          f"CPU's on the lane); launches {back}")
    out.update(loss_gpu=tg)

    # Swin-MoE-Small, full width and depth, int8 MoE experts: one forward
    scfg = swin_moe_small.CONFIG
    sgen = torch.Generator(device="cuda").manual_seed(26)
    sp = swin.init_swin(scfg, generator=sgen, device="cuda")
    for stage in sp["stages"]:
        for blk in stage["blocks"]:
            if "moe" in blk:
                blk["moe"] = quantize_ffn(blk["moe"], mode="int8")
    images, _ = swin.synthetic_batch(scfg, QUANT_SWIN_BATCH, generator=sgen,
                                     device="cuda")
    _reset_quant(*kernels)
    with torch.no_grad():
        logits = swin.swin_forward(sp, images, scfg, ParallelConfig(
            blk=128))[0].float().cpu()
    out["launches"]["reference_swin"] = _quant_counts(*kernels)
    n_moe = sum("moe" in blk for st in sp["stages"] for blk in st["blocks"])
    sw = out["launches"]["reference_swin"]
    if sw["esffn_mlp"]["int8"] != n_moe:
        raise AssertionError(f"quant swin: launches {sw}, expected {n_moe} "
                             f"int8 esffn_mlp")
    if not bool(logits.isfinite().all()):
        raise AssertionError("quant swin forward: non-finite output")
    print(f"[quant-reference] Swin-MoE-Small full width and depth, int8 MoE "
          f"experts, {QUANT_SWIN_BATCH} images: launches {sw} (the CPU's "
          f"logits on the lane)")
    cpu = {"lm": tree_map(lambda t: t.cpu(), params),
           "swin": tree_map(lambda t: t.cpu(), sp), "images": images.cpu()}
    card = {"tokens": served_tokens, "total": tg, "grads": gg,
            "logits": logits}
    _LANE.submit("Q2", _host_bytes(cpu) + _host_bytes(gg), _quant_reference_cpu,
                 cfg, scfg, cpu, prompts, batch, card)
    return out


def _quant_reference_serve(cfg, params, device, prompts):
    """Phase Q2's int8-KV ``PagedServer`` (2 slots, 3 requests of 8 + 4)."""
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import ParallelConfig

    server = serve.PagedServer(
        cfg, ParallelConfig(blk=16), num_slots=2, page_size=16,
        num_pages=9, max_pages_per_slot=4, params=params, kv_quant="int8",
        device=device)
    for i, pr in enumerate(prompts):
        server.submit(serve.Request(rid=i, prompt=pr, max_new=4))
    return {r.rid: r.out for r in server.run()}


def _quant_reference_grads(cfg, params, batch, device):
    """Phase Q2's loss forward and backward, experts frozen: the total, the
    grads (on the host) of every float leaf but the scales, their names."""
    import torch
    from repro_torch.common import tree_map
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to
    from repro_torch.parallel.sharding import ParallelConfig

    p = tree_map(lambda t: t.detach().to(device), params)
    named = [(n, t) for n, t in _named_leaves(p)
             if t.dtype == torch.float32 and not n.endswith("_scale")]
    leaves = [t.requires_grad_(True) for _, t in named]
    loss_fn = steps.make_loss_fn(cfg, ParallelConfig(blk=16))
    total, _ = loss_fn(p, batch_to(batch, device))
    grads = torch.autograd.grad(total, leaves)
    return (float(total.detach()), [g.cpu() for g in grads],
            [n for n, _ in named])


def _quant_reference_cpu(cfg, scfg, cpu, prompts, batch, card):
    """Phase Q2's CPU sides (the plain versions): the int8-KV engine's
    tokens on every request, the frozen-expert loss and grads within phase
    7's limits, the int8 Swin forward within SWIN_KERNEL_TOL."""
    import torch
    from repro_torch.models import swin
    from repro_torch.parallel.sharding import ParallelConfig

    tokens = _quant_reference_serve(cfg, cpu["lm"], "cpu", prompts)
    if tokens != card["tokens"]:
        raise AssertionError(f"quant reference: GPU tokens {card['tokens']}"
                             f" != CPU tokens {tokens}")
    tc, gc, _ = _quant_reference_grads(cfg, cpu["lm"], batch, "cpu")
    tg = card["total"]
    if not abs(tg - tc) <= TRAIN_LOSS_RTOL * abs(tc):
        raise AssertionError(f"quant reference: GPU loss {tg} vs CPU {tc}")
    worst = _grad_err(card["grads"], gc, TRAIN_GRAD_TOL, "quant reference")
    with torch.no_grad():
        logits = swin.swin_forward(cpu["swin"], cpu["images"], scfg,
                                   ParallelConfig(blk=128))[0].float()
    err, tol = _check("quant swin forward", card["logits"], logits,
                      SWIN_KERNEL_TOL)
    print(f"[quant-reference] CPU (plain versions): greedy tokens {tokens} "
          f"== the card's; loss + grads total GPU {tg!r} CPU {tc!r} (rel "
          f"diff {abs(tg - tc) / abs(tc):.3e}), worst max |diff| / max "
          f"|grad| {worst:.3e}; Swin logits max |diff| {err:.3e} (limit "
          f"{tol:.3e})")


def _named_leaves(tree, prefix=""):
    """(dotted name, leaf) of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree



def quant_serve_phase(torch, bf16_peak_gb):
    """Phase Q3: PagedServer on qwen3-moe-30b-a3b at full width and depth
    with int8 expert weights (quantized layer by layer as drawn) and int8
    KV pages, the serve phase's slots, pages and requests; then a few
    requests with fp8 expert weights. The 8-bit branches of esffn_glu and
    paged_attention must launch on every layer."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves
    from repro_torch.kernels import esffn, paged_attention
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = cfglib.get_config("qwen3-moe-30b-a3b")
    slots, page, max_seq = 8, 16, 128
    maxp = max_seq // page
    pcfg = ParallelConfig(blk=16)
    glu, pa = esffn.esffn_glu, paged_attention.paged_attention
    out = {}

    def make_server(params):
        return serve.PagedServer(
            cfg, pcfg, num_slots=slots, page_size=page,
            num_pages=slots * maxp // 2 + 1, max_pages_per_slot=maxp,
            params=params, prefill_chunk=16, kv_quant="int8", device="cuda")

    for mode, n_req in (("int8", QUANT_INT8_REQUESTS),
                        ("fp8", QUANT_FP8_REQUESTS)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = lm.init_params(cfg, generator=gen, device="cuda", quant=mode)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        n_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
        warm = make_server(params)      # allocator warm-up, unmeasured
        warm.submit(serve.Request(rid=-1, prompt=np.arange(8, dtype=np.int32),
                                  max_new=2))
        warm.run()
        del warm
        server = make_server(params)
        rng = np.random.default_rng(0)
        reqs = [serve.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, size=8).astype(
                np.int32), max_new=16) for i in range(n_req)]
        for r in reqs:
            server.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_quant(glu, pa)
        glu.launches_by_route = dict.fromkeys(glu.launches_by_route, 0)
        t0 = time.perf_counter()
        done = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _quant_counts(glu, pa)
        peak = torch.cuda.max_memory_allocated()
        tokens = sum(len(r.out) for r in done)
        steps = server.decode_times_s
        if len(done) != n_req or any(len(r.out) != 16 for r in done):
            raise AssertionError(f"quant serve {mode}: not every request "
                                 f"finished with 16 tokens")
        if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
            raise AssertionError(f"quant serve {mode}: token out of the "
                                 f"vocabulary")
        st = server.stats()
        if st["free_pages"] != st["num_pages"] - 1 or st["in_use_pages"]:
            raise AssertionError(f"quant serve {mode}: page pool leaked: "
                                 f"{st}")
        server.pool.assert_consistent()
        # every layer of every prefill chunk (one per 8-token prompt) and
        # decode step runs the 8-bit esffn_glu; every decode step's layers
        # read the int8 pages through paged_attention
        want = {"esffn_glu": cfg.num_layers * (n_req + len(steps)),
                "paged_attention": cfg.num_layers * len(steps)}
        got = {"esffn_glu": launches["esffn_glu"][mode],
               "paged_attention": launches["paged_attention"]["int8"]}
        if got != want:
            raise AssertionError(f"quant serve {mode}: 8-bit launches {got}, "
                                 f"expected {want}")
        routes = {"esffn_glu": dict(glu.launches_by_route)}
        if routes["esffn_glu"] != {"stream": want["esffn_glu"], "wgmma": 0}:
            raise AssertionError(f"quant serve {mode}: esffn_glu routes "
                                 f"{routes}")
        ttft = sorted(server.ttft_s.values())
        res = {"weights": mode, "kv": "int8", "requests": len(done),
               "tokens": tokens, "wall_s": wall,
               "decode_step_median_ms": statistics.median(steps) * 1e3,
               "decode_steps": len(steps),
               "tokens_per_s": tokens / wall,
               "ttft_median_ms": statistics.median(ttft) * 1e3,
               "peak_allocated_gb": peak / 1e9,
               "init_peak_allocated_gb": init_peak / 1e9,
               "bf16_serve_peak_allocated_gb": bf16_peak_gb,
               "weights_gb": n_bytes / 1e9, "init_s": init_s,
               "page_bytes": server.page_bytes,
               "bf16_page_bytes": lm.paged_kv_page_bytes(cfg, page),
               "launches": got, "launches_by_route": routes,
               "layers": cfg.num_layers}
        print(f"[quant-serve] {mode} experts + int8 KV, {cfg.num_layers} "
              f"layers at full width: {n_bytes / 1e9:.2f} GB of weights "
              f"(drawn and quantized layer by layer in {init_s:.1f}s, peak "
              f"{init_peak / 1e9:.2f} GB); {len(done)} requests, {tokens} "
              f"tokens in {wall:.3f}s ({tokens / wall:.1f} tok/s); decode "
              f"step median {res['decode_step_median_ms']:.2f}ms over "
              f"{len(steps)} steps; TTFT median {res['ttft_median_ms']:.1f}"
              f"ms; peak allocated {peak / 1e9:.2f} GB (bf16 serve phase: "
              f"{bf16_peak_gb:.2f} GB); page {server.page_bytes} B (bf16: "
              f"{res['bf16_page_bytes']} B); 8-bit launches {got}")
        print(f"  req 0: {done[0].out}")
        if not peak < bf16_peak_gb * 1e9 * 0.75:
            raise AssertionError(f"quant serve {mode}: peak {peak / 1e9} GB "
                                 f"is not well under the bf16 serve's "
                                 f"{bf16_peak_gb} GB")
        out[mode] = res
        del params, server, done
    return out


def train_reference_bf16_phase(torch):
    """Phase 7b: phase 7 in the working dtype: one loss_fn forward and
    backward of a 2-layer full-width model in bf16 at blk 128 (2 x 64
    tokens) on the GPU, where every esmm and estmm launch takes the wgmma
    route, and on the CPU (the plain versions, on the CPU lane:
    ``_bf16_reference_cpu``). The routers' top-k picks of both runs are
    recorded: a pick that differs sends a token's grads to another expert,
    which the limits below allow for."""
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_map
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.kernels import esffn, esmm, estmm
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2)
    pcfg = ParallelConfig(blk=128)
    routed = (esffn.esffn_glu, esmm.esmm, estmm.estmm)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    batch = TokenSource(DataConfig(seq_len=64, global_batch=2,
                                   vocab_size=cfg.vocab_size,
                                   seed=7)).batch(0)
    before = {fn.__name__: dict(fn.launches_by_route) for fn in routed}
    card = _bf16_loss_picks(cfg, pcfg, params, batch, "cuda")
    torch.cuda.synchronize()
    routes = {fn.__name__: {r: fn.launches_by_route[r]
                            - before[fn.__name__][r]
                            for r in fn.launches_by_route}
              for fn in routed}
    # esffn_glu: once a layer in the forward and again in remat's
    # recompute, every launch on wgmma
    want = {"esffn_glu": {"stream": 0, "wgmma": 2 * cfg.num_layers},
            "esmm": {"simt": 0, "wgmma": 5 * cfg.num_layers,
                     "mma_tf32x3": 0},
            "estmm": {"simt": 0, "wgmma": 3 * cfg.num_layers,
                      "mma_tf32x3": 0}}
    if routes != want:
        raise AssertionError(f"bf16 train reference: routes {routes}, "
                             f"expected {want}")
    cpu = tree_map(lambda t: t.cpu(), params)
    _LANE.submit("7b", 3 * _host_bytes(cpu), _bf16_reference_cpu, cfg, pcfg,
                 cpu, batch, card)
    print(f"[train-reference-bf16] 2-layer full-width bf16, blk 128, 2 x 64 "
          f"tokens: loss GPU {card[0]!r}, total GPU {card[1]!r} (the CPU's "
          f"on the lane); routes {routes}")
    return {"loss_gpu": card[0], "routes": routes}


def _bf16_loss_picks(cfg, pcfg, params, batch, device):
    """Phase 7b's ``loss_fn`` forward and backward from a copy of
    ``params`` on ``device``: loss, total, the grads (host, f32) and each
    router call's sorted top-k picks (host), recorded on this thread."""
    import torch
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.core import espec
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to

    picks, route = [], espec.route

    def recording(*a, **kw):
        r = route(*a, **kw)
        picks.append(torch.sort(r.expert_idx, dim=-1)[0].cpu())
        return r

    espec.route = _this_thread_only(recording, route)
    try:
        p = tree_map(lambda t: t.detach().to(device).requires_grad_(),
                     params)
        total, metrics = steps.make_loss_fn(cfg, pcfg)(
            p, batch_to(batch, device))
        grads = torch.autograd.grad(total, tree_leaves(p))
    finally:
        espec.route = route
    return (float(metrics["loss"].detach()), float(total.detach()),
            [g.float().cpu() for g in grads], picks)


def _bf16_reference_cpu(cfg, pcfg, cpu, batch, card):
    """Phase 7b's CPU side and its limits: the totals within
    BF16_REF_LOSS_RTOL and every grad leaf within BF16_REF_GRAD_TOL of its
    Frobenius norm; the tokens whose picks differ are printed."""
    lg, tg, gg, picks_g = card
    lc, tc, gc, picks_c = _bf16_loss_picks(cfg, pcfg, cpu, batch, "cpu")
    flips = [int((a != b).any(dim=-1).sum())
             for a, b in zip(picks_g, picks_c)]
    rel = abs(tg - tc) / abs(tc)
    worst_f, worst_max, worst_leaf = 0.0, 0.0, None
    for i, (a, b) in enumerate(zip(gg, gc)):
        norm = b.norm().item()
        f_rel = (a - b).norm().item() / norm if norm else 0.0
        m_rel = ((a - b).abs().max() / b.abs().max()).item() if norm else 0.0
        if f_rel > worst_f:
            worst_f, worst_leaf = f_rel, (i, tuple(b.shape))
        worst_max = max(worst_max, m_rel)
    print(f"[train-reference-bf16] 2-layer full-width bf16, blk 128, 2 x 64 "
          f"tokens: loss GPU {lg!r} CPU {lc!r}, total GPU {tg!r} CPU {tc!r} "
          f"(rel diff {rel:.3e}, limit {BF16_REF_LOSS_RTOL}); {len(gc)} grad "
          f"leaves, worst |diff| / |grad| (Frobenius) {worst_f:.3e} at leaf "
          f"{worst_leaf} (limit {BF16_REF_GRAD_TOL}), worst max |diff| / max "
          f"|grad| {worst_max:.3e} (not a limit); tokens whose top-k picks "
          f"differ, per layer: {flips}")
    if not rel <= BF16_REF_LOSS_RTOL:
        raise AssertionError(f"bf16 train reference: GPU total {tg} vs CPU "
                             f"{tc} (rel {rel})")
    if not worst_f <= BF16_REF_GRAD_TOL:
        raise AssertionError(f"bf16 train reference: grad leaf {worst_leaf}"
                             f" |diff| / |grad| {worst_f} > "
                             f"{BF16_REF_GRAD_TOL}")


def reference_phase(torch):
    """2 layers at full width in f32: the dense ``BatchedServer`` on the GPU
    must give the same greedy tokens as ``PagedServer`` and the batch-1
    ``reference_stream``, each on the GPU (kernels) and on the CPU (plain
    versions, on the CPU lane: ``_reference_cpu``), from the same weights.
    Returns the tokens and each card run's wall time."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_map
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    pcfg = ParallelConfig(blk=16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(3)]
    streams, wall = {}, {}
    for kind in ("dense", "paged", "reference_stream"):
        t0 = time.perf_counter()
        streams[f"{kind} cuda"] = _reference_engine(cfg, pcfg, kind, "cuda",
                                                    params, prompts)
        wall[f"{kind} cuda"] = time.perf_counter() - t0
    want = streams["dense cuda"]
    if len(want) != 3 or any(len(o) != 4 for o in want.values()) \
            or any(st != want for st in streams.values()):
        raise AssertionError(f"reference phase: greedy tokens differ: "
                             f"{streams}")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    _LANE.submit("4", _host_bytes(cpu_params), _reference_cpu, cfg, pcfg,
                 cpu_params, prompts, want)
    print(f"[reference] 2-layer full-width f32: dense BatchedServer == "
          f"PagedServer == reference_stream on the GPU, greedy tokens "
          f"{want} (the CPU's engines on the lane); wall s "
          f"{json.dumps(wall)}")
    return {"tokens": {str(k): v for k, v in want.items()},
            "engines": sorted(streams), "wall_s": wall}


def _reference_engine(cfg, pcfg, kind, device, p, prompts):
    """Phase 4's engines (2 slots, 3 requests of 8 + 4): greedy streams."""
    from repro_torch.launch import serve

    reqs = [serve.Request(rid=i, prompt=pr, max_new=4)
            for i, pr in enumerate(prompts)]
    if kind == "reference_stream":
        return {r.rid: serve.reference_stream(cfg, pcfg, p, r, max_seq=64)
                for r in reqs}
    if kind == "dense":
        server = serve.BatchedServer(cfg, pcfg, num_slots=2, max_seq=64,
                                     params=p, device=device)
    else:
        server = serve.PagedServer(
            cfg, pcfg, num_slots=2, page_size=16, num_pages=9,
            max_pages_per_slot=4, params=p, device=device)
    for r in reqs:
        server.submit(r)
    return {r.rid: r.out for r in server.run()}


def _reference_cpu(cfg, pcfg, cpu_params, prompts, want):
    """Phase 4's CPU side (the plain versions): ``PagedServer`` and
    ``reference_stream`` on every request give the card's tokens."""
    streams, wall = {}, {}
    for kind in ("paged", "reference_stream"):
        t0 = time.perf_counter()
        streams[f"{kind} cpu"] = _reference_engine(cfg, pcfg, kind, "cpu",
                                                   cpu_params, prompts)
        wall[f"{kind} cpu"] = time.perf_counter() - t0
    if any(st != want for st in streams.values()):
        raise AssertionError(f"reference phase: the CPU's greedy tokens "
                             f"{streams} != the card's {want}")
    print(f"[reference] PagedServer (CPU) == reference_stream (CPU) == the "
          f"card's greedy tokens {want}; wall s {json.dumps(wall)}")


def serve_phase(torch):
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves
    from repro_torch.kernels import esffn, paged_attention
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = cfglib.get_config("qwen3-moe-30b-a3b")
    if SERVE_DEPTH != cfg.num_layers:
        print(f"[serve] depth cut: {cfg.num_layers} -> {SERVE_DEPTH} layers")
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DEPTH)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, expert d_ff "
          f"{cfg.moe.d_ff}, vocab {cfg.vocab_size}: {n_bytes / 1e9:.2f} GB of "
          f"weights, initialised in {time.perf_counter() - t0:.1f}s")

    slots, page, max_seq = 8, 16, 128
    maxp = max_seq // page
    pcfg = ParallelConfig(blk=16)
    rng = np.random.default_rng(0)

    def make_server():
        return serve.PagedServer(
            cfg, pcfg, num_slots=slots, page_size=page,
            num_pages=slots * maxp // 2 + 1, max_pages_per_slot=maxp,
            params=params, prefill_chunk=16, device="cuda")

    warm = make_server()                 # cuBLAS/allocator warm-up, unmeasured
    warm.submit(serve.Request(rid=-1, prompt=np.arange(8, dtype=np.int32),
                              max_new=2))
    warm.run()
    del warm

    server = make_server()
    reqs = [serve.Request(
        rid=i, prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
        max_new=16) for i in range(16)]
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    esffn.esffn_glu.launches = 0
    esffn.esffn_glu.launches_by_route = dict.fromkeys(
        esffn.esffn_glu.launches_by_route, 0)
    paged_attention.paged_attention.launches = 0
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"esffn_glu": esffn.esffn_glu.launches,
                "paged_attention": paged_attention.paged_attention.launches}
    routes = {"esffn_glu": dict(esffn.esffn_glu.launches_by_route)}
    # blk 16: every expert FFN of the serve streams its weights
    if routes["esffn_glu"] != {"stream": launches["esffn_glu"], "wgmma": 0}:
        raise AssertionError(f"serve: esffn_glu routes {routes}")
    peak = torch.cuda.max_memory_allocated()

    tokens = sum(len(r.out) for r in done)
    steps = server.decode_times_s
    if len(done) != 16 or any(len(r.out) != 16 for r in done):
        raise AssertionError("serve: not every request finished with 16 tokens")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError("serve: token out of the vocabulary")
    st = server.stats()
    if st["free_pages"] != st["num_pages"] - 1 or st["in_use_pages"]:
        raise AssertionError(f"serve: page pool leaked: {st}")
    server.pool.assert_consistent()
    if min(launches.values()) <= 0:
        raise AssertionError(f"serve: a kernel never launched: {launches}")
    ttft = sorted(server.ttft_s.values())
    pool_bytes = server.pool.num_pages * server.page_bytes
    print(f"[serve] {len(done)} requests, {tokens} tokens in {wall:.3f}s "
          f"({tokens / wall:.1f} tok/s); decode step median "
          f"{statistics.median(steps) * 1e3:.2f}ms over {len(steps)} steps; "
          f"TTFT median {statistics.median(ttft) * 1e3:.1f}ms; peak allocated "
          f"{peak / 1e9:.2f} GB; launches {launches}; routes {routes}; pool "
          f"peak {st['peak_in_use_pages']} pages, leak-free")
    print(f"  req 0: {done[0].out}")
    paged_out = {r.rid: r.out for r in done}
    dense_launches, dense = _dense_serve(
        torch, cfg, pcfg, params, [r.prompt for r in reqs], paged_out,
        slots, max_seq, pool_bytes)
    spec_launches, spec_routes, spec_res = _spec_serve(
        torch, cfg, params, [r.prompt for r in reqs], make_server)
    prefix_launches, prefix_routes, prefix_res = _prefix_serve(
        torch, cfg, params)
    p2_launches, p2_routes, p2_res = _paged_mesh_serve(
        torch, cfg, pcfg, params, [r.prompt for r in reqs],
        statistics.median(steps) * 1e3)
    return {"serve": launches, "serve_dense": dense_launches,
            "serve_spec": {"esffn_glu": spec_launches},
            "paged_mesh_p2": p2_launches, **prefix_launches}, {
        "paged_mesh": p2_res, "paged_mesh_launches_by_route": p2_routes,
        "prefix": prefix_res, "prefix_launches_by_route": prefix_routes,
        "requests": len(done), "tokens": tokens, "wall_s": wall,
        "decode_step_median_ms": statistics.median(steps) * 1e3,
        "decode_steps": len(steps),
        "ttft_median_ms": statistics.median(ttft) * 1e3,
        "peak_allocated_gb": peak / 1e9,
        "launches_by_route": routes, "layers": cfg.num_layers,
        "pool_bytes": pool_bytes,
        "pool_peak_in_use_bytes": st["peak_in_use_bytes"], "dense": dense,
        "spec": spec_res, "spec_launches_by_route": {"esffn_glu": spec_routes}}


def _dense_serve(torch, cfg, pcfg, params, prompts, paged_out, slots,
                 max_seq, pool_bytes):
    """Phase 5's dense run: the same requests through ``BatchedServer``
    (``slots`` x ``max_seq`` KV rectangle) on the same weights, after one
    unmeasured warm-up request. Returns (launches, result)."""
    import numpy as np
    from repro_torch.kernels import esffn
    from repro_torch.launch import serve

    def make_server():
        return serve.BatchedServer(cfg, pcfg, num_slots=slots,
                                   max_seq=max_seq, params=params,
                                   device="cuda")

    warm = make_server()
    warm.submit(serve.Request(rid=-1, prompt=np.arange(8, dtype=np.int32),
                              max_new=2))
    warm.run()
    del warm
    server = make_server()
    for i, pr in enumerate(prompts):
        server.submit(serve.Request(rid=i, prompt=pr, max_new=16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    esffn.esffn_glu.launches = 0
    esffn.esffn_glu.launches_by_route = dict.fromkeys(
        esffn.esffn_glu.launches_by_route, 0)
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"esffn_glu": esffn.esffn_glu.launches}
    routes = {"esffn_glu": dict(esffn.esffn_glu.launches_by_route)}
    peak = torch.cuda.max_memory_allocated()
    if launches["esffn_glu"] <= 0 or routes["esffn_glu"] != {
            "stream": launches["esffn_glu"], "wgmma": 0}:
        raise AssertionError(f"serve (dense): esffn_glu launches {launches}, "
                             f"routes {routes}")
    if len(done) != len(prompts) or any(len(r.out) != 16 for r in done):
        raise AssertionError("serve (dense): not every request finished "
                             "with 16 tokens")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError("serve (dense): token out of the vocabulary")
    kv = server.kv_bytes()
    if not kv > pool_bytes:
        raise AssertionError(f"serve (dense): the KV rectangle ({kv} B) is "
                             f"not larger than the page pool ({pool_bytes} B)")
    # bf16 at 48 layers: the two attention paths round differently, so the
    # streams may part; equal tokens are asserted in f32 (phase 4)
    first_diff = {}
    for r in done:
        want = paged_out[r.rid]
        if r.out != want:
            first_diff[r.rid] = next(i for i, (a, b) in
                                     enumerate(zip(r.out, want)) if a != b)
    steps = server.decode_times_s
    ttft = sorted(server.ttft_s.values())
    tokens = sum(len(r.out) for r in done)
    res = {"requests": len(done), "tokens": tokens, "wall_s": wall,
           "tok_per_s": tokens / wall,
           "decode_step_median_ms": statistics.median(steps) * 1e3,
           "decode_steps": len(steps),
           "ttft_median_ms": statistics.median(ttft) * 1e3,
           "peak_allocated_gb": peak / 1e9, "kv_bytes": kv,
           "pool_bytes": pool_bytes, "slots": slots, "max_seq": max_seq,
           "launches_by_route": routes,
           "streams_equal_to_paged": len(done) - len(first_diff),
           "first_diff_position": first_diff}
    print(f"[serve-dense] {len(done)} requests, {tokens} tokens in "
          f"{wall:.3f}s ({tokens / wall:.1f} tok/s); macro-step median "
          f"{res['decode_step_median_ms']:.2f}ms over {len(steps)} steps; "
          f"TTFT median {res['ttft_median_ms']:.1f}ms; peak allocated "
          f"{peak / 1e9:.2f} GB; KV rectangle {kv / 1e6:.1f} MB ({slots} x "
          f"{max_seq}) vs the page pool's {pool_bytes / 1e6:.1f} MB; "
          f"launches {launches}, routes {routes}; {res['streams_equal_to_paged']}"
          f" of {len(done)} bf16 streams equal the paged engine's, the others "
          f"part at positions {first_diff}")
    return launches, res


# ---------------------------------------------------------------------------
# sampled and speculative decoding (phases S, 4s, 5s)
# ---------------------------------------------------------------------------

def sampling_phase(torch, flush):
    """Phase S: ``sample_rows`` on the card against the same function on
    the CPU, on seeded f32 rows (8, 151,936): keys, bits and uniforms bit
    for bit, Gumbel draws within ``GUMBEL_ULP`` ulp of max(|g|, 1), tokens
    equal; a key off by one in ``fold_in``'s data must give other bits;
    then timed at B 1 and 8 (sampled and greedy rows)."""
    import numpy as np
    from repro_torch.launch import sampling

    seeds, steps = list(SAMPLE_SEEDS), list(SAMPLE_STEPS)
    b, v = len(seeds), SAMPLE_VOCAB
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = torch.randn(b, v, generator=gen, device="cuda") * 2.0
    cpu_rows = rows.cpu()

    def keys(device, off=0):
        return sampling.fold_in(sampling.prng_key(seeds, device),
                                torch.tensor(steps, device=device) + off)

    kg, kc = keys("cuda"), keys("cpu")
    if not torch.equal(kg.cpu(), kc):
        raise AssertionError("sampling: keys differ between card and CPU")
    bits = sampling.random_bits(kc, v)
    if not torch.equal(sampling.random_bits(kg, v).cpu(), bits):
        raise AssertionError("sampling: random bits differ")
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0)):
        ug = sampling.uniform(kg, v, lo, hi).cpu()
        if not torch.equal(ug.view(torch.int32),
                           sampling.uniform(kc, v, lo, hi).view(torch.int32)):
            raise AssertionError(f"sampling: uniforms on [{lo}, {hi}) differ")
    gg = sampling.gumbel(kg, v).cpu().numpy()
    gc = sampling.gumbel(kc, v).numpy()
    ulp = np.spacing(np.maximum(np.abs(gc), np.float32(1.0)))
    gumbel_ulps = float((np.abs(gg - gc) / ulp).max())
    if not np.all(np.isfinite(gg)) or not gumbel_ulps <= GUMBEL_ULP:
        raise AssertionError(f"sampling: gumbel {gumbel_ulps} ulp apart")
    token_sets = {"t0.8": [0.8] * b, "t1.3": [1.3] * b,
                  "mixed": [0.0, 0.8, 1.3, 0.0, 0.8, 2.0, 0.0, 0.8]}
    tokens = {}
    for name, temps in token_sets.items():
        tg = sampling.sample_rows(rows, seeds, steps, temps).cpu()
        tc = sampling.sample_rows(cpu_rows, seeds, steps, temps)
        if not torch.equal(tg, tc):
            raise AssertionError(f"sampling: {name} tokens differ: "
                                 f"{tg.tolist()} vs {tc.tolist()}")
        tokens[name] = tg.tolist()
    # negative control: fold_in's data off by one must fail the bit check
    wrong = sampling.random_bits(keys("cuda", off=1), v).cpu()
    if torch.equal(wrong, bits):
        raise AssertionError("sampling: the off-by-one key gave equal bits")
    wrong_equal = float((wrong == bits).double().mean())
    times = {}
    for n in (1, b):
        r = rows[:n]
        for mode, temps in (("sampled", [0.8] * n), ("greedy", [0.0] * n)):
            times[f"B{n} {mode}"] = time_ms(
                torch, lambda: sampling.sample_rows(r, seeds[:n], steps[:n],
                                                    temps), flush)
        times[f"B{n} bound"] = n * v * 4 / HBM_BYTES_PER_S * 1e3
    res = {"rows": [b, v], "seeds": seeds, "steps": steps,
           "bits_equal": True, "uniforms_equal": True,
           "gumbel_max_ulp": gumbel_ulps, "gumbel_limit_ulp": GUMBEL_ULP,
           "tokens": tokens, "negative_control_equal_bits": wrong_equal,
           "ms": times}
    print(f"[sampling] (8, {v}) f32 rows: keys, bits and uniforms equal "
          f"card and CPU bit for bit; gumbel {gumbel_ulps:.3g} ulp of "
          f"max(|g|, 1) apart (limit {GUMBEL_ULP}); tokens equal "
          f"{tokens}; negative control (fold_in data + 1): "
          f"{wrong_equal:.2e} of the bits equal; ms (CUDA events, one "
          f"call, L2 flushed) {json.dumps(times)}")
    return res


def _spec_mix(prompts, max_new):
    """Greedy + seeded-temperature mix: odd rids sample at 0.8 with seed
    1000 + rid (tests/test_serve_parity.py's speculative matrix)."""
    return [dict(rid=i, prompt=p, max_new=max_new,
                 **({"temperature": 0.8, "seed": 1000 + i} if i % 2 else {}))
            for i, p in enumerate(prompts)]


def _audited(server):
    """``server`` with its page pool checked after every tick."""
    for name in ("_prefill_tick", "_decode_tick"):
        tick = getattr(server, name)

        def checked(done, tick=tick):
            out = tick(done)
            server.pool.assert_consistent()
            return out

        setattr(server, name, checked)
    return server


def _drained(server, what):
    st = server.stats()
    if st["free_pages"] != st["num_pages"] - 1 or st["in_use_pages"] \
            or st["reserved_pages"] or server.table.any():
        raise AssertionError(f"{what}: page pool leaked: {st}")
    server.pool.assert_consistent()


class _WrongDrafter:
    """Drafts ``(true + 1) % V``, ``true`` the non-speculative stream's
    token at that position: wrong by construction."""

    def __init__(self, mix, streams, vocab):
        self.plen = {r["rid"]: len(r["prompt"]) for r in mix}
        self.streams, self.vocab = streams, vocab

    def draft(self, history, k, rid=-1):
        pos = len(history) - self.plen[rid]
        return [(t + 1) % self.vocab for t in self.streams[rid][pos:pos + k]]


def spec_reference_phase(torch):
    """Phase 4s: 2 layers at full width in f32, 4 requests (odd rids
    sampled), ``max_new`` 6, k ``SPEC_K``, through ``PagedServer`` on the
    card: speculation on (``NGramDrafter``) == off == ``reference_stream``;
    a drafter wrong by construction accepts nothing and rolls back every
    drafted row, same streams; ``ModelDrafter`` with the target's own
    config and params accepts every greedy draft; the pool checked after
    every tick and drained; temperature 0.8 moves a token off greedy; the
    CPU's speculative engine (the plain versions, on the CPU lane) gives
    the card's streams."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_map
    from repro_torch.launch import serve, spec
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    pcfg = ParallelConfig(blk=16)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(7)
    mix = _spec_mix([rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
                     for _ in range(4)], 6)
    max_seq = 64

    def run(what, p, device, reqs, drafter=None):
        t0 = time.perf_counter()
        srv, out = _spec_reference_run(cfg, pcfg, what, p, device, reqs,
                                       drafter)
        wall[what] = time.perf_counter() - t0
        return srv, out

    wall = {}
    _, off = run("off", params, "cuda", mix)
    ref = {r["rid"]: serve.reference_stream(cfg, pcfg, params,
                                            serve.Request(**r),
                                            max_seq=max_seq) for r in mix}
    ngram, on = run("ngram", params, "cuda", mix, spec.NGramDrafter())
    if not on == off == ref:
        raise AssertionError(f"spec reference: streams differ: on {on}, "
                             f"off {off}, reference_stream {ref}")
    wrong, out = run("wrong", params, "cuda", mix,
                     _WrongDrafter(mix, off, cfg.vocab_size))
    sw = wrong.spec.stats()
    if out != off or not sw["drafted"] or sw["accepted_drafts"] \
            or sw["rollback_tokens"] != sw["drafted"] \
            or not any(ev[0] == "rollback" for ev in wrong.trace):
        raise AssertionError(f"spec reference: wrong drafter {sw}, streams "
                             f"{out} vs {off}")
    greedy = [r for r in mix if "temperature" not in r]
    drafter = spec.ModelDrafter(cfg, pcfg, params, max_seq=max_seq,
                                device="cuda")
    self_srv, out = run("model_self", params, "cuda", greedy, drafter)
    ss = self_srv.spec.stats()
    if out != {r["rid"]: off[r["rid"]] for r in greedy} \
            or not ss["drafted"] or ss["acceptance_rate"] != 1.0 \
            or drafter._state:
        raise AssertionError(f"spec reference: self-drafting {ss}")
    moved = sum(serve.greedy_reference(cfg, pcfg, params, r["prompt"], 6,
                                       max_seq=max_seq) != off[r["rid"]]
                for r in mix if "temperature" in r)
    if not moved:
        raise AssertionError("spec reference: temperature 0.8 moved no "
                             "stream off greedy")
    _LANE.submit("4s", _host_bytes(cpu_params), _spec_reference_cpu, cfg,
                 pcfg, cpu_params, mix, off)
    res = {"streams": {str(k): v for k, v in off.items()},
           "ngram": ngram.spec.stats(), "wrong": sw, "model_self": ss,
           "sampled_streams_off_greedy": moved, "wall_s": wall}
    print(f"[spec-reference] 2-layer full-width f32, k {SPEC_K}: NGram "
          f"speculation (card) == off == reference_stream (NGram on the "
          f"CPU on the lane), streams {off}; NGram {res['ngram']}; wrong "
          f"drafter {sw}; "
          f"self-drafting ModelDrafter {ss}; {moved} of 2 sampled streams "
          f"off greedy; pool checked every tick and drained; wall s "
          f"{json.dumps(wall)}")
    return res


def _spec_reference_run(cfg, pcfg, what, p, device, reqs, drafter=None):
    """Phase 4s's audited ``PagedServer`` (2 slots), speculating with
    ``drafter`` if one is given: the server and its streams, drained."""
    from repro_torch.launch import serve, spec

    srv = _audited(serve.PagedServer(
        cfg, pcfg, num_slots=2, page_size=16, num_pages=9,
        max_pages_per_slot=4, params=p, device=device))
    if drafter is not None:
        spec.SpecDecoder(srv, drafter, k=SPEC_K)
    for r in reqs:
        srv.submit(serve.Request(**r))
    out = {r.rid: r.out for r in srv.run()}
    _drained(srv, f"spec reference ({what})")
    if len(out) != len(reqs):
        raise AssertionError(f"spec reference ({what}): unfinished")
    return srv, out


def _spec_reference_cpu(cfg, pcfg, cpu_params, mix, off):
    """Phase 4s's CPU side: NGram speculation on the CPU (the plain
    versions) gives the card's streams on the whole mix."""
    from repro_torch.launch import spec

    _, cpu_on = _spec_reference_run(cfg, pcfg, "ngram cpu", cpu_params,
                                    "cpu", mix, spec.NGramDrafter())
    if cpu_on != off:
        raise AssertionError(f"spec reference: CPU streams {cpu_on} vs the "
                             f"card's {off}")
    print(f"[spec-reference] NGram speculation on the CPU == the card's "
          f"streams {off}")


def _shared_prefix_prompts(rng, vocab, own_lengths):
    """Prompts opening with one ``PREFIX_SHARED``-token prompt, each with a
    tail of its own of each of ``own_lengths`` tokens."""
    import numpy as np
    shared = rng.integers(0, vocab, size=PREFIX_SHARED)
    return [np.concatenate([shared, rng.integers(0, vocab, size=int(n))])
            .astype(np.int32) for n in own_lengths]


def prefix_reference_phase(torch):
    """Phase 4p: 2 layers at full width in f32 through the robust,
    prefix-sharing ``PagedServer`` on the card, every run audited after
    every scheduler step (``assert_page_invariants``) and drained after
    ``drop_prefix_cache``. Against the streams of the plain engine: the
    prefix cache (second-wave hits), half/half prefill/decode roles (one
    transfer a request), and one ``FaultPlan`` each for NaN logits (that
    request fails, its batchmates' streams stand), an engine-level error
    (one recovery), priority preemption (the victim replays) and a device
    dropout (the requests carry across the shrink); then
    ``make_page_copy_step`` on bf16 and int8 pools."""
    import numpy as np
    from types import SimpleNamespace
    from repro_torch import configs as cfglib
    from repro_torch.launch import serve, steps
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.runtime import faults

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    pcfg = ParallelConfig(blk=16)
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(23),
        device="cuda")
    rng = np.random.default_rng(24)
    reqs = [dict(rid=i, prompt=p, max_new=4) for i, p in enumerate(
        _shared_prefix_prompts(rng, cfg.vocab_size, rng.integers(
            1, 7, size=PREFIX_REF_REQUESTS)))]
    maxp = 128 // PREFIX_PAGE

    def run(reqs, *, slots=PREFIX_REF_SLOTS, num_pages=None, fault=None,
            **kw):
        server = serve.PagedServer(
            cfg, pcfg, num_slots=slots, page_size=PREFIX_PAGE,
            num_pages=num_pages or 1 + slots * maxp, max_pages_per_slot=maxp,
            params=params, prefill_chunk=PREFIX_PAGE, audit=True,
            device="cuda", **kw)
        for r in reqs:
            server.submit(serve.Request(**r))
        plan = faults.FaultPlan([faults.Fault(**fault)] if fault else [])
        with faults.scope(plan):
            done = server.run()
        if fault and len(plan.fired) != 1:
            raise AssertionError(f"prefix reference: {fault} fired "
                                 f"{plan.fired}")
        stats = server.stats()
        server.drop_prefix_cache()
        _drained(server, "prefix reference")
        return server, stats, {r.rid: r.out for r in done}

    def chunks(server):
        return sum(e[0] == "prefill_chunk" for e in server.trace)

    off, _, base = run(reqs)
    if len(base) != len(reqs) or any(len(o) != 4 for o in base.values()):
        raise AssertionError(f"prefix reference: plain engine {base}")
    out = {}
    on, st_on, streams = run(reqs, prefix_cache=True)
    hits = st_on["prefix"]["hit_tokens"]
    want_hits = PREFIX_SHARED * (len(reqs) - PREFIX_REF_SLOTS)
    if streams != base or hits < want_hits or chunks(on) >= chunks(off):
        raise AssertionError(f"prefix reference: cache on {streams} vs off "
                             f"{base}; {hits} hit tokens (want >= "
                             f"{want_hits}); chunks {chunks(on)} vs "
                             f"{chunks(off)}")
    out["prefix_cache"] = {"hit_tokens": hits, "prefill_chunks": chunks(on),
                           "prefill_chunks_off": chunks(off)}
    dis, _, streams = run(reqs, slots=4, disagg=True)
    if streams != base or dis.transfers != len(reqs) \
            or dis.roles != ["prefill", "prefill", "decode", "decode"]:
        raise AssertionError(f"prefix reference: disagg {streams}, "
                             f"{dis.transfers} transfers, roles {dis.roles}")
    out["disagg_transfers"] = dis.transfers
    nan, _, streams = run(reqs, max_retries=0, fault=dict(
        site="serve.logits", kind="nan", at=1, payload={"slot": 0}))
    if len(nan.failed) != 1:
        raise AssertionError(f"prefix reference: NaN watchdog failed "
                             f"{[(r.rid, r.error) for r in nan.failed]}")
    bad = nan.failed[0]
    if "non-finite decode logits" not in bad.error or bad.out \
            or streams != {k: v for k, v in base.items() if k != bad.rid} \
            or nan.engine_recoveries:
        raise AssertionError(f"prefix reference: NaN watchdog {streams}, "
                             f"failed {[(r.rid, r.error) for r in nan.failed]}")
    out["nan_failed_rid"] = bad.rid
    rec, _, streams = run(reqs, fault=dict(site="serve.decode",
                                           kind="error", at=1))
    if streams != base or rec.engine_recoveries != 1 or rec.aborts:
        raise AssertionError(f"prefix reference: engine recovery {streams}, "
                             f"{rec.engine_recoveries} recoveries")
    # two low-priority requests reserve the whole pool (4 pages each); a
    # higher-priority head preempts the younger once it decodes
    low = [dict(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=40)
                .astype(np.int32), max_new=20) for i in range(2)]
    prio = low + [dict(rid=2, prompt=rng.integers(
        0, cfg.vocab_size, size=10).astype(np.int32), max_new=4,
        priority=5)]
    _, _, prio_base = run(prio)
    pre, st_pre, streams = run(prio, num_pages=1 + 8, prefix_cache=True)
    victims = [e[1] for e in pre.trace if e[0] == "preempt"]
    if streams != prio_base or pre.preemptions != 1 or pre.failed \
            or len(victims) != 1 or pre.aborts \
            or st_pre["prefix"]["hit_tokens"] < PREFIX_PAGE:
        raise AssertionError(f"prefix reference: preemption {streams} vs "
                             f"{prio_base}, victims {victims}")
    out["preempted_rid"] = victims[0]
    drop, _, streams = run(
        reqs, slots=4, plan=SimpleNamespace(token_counts=(2, 1)),
        prefix_cache=True, fault=dict(site="serve.decode",
                                      kind="device_drop", at=2,
                                      payload={"survivors": [0]}))
    if streams != base or ("shrink", (0,)) not in drop.trace \
            or drop.pool.shares != [4 * maxp] or drop.failed:
        raise AssertionError(f"prefix reference: device dropout {streams}, "
                             f"shares {drop.pool.shares}")
    copies = {}
    for kv in (None, "int8"):
        bcfg = dataclasses.replace(cfg, dtype="bfloat16")
        cache = lm.init_paged_cache(bcfg, 2, 9, PREFIX_PAGE, "cuda",
                                    kv_quant=kv)
        gen = torch.Generator(device="cuda").manual_seed(25)
        for layer in cache["layers"]:
            for t in layer.values():
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda")
                        .mul_(40).clamp_(-127, 127))
        before = [{k: t.clone() for k, t in layer.items()}
                  for layer in cache["layers"]]
        cache = steps.make_page_copy_step(bcfg)(cache, 3, 7)
        for layer, was in zip(cache["layers"], before):
            for k, t in layer.items():
                keep = torch.ones(t.shape[0], dtype=torch.bool,
                                  device="cuda")
                keep[7] = False
                if not torch.equal(t[7], was[k][3]) \
                        or not torch.equal(t[keep], was[k][keep]):
                    raise AssertionError(f"page copy {kv or 'bf16'} {k}")
        copies[kv or "bfloat16"] = sorted(cache["layers"][0])
    out.update(page_copy_pools=copies, streams={
        str(k): v for k, v in base.items()},
        seconds=time.perf_counter() - t_phase)
    print(f"[prefix-reference] 2-layer full-width f32, {len(reqs)} requests "
          f"on a {PREFIX_SHARED}-token shared prompt: prefix cache, disagg, "
          f"NaN watchdog (rid {bad.rid} failed), engine recovery, priority "
          f"preemption, device dropout all token-equal to the plain engine; "
          f"{hits} hit tokens, prefill chunks {chunks(on)} vs {chunks(off)}; "
          f"page copy exact on {copies}; {out['seconds']:.1f}s")
    return out


def _prefix_serve(torch, cfg, params):
    """Phase 5p, on phase 5's 48-layer bf16 weights: ``PREFIX_SERVE_REQUESTS``
    requests of the ``PREFIX_SHARED``-token shared prompt and
    ``PREFIX_OWN`` tokens of their own, ``PREFIX_NEW`` new tokens, through
    ``PagedServer`` (8 slots, a pool that holds every slot's worst case)
    without and with the prefix cache, then with ``disagg=True``; the
    kernels' counts set to 0 just before each run and read just after.
    Returns (launches by path, esffn_glu routes by path, result)."""
    import numpy as np
    from repro_torch.kernels import esffn, paged_attention
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import ParallelConfig

    t_phase = time.perf_counter()
    pcfg = ParallelConfig(blk=16)
    rng = np.random.default_rng(26)
    prompts = _shared_prefix_prompts(rng, cfg.vocab_size,
                                     [PREFIX_OWN] * PREFIX_SERVE_REQUESTS)
    slots, maxp = 8, 128 // PREFIX_PAGE
    launches, routes, res, streams = {}, {}, {}, {}
    for path, kw in (("serve_prefix_off", {}),
                     ("serve_prefix_on", {"prefix_cache": True}),
                     ("serve_disagg", {"disagg": True})):
        server = serve.PagedServer(
            cfg, pcfg, num_slots=slots, page_size=PREFIX_PAGE,
            num_pages=1 + slots * maxp, max_pages_per_slot=maxp,
            params=params, prefill_chunk=PREFIX_PAGE, device="cuda", **kw)
        for i, p in enumerate(prompts):
            server.submit(serve.Request(rid=i, prompt=p, max_new=PREFIX_NEW))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        esffn.esffn_glu.launches = 0
        esffn.esffn_glu.launches_by_route = dict.fromkeys(
            esffn.esffn_glu.launches_by_route, 0)
        paged_attention.paged_attention.launches = 0
        t0 = time.perf_counter()
        done = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = {
            "esffn_glu": esffn.esffn_glu.launches,
            "paged_attention": paged_attention.paged_attention.launches}
        routes[path] = {"esffn_glu": dict(esffn.esffn_glu.launches_by_route)}
        if routes[path]["esffn_glu"] != {
                "stream": launches[path]["esffn_glu"], "wgmma": 0} \
                or min(launches[path].values()) <= 0:
            raise AssertionError(f"{path}: launches {launches[path]}, "
                                 f"routes {routes[path]}")
        if len(done) != len(prompts) or any(
                len(r.out) != PREFIX_NEW or not all(
                    0 <= t < cfg.vocab_size for t in r.out) for r in done):
            raise AssertionError(f"{path}: not every request finished with "
                                 f"{PREFIX_NEW} in-vocabulary tokens")
        st = server.stats()
        server.drop_prefix_cache()
        _drained(server, path)
        streams[path] = {r.rid: r.out for r in done}
        first = set(server.admission_log[:slots])
        ttft = {w: [v * 1e3 for k, v in server.ttft_s.items()
                    if (k in first) == (w == "first")]
                for w in ("first", "second")}
        tokens = sum(len(r.out) for r in done)
        res[path] = {
            "prefill_chunks": sum(e[0] == "prefill_chunk"
                                  for e in server.trace),
            "transfers": server.transfers, "wall_s": wall,
            "tok_per_s": tokens / wall,
            "decode_tick_median_ms": statistics.median(
                server.decode_times_s) * 1e3,
            "ttft_median_ms": {w: statistics.median(v)
                               for w, v in ttft.items()},
            "peak_pages": st["peak_in_use_pages"],
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches[path]}
        if "prefix" in st:
            pf = st["prefix"]
            res[path]["hit_rate"] = pf["hit_tokens"] / pf["lookup_tokens"]
            res[path]["hit_tokens"] = pf["hit_tokens"]
    on, off = res["serve_prefix_on"], res["serve_prefix_off"]
    if on["prefill_chunks"] >= off["prefill_chunks"]:
        raise AssertionError(f"prefix serve: {on['prefill_chunks']} prefill "
                             f"chunks with the cache, {off['prefill_chunks']} "
                             f"without")
    if res["serve_disagg"]["transfers"] != len(prompts):
        raise AssertionError(f"prefix serve: {res['serve_disagg']} "
                             f"transfers for {len(prompts)} requests")
    same = {k: sum(streams[k][r] == streams["serve_prefix_off"][r]
                   for r in streams[k])
            for k in ("serve_prefix_on", "serve_disagg")}
    res["bf16_streams_equal_to_cache_off"] = same
    res["seconds"] = time.perf_counter() - t_phase
    for path, r in res.items():
        if isinstance(r, dict) and "prefill_chunks" in r:
            print(f"[prefix-serve] {path}: {r['prefill_chunks']} prefill "
                  f"chunks, hit rate {r.get('hit_rate', 0.0):.3f}, TTFT "
                  f"median first/second wave "
                  f"{r['ttft_median_ms']['first']:.1f}/"
                  f"{r['ttft_median_ms']['second']:.1f}ms, decode tick "
                  f"median {r['decode_tick_median_ms']:.2f}ms, "
                  f"{r['tok_per_s']:.1f} tok/s, {r['transfers']} transfers, "
                  f"peak {r['peak_pages']} pages, "
                  f"{r['peak_allocated_gb']:.2f} GB; launches "
                  f"{r['launches']}")
    print(f"[prefix-serve] bf16 streams equal to the cache-off run's "
          f"(not asserted): {same} of {len(prompts)}; {res['seconds']:.1f}s")
    return launches, routes, res


def _spec_serve(torch, cfg, params, prompts, make_server):
    """Phase 5s: phase 5's weights, the first ``SPEC_SERVE_REQUESTS`` of its
    prompts (2 of 16, a greedy and a sampled one: the 16 took 70 s, 8
    took 36 s on a slower host), odd rids
    sampled at 0.8, 16 new tokens, speculation off then on
    (``NGramDrafter``, k ``SPEC_K``), ``SPEC_SERVE_PAIRS`` times in turn.
    Each run's ``esffn_glu`` counts are set to 0 just before and read just
    after: one launch a layer a prefill chunk and a decode step or verify
    round, every one on ``stream``. Returns (launches of the last spec-on
    run, its routes, the results)."""
    from repro_torch.kernels import esffn
    from repro_torch.launch import serve, spec

    mix = _spec_mix(prompts[:SPEC_SERVE_REQUESTS], 16)
    warm = make_server()                 # the score step's shapes, unmeasured
    spec.SpecDecoder(warm, spec.NGramDrafter(), k=SPEC_K)
    warm.submit(serve.Request(rid=-1, prompt=mix[0]["prompt"], max_new=3))
    warm.run()
    del warm
    runs = []
    for _ in range(SPEC_SERVE_PAIRS):
        for mode in ("off", "on"):
            srv = make_server()
            if mode == "on":
                spec.SpecDecoder(srv, spec.NGramDrafter(), k=SPEC_K)
            for r in mix:
                srv.submit(serve.Request(**r))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            esffn.esffn_glu.launches = 0
            esffn.esffn_glu.launches_by_route = dict.fromkeys(
                esffn.esffn_glu.launches_by_route, 0)
            t0 = time.perf_counter()
            done = srv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = esffn.esffn_glu.launches
            routes = dict(esffn.esffn_glu.launches_by_route)
            what = f"serve (spec {mode})"
            if len(done) != len(mix) or any(len(r.out) != 16 for r in done):
                raise AssertionError(f"{what}: not every request finished "
                                     f"with 16 tokens")
            if not all(0 <= t < cfg.vocab_size for r in done
                       for t in r.out):
                raise AssertionError(f"{what}: token out of the vocabulary")
            _drained(srv, what)
            sp = srv.spec.stats() if mode == "on" else None
            forwards = len(mix) + (sp["rounds"] if sp
                                   else len(srv.decode_times_s))
            if launches != cfg.num_layers * forwards or routes != {
                    "stream": launches, "wgmma": 0}:
                raise AssertionError(f"{what}: esffn_glu launches {launches}"
                                     f" ({routes}), expected "
                                     f"{cfg.num_layers} x {forwards}")
            tokens = sum(len(r.out) for r in done)
            run = {"mode": mode, "wall_s": wall, "tok_per_s": tokens / wall,
                   "decode_tick_median_ms": statistics.median(
                       srv.decode_times_s) * 1e3,
                   "decode_ticks": len(srv.decode_times_s),
                   "peak_allocated_gb": torch.cuda.max_memory_allocated()
                   / 1e9, "esffn_glu_launches": launches, "routes": routes,
                   "pool_drained": True,
                   "streams": {r.rid: r.out for r in done}}
            if sp:
                run.update(sp, verify_round_median_ms=statistics.median(
                    srv.spec.round_times_s) * 1e3)
            runs.append(run)
            print(f"[serve-spec] {mode}: {len(done)} requests, {tokens} "
                  f"tokens in {wall:.3f}s ({run['tok_per_s']:.1f} tok/s); "
                  f"decode tick median {run['decode_tick_median_ms']:.2f}ms "
                  f"over {run['decode_ticks']}"
                  + (f"; verify round median "
                     f"{run['verify_round_median_ms']:.2f}ms over "
                     f"{sp['rounds']} rounds; acceptance "
                     f"{sp['acceptance_rate']:.3f} ({sp['accepted_drafts']}"
                     f"/{sp['drafted']}), {sp['rollback_tokens']} rows rolled"
                     f" back" if sp else "")
                  + f"; esffn_glu {routes}; peak "
                  f"{run['peak_allocated_gb']:.2f} GB; pool drained")
    offs = [r for r in runs if r["mode"] == "off"]
    ons = [r for r in runs if r["mode"] == "on"]
    # bf16 at 48 layers: not repeatable between runs (PERF.md §7), so the
    # streams are compared, not asserted (phase 4s asserts them in f32)
    same = [sum(a["streams"][k] == b["streams"][k] for k in a["streams"])
            for a, b in zip(offs, ons)]
    res = {"requests": len(mix), "pairs": SPEC_SERVE_PAIRS, "k": SPEC_K,
           "runs": [{k: v for k, v in r.items() if k != "streams"}
                    for r in runs],
           "streams_equal_on_off": same,
           "tok_per_s_on_over_off": [b["tok_per_s"] / a["tok_per_s"]
                                     for a, b in zip(offs, ons)]}
    print(f"[serve-spec] {len(mix)} of phase 5's {len(prompts)} requests "
          f"(cut to keep the script's time), k "
          f"{SPEC_K}, {SPEC_SERVE_PAIRS} off/on pairs: tok/s on / off {res['tok_per_s_on_over_off']}; "
          f"bf16 streams equal on and off {same} of {len(mix)}")
    return ons[-1]["esffn_glu_launches"], ons[-1]["routes"], res


# ---------------------------------------------------------------------------
# recurrent mixers and dense FFN layers (phases 4j, 4x, 5j, 5x)
# ---------------------------------------------------------------------------

def jamba_kernel_cases(torch, flush):
    """The two kernels at the shapes jamba-1.5-large-398b gives them: the
    8-bit ``esffn_glu`` stream route at D 8192, F 24576, E 16, top-2, blk
    16, for N 16 (a decode step of 8 slots) and N 2 (a paged prefill
    token), int8 payloads with tile scales 2^-2 .. 2^2 apart, against the
    plain version at ESFFN_TOL (negative control: w_down's scale grid
    transposed), timed, with the bound from the bytes of the experts the
    case touches; ``paged_attention`` at B 8, Hq 64, Hkv 8, hd 128, page
    16 over the serve lengths, checked as phase 3 checks and timed."""
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route
    from repro_torch.kernels import esffn
    from repro_torch.kernels import paged_attention as pa

    res = {"esffn_glu": [], "paged_attention": [], "negative_controls": []}
    d, e, f, k, blk = 8192, 16, 24576, 2, 16
    gen = torch.Generator(device="cuda").manual_seed(31)

    def payload(shape):
        q = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        tiles = (shape[0], shape[1] // 128, shape[2] // 128)
        s = 0.02 / 127 * torch.exp2(torch.rand(
            tiles, generator=gen, device="cuda") * 4 - 2)
        return q, s

    qs = [payload(s) for s in ((e, d, f), (e, d, f), (e, f, d))]
    wq, sc = [q for q, _ in qs], tuple(s for _, s in qs)
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    for n in (16, 2):
        x = torch.randn((n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        r = route(x, router, k)
        ri = build_reindex(r.expert_idx, r.gates, e, blk)
        args = (x, ri.row_token, ri.row_gate, ri.block_expert, *wq)
        name = f"esffn_glu int8 jamba N={n} blk={blk} bfloat16"
        plain = esffn.esffn_glu_plain(*args, w_scales=sc)
        kern, kroute = _routed(torch, lambda: esffn.esffn_glu(
            *args, w_scales=sc), esffn.esffn_glu)
        if kroute != "stream":
            raise AssertionError(f"{name}: took the {kroute} route")
        err, tol = _check(name, kern, plain, ESFFN_TOL["bfloat16"])
        if n == 16:
            res["negative_controls"].append({
                "kernel": "esffn_glu", "fault": "w_down's scale grid "
                "transposed (jamba shape)", "err_over_tol": _must_fail(
                    name + " with sd transposed", esffn.esffn_glu_plain(
                        *args, w_scales=sc[:2] + (_scale_transposed(sc[2]),)),
                    plain, ESFFN_TOL["bfloat16"])})
        del plain
        live = (ri.row_gate.reshape(-1, blk) != 0).any(dim=1)
        experts = torch.unique(ri.block_expert[live]).numel()
        np_rows = ri.row_token.numel()
        nbytes = (n * d * 2 + experts * 3 * d * f
                  + experts * sum(s[0].numel() for s in sc) * 4
                  + np_rows * 8 + ri.block_expert.numel() * 4
                  + np_rows * d * 2)
        flops = 6 * int((ri.row_gate != 0).sum()) * d * f
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        res["esffn_glu"].append({
            "case": "jamba-1.5-large-398b experts",
            "shape": {"N": n, "D": d, "E": e, "F": f, "top_k": k, "blk": blk,
                      "Np": np_rows, "live_blocks": int(live.sum()),
                      "experts_read": experts},
            "dtype": "bfloat16", "weights": "int8", "kernel_route": kroute,
            "max_abs_err": err, "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: esffn.esffn_glu(
                *args, w_scales=sc), flush, iters=10),
            "plain_ms": time_ms(torch, lambda: esffn.esffn_glu_plain(
                *args, w_scales=sc), flush, iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": _NO_LIBRARY_Q})
        del kern
    del qs, wq, sc
    torch.cuda.empty_cache()

    b, hq, hkv, hd, page, maxp = 8, 64, 8, 128, 16, 16
    lengths_l = [0, 1, 9, 16, 17, 24, 100, 250]
    args, _ = _paged_inputs(torch, gen, b, hq, hkv, hd, page, lengths_l,
                            maxp, "bfloat16")
    _, _, err, tol, worst = _paged_check(
        torch, "paged_attention jamba heads", args, {}, "bfloat16")
    nbytes, flops = _paged_work(args, {}, None)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    res["paged_attention"].append({
        "case": "jamba-1.5-large-398b heads, serve lengths",
        "shape": {"B": b, "Hq": hq, "Hkv": hkv, "hd": hd, "page": page,
                  "maxp": maxp, "lengths": lengths_l, "window": None,
                  "softcap": 0.0, "splits": pa.num_splits(maxp)},
        "dtype": "bfloat16", "max_abs_err": err, "tolerance": tol,
        "worst_slot_err_over_tol": worst,
        "kernel_ms": time_ms(torch, lambda: pa.paged_attention(*args),
                             flush),
        "plain_ms": time_ms(torch, lambda: pa.paged_attention_ref(*args),
                            flush),
        "bound_ms": b_ms, "bound_by": b_by})
    return res


# ---------------------------------------------------------------------------
# phase P: the paged engine on a 1-rank NCCL mesh (P1 after phase 4, P2 on
# phase 5's weights)
# ---------------------------------------------------------------------------

def _paged_kernel_fns():
    from repro_torch.kernels import paged_attention as pa

    return {**_swin_kernel_fns(), "paged_attention": pa.paged_attention}


def _reset_paged_counts(fns):
    _reset_launches(fns)
    _reset_quant(*(fn for fn in fns.values() if hasattr(fn, "launches_quant")))


def _paged_counts(fns):
    """Each kernel's launches, launches by route and 8-bit launches since
    ``_reset_paged_counts``."""
    return ({k: fn.launches for k, fn in fns.items()},
            {k: dict(fn.launches_by_route) for k, fn in fns.items()
             if hasattr(fn, "launches_by_route")},
            {k: dict(fn.launches_quant) for k, fn in fns.items()
             if hasattr(fn, "launches_quant")})


class _HeldToPlain:
    """While active (a ``with`` block), every launch of ``paged_attention``,
    ``esffn_glu`` and ``esffn_mlp`` that the model makes is followed by the
    kernel's plain version on the same inputs, on the card, and held to it:
    ``ATTN_TOL``/``ESFFN_TOL`` of the output's dtype x max|plain|, over the
    whole output. The wrappers go in at the call sites (the attention
    layer's ``paged_attention``, ``kernels.ops``' view of the ``esffn``
    module), so the kernels count their launches as always; the plain calls
    launch nothing, so the counts are the path's own. ``checks`` counts the
    held launches a kernel and ``worst`` keeps the largest err / limit.
    ``path`` names the path in the error. Only the calls of the thread
    that enters are held (``_this_thread_only``): the CPU lane's go to the
    wrappers as they are."""

    def __init__(self, path: str = "the mesh path"):
        self.path = path
        self.checks = dict.fromkeys(("paged_attention", "esffn_glu",
                                     "esffn_mlp"), 0)
        self.worst = dict.fromkeys(self.checks, 0.0)
        self._saved = []

    def __enter__(self):
        from repro_torch.kernels import esffn, ops, paged_attention as pa
        from repro_torch.models import transformer as tfm

        self._saved = [(tfm, "paged_attention", tfm.paged_attention),
                       (ops, "esffn_kernel", ops.esffn_kernel)]
        tfm.paged_attention = _this_thread_only(self._held(
            "paged_attention", pa.paged_attention, pa.paged_attention_ref,
            ATTN_TOL), tfm.paged_attention)
        ops.esffn_kernel = _ModuleView(esffn, {
            name: _this_thread_only(
                self._held(name, getattr(esffn, name),
                           getattr(esffn, name + "_plain"), ESFFN_TOL),
                getattr(esffn, name))
            for name in ("esffn_glu", "esffn_mlp")})
        return self

    def __exit__(self, *exc):
        for mod, name, value in self._saved:
            setattr(mod, name, value)
        self._saved = []

    def _held(self, name, kernel, plain, tol):
        def run(*args, **kw):
            out = kernel(*args, **kw)
            want = plain(*args, **kw)
            lim = tol[str(out.dtype).replace("torch.", "")] * max(
                want.float().abs().max().item(), 1e-30)
            err = (out.float() - want.float()).abs().max().item()
            self.checks[name] += 1
            self.worst[name] = max(self.worst[name], err / lim)
            if not err <= lim:
                raise AssertionError(f"{name} on {self.path}: err {err} "
                                     f"against the plain version, limit "
                                     f"{lim}")
            return out

        return run


class _ModuleView:
    """A module's attributes, some of them replaced."""

    def __init__(self, module, replaced: dict):
        self._module = module
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _forwards(trace):
    """(prefill chunks, decode steps, verify rounds) in a ``trace``."""
    n = collections.Counter(e[0] for e in trace)
    return n["prefill_chunk"], n["decode"], n["spec_verify"]


def _mesh_warm(torch, mesh):
    """Make every communicator of the 1-rank mesh before anything runs."""
    for axes in (("pod",), ("data",), ("model",), ("pod", "data"),
                 ("pod", "data", "model")):
        mesh.all_reduce(torch.ones(1, device="cuda"), axes)
    torch.cuda.synchronize()


def paged_mesh_phase(torch, serve_ref):
    """Phase P1: phase 4's model (qwen3-moe-30b-a3b, 2 layers at full width,
    f32, seed 3) through ``PagedServer`` mesh-less and on a 1-rank NCCL
    mesh (1, 1, 1) in each of ``PAGED_MESH_VARIANTS``: streams and the
    whole trace equal, the page books audited every step and drained,
    every kernel launch on the mesh held to its plain version
    (``_HeldToPlain``) and the launches exactly one a layer a forward;
    then the MLP-experts graft (``_paged_mesh_graft``). Returns (launches
    by path, launches by route by path, result)."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.launch import serve, spec
    from repro_torch.launch.mesh import make_mesh, single_rank_nccl
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    pcfg = ParallelConfig(blk=16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    rng = np.random.default_rng(4)            # phase 4's prompts
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(3)]
    rng = np.random.default_rng(9)
    shared = rng.integers(0, cfg.vocab_size, size=16)
    prefixed = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, size=n)]).astype(np.int32) for n in (3, 5, 2)]
    fns = _paged_kernel_fns()
    held = _HeldToPlain()

    def run(variant, mesh, drafter=None):
        srv = serve.PagedServer(
            cfg, pcfg, num_slots=2, page_size=16, num_pages=9,
            max_pages_per_slot=4, params=params, device="cuda", audit=True,
            prefix_cache=variant == "prefix", disagg=variant == "disagg",
            kv_quant="int8" if variant == "int8" else None, mesh=mesh)
        if drafter is not None:
            spec.SpecDecoder(srv, drafter, k=SPEC_K)
        for i, pr in enumerate(prefixed if variant == "prefix" else prompts):
            srv.submit(serve.Request(rid=i, prompt=pr, max_new=4))
        with torch.no_grad():
            out = {r.rid: r.out for r in srv.run()}
        torch.cuda.synchronize()
        st = srv.stats()
        srv.drop_prefix_cache()
        _drained(srv, f"P1 {variant}")
        return srv, out, st

    res, paths, route_paths = {}, {}, {}
    with single_rank_nccl():
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        _mesh_warm(torch, mesh)
        plain = None
        for variant in PAGED_MESH_VARIANTS:
            mix = [{"rid": i, "prompt": p} for i, p in enumerate(prompts)]
            wrong = (lambda: _WrongDrafter(mix, plain, cfg.vocab_size)) \
                if variant == "spec" else (lambda: None)
            ref, want, _ = run(variant, None, wrong())
            _reset_paged_counts(fns)
            t0 = time.perf_counter()
            with held:
                srv, got, st = run(variant, mesh, wrong())
            wall = time.perf_counter() - t0
            launches, routes, quant = _paged_counts(fns)
            if got != want or srv.trace != ref.trace or len(got) != 3:
                raise AssertionError(f"P1 {variant}: mesh streams {got} vs "
                                     f"mesh-less {want}")
            chunks, decodes, rounds = _forwards(srv.trace)
            expect = {"esffn_glu": 2 * (chunks + decodes + rounds),
                      "paged_attention": 2 * decodes}
            if {k: launches[k] for k in expect} != expect \
                    or routes["esffn_glu"]["stream"] != expect["esffn_glu"]:
                raise AssertionError(f"P1 {variant}: launches {launches} "
                                     f"{routes}, expected {expect}")
            if variant == "plain":
                plain = want
                if {str(k): v for k, v in want.items()} != \
                        serve_ref["tokens"]:
                    raise AssertionError(f"P1: streams {want} vs phase "
                                         f"4's {serve_ref['tokens']}")
            if variant == "prefix" and not st["prefix"]["hit_tokens"]:
                raise AssertionError(f"P1 prefix: no hit {st['prefix']}")
            if variant == "disagg" and srv.transfers != 3:
                raise AssertionError(f"P1 disagg: {srv.transfers} transfers")
            if variant == "int8" and quant["paged_attention"]["int8"] != \
                    expect["paged_attention"]:
                raise AssertionError(f"P1 int8: launches {quant}")
            sp = srv.spec.stats() if srv.spec is not None else None
            if variant == "spec" and (not sp["drafted"]
                                      or sp["accepted_drafts"]
                                      or sp["rollback_tokens"]
                                      != sp["drafted"]):
                raise AssertionError(f"P1 spec: wrong drafter {sp}")
            paths[f"paged_mesh_p1_{variant}"] = {
                k: n for k, n in launches.items() if n}
            route_paths[f"paged_mesh_p1_{variant}"] = {
                "esffn_glu": routes["esffn_glu"]}
            res[variant] = {"streams": {str(k): v for k, v in got.items()},
                            "forwards": [chunks, decodes, rounds],
                            "launches": launches, "wall_s": wall,
                            "transfers": srv.transfers, "spec": sp,
                            "prefix": st.get("prefix")}
            print(f"[paged-mesh] P1 {variant}: streams and trace equal "
                  f"mesh-less and on the mesh ({len(srv.trace)} events, "
                  f"{chunks} prefill chunks, {decodes} decode steps, "
                  f"{rounds} verify rounds); launches "
                  f"{paths[f'paged_mesh_p1_{variant}']}; {wall:.2f}s on "
                  f"the mesh")
            del ref, srv
        graft_paths, graft_routes, graft = _paged_mesh_graft(torch, mesh,
                                                             held, fns)
    paths.update(graft_paths)
    route_paths.update(graft_routes)
    seconds = time.perf_counter() - t_phase
    res.update({"graft": graft, "held_checks": dict(held.checks),
                "held_worst_err_over_limit": dict(held.worst),
                "seconds": seconds})
    print(f"[paged-mesh] P1: {held.checks} launches held to their plain "
          f"versions, worst err / limit "
          f"{ {k: round(v, 4) for k, v in held.worst.items()} }; phase P1 "
          f"in {seconds:.1f}s")
    return paths, route_paths, res


def _paged_mesh_graft(torch, mesh, held, fns):
    """P1's graft: phase 7's size (2 layers at full width, f32, seed 7, 2 x
    64 tokens) with MLP experts (``glu=False``; biases drawn, not zero):
    one loss forward and backward card vs CPU at phase 7's limits
    (``_card_vs_cpu_loss``), every expert kernel's launches counted; then
    2 greedy requests of 8 + 4 through ``PagedServer`` on the mesh (every
    launch held to its plain version, one ``esffn_mlp`` a layer a forward
    on ``mma_tf32x3``) against the same on the CPU: streams equal. The
    CPU sides run on the CPU lane (``_graft_decode_cpu``)."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_map
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32", glu=False)
    pcfg = ParallelConfig(blk=16)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    for layer in params["layers"]:
        for k in ("b1", "b2"):
            b = layer["ffn"][k]
            b.copy_(0.02 * torch.randn(b.shape, generator=gen, device="cuda"))
    batch = TokenSource(DataConfig(seq_len=64, global_batch=2,
                                   vocab_size=cfg.vocab_size,
                                   seed=7)).batch(0)
    _reset_paged_counts(fns)
    loss = _card_vs_cpu_loss(torch, "P1 graft", cfg, pcfg, params, batch)
    train_launches, train_routes, _ = _paged_counts(fns)
    if not train_launches["esffn_mlp"] or train_launches["esffn_glu"]:
        raise AssertionError(f"P1 graft: train launches {train_launches}")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(2)]

    _reset_paged_counts(fns)
    with held:
        srv, got = _graft_serve(cfg, pcfg, params, "cuda", mesh, prompts)
    torch.cuda.synchronize()
    launches, routes, _ = _paged_counts(fns)
    chunks, decodes, _ = _forwards(srv.trace)
    n = 2 * (chunks + decodes)
    if len(got) != 2 or launches["esffn_mlp"] != n \
            or routes["esffn_mlp"]["mma_tf32x3"] != n \
            or launches["paged_attention"] != 2 * decodes:
        raise AssertionError(f"P1 graft: mesh streams {got}; launches "
                             f"{launches} {routes}, expected {n} esffn_mlp")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    _LANE.submit("P1 graft decode", _host_bytes(cpu_params),
                 _graft_decode_cpu, cfg, pcfg, cpu_params, prompts, got)
    print(f"[paged-mesh] P1 graft (glu=False, 2 full-width layers, f32): "
          f"total card {loss['total_gpu']!r} (the CPU's on the lane); train "
          f"launches { {k: v for k, v in train_launches.items() if v} }; "
          f"paged decode on the mesh {got} (the CPU's on the lane), "
          f"launches { {k: v for k, v in launches.items() if v} }")
    paths = {"paged_mesh_p1_graft_train": {
        k: v for k, v in train_launches.items() if v},
        "paged_mesh_p1_graft_decode": {k: v for k, v in launches.items()
                                       if v}}
    route_paths = {"paged_mesh_p1_graft_train": train_routes,
                   "paged_mesh_p1_graft_decode": {
                       "esffn_mlp": routes["esffn_mlp"]}}
    return paths, route_paths, {
        "loss": {"total_gpu": loss["total_gpu"]},
        "train_launches": train_launches, "train_routes": train_routes,
        "streams": {str(k): v for k, v in got.items()},
        "decode_launches": launches}


def _graft_serve(cfg, pcfg, p, device, mesh, prompts):
    """P1 graft's audited ``PagedServer`` (2 slots, 2 requests of 8 + 4)."""
    import torch
    from repro_torch.launch import serve

    srv = serve.PagedServer(cfg, pcfg, num_slots=2, page_size=16,
                            num_pages=9, max_pages_per_slot=4, params=p,
                            device=device, audit=True, mesh=mesh)
    for i, pr in enumerate(prompts):
        srv.submit(serve.Request(rid=i, prompt=pr, max_new=4))
    with torch.no_grad():
        out = {r.rid: r.out for r in srv.run()}
    _drained(srv, f"P1 graft {device}")
    return srv, out


def _graft_decode_cpu(cfg, pcfg, cpu_params, prompts, got):
    """P1 graft's CPU side: the CPU's paged engine (the plain versions)
    gives the mesh's streams."""
    _, want = _graft_serve(cfg, pcfg, cpu_params, "cpu", None, prompts)
    if got != want:
        raise AssertionError(f"P1 graft: mesh streams {got} vs CPU {want}")
    print(f"[paged-mesh] P1 graft: paged decode on the CPU == on the mesh "
          f"{want}")


def _paged_mesh_serve(torch, cfg, pcfg, params, prompts, base_median_ms):
    """Phase P2, on phase 5's weights (no second copy: on a 1-rank mesh
    every block is the whole tensor): ``PAGED_MESH_P2`` requests through
    ``PagedServer`` on the 1-rank NCCL mesh (8 slots, 16-token pages).
    First an unmeasured warm-up of the same prompts with 2 new tokens
    each, in which every kernel launch is held to its plain version
    (``_HeldToPlain``: the timed run is not, so that no check sits inside
    its times); then the timed run, its launches counted from 0: exactly
    one ``esffn_glu`` (stream) a layer a forward and one
    ``paged_attention`` a layer a decode step. Returns (launches, routes,
    result)."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh, single_rank_nccl

    t_phase = time.perf_counter()
    n_req, new = PAGED_MESH_P2["requests"], PAGED_MESH_P2["new"]
    slots, page, max_seq = 8, 16, 128
    maxp = max_seq // page
    fns = _paged_kernel_fns()
    held = _HeldToPlain()
    with single_rank_nccl():
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        _mesh_warm(torch, mesh)

        def make_server(max_new):
            srv = serve.PagedServer(
                cfg, pcfg, num_slots=slots, page_size=page,
                num_pages=slots * maxp // 2 + 1, max_pages_per_slot=maxp,
                params=params, prefill_chunk=16, device="cuda", mesh=mesh)
            for i, pr in enumerate(prompts[:n_req]):
                srv.submit(serve.Request(rid=i, prompt=pr, max_new=max_new))
            return srv

        warm = make_server(2)
        with held, torch.no_grad():
            warm.run()
        _drained(warm, "P2 warm-up")
        del warm
        server = make_server(new)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_paged_counts(fns)
        t0 = time.perf_counter()
        with torch.no_grad():
            done = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes, _ = _paged_counts(fns)
        peak = torch.cuda.max_memory_allocated()
    chunks, decodes, _ = _forwards(server.trace)
    n = cfg.num_layers
    expect = {"esffn_glu": n * (chunks + decodes), "paged_attention":
              n * decodes}
    if {k: launches[k] for k in expect} != expect \
            or routes["esffn_glu"]["stream"] != expect["esffn_glu"]:
        raise AssertionError(f"P2: launches {launches} {routes}, expected "
                             f"{expect}")
    if len(done) != n_req or any(len(r.out) != new for r in done) \
            or not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError("P2: a request did not finish in the "
                             "vocabulary")
    _drained(server, "P2")
    steps = server.decode_times_s
    ttft = sorted(server.ttft_s.values())
    tokens = sum(len(r.out) for r in done)
    seconds = time.perf_counter() - t_phase
    res = {"requests": len(done), "tokens": tokens, "wall_s": wall,
           "tok_per_s": tokens / wall,
           "decode_step_median_ms": statistics.median(steps) * 1e3,
           "decode_steps": len(steps),
           "meshless_decode_step_median_ms": base_median_ms,
           "ttft_median_ms": statistics.median(ttft) * 1e3,
           "peak_allocated_gb": peak / 1e9,
           "pool_bytes": server.pool.num_pages * server.page_bytes,
           "cache_bytes": server.kv_bytes(), "launches": launches,
           "held_checks": dict(held.checks),
           "held_worst_err_over_limit": dict(held.worst),
           "seconds": seconds}
    print(f"[paged-mesh] P2 {n}-layer full-width bf16 on the 1-rank mesh: "
          f"{len(done)} requests, {tokens} tokens in {wall:.3f}s "
          f"({res['tok_per_s']:.1f} tok/s); decode step median "
          f"{res['decode_step_median_ms']:.2f}ms over {len(steps)} steps "
          f"(phase 5 mesh-less: {base_median_ms:.2f}ms); TTFT median "
          f"{res['ttft_median_ms']:.1f}ms; peak allocated {peak / 1e9:.2f} "
          f"GB; pool {res['pool_bytes'] / 1e6:.1f} MB; launches "
          f"{ {k: v for k, v in launches.items() if v} }; warm-up launches "
          f"held to plain {held.checks}, worst err / limit "
          f"{ {k: round(v, 4) for k, v in held.worst.items()} }; "
          f"{seconds:.1f}s")
    return ({k: v for k, v in launches.items() if v},
            {"esffn_glu": routes["esffn_glu"]}, res)


def _hybrid_config(arch, dtype):
    """jamba-1.5-large-398b cut to one period (JAMBA_DEPTH layers), 4j's
    f32 also to HYBRID_REF_FFN-wide FFNs; xlstm-350m whole."""
    from repro_torch import configs as cfglib

    cfg = dataclasses.replace(cfglib.get_config(arch), dtype=dtype)
    if arch == "jamba-1.5-large-398b":
        cfg = dataclasses.replace(cfg, num_layers=JAMBA_DEPTH)
        if dtype == "float32":
            cfg = dataclasses.replace(
                cfg, d_ff=HYBRID_REF_FFN, moe=dataclasses.replace(
                    cfg.moe, d_ff=HYBRID_REF_FFN))
    return cfg


def _hybrid_launch_counts(cfg):
    """(esffn_glu, paged_attention) launches of ONE forward of ``cfg``."""
    n = cfg.num_layers
    return (sum(cfg.is_moe_layer(i) for i in range(n)),
            sum(cfg.layer_kind(i) == "attn" for i in range(n)))


def _reset_counts():
    from repro_torch.kernels import esffn, paged_attention

    glu, pa = esffn.esffn_glu, paged_attention.paged_attention
    glu.launches = pa.launches = 0
    glu.launches_by_route = dict.fromkeys(glu.launches_by_route, 0)
    _reset_quant(glu, pa)


def _read_counts():
    from repro_torch.kernels import esffn, paged_attention

    glu, pa = esffn.esffn_glu, paged_attention.paged_attention
    return {"esffn_glu": glu.launches, "paged_attention": pa.launches,
            "esffn_glu_routes": dict(glu.launches_by_route),
            "esffn_glu_quant": dict(glu.launches_quant),
            "paged_attention_quant": dict(pa.launches_quant)}


def hybrid_reference_phase(torch, arch, tag):
    """Phase 4j (jamba-1.5-large-398b, one period, FFNs HYBRID_REF_FFN
    wide) or 4x (xlstm-350m, whole), f32: ``HYBRID_REF_REQUESTS`` greedy
    requests of 8 prompt and ``HYBRID_REF_NEW`` new tokens through the
    dense ``BatchedServer``, ``PagedServer`` and ``reference_stream`` on
    the card and the ``HYBRID_CPU`` engines on the CPU (on its first
    requests; on the CPU lane, ``_hybrid_reference_cpu``), 2 slots so both
    engines refill a slot: every stream equal. The paged card run's kernel
    launches, counted from 0, are
    exactly one ``esffn_glu`` a MoE layer and one ``paged_attention`` an
    attention layer a forward (one forward a prompt token, the token-wise
    prefill, and one a decode step), all ``esffn_glu`` on ``stream``.
    ``steps.make_prefill_step`` (the chunked scans) gives last logits
    within HYBRID_CHUNK_TOL of the token-wise path's on the card and
    within ESFFN_TOL of its own on the CPU."""
    import numpy as np
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    t_phase = time.perf_counter()
    cfg = _hybrid_config(arch, "float32")
    pcfg = ParallelConfig(blk=16)
    params = lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(41), device="cuda")
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(HYBRID_REF_REQUESTS)]
    per_fwd = _hybrid_launch_counts(cfg)

    cpu_kinds, cpu_requests = HYBRID_CPU[arch]
    streams, wall, counts = {}, {}, {}
    for kind in ("dense", "paged", "reference_stream"):
        t0 = time.perf_counter()
        _reset_counts()
        out, fwds = _hybrid_engine(cfg, pcfg, kind, "cuda", params, prompts)
        key = f"{kind} cuda"
        streams[key], wall[key] = out, time.perf_counter() - t0
        if key == "paged cuda":
            counts = _read_counts()
            want = {"esffn_glu": per_fwd[0] * fwds,
                    "paged_attention": per_fwd[1] * fwds}
            got = {k: counts[k] for k in want}
            if got != want or counts["esffn_glu_routes"] != {
                    "stream": want["esffn_glu"], "wgmma": 0}:
                raise AssertionError(f"phase {tag}: launches {counts}, "
                                     f"expected {want}")
    want = streams["dense cuda"]
    if len(want) != HYBRID_REF_REQUESTS or any(
            len(o) != HYBRID_REF_NEW for o in want.values()) or any(
            st != want for st in streams.values()):
        raise AssertionError(f"phase {tag}: greedy tokens differ: {streams}")

    tokens = np.stack(prompts)
    b = tokens.shape[0]
    t0 = time.perf_counter()
    chunked = _hybrid_prefill(cfg, pcfg, params, tokens, "cuda")
    wall["make_prefill_step cuda"] = time.perf_counter() - t0
    step = steps.make_serve_step(cfg, pcfg)
    cache = lm.init_cache(cfg, b, 64, "cuda")
    for t in range(tokens.shape[1]):
        lg, cache = step(params, {"tokens": torch.from_numpy(
            tokens[:, t:t + 1]).cuda()}, cache)
    tokenwise = lg[:, -1].float().cpu()
    err_tw, tol_tw = _check(f"phase {tag}: chunked vs token-wise logits",
                            chunked, tokenwise, HYBRID_CHUNK_TOL[arch])
    del cache, lg
    cpu_params = tree_map(lambda t: t.cpu(), params)
    _LANE.submit(tag, n_bytes, _hybrid_reference_cpu, tag, cfg, pcfg,
                 cpu_params, prompts, cpu_kinds, cpu_requests, want, chunked,
                 full=arch in LANE_FULL)
    res = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "moe_d_ff": cfg.moe.d_ff if cfg.moe else None,
           "weights_gb": n_bytes / 1e9, "tokens": {str(k): v for k, v in
                                                   want.items()},
           "engines": sorted(streams) + [f"{k} cpu" for k in cpu_kinds],
           "cpu_requests": cpu_requests,
           "launches": {
               k: counts[k] for k in ("esffn_glu", "paged_attention")},
           "launches_per_forward": {"esffn_glu": per_fwd[0],
                                    "paged_attention": per_fwd[1]},
           "launches_by_route": {"esffn_glu": counts["esffn_glu_routes"]},
           "chunked_vs_tokenwise_err": err_tw,
           "chunked_vs_tokenwise_tol": tol_tw,
           "wall_s": wall, "seconds": time.perf_counter() - t_phase}
    print(f"[{tag}] {arch}, {cfg.num_layers} layers, f32, {n_bytes / 1e9:.2f}"
          f" GB: greedy tokens {want} equal on {sorted(streams)} (the CPU's "
          f"{cpu_kinds} on the first {cpu_requests} requests on the lane); "
          f"launches {res['launches']} ({per_fwd} a forward); prefill "
          f"logits chunked vs token-wise err {err_tw:.3g} (limit "
          f"{tol_tw:.3g}); in {res['seconds']:.1f}s, wall s "
          f"{json.dumps(wall)}")
    return res


def _hybrid_engine(cfg, pcfg, kind, device, p, prompts):
    """Phases 4j/4x's engines (2 slots, ``HYBRID_REF_NEW`` new tokens a
    request): the greedy streams and the forwards the paged engine ran
    (one a prompt token and one a decode step; else None)."""
    from repro_torch.launch import serve

    reqs = [serve.Request(rid=i, prompt=pr, max_new=HYBRID_REF_NEW)
            for i, pr in enumerate(prompts)]
    if kind == "reference_stream":
        return {r.rid: serve.reference_stream(cfg, pcfg, p, r, max_seq=64)
                for r in reqs}, None
    if kind == "dense":
        server = serve.BatchedServer(cfg, pcfg, num_slots=2, max_seq=64,
                                     params=p, device=device)
    else:
        server = serve.PagedServer(
            cfg, pcfg, num_slots=2, page_size=16, num_pages=9,
            max_pages_per_slot=4, params=p, device=device)
    for r in reqs:
        server.submit(r)
    out = {r.rid: r.out for r in server.run()}
    fwds = (sum(len(r.prompt) for r in reqs) + len(server.decode_times_s)
            if kind == "paged" else None)
    return out, fwds


def _hybrid_prefill(cfg, pcfg, params, tokens, device):
    """``steps.make_prefill_step``'s last logits (host, f32)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import lm

    lg, _ = steps.make_prefill_step(cfg, pcfg)(
        params, {"tokens": torch.from_numpy(tokens).to(device)},
        lm.init_cache(cfg, tokens.shape[0], 64, device))
    return lg[:, -1].float().cpu()


def _hybrid_reference_cpu(tag, cfg, pcfg, cpu_params, prompts, kinds,
                          n_requests, want, chunked):
    """Phases 4j/4x's CPU side (the plain versions): ``kinds`` on the first
    ``n_requests`` prompts give the card's streams, and the chunked
    prefill's last logits are within ESFFN_TOL of the card's."""
    import numpy as np

    streams = {f"{kind} cpu": _hybrid_engine(
        cfg, pcfg, kind, "cpu", cpu_params, prompts[:n_requests])[0]
        for kind in kinds}
    cpu_want = {rid: want[rid] for rid in range(n_requests)}
    if any(st != cpu_want for st in streams.values()):
        raise AssertionError(f"phase {tag}: the CPU's greedy tokens "
                             f"{streams} != the card's {cpu_want}")
    logits = _hybrid_prefill(cfg, pcfg, cpu_params, np.stack(prompts), "cpu")
    err, tol = _check(f"phase {tag}: card vs CPU logits", chunked, logits,
                      ESFFN_TOL["float32"])
    print(f"[{tag}] CPU (plain versions): {kinds} on {n_requests} requests "
          f"== the card's greedy tokens; chunked prefill logits card vs CPU "
          f"{err:.3g} (limit {tol:.3g})")


def hybrid_serve_phase(torch, arch, tag):
    """Phase 5j (jamba-1.5-large-398b, one period at full width, bf16
    with int8 experts drawn and quantized expert matrix by expert matrix)
    or 5x (xlstm-350m, bf16, whole): ``HYBRID_SERVE_REQUESTS`` greedy
    requests of 8 prompt and ``HYBRID_SERVE_NEW`` new tokens through
    ``PagedServer`` (8 slots, 16-token pages, every slot's worst case in
    the pool), then ``BatchedServer`` (8 x 128), each after an unmeasured
    warm-up request, the kernel counts set to 0 just before each run and
    read just after: one ``esffn_glu`` a MoE layer a forward, every one the
    8-bit stream route, and on the paged engine one bf16
    ``paged_attention`` an attention layer a forward. Every stream full
    length and in the vocabulary; the bf16 streams of the two engines are
    counted, not asserted."""
    import numpy as np
    from repro_torch.common import tree_leaves
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    t_phase = time.perf_counter()
    cfg = _hybrid_config(arch, "bfloat16")
    quant = "int8" if cfg.moe is not None else None
    pcfg = ParallelConfig(blk=16)
    slots, page, max_seq = 8, 16, 128
    maxp = max_seq // page
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda", quant=quant)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    if quant and not JAMBA_WEIGHT_GB[0] <= n_bytes / 1e9 <= JAMBA_WEIGHT_GB[1]:
        raise AssertionError(f"phase {tag}: {n_bytes / 1e9} GB of weights, "
                             f"predicted {JAMBA_WEIGHT_GB}")
    per_fwd = _hybrid_launch_counts(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(HYBRID_SERVE_REQUESTS)]

    def paged():
        return serve.PagedServer(
            cfg, pcfg, num_slots=slots, page_size=page,
            num_pages=1 + slots * maxp, max_pages_per_slot=maxp,
            params=params, prefill_chunk=16, device="cuda")

    def dense():
        return serve.BatchedServer(cfg, pcfg, num_slots=slots,
                                   max_seq=max_seq, params=params,
                                   device="cuda")

    res = {"arch": arch, "layers": cfg.num_layers, "weights": quant or "bf16",
           "weights_gb": n_bytes / 1e9, "init_s": init_s,
           "init_peak_allocated_gb": init_peak / 1e9}
    outs = {}
    for kind, make in (("paged", paged), ("dense", dense)):
        warm = make()
        warm.submit(serve.Request(rid=-1, prompt=np.arange(8, dtype=np.int32),
                                  max_new=2))
        warm.run()
        del warm
        server = make()
        for i, pr in enumerate(prompts):
            server.submit(serve.Request(rid=i, prompt=pr,
                                        max_new=HYBRID_SERVE_NEW))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        done = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = server.decode_times_s
        if kind == "paged":
            fwds = sum(len(pr) for pr in prompts) + len(steps)
        else:
            fwds = len(steps)
        want = {"esffn_glu": per_fwd[0] * fwds,
                "paged_attention": per_fwd[1] * fwds if kind == "paged"
                else 0}
        got = {k: counts[k] for k in want}
        if got != want or counts["esffn_glu_routes"] != {
                "stream": want["esffn_glu"], "wgmma": 0} \
                or counts["esffn_glu_quant"].get("int8", 0) != (
                    want["esffn_glu"] if quant else 0) \
                or counts["paged_attention_quant"]["int8"]:
            raise AssertionError(f"phase {tag} ({kind}): launches {counts}, "
                                 f"expected {want}")
        if len(done) != len(prompts) or any(
                len(r.out) != HYBRID_SERVE_NEW for r in done):
            raise AssertionError(f"phase {tag} ({kind}): not every request "
                                 f"finished with {HYBRID_SERVE_NEW} tokens")
        if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
            raise AssertionError(f"phase {tag} ({kind}): token out of the "
                                 f"vocabulary")
        if kind == "paged":
            st = server.stats()
            if st["free_pages"] != st["num_pages"] - 1 or st["in_use_pages"]:
                raise AssertionError(f"phase {tag}: page pool leaked: {st}")
            server.pool.assert_consistent()
        tokens = sum(len(r.out) for r in done)
        ttft = sorted(server.ttft_s.values())
        outs[kind] = {r.rid: r.out for r in done}
        res[kind] = {
            "requests": len(done), "tokens": tokens, "wall_s": wall,
            "tok_per_s": tokens / wall,
            "decode_step_median_ms": statistics.median(steps) * 1e3,
            "decode_steps": len(steps),
            "ttft_median_ms": statistics.median(ttft) * 1e3,
            "peak_allocated_gb": peak / 1e9,
            "cache_bytes": lm.cache_bytes(server.cache),
            "launches": got, "launches_by_route": {
                "esffn_glu": counts["esffn_glu_routes"]},
            "launches_quant": {"esffn_glu": counts["esffn_glu_quant"]}}
        print(f"[{tag}] {kind}: {len(done)} requests, {tokens} tokens in "
              f"{wall:.3f}s ({tokens / wall:.1f} tok/s); decode step median "
              f"{res[kind]['decode_step_median_ms']:.2f}ms over {len(steps)} "
              f"steps; TTFT median {res[kind]['ttft_median_ms']:.1f}ms; peak "
              f"allocated {peak / 1e9:.2f} GB; launches {got}")
        del server, done
    equal = sum(outs["dense"][rid] == outs["paged"][rid] for rid in outs[
        "paged"])
    res["dense_streams_equal_to_paged"] = equal
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[{tag}] {arch}, {cfg.num_layers} layers at full width, bf16"
          f"{' + int8 experts' if quant else ''}: {n_bytes / 1e9:.2f} GB of "
          f"weights (drawn in {init_s:.1f}s, peak {init_peak / 1e9:.2f} GB);"
          f" {equal} of {len(prompts)} dense streams equal the paged "
          f"engine's; phase {res['seconds']:.1f}s")
    del params
    return res


# ---------------------------------------------------------------------------
# phases 3d, 4d, 5d, 8d: the five LM configurations first run on the card
# here, at full width
# ---------------------------------------------------------------------------

#: Per configuration: the depth of the f32 reference (4d) and of the bf16
#: training (8d), each a whole number of ``cfg.period`` (gemma3-12b's 6 is
#: one 5:1 local:global period, so a global layer is in); the serve
#: weights (5d, full depth; mixtral-8x7b's experts int8, drawn and
#: quantized expert matrix by expert matrix) and the 8d state at 14 B a
#: parameter (the bf16 weight, its f32 master, m and v: what the step
#: holds between steps), both reckoned from the configs (GB); and the
#: prompt length
#: of the request that crosses the window of the local layers (0: no
#: window). 4d cuts mixtral-8x7b's expert d_ff to HYBRID_REF_FFN, as 4j
#: cuts Jamba's.
FULLWIDTH = {
    "gemma-2b": dict(ref_layers=2, train_layers=18, weight_gb=5.012,
                     train_gb=35.09, cross=0),
    "gemma3-12b": dict(ref_layers=6, train_layers=6, weight_gb=23.532,
                       train_gb=32.92, cross=1100),
    "phi3-medium-14b": dict(ref_layers=2, train_layers=4, weight_gb=29.320,
                            train_gb=33.47, cross=0),
    "starcoder2-15b": dict(ref_layers=2, train_layers=4, weight_gb=31.919,
                           train_gb=29.95, cross=0),
    "mixtral-8x7b": dict(ref_layers=2, train_layers=2, weight_gb=48.322,
                         train_gb=44.31, cross=4200),
}
FULLWIDTH_WEIGHT_RTOL = 0.01       # measured weight bytes vs reckoned
# 4d: 2 greedy requests of 8 + 4 on 2 slots; the crossing request gets 8
# new tokens. 5d: 8 of 8 + 16 on 8 slots (16-token pages, a dense 8 x 128
# rectangle), each engine after a warm-up of 8 of 8 + 2 whose first decode
# step is held to plain; the crossing request gets 16 new tokens, and its
# first FULLWIDTH_CROSS_HELD decode steps are held (the plain esffn_glu at
# mixtral-8x7b's width is ~100 ms a call, 32 a step).
FULLWIDTH_REF_REQUESTS, FULLWIDTH_REF_PROMPT, FULLWIDTH_REF_NEW = 2, 8, 4
FULLWIDTH_SERVE_REQUESTS, FULLWIDTH_SERVE_NEW = 8, 16
FULLWIDTH_CROSS_REF_NEW, FULLWIDTH_CROSS_NEW = 8, 16
FULLWIDTH_CROSS_CHUNK, FULLWIDTH_CROSS_HELD = 256, 2
# mixtral-8x7b's paged run is the serve CLI a user with one card types
FULLWIDTH_CLI = {"mixtral-8x7b": [
    "--arch", "mixtral-8x7b", "--quant", "int8", "--paged", "--slots", "8",
    "--requests", str(FULLWIDTH_SERVE_REQUESTS), "--max-new",
    str(FULLWIDTH_SERVE_NEW)]}
# 5d crosses the windows at full depth on the paged engine only: the
# dense engine prefills token by token, and gemma3-12b's 1,116 forwards of
# 48 layers took 92.2 s on an H100 80GB HBM3 at 700 W (mixtral-8x7b's
# 4,216 of 32 would take more); 4d crosses both windows on both engines
FULLWIDTH_PEAK_NOTE_GB = 72.0      # an 8d peak past this is reported


def _fullwidth_config(arch, dtype, layers=None):
    """``arch`` at full width in ``dtype``, cut to ``layers``; in f32 an
    MoE config's expert d_ff is cut to HYBRID_REF_FFN."""
    from repro_torch import configs as cfglib

    cfg = dataclasses.replace(cfglib.get_config(arch), dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if dtype == "float32" and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_ff=HYBRID_REF_FFN))
    return cfg


def _hold_steps(server, held, n):
    """The first ``n`` calls of ``server.serve_step`` (a paged engine's
    decode step, a dense engine's macro-step) run inside ``held``."""
    step, left = server.serve_step, [n]

    def run(*args, **kw):
        if left[0] <= 0:
            return step(*args, **kw)
        left[0] -= 1
        with held:
            return step(*args, **kw)

    server.serve_step = run


def _engine_run(torch, server, reqs):
    """Submit ``reqs``, set the launch counts to 0, run to the end.
    Returns (done, wall s, counts)."""
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return done, wall, _read_counts()


def _expect_launches(tag, cfg, server, counts, quant=None):
    """The launches of one engine run: one ``esffn_glu`` a MoE layer a
    forward (a prefill chunk, a decode step, a dense macro-step), every one
    on the stream route (int8 where ``quant``), and on the paged engine one
    bf16 ``paged_attention`` an attention layer a decode step (the chunked
    prefill attends through einsums, as JAX's). Returns the launches."""
    n_moe, n_attn = _hybrid_launch_counts(cfg)
    paged = hasattr(server, "trace")
    if paged:
        chunks, decodes, _ = _forwards(server.trace)
    else:
        chunks, decodes = 0, len(server.decode_times_s)
    want = {"esffn_glu": n_moe * (chunks + decodes),
            "paged_attention": n_attn * decodes if paged else 0}
    got = {k: counts[k] for k in want}
    if got != want or counts["esffn_glu_routes"] != {
            "stream": want["esffn_glu"], "wgmma": 0} \
            or counts["esffn_glu_quant"].get("int8", 0) != (
                want["esffn_glu"] if quant else 0) \
            or counts["paged_attention_quant"]["int8"]:
        raise AssertionError(f"phase {tag}: launches {counts}, expected "
                             f"{want} ({chunks} prefill chunks, {decodes} "
                             f"decode steps)")
    return got


def _cross_window(torch, tag, cfg, pcfg, params, quant, new, kinds, held,
                  hold_steps=None):
    """One request of ``FULLWIDTH[arch]["cross"]`` prompt tokens and
    ``new`` new ones, past the window of ``cfg``'s local layers, on 1 slot
    of each engine in ``kinds``: the paged engine prefills it in
    FULLWIDTH_CROSS_CHUNK-token chunks (mixtral-8x7b's pages wholly behind
    its window go back to the pool as it decodes), the dense engine token
    by token into its ``min(max_seq, window)``-row rolling buffer. The
    paged run goes through ``held``: whole, or its first ``hold_steps``
    decode steps. Returns ({kind: result}, {kind: tokens})."""
    import numpy as np
    from repro_torch.common import cdiv
    from repro_torch.launch import serve

    n = FULLWIDTH[cfg.name]["cross"]
    if not n > cfg.window:
        raise AssertionError(f"phase {tag}: a {n}-token prompt does not "
                             f"cross the {cfg.window}-token window")
    prompt = np.random.default_rng(43).integers(
        0, cfg.vocab_size, size=n).astype(np.int32)
    maxp = cdiv(n + new, 16)
    out, toks = {}, {}
    for kind in kinds:
        if kind == "paged":
            server = serve.PagedServer(
                cfg, pcfg, num_slots=1, page_size=16, num_pages=1 + maxp,
                max_pages_per_slot=maxp, params=params,
                prefill_chunk=FULLWIDTH_CROSS_CHUNK, device="cuda")
        else:
            server = serve.BatchedServer(cfg, pcfg, num_slots=1,
                                         max_seq=n + new, params=params,
                                         device="cuda")
        if kind == "paged" and hold_steps:
            _hold_steps(server, held, hold_steps)
        before = dict(held.checks)
        torch.cuda.reset_peak_memory_stats()
        with (held if kind == "paged" and not hold_steps
              else contextlib.nullcontext()):
            done, wall, counts = _engine_run(
                torch, server, [serve.Request(rid=0, prompt=prompt,
                                              max_new=new)])
        launches = _expect_launches(f"{tag} crossing ({kind})", cfg, server,
                                    counts, quant=quant)
        if len(done) != 1 or len(done[0].out) != new:
            raise AssertionError(f"phase {tag} crossing ({kind}): the "
                                 f"request did not finish")
        if kind == "paged":
            _drained(server, f"phase {tag} crossing")
        steps = server.decode_times_s
        first = server.ttft_s[0]
        toks[kind] = list(done[0].out)
        out[kind] = {
            "prompt": n, "new": new, "window": cfg.window,
            "wall_s": wall, "ttft_ms": first * 1e3,
            "decode_step_median_ms": statistics.median(
                steps[-(new - 1):]) * 1e3,
            "steps": len(steps), "launches": launches,
            "launches_quant": {"esffn_glu": counts["esffn_glu_quant"]},
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "held_checks": {k: held.checks[k] - before[k]
                            for k in held.checks}}
        print(f"[{tag}] {cfg.name} crossing ({kind}): {n} + {new} tokens "
              f"past the {cfg.window}-token window in {wall:.2f}s (TTFT "
              f"{first * 1e3:.1f}ms, decode step median "
              f"{out[kind]['decode_step_median_ms']:.2f}ms); launches "
              f"{launches}; held to plain "
              f"{out[kind]['held_checks']}")
        del server, done
    return out, toks


def fullwidth_kernel_cases(torch, flush):
    """Phase 3d: the two kernels at the shapes the five configurations give
    them. ``paged_attention`` (bf16, page 16) at each one's heads (gemma-2b
    8/1 hd 256, gemma3-12b 16/8 hd 256, phi3-medium-14b 40/10, starcoder2-15b
    48/4, mixtral-8x7b 32/8, hd 128) over 5d's lengths on 8 slots, with the
    window its local layers pass, and at the crossing requests' lengths
    (gemma3-12b 1,116 with its 1,024 window and without, for its global
    layers; mixtral-8x7b 4,216 with its 4,096 window), checked as phase 3
    checks; ``esffn_glu``'s 8-bit stream route at mixtral-8x7b's experts
    (D 4096, F 14,336, E 8, top-2, blk 16, int8 payloads with 128 x 128
    tile scales 2^-2 .. 2^2 apart) for N 8 (a decode step of 8 slots) and
    16 (a 16-token prefill chunk) against the plain version at ESFFN_TOL.
    All timed, the bounds from the bytes the case needs."""
    from repro_torch import configs as cfglib
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route
    from repro_torch.kernels import esffn
    from repro_torch.kernels import paged_attention as pa

    t_phase = time.perf_counter()
    res = {"esffn_glu": [], "paged_attention": []}
    gen = torch.Generator(device="cuda").manual_seed(37)
    page = 16
    serve_lengths = [FULLWIDTH_REF_PROMPT + 1 + 2 * i for i in range(8)]
    for arch, fw in FULLWIDTH.items():
        cfg = cfglib.get_config(arch)
        local = cfg.window if "local" in cfg.attn_pattern else None
        shapes = [(f"{arch} heads, 5d lengths", 8, serve_lengths,
                   128 // page, local)]
        if fw["cross"]:
            n = fw["cross"] + FULLWIDTH_CROSS_NEW
            shapes.append((f"{arch} heads, crossing length", 1, [n],
                           -(-n // page), cfg.window))
            if "global" in cfg.attn_pattern:
                shapes.append((f"{arch} heads, crossing length, global "
                               f"layer", 1, [n], -(-n // page), None))
        for case, b, lengths_l, maxp, window in shapes:
            maxp = max(maxp, -(-max(lengths_l) // page))
            args, _ = _paged_inputs(torch, gen, b, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.hd, page,
                                    lengths_l, maxp, "bfloat16")
            kw = {"window": window}
            _, _, err, tol, worst = _paged_check(
                torch, f"paged_attention {case}", args, kw, "bfloat16")
            nbytes, flops = _paged_work(args, False, window)
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            res["paged_attention"].append({
                "case": case,
                "shape": {"B": b, "Hq": cfg.num_heads,
                          "Hkv": cfg.num_kv_heads, "hd": cfg.hd,
                          "page": page, "maxp": maxp, "lengths": lengths_l,
                          "window": window, "softcap": 0.0,
                          "splits": pa.num_splits(maxp)},
                "dtype": "bfloat16", "max_abs_err": err, "tolerance": tol,
                "worst_slot_err_over_tol": worst,
                "kernel_ms": time_ms(torch, lambda: pa.paged_attention(
                    *args, **kw), flush),
                "plain_ms": time_ms(torch, lambda: pa.paged_attention_ref(
                    *args, **kw), flush, iters=5, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library": "none: no one call takes the paged layout"})
            del args

    cfg = cfglib.get_config("mixtral-8x7b")
    d, e, f, k, blk = (cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff,
                       cfg.moe.top_k, 16)

    def payload(shape):
        q = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        tiles = (shape[0], shape[1] // 128, shape[2] // 128)
        s = 0.02 / 127 * torch.exp2(torch.rand(
            tiles, generator=gen, device="cuda") * 4 - 2)
        return q, s

    qs = [payload(s) for s in ((e, d, f), (e, d, f), (e, f, d))]
    wq, sc = [q for q, _ in qs], tuple(s for _, s in qs)
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    for n in (8, 16):
        x = torch.randn((n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        r = route(x, router, k)
        ri = build_reindex(r.expert_idx, r.gates, e, blk)
        args = (x, ri.row_token, ri.row_gate, ri.block_expert, *wq)
        name = f"esffn_glu int8 mixtral N={n} blk={blk} bfloat16"
        plain = esffn.esffn_glu_plain(*args, w_scales=sc)
        kern, kroute = _routed(torch, lambda: esffn.esffn_glu(
            *args, w_scales=sc), esffn.esffn_glu)
        if kroute != "stream":
            raise AssertionError(f"{name}: took the {kroute} route")
        err, tol = _check(name, kern, plain, ESFFN_TOL["bfloat16"])
        del plain, kern
        live = (ri.row_gate.reshape(-1, blk) != 0).any(dim=1)
        experts = torch.unique(ri.block_expert[live]).numel()
        np_rows = ri.row_token.numel()
        nbytes = (n * d * 2 + experts * 3 * d * f
                  + experts * sum(s[0].numel() for s in sc) * 4
                  + np_rows * 8 + ri.block_expert.numel() * 4
                  + np_rows * d * 2)
        flops = 6 * int((ri.row_gate != 0).sum()) * d * f
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        res["esffn_glu"].append({
            "case": "mixtral-8x7b experts",
            "shape": {"N": n, "D": d, "E": e, "F": f, "top_k": k, "blk": blk,
                      "Np": np_rows, "live_blocks": int(live.sum()),
                      "experts_read": experts},
            "dtype": "bfloat16", "weights": "int8", "kernel_route": kroute,
            "max_abs_err": err, "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: esffn.esffn_glu(
                *args, w_scales=sc), flush, iters=10),
            "plain_ms": time_ms(torch, lambda: esffn.esffn_glu_plain(
                *args, w_scales=sc), flush, iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": _NO_LIBRARY_Q})
    del qs, wq, sc
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[3d] paged_attention at the five configurations' heads and "
          f"esffn_glu int8 at mixtral-8x7b's experts: "
          f"{len(res['paged_attention']) + len(res['esffn_glu'])} cases "
          f"checked and timed in {res['seconds']:.1f}s")
    return res


def fullwidth_reference_phase(torch, arch):
    """Phase 4d: ``arch`` at full width, f32, cut to its FULLWIDTH
    ``ref_layers`` (mixtral-8x7b's expert d_ff to HYBRID_REF_FFN), seed 41:
    FULLWIDTH_REF_REQUESTS greedy requests of FULLWIDTH_REF_PROMPT +
    FULLWIDTH_REF_NEW tokens on 2 slots through the card's
    ``BatchedServer`` and ``PagedServer`` and the CPU's ``PagedServer``
    from the same weights (on the CPU lane, ``_fullwidth_reference_cpu``):
    every stream equal; the card engines' every
    ``paged_attention`` and ``esffn_glu`` launch held to its plain version
    (``_HeldToPlain``), the paged run's launches counted from 0 and as
    ``_expect_launches`` says. Where the config has a window, one request
    past it (``_cross_window``, FULLWIDTH_CROSS_REF_NEW new tokens) on
    both card engines: the streams equal, every paged launch held. This
    is the one place the windows are checked exactly: the CPU cannot
    prefill 1,100-4,200 tokens at this width in the script's time."""
    import numpy as np
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    t_phase = time.perf_counter()
    tag = "4d"
    cfg = _fullwidth_config(arch, "float32", FULLWIDTH[arch]["ref_layers"])
    pcfg = ParallelConfig(blk=16)
    params = lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(41), device="cuda")
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, size=FULLWIDTH_REF_PROMPT)
               .astype(np.int32) for _ in range(FULLWIDTH_REF_REQUESTS)]
    held = _HeldToPlain(path=f"phase 4d {arch}")
    streams, wall, launches = {}, {}, {}
    for kind in ("dense", "paged"):
        key = f"{kind} cuda"
        server = _fullwidth_ref_engine(cfg, pcfg, kind, "cuda", params)
        with held:
            done, wall[key], counts = _engine_run(
                torch, server, _fullwidth_ref_requests(prompts))
        launches[key] = _expect_launches(f"{tag} {arch} ({key})", cfg,
                                         server, counts)
        streams[key] = {r.rid: list(r.out) for r in done}
        if kind == "paged":
            _drained(server, f"phase {tag} {arch} ({key})")
        del server, done
    want = streams["dense cuda"]
    if len(want) != FULLWIDTH_REF_REQUESTS or any(
            len(o) != FULLWIDTH_REF_NEW for o in want.values()) or any(
            st != want for st in streams.values()):
        raise AssertionError(f"phase {tag} {arch}: greedy tokens differ: "
                             f"{streams}")
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    to_cpu_s = time.perf_counter() - t0
    _LANE.submit(f"4d {arch}", n_bytes, _fullwidth_reference_cpu, arch, cfg,
                 pcfg, cpu_params, prompts, want)
    del cpu_params
    res = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.hd],
           "moe_d_ff": cfg.moe.d_ff if cfg.moe else None,
           "weights_gb": n_bytes / 1e9, "to_cpu_s": to_cpu_s,
           "tokens": {str(k): v for k, v in want.items()},
           "engines": sorted(streams) + ["paged cpu"], "launches": launches,
           "wall_s": wall}
    if FULLWIDTH[arch]["cross"]:
        xheld = _HeldToPlain(path=f"phase 4d {arch} window crossing")
        res["cross"], toks = _cross_window(
            torch, tag, cfg, pcfg, params, None, FULLWIDTH_CROSS_REF_NEW,
            ("paged", "dense"), xheld)
        if toks["paged"] != toks["dense"]:
            raise AssertionError(f"phase {tag} {arch}: past the window the "
                                 f"paged engine's tokens {toks['paged']} "
                                 f"differ from the dense engine's "
                                 f"{toks['dense']}")
        res["cross"]["tokens"] = toks["paged"]
        res["cross"]["held_worst_err_over_limit"] = dict(xheld.worst)
    res["held_checks"] = dict(held.checks)
    res["held_worst_err_over_limit"] = dict(held.worst)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[{tag}] {arch}, {cfg.num_layers} layers at full width"
          f"{f' (expert d_ff {cfg.moe.d_ff})' if cfg.moe else ''}, f32, "
          f"{n_bytes / 1e9:.2f} GB: greedy tokens {want} equal on "
          f"{sorted(streams)} (the CPU's paged engine on the lane); card "
          f"launches {launches}, each held to plain "
          f"({held.checks}, worst err / limit "
          f"{ {k: round(v, 4) for k, v in held.worst.items()} })"
          + (f"; past the window: tokens {res['cross']['tokens']} equal on "
             f"both card engines" if "cross" in res else "")
          + f"; phase {res['seconds']:.1f}s")
    del params
    return res


def _fullwidth_ref_engine(cfg, pcfg, kind, device, p):
    """Phase 4d's engines: 2 slots, 16-token pages."""
    from repro_torch.launch import serve

    if kind == "dense":
        return serve.BatchedServer(cfg, pcfg, num_slots=2, max_seq=64,
                                   params=p, device=device)
    return serve.PagedServer(cfg, pcfg, num_slots=2, page_size=16,
                             num_pages=9, max_pages_per_slot=4, params=p,
                             device=device)


def _fullwidth_ref_requests(prompts):
    from repro_torch.launch import serve

    return [serve.Request(rid=i, prompt=pr, max_new=FULLWIDTH_REF_NEW)
            for i, pr in enumerate(prompts)]


def _fullwidth_reference_cpu(arch, cfg, pcfg, cpu_params, prompts, want):
    """Phase 4d's CPU side: the CPU's ``PagedServer`` (the plain versions)
    gives the card's streams and drains its pool."""
    server = _fullwidth_ref_engine(cfg, pcfg, "paged", "cpu", cpu_params)
    for r in _fullwidth_ref_requests(prompts):
        server.submit(r)
    got = {r.rid: list(r.out) for r in server.run()}
    _drained(server, f"phase 4d {arch} (paged cpu)")
    if got != want:
        raise AssertionError(f"phase 4d {arch}: the CPU's greedy tokens "
                             f"{got} != the card's {want}")
    print(f"[4d] {arch}: PagedServer (CPU) == the card's greedy tokens "
          f"{want}")


def _fullwidth_cli(torch, tag, cfg, argv):
    """The serve CLI (``launch.serve.main(argv)``) in process, its printed
    lines captured and shown, the kernels' counts set to 0 just before it
    and read just after (``_expect_launches``; every ``esffn_glu`` on the
    int8 stream route). Returns (result, {rid: tokens})."""
    import io

    from repro_torch.common import tree_leaves
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import lm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    with _ServerLog() as log, contextlib.redirect_stdout(out):
        done = serve_lib.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = _read_counts(), torch.cuda.max_memory_allocated()
    printed = out.getvalue().splitlines()
    for line in printed:
        print(f"[{tag}] {cfg.name} serve CLI | {line}")
    srv = log.servers[0]
    launches = _expect_launches(f"{tag} {cfg.name} (serve CLI)", cfg, srv,
                                counts, quant="int8")
    _drained(srv, f"phase {tag} {cfg.name} (serve CLI)")
    if len(done) != FULLWIDTH_SERVE_REQUESTS or any(
            len(r.out) != FULLWIDTH_SERVE_NEW for r in done):
        raise AssertionError(f"phase {tag} {cfg.name}: the serve CLI did "
                             f"not finish every request")
    steps = srv.decode_times_s
    tokens = sum(len(r.out) for r in done)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(srv.params))
    res = {"entry": "launch.serve.main " + " ".join(argv),
           "requests": len(done), "tokens": tokens, "wall_s": wall,
           "run_s": log.run_s[0], "tok_per_s": tokens / log.run_s[0],
           "decode_step_median_ms": statistics.median(steps[1:]) * 1e3,
           "decode_steps": len(steps),
           "ttft_median_ms": statistics.median(srv.ttft_s.values()) * 1e3,
           "peak_allocated_gb": peak / 1e9, "weights_gb": n_bytes / 1e9,
           "cache_bytes": lm.cache_bytes(srv.cache), "launches": launches,
           "launches_quant": {"esffn_glu": counts["esffn_glu_quant"]},
           "printed": printed}
    streams = {r.rid: list(r.out) for r in done}
    del srv, log, done
    return res, streams


def fullwidth_serve_phase(torch, arch):
    """Phase 5d: ``arch`` at full width and depth in bf16 (mixtral-8x7b's
    experts int8, drawn and quantized expert matrix by expert matrix),
    seed 0, FULLWIDTH_SERVE_REQUESTS greedy requests of 8 (the serve CLI's
    prompts) + FULLWIDTH_SERVE_NEW tokens through ``PagedServer`` (8
    slots, 16-token pages) and ``BatchedServer`` (8 x 128), each after an
    unmeasured warm-up (8 of 8 + 2) whose first decode step is held to
    plain, the counts set to 0 just before each run and read just after
    (``_expect_launches``). mixtral-8x7b's paged run is the serve CLI
    (FULLWIDTH_CLI), its printed lines captured, last: after both
    warm-ups, the dense run and the crossing, once the phase's weights
    are freed (the CLI draws its own; both would not fit). Prints the
    decode-step median (the first step left out, as the CLI leaves it
    out) against the byte bound of reading the weights once, tok/s,
    TTFT, peak memory, weight and KV bytes; the two engines' bf16 streams
    are counted, not asserted. Then the window-crossing request
    (``_cross_window``, its first FULLWIDTH_CROSS_HELD decode steps held)
    on the paged engine."""
    import numpy as np
    from repro_torch.common import tree_leaves
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    t_phase = time.perf_counter()
    tag = "5d"
    fw = FULLWIDTH[arch]
    cfg = _fullwidth_config(arch, "bfloat16")
    quant = "int8" if cfg.moe is not None else None
    pcfg = ParallelConfig(blk=16)
    slots, page, max_seq = 8, 16, 128
    maxp = max_seq // page
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(FULLWIDTH_SERVE_REQUESTS)]
    res = {"arch": arch, "layers": cfg.num_layers,
           "weights": quant and f"bf16 + {quant} experts" or "bf16",
           "reckoned_weights_gb": fw["weight_gb"]}
    outs = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda", quant=quant)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    if abs(n_bytes / 1e9 - fw["weight_gb"]) > FULLWIDTH_WEIGHT_RTOL * \
            fw["weight_gb"]:
        raise AssertionError(f"phase {tag} {arch}: {n_bytes / 1e9} GB of "
                             f"weights, reckoned {fw['weight_gb']}")
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    res.update(weights_gb=n_bytes / 1e9, init_s=init_s,
               init_peak_allocated_gb=init_peak / 1e9,
               decode_bound_ms=bound_ms)
    held = _HeldToPlain(path=f"phase 5d {arch}")

    def make(kind):
        if kind == "paged":
            return serve.PagedServer(
                cfg, pcfg, num_slots=slots, page_size=page,
                num_pages=1 + slots * maxp, max_pages_per_slot=maxp,
                params=params, prefill_chunk=16, device="cuda")
        return serve.BatchedServer(cfg, pcfg, num_slots=slots,
                                   max_seq=max_seq, params=params,
                                   device="cuda")

    for kind in ("paged", "dense"):
        warm = make(kind)
        _hold_steps(warm, held, 1)
        for i in range(slots):
            warm.submit(serve.Request(rid=-1 - i, prompt=np.arange(
                8, dtype=np.int32) + i, max_new=2))
        warm.run()
        del warm
        if kind == "paged" and arch in FULLWIDTH_CLI:
            continue                  # the serve CLI's run, below
        server = make(kind)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        done, wall, counts = _engine_run(torch, server, [
            serve.Request(rid=i, prompt=pr, max_new=FULLWIDTH_SERVE_NEW)
            for i, pr in enumerate(prompts)])
        peak = torch.cuda.max_memory_allocated()
        launches = _expect_launches(f"{tag} {arch} ({kind})", cfg, server,
                                    counts, quant=quant)
        if len(done) != len(prompts) or any(
                len(r.out) != FULLWIDTH_SERVE_NEW for r in done) or not all(
                0 <= t < cfg.vocab_size for r in done for t in r.out):
            raise AssertionError(f"phase {tag} {arch} ({kind}): not every "
                                 f"request finished in the vocabulary")
        if kind == "paged":
            _drained(server, f"phase {tag} {arch}")
        steps = server.decode_times_s
        tokens = sum(len(r.out) for r in done)
        outs[kind] = {r.rid: list(r.out) for r in done}
        res[kind] = {
            "requests": len(done), "tokens": tokens, "wall_s": wall,
            "tok_per_s": tokens / wall,
            "decode_step_median_ms": statistics.median(steps[1:]) * 1e3,
            "decode_steps": len(steps),
            "ttft_median_ms": statistics.median(
                server.ttft_s.values()) * 1e3,
            "peak_allocated_gb": peak / 1e9,
            "cache_bytes": lm.cache_bytes(server.cache),
            "launches": launches,
            "launches_quant": {"esffn_glu": counts["esffn_glu_quant"]}}
        del server, done
    if fw["cross"]:
        res["cross"], toks = _cross_window(
            torch, tag, cfg, pcfg, params, quant, FULLWIDTH_CROSS_NEW,
            ("paged",), held, hold_steps=FULLWIDTH_CROSS_HELD)
        res["cross"]["tokens"] = toks["paged"]
    del params
    if arch in FULLWIDTH_CLI:         # after the warm-ups: the weights
        _release(torch)               # of its own are drawn again
        res["paged"], outs["paged"] = _fullwidth_cli(torch, tag, cfg,
                                                     FULLWIDTH_CLI[arch])
    for kind in ("paged", "dense"):
        r = res[kind]
        r["decode_over_bound"] = r["decode_step_median_ms"] / bound_ms
        print(f"[{tag}] {arch} ({kind}): {r['requests']} requests, "
              f"{r['tokens']} tokens ({r['tok_per_s']:.1f} tok/s); decode "
              f"step median {r['decode_step_median_ms']:.2f}ms over "
              f"{r['decode_steps']} steps = {r['decode_over_bound']:.2f} x "
              f"the {bound_ms:.2f}ms byte bound; TTFT median "
              f"{r['ttft_median_ms']:.1f}ms; peak allocated "
              f"{r['peak_allocated_gb']:.2f} GB; KV "
              f"{r['cache_bytes'] / 1e6:.1f} MB; launches {r['launches']}")
    res["dense_streams_equal_to_paged"] = sum(
        outs["dense"][rid] == outs["paged"][rid] for rid in outs["paged"])
    res["held_checks"] = dict(held.checks)
    res["held_worst_err_over_limit"] = dict(held.worst)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[{tag}] {arch}, {cfg.num_layers} layers at full width, "
          f"{res['weights']}: {n_bytes / 1e9:.3f} GB of weights (reckoned "
          f"{fw['weight_gb']}; drawn in {init_s:.1f}s, peak "
          f"{init_peak / 1e9:.2f} GB); {res['dense_streams_equal_to_paged']}"
          f" of {len(prompts)} dense streams equal the paged engine's; held "
          f"to plain {held.checks}, worst err / limit "
          f"{ {k: round(v, 4) for k, v in held.worst.items()} }; phase "
          f"{res['seconds']:.1f}s")
    return res


def fullwidth_train_phase(torch, arch):
    """Phase 8d: ``arch`` at full width cut to its FULLWIDTH
    ``train_layers``, bf16, through ``_family_train`` (AdamW with f32
    masters, ``remat="block"``, TRAIN_BATCH x TRAIN_SEQ rows, blk 128);
    mixtral-8x7b's 2 MoE layers launch 2 ``esffn_glu``, 5 ``esmm`` and 3
    ``estmm`` a layer a step, all on wgmma. A peak past
    FULLWIDTH_PEAK_NOTE_GB is printed as a finding."""
    cfg = _fullwidth_config(arch, "bfloat16",
                            FULLWIDTH[arch]["train_layers"])
    n = _moe_layers(cfg)
    res = _family_train(torch, "8d", cfg, TRAIN_BATCH, TRAIN_SEQ,
                        expect=n and {"esffn_glu": 2 * n, "esmm": 5 * n,
                                      "estmm": 3 * n} or None)
    res["reckoned_state_gb"] = FULLWIDTH[arch]["train_gb"]
    res["tokens_per_s"] = res["rows_per_s"]
    if res["peak_allocated_gb"] > FULLWIDTH_PEAK_NOTE_GB:
        print(f"[8d] finding: {arch}'s peak {res['peak_allocated_gb']:.2f} "
              f"GB is past {FULLWIDTH_PEAK_NOTE_GB} GB")
    print(f"[8d] {arch}: {res['state_gb']:.2f} GB of state (reckoned "
          f"{res['reckoned_state_gb']}), step median "
          f"{res['step_median_ms']:.1f}ms, {res['tokens_per_s']:.1f} "
          f"tokens/s; phase {res['seconds']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phases M, H, R: the mesh islands, heterogeneous execution, roofline
# ---------------------------------------------------------------------------

SWIN_KERNELS = ("esffn_mlp", "esmm", "esfk", "ess", "estmm")


def _swin_kernel_fns():
    from repro_torch.kernels import esffn, esfk, esmm, ess, estmm

    return {"esffn_mlp": esffn.esffn_mlp, "esmm": esmm.esmm,
            "esfk": esfk.esfk, "ess": ess.ess, "estmm": estmm.estmm,
            "esffn_glu": esffn.esffn_glu}


def _reset_launches(fns):
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def mesh_phase(torch):
    """Phase M: Swin-MoE-Small's train step on a 1-rank NCCL mesh in each
    mode and cache policy, against the mesh-less step."""
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.configs import swin_moe_small
    from repro_torch.launch.mesh import make_mesh, single_rank_nccl
    from repro_torch.models import swin
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import (
        ParallelConfig, shard_tree, unshard_tree)

    cfg = swin_moe_small.CONFIG
    opt_cfg = adamw.OptimizerConfig(master_fp32=False)
    fns = _swin_kernel_fns()
    t_phase = time.perf_counter()
    with single_rank_nccl():
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        # create every communicator before anything is timed
        for axes in (("pod",), ("data",), ("model",), ("pod", "data"),
                     ("pod", "data", "model")):
            mesh.all_reduce(torch.ones(1, device="cuda"), axes)
        torch.cuda.synchronize()
        gen = torch.Generator(device="cuda").manual_seed(0)
        swin.init_swin(cfg, generator=gen, device="cuda")  # phase 11's draws
        batches = [swin.synthetic_batch(cfg, SWIN_BATCH, generator=gen,
                                        device="cuda")
                   for _ in range(SWIN_STEPS)]
        del gen

        def fresh():
            g = torch.Generator(device="cuda").manual_seed(0)
            return swin.init_swin(cfg, generator=g, device="cuda")

        def run(step, params, opt):
            log, times = [], []
            for i in range(SWIN_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, _, m = step(params, opt, *batches[i])
                m = {k: float(v) for k, v in m.items()}
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                log.append(m)
            return log, times

        params = fresh()
        opt = adamw.init_opt_state(params, opt_cfg)
        torch.cuda.reset_peak_memory_stats()
        ref_log, ref_times = run(swin.make_train_step(
            cfg, ParallelConfig(blk=128), opt_cfg), params, opt)
        ref_peak = torch.cuda.max_memory_allocated()
        ref_params = [t.detach().clone() for t in tree_leaves(params)]
        del params, opt
        _release(torch)
        med = statistics.median(ref_times)
        print(f"[mesh] mesh-less reference: losses "
              f"{[m['loss'] for m in ref_log]}; step median "
              f"{med * 1e3:.1f}ms, {SWIN_BATCH / med:.1f} images/s, peak "
              f"{ref_peak / 1e9:.2f} GB")
        out = {"reference": {"losses": [m["loss"] for m in ref_log],
                             "step_times_s": ref_times,
                             "step_median_ms": med * 1e3,
                             "images_per_s": SWIN_BATCH / med,
                             "peak_allocated_gb": ref_peak / 1e9}}
        launches_by_path = {}
        shapes = swin.param_shapes(cfg)
        for mode, policy in MESH_MODES:
            pcfg = ParallelConfig(blk=128, mode=mode, cache_policy=policy,
                                  capacity_factor=8.0)
            specs = swin.param_specs(cfg, pcfg)
            full = fresh()
            params = shard_tree(full, specs, pcfg, mesh)
            del full
            opt = adamw.init_opt_state(params, opt_cfg)
            step = swin.make_train_step(cfg, pcfg, opt_cfg, mesh=mesh)
            _release(torch)
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(fns)
            log, times = run(step, params, opt)
            peak = torch.cuda.max_memory_allocated()
            launches = {k: fns[k].launches for k in SWIN_KERNELS}
            routes = {k: dict(fns[k].launches_by_route)
                      for k in ("esffn_mlp", "esmm", "esfk")}
            gathered = unshard_tree(tree_map(lambda t: t.detach(), params),
                                    specs, shapes, pcfg, mesh)
            tol = MESH_EP_TOL if mode == "ep" else MESH_PARAM_TOL
            worst = 0.0
            for a, b in zip(tree_leaves(gathered), ref_params):
                worst = max(worst, (a - b).abs().max().item())
            errs = [abs(m["loss"] - r["loss"]) / abs(r["loss"])
                    for m, r in zip(log, ref_log)]
            loss_err = max(errs)
            name = f"{mode}/{policy}"
            if not (errs[0] <= SWIN_LOSS_RTOL and loss_err <= (
                    MESH_EP_LOSS_RTOL if mode == "ep" else SWIN_LOSS_RTOL)):
                raise AssertionError(f"phase M {name}: losses "
                                     f"{[m['loss'] for m in log]} vs "
                                     f"{[m['loss'] for m in ref_log]}")
            if not worst <= tol:
                raise AssertionError(f"phase M {name}: gathered params "
                                     f"{worst} from the mesh-less step's "
                                     f"(limit {tol})")
            if mode != "ep" and (launches["esffn_mlp"] == 0
                                 or launches["esfk"] == 0):
                raise AssertionError(f"phase M {name}: launches {launches}")
            med = statistics.median(times)
            print(f"[mesh] {name}: losses {[m['loss'] for m in log]} (worst "
                  f"rel diff {loss_err:.2e}), gathered params within "
                  f"{worst:.2e} of the mesh-less step's; step median "
                  f"{med * 1e3:.1f}ms, {SWIN_BATCH / med:.1f} images/s, peak "
                  f"{peak / 1e9:.2f} GB; launches {launches}")
            out[name] = {"losses": [m["loss"] for m in log],
                         "loss_rel_diff": loss_err,
                         "param_max_abs_diff": worst, "param_tol": tol,
                         "step_times_s": times, "step_median_ms": med * 1e3,
                         "images_per_s": SWIN_BATCH / med,
                         "peak_allocated_gb": peak / 1e9,
                         "launches": launches, "launches_by_route": routes}
            launches_by_path[f"swin_mesh_{mode}_{policy}"] = launches
            del params, opt, step, gathered
            _release(torch)
        janus = out["data_centric/janus"]["peak_allocated_gb"]
        shared = out["data_centric/shared_cache"]["peak_allocated_gb"]
        expert_gb = sum(
            t.numel() * t.element_size()
            for st in fresh()["stages"] for b in st["blocks"]
            if "moe" in b for k, t in b["moe"].items()
            if k in ("w1", "w2")) / 1e9
        _release(torch)
        out["janus_minus_shared_cache_gb"] = janus - shared
        out["expert_weight_gb"] = expert_gb
        print(f"[mesh] data_centric peak: janus {janus:.3f} GB, shared_cache "
              f"{shared:.3f} GB: {janus - shared:+.3f} GB kept for the "
              f"backward (the expert weights: {expert_gb:.3f} GB); 1 rank: "
              f"no traffic crosses a chip")
        out["baselines"] = _mesh_baselines(torch, cfg, mesh, fresh, run,
                                           opt_cfg)
    out["seconds"] = time.perf_counter() - t_phase
    return launches_by_path, out


def _mesh_baselines(torch, cfg, mesh, fresh, run, opt_cfg):
    """Phase M's baselines: Swin-MoE-Small's train steps through
    ``moe_impl="tutel"`` (capacity factor 1.25: copies drop) and
    ``"megablocks"`` on the 1-rank mesh against the mesh-less steps: the
    losses within SWIN_LOSS_RTOL, the parameters after the steps (so the
    gradients) within MESH_PARAM_TOL, the copies each step drops equal;
    a step median each. The baselines compute with ``torch.bmm``: no
    kernel of the port is on their path."""
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.core import baselines
    from repro_torch.models import swin
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import (
        ParallelConfig, shard_tree, unshard_tree)

    real = baselines.dispatch_combine_moe
    drops = []

    def counting(x, r, w1, *a, capacity=None, capacity_factor=1.25,
                 rank_offset=None, **kw):
        n, k = r.expert_idx.shape
        e = w1.shape[0]
        cap = capacity or baselines.tutel_capacity(n, k, e, capacity_factor)
        rank, _ = baselines._dispatch_ranks(r.expert_idx, e)
        if rank_offset is not None:
            rank = rank + rank_offset[r.expert_idx.long()]
        drops.append((rank >= cap).sum())
        return real(x, r, w1, *a, capacity=cap, rank_offset=rank_offset,
                    **kw)

    out = {}
    shapes = swin.param_shapes(cfg)
    for impl in ("tutel", "megablocks"):
        res = {}
        for on_mesh in (False, True):
            pcfg = ParallelConfig(blk=128)
            m = mesh if on_mesh else None
            specs = swin.param_specs(cfg, pcfg)
            params = fresh()
            if on_mesh:
                params = shard_tree(params, specs, pcfg, mesh)
            opt = adamw.init_opt_state(params, opt_cfg)
            step = swin.make_train_step(cfg, pcfg, opt_cfg, moe_impl=impl,
                                        mesh=m)
            _release(torch)
            torch.cuda.reset_peak_memory_stats()
            del drops[:]
            baselines.dispatch_combine_moe = counting
            try:
                log, times = run(step, params, opt)
            finally:
                baselines.dispatch_combine_moe = real
            dropped = [int(d) for d in drops]
            peak = torch.cuda.max_memory_allocated()
            final = params if not on_mesh else unshard_tree(
                tree_map(lambda t: t.detach(), params), specs, shapes, pcfg,
                mesh)
            res[on_mesh] = {"losses": [x["loss"] for x in log],
                            "times": times, "peak": peak, "drops": dropped,
                            "params": [t.detach().clone()
                                       for t in tree_leaves(final)]}
            del params, opt, step, final
            _release(torch)
        plain, meshed = res[False], res[True]
        errs = [abs(a - b) / abs(b) for a, b in zip(meshed["losses"],
                                                   plain["losses"])]
        worst = max((a - b).abs().max().item() for a, b in
                    zip(meshed["params"], plain["params"]))
        if not max(errs) <= SWIN_LOSS_RTOL:
            raise AssertionError(f"phase M {impl}: losses "
                                 f"{meshed['losses']} vs {plain['losses']}")
        if not worst <= MESH_PARAM_TOL:
            raise AssertionError(f"phase M {impl}: gathered params {worst} "
                                 f"from the mesh-less step's (limit "
                                 f"{MESH_PARAM_TOL})")
        if meshed["drops"] != plain["drops"] or (
                impl == "megablocks" and any(meshed["drops"])) or (
                impl == "tutel" and not any(meshed["drops"])):
            raise AssertionError(f"phase M {impl}: dropped copies "
                                 f"{meshed['drops']} vs {plain['drops']}")
        meds = {k: statistics.median(r["times"]) * 1e3
                for k, r in (("meshless", plain), ("mesh", meshed))}
        out[impl] = {"losses": meshed["losses"], "loss_rel_diff": max(errs),
                     "param_max_abs_diff": worst, "param_tol": MESH_PARAM_TOL,
                     "dropped_copies": sum(meshed["drops"]),
                     "step_median_ms": meds,
                     "images_per_s": SWIN_BATCH / meds["mesh"] * 1e3,
                     "peak_allocated_gb": {"meshless": plain["peak"] / 1e9,
                                           "mesh": meshed["peak"] / 1e9}}
        print(f"[mesh] {impl} on the mesh: losses {meshed['losses']} "
              f"(worst rel diff {max(errs):.2e}), gathered params within "
              f"{worst:.2e} of the mesh-less step's, "
              f"{sum(meshed['drops'])} dropped copies as mesh-less; step "
              f"median {meds['mesh']:.1f} ms (mesh-less "
              f"{meds['meshless']:.1f} ms), peak "
              f"{meshed['peak'] / 1e9:.2f} GB")
    return out


# ---------------------------------------------------------------------------
# phase L: the LM on a 1-rank mesh
# ---------------------------------------------------------------------------

def _lm_mesh_decode(torch, cfg, pcfg, params, mesh, prompts, max_new, slots,
                    max_seq):
    """Greedy requests through ``BatchedServer`` (mesh-less where ``mesh``
    is None): the streams, each macro-step's last-row logits (on the
    host), the decode step times, the expert launches and the prefetch
    cache's stats."""
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import lm

    srv = BatchedServer(cfg, pcfg, num_slots=slots, max_seq=max_seq,
                        params=params, device="cuda", mesh=mesh)
    logits = []
    inner = srv.serve_step

    def step(p, inputs, cache):
        lg, cache = inner(p, inputs, cache)
        logits.append(lg[:, -1].float().cpu())
        return lg, cache

    srv.serve_step = step
    for i, pr in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=pr, max_new=max_new))
    lm.LAST_PIPELINE_CACHE_STATS = None
    _reset_expert_counts()
    with torch.no_grad():
        done = srv.run()
    torch.cuda.synchronize()
    launches, routes = _expert_counts()
    return {"tokens": {r.rid: list(r.out) for r in done},
            "logits": logits, "times": srv.decode_times_s[1:],
            "launches": launches, "routes": routes,
            "cache_stats": lm.LAST_PIPELINE_CACHE_STATS}


def _lm_mesh_f32(torch, mesh):
    """L1: phase 7's model (qwen3-moe-30b-a3b, 2 layers at full width,
    f32, seed 7, 2 x 64 tokens): one loss and gradient mesh-less, then on
    the mesh in every mode; then greedy decode mesh-less and on the mesh,
    cache_layers 0 and 2."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.train import batch_to
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import (
        ParallelConfig, shard_tree, unshard_tree)

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    batch = TokenSource(DataConfig(seq_len=64, global_batch=2,
                                   vocab_size=cfg.vocab_size,
                                   seed=7)).batch(0)
    shape3 = (2, 64, cfg.d_model)
    shapes = lm.param_shapes(cfg)
    n_moe = _moe_layers(cfg)

    def loss_grads(pcfg, m):
        specs = lm.param_specs(cfg, pcfg)
        p = params if m is None else shard_tree(params, specs, pcfg, m)
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        x_spec = activation_spec(shape3, pcfg, m)
        _reset_expert_counts()
        total, met = steps.make_loss_fn(cfg, pcfg, mesh=m,
                                        batch_shape3=shape3)(
            p, batch_to(batch_block(batch, x_spec, m), "cuda"))
        grads = torch.autograd.grad(total, tree_leaves(p))
        torch.cuda.synchronize()
        launches, routes = _expert_counts()
        if m is not None:
            it = iter(grads)
            grads = tree_leaves(unshard_tree(
                tree_map(lambda _: next(it), p), specs, shapes, pcfg, m))
        return float(total.detach()), list(grads), launches, routes

    base = ParallelConfig(blk=16)
    ref_total, ref_grads, _, _ = loss_grads(base, None)
    cpu_total = _LANE.result("7")["total_cpu"]   # phase 7's CPU side
    out = {"meshless_total": ref_total, "phase7_cpu_total": cpu_total,
           "modes": {}}
    paths = {}
    for mode, policy in MESH_MODES:
        pcfg = dataclasses.replace(base, mode=mode, cache_policy=policy,
                                   capacity_factor=8.0)
        total, grads, launches, routes = loss_grads(pcfg, mesh)
        name = f"{mode}/{policy}"
        tol = MESH_EP_TOL if mode == "ep" else TRAIN_GRAD_TOL
        worst = 0.0
        for a, b in zip(grads, ref_grads):
            scale = b.abs().max().item()
            worst = max(worst, (a - b).abs().max().item() / (scale or 1.0))
        del grads
        rel = abs(total - ref_total) / abs(ref_total)
        rel_cpu = abs(total - cpu_total) / abs(cpu_total)
        if not (rel <= TRAIN_LOSS_RTOL and rel_cpu <= TRAIN_LOSS_RTOL):
            raise AssertionError(f"phase L1 {name}: total {total} vs "
                                 f"mesh-less {ref_total} (rel {rel}) and "
                                 f"the CPU's {cpu_total} (rel "
                                 f"{rel_cpu})")
        if not worst <= tol:
            raise AssertionError(f"phase L1 {name}: a gathered grad leaf "
                                 f"{worst} x its max |grad| from the "
                                 f"mesh-less one's (limit {tol})")
        want = ({k: dict.fromkeys(v, 0) for k, v in routes.items()}
                if mode == "ep" else _f32_expert_routes(n_moe))
        if routes != want:
            raise AssertionError(f"phase L1 {name}: routes {routes}, "
                                 f"expected {want}")
        out["modes"][name] = {"total": total, "total_rel_diff": rel,
                              "total_rel_diff_cpu": rel_cpu,
                              "worst_grad_rel": worst, "grad_tol": tol,
                              "launches": launches}
        paths[f"qwen_mesh_f32_{mode}_{policy}"] = (launches, routes)
        print(f"[lm-mesh] L1 {name}: total {total!r} (mesh-less rel "
              f"{rel:.2e}, phase 7's CPU rel {rel_cpu:.2e}), gathered grads "
              f"within {worst:.2e} x max |grad| (limit {tol}); launches "
              f"{launches}")
        _release(torch)
    del ref_grads
    _release(torch)

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=LM_MESH_PROMPT)
               for _ in range(LM_MESH_PROMPTS)]
    runs = {}
    for m, layers in ((None, 0), (None, LM_MESH_CACHE_LAYERS), (mesh, 0),
                      (mesh, LM_MESH_CACHE_LAYERS)):
        pcfg = ParallelConfig(blk=16, mode="auto", cache_layers=layers)
        p = params if m is None else shard_tree(
            params, lm.param_specs(cfg, pcfg), pcfg, m)
        runs[(m is not None, layers)] = _lm_mesh_decode(
            torch, cfg, pcfg, p, m, prompts, LM_MESH_NEW, LM_MESH_PROMPTS,
            LM_MESH_PROMPT + LM_MESH_NEW)
        del p
    ref = runs[(False, 0)]
    worst = 0.0
    for key, r in runs.items():
        if r["tokens"] != ref["tokens"]:
            raise AssertionError(f"phase L1 decode {key}: tokens "
                                 f"{r['tokens']} vs {ref['tokens']}")
        for a, b in zip(r["logits"], ref["logits"]):
            err, _ = _check(f"phase L1 decode {key} logits", a, b,
                            ATTN_TOL["float32"])
            worst = max(worst, err / b.abs().max().item())
        st = r["cache_stats"]
        if key[1] and not (st and st["peak_resident_layers"]
                           <= LM_MESH_CACHE_LAYERS and st["hits"] > 0):
            raise AssertionError(f"phase L1 decode {key}: cache stats {st}")
        if not key[1] and st is not None:
            raise AssertionError(f"phase L1 decode {key}: a cache was built")
    steps_n = len(ref["logits"])
    want = {"stream": n_moe * steps_n, "wgmma": 0}
    for key, r in runs.items():
        if r["routes"]["esffn_glu"] != want:
            raise AssertionError(f"phase L1 decode {key}: esffn_glu routes "
                                 f"{r['routes']['esffn_glu']}, expected "
                                 f"{want}")
    mesh_run = runs[(True, LM_MESH_CACHE_LAYERS)]
    paths["qwen_mesh_decode_f32"] = (mesh_run["launches"],
                                     mesh_run["routes"])
    out["decode"] = {"tokens": ref["tokens"], "macro_steps": steps_n,
                     "worst_logit_rel": worst,
                     "cache_stats": mesh_run["cache_stats"]}
    print(f"[lm-mesh] L1 decode: {LM_MESH_PROMPTS} x {LM_MESH_NEW} greedy "
          f"tokens equal mesh-less and on the mesh, cache_layers 0 and "
          f"{LM_MESH_CACHE_LAYERS}; logits within {worst:.2e} x max |logit| "
          f"(limit {ATTN_TOL['float32']}); cache {mesh_run['cache_stats']}")
    p = shard_tree(params, lm.param_specs(cfg, ParallelConfig(
        mode="auto")), ParallelConfig(mode="auto"), mesh)
    out["overlap"], opaths = _lm_mesh_overlap(
        torch, "L1", cfg, p, mesh, prompts, LM_MESH_PROMPTS)
    del p
    paths.update({f"qwen_mesh_overlap_f32_{k}": v for k, v in opaths.items()})
    return paths, out


def _lm_mesh_overlap(torch, tag, cfg, params, mesh, prompts, slots):
    """The overlap schedule on the 1-rank mesh: greedy decode through
    ``BatchedServer`` in the "auto" mode with ``cache_layers`` 2, eager
    and with ``overlap_dispatch``, under auto's own chooser and forced to
    data-centric dispatch (where each cache entry is a layer's whole
    expert weights): tokens and every macro-step's logits bit for bit
    the eager run's, the cache's residency bounded. Both run under
    ``torch.use_deterministic_algorithms`` (the combine's ``index_add_``
    otherwise adds in the atomics' order, which differs between any two
    runs). The "node" schedule itself needs a node extent above 1: one
    rank cannot run it."""
    from repro_torch.parallel.sharding import ParallelConfig

    out, paths = {}, {}
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    for forced in (None, "data_centric"):
        runs = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for overlap in (False, True):
                pcfg = ParallelConfig(blk=16, mode="auto",
                                      cache_layers=LM_MESH_CACHE_LAYERS,
                                      overlap_dispatch=overlap,
                                      forced_layer_mode=forced)
                runs[overlap] = _lm_mesh_decode(
                    torch, cfg, pcfg, params, mesh, prompts, LM_MESH_NEW,
                    slots, LM_MESH_PROMPT + LM_MESH_NEW)
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        eager, ovl = runs[False], runs[True]
        name = forced or "chooser"
        diff = max((a - b).abs().max().item()
                   for a, b in zip(ovl["logits"], eager["logits"]))
        if ovl["tokens"] != eager["tokens"] or len(ovl["logits"]) != len(
                eager["logits"]) or diff != 0.0:
            raise AssertionError(f"phase {tag} overlap ({name}): the overlap "
                                 f"decode is not the eager one bit for bit: "
                                 f"tokens {ovl['tokens']} vs "
                                 f"{eager['tokens']}, logits {diff} apart")
        st, st0 = ovl["cache_stats"], eager["cache_stats"]
        if not (st and st["peak_resident_layers"] <= LM_MESH_CACHE_LAYERS
                and st["hits"] > 0 and st["prefetches"] > 0):
            raise AssertionError(f"phase {tag} overlap ({name}): cache "
                                 f"stats {st}")
        meds = {k: statistics.median(r["times"]) * 1e3
                for k, r in (("eager", eager), ("overlap", ovl))}
        out[name] = {"bitwise": True, "cache_stats": st,
                     "cache_stats_eager": st0, "step_median_ms": meds,
                     "launches": ovl["launches"]}
        paths[name] = (ovl["launches"], ovl["routes"])
        print(f"[lm-mesh] {tag} overlap ({name}): {len(ovl['logits'])} "
              f"macro-steps' logits and the tokens bit for bit the eager "
              f"schedule's; cache {st} (eager: peak "
              f"{st0['peak_resident_bytes'] / 1e9:.3f} GB); decode step "
              f"medians {meds['eager']:.2f} ms eager, {meds['overlap']:.2f} "
              f"ms overlap; the node schedule is off at node extent 1")
    return out, paths


def _lm_mesh_bf16(torch, mesh, train_out):
    """L2: phase 8's state (4 layers at full width, bf16, seed 0, 4 x 1024
    tokens): a warm-up and LM_MESH_STEPS timed steps on the mesh in every
    mode, each from the same weights; then the dense decode mesh-less and
    on the mesh with the prefetch cache."""
    import math

    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.train import batch_to, build_state
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=TRAIN_DEPTH)
    base = ParallelConfig(blk=min(128, max(16, TRAIN_SEQ // 4)),
                          remat="block", capacity_factor=8.0)
    opt_cfg = adamw.OptimizerConfig(peak_lr=3e-4, warmup_steps=20,
                                    decay_steps=40, master_fp32=True)
    source = TokenSource(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    vocab_size=cfg.vocab_size, seed=0))
    shape3 = (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    plain_med = train_out["step_median_ms"]
    plain_losses = [m["loss"] for m in train_out["steps"]]
    out, paths = {}, {}
    for mode, policy in MESH_MODES:
        pcfg = dataclasses.replace(base, mode=mode, cache_policy=policy)
        params, opt_state = build_state(cfg, opt_cfg, 0, "cuda", pcfg=pcfg,
                                        mesh=mesh)
        step = steps.make_train_step(cfg, pcfg, opt_cfg, mesh=mesh,
                                     batch_shape3=shape3)
        x_spec = activation_spec(shape3, pcfg, mesh)

        def run(i):
            batch = batch_to(batch_block(source.batch(i), x_spec, mesh),
                             "cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, m = step(params, opt_state, batch)
            m = {k: float(v) for k, v in m.items()}
            torch.cuda.synchronize()
            return m, time.perf_counter() - t

        run(0)                                     # warm-up
        torch.cuda.reset_peak_memory_stats()
        _reset_expert_counts()
        log, times = [], []
        for i in range(1, LM_MESH_STEPS + 1):
            m, dt = run(i)
            log.append(m)
            times.append(dt)
        launches, routes = _expert_counts()
        peak = torch.cuda.max_memory_allocated()
        name = f"{mode}/{policy}"
        losses = [m["loss"] for m in log]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase L2 {name}: losses {losses}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
        if not rel <= BF16_REF_LOSS_RTOL:
            raise AssertionError(f"phase L2 {name}: losses {losses} vs "
                                 f"phase 8's {plain_losses}")
        want = {k: (0 if mode == "ep" else v * TRAIN_DEPTH * LM_MESH_STEPS)
                for k, v in LM_MESH_LAUNCHES.items()}
        if launches != want:
            raise AssertionError(f"phase L2 {name}: launches {launches}, "
                                 f"expected {want}")
        if mode != "ep" and any(n != routes[k].get("wgmma") for k, n in
                                launches.items()):
            raise AssertionError(f"phase L2 {name}: routes {routes}")
        med = statistics.median(times)
        print(f"[lm-mesh] L2 {name}: losses {losses} (phase 8's within "
              f"{rel:.2e}); step median {med * 1e3:.1f}ms against phase 8's "
              f"mesh-less {plain_med:.1f}ms ({med * 1e3 / plain_med:.3f} x), "
              f"{tokens / med:.1f} tokens/s, peak {peak / 1e9:.2f} GB; "
              f"launches {launches} ({ {k: v // (TRAIN_DEPTH * LM_MESH_STEPS) for k, v in launches.items()} } a layer a step)")
        out[name] = {"losses": losses, "loss_rel_diff_phase8": rel,
                     "step_times_s": times, "step_median_ms": med * 1e3,
                     "tokens_per_s": tokens / med,
                     "peak_allocated_gb": peak / 1e9, "launches": launches,
                     "launches_by_route": routes}
        paths[f"qwen_mesh_{mode}_{policy}"] = (launches, routes)
        del params, opt_state, step
        _release(torch)

    # the dense decode at the same 4 layers, phase 8's weights
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec_pcfg = ParallelConfig(blk=16, mode="auto")
    params, _ = steps.sharded_params(cfg, dec_pcfg, mesh, generator=gen,
                                     device="cuda")
    # what one layer's fsdp gather costs on one rank: NCCL's all-gather
    # into a fresh tensor plus the port's moves of the gathered dimension,
    # against a device copy of the same bytes
    from repro_torch.parallel.cache import gather_ffn_params

    ffn = params["layers"][0]["ffn"]
    experts = [t for k, t in ffn.items() if k != "router"]
    nbytes = sum(t.numel() * t.element_size() for t in experts)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    with torch.no_grad():
        gather_ms = time_ms(torch, lambda: gather_ffn_params(
            ffn, dec_pcfg, mesh, d_ff=cfg.moe.d_ff), flush, iters=10)
        clone_ms = time_ms(torch, lambda: [t.clone() for t in experts],
                           flush, iters=10)
    del flush
    out["layer_gather"] = {"bytes": nbytes, "gather_ms": gather_ms,
                           "clone_ms": clone_ms}
    print(f"[lm-mesh] L2: one layer's expert weights ({nbytes / 1e9:.3f} "
          f"GB) through gather_ffn_params on the 1-rank mesh "
          f"{gather_ms:.2f} ms ({nbytes / gather_ms / 1e6:.0f} GB/s of "
          f"output), a device copy of them {clone_ms:.2f} ms")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, size=LM_MESH_PROMPT)
               for _ in range(LM_MESH_DECODE_REQUESTS)]
    runs = {}
    for m, layers in ((None, 0), (mesh, 0), (mesh, LM_MESH_CACHE_LAYERS)):
        pcfg = dataclasses.replace(dec_pcfg, cache_layers=layers)
        # one rank: the shards are the whole tensors, the mesh-less tree
        runs[(m is not None, layers)] = _lm_mesh_decode(
            torch, cfg, pcfg, params, m, prompts, LM_MESH_NEW,
            LM_MESH_DECODE_SLOTS, LM_MESH_PROMPT + LM_MESH_NEW)
    ovl_params = params
    del params
    plain = runs[(False, 0)]
    cached = runs[(True, LM_MESH_CACHE_LAYERS)]
    st = cached["cache_stats"]
    if not (st and st["peak_resident_layers"] <= LM_MESH_CACHE_LAYERS
            and st["hits"] > 0):
        raise AssertionError(f"phase L2 decode: cache stats {st}")
    n_moe = _moe_layers(cfg)
    steps_n = len(plain["logits"])
    for key, r in runs.items():
        want = {"stream": n_moe * steps_n, "wgmma": 0}
        if r["routes"]["esffn_glu"] != want:
            raise AssertionError(f"phase L2 decode {key}: esffn_glu routes "
                                 f"{r['routes']['esffn_glu']}, expected "
                                 f"{want}")
    meds = {f"{'mesh' if k[0] else 'meshless'}_cache{k[1]}":
            statistics.median(r["times"]) * 1e3 for k, r in runs.items()}
    same = sum(r["tokens"] == plain["tokens"] for r in runs.values()) - 1
    paths["qwen_mesh_decode"] = (cached["launches"], cached["routes"])
    out["decode"] = {"step_median_ms": meds, "macro_steps": steps_n,
                     "cache_stats": st,
                     "gathered_bytes_resident_peak":
                         st["peak_resident_bytes"],
                     "mesh_runs_with_the_meshless_streams": same}
    out["overlap"], opaths = _lm_mesh_overlap(
        torch, "L2", cfg, ovl_params, mesh, prompts, LM_MESH_DECODE_SLOTS)
    del ovl_params
    _release(torch)
    paths.update({f"qwen_mesh_overlap_{k}": v for k, v in opaths.items()})
    print(f"[lm-mesh] L2 decode ({LM_MESH_DECODE_SLOTS} slots, "
          f"{steps_n} macro-steps, bf16, 4 layers): step medians "
          f"{ {k: round(v, 2) for k, v in meds.items()} } ms; the cache "
          f"held {st['peak_resident_bytes'] / 1e9:.3f} GB of gathered "
          f"expert weights at its peak ({st['peak_resident_layers']} "
          f"layers, {st['hits']} hits a forward); {same} of 2 mesh runs "
          f"gave the mesh-less streams (bf16: compared, not asserted); one "
          f"rank moves nothing across chips, so these times show the code "
          f"path's copies and recompute only")
    return paths, out


def lm_mesh_phase(torch, train_out):
    """Phase L: the MoE LM on a 1-rank NCCL mesh (1, 1, 1): L1 against the
    mesh-less run in f32, L2 timed in bf16."""
    from repro_torch.launch.mesh import make_mesh, single_rank_nccl

    t_phase = time.perf_counter()
    with single_rank_nccl():
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        for axes in (("pod",), ("data",), ("model",), ("pod", "data"),
                     ("pod", "data", "model")):
            mesh.all_reduce(torch.ones(1, device="cuda"), axes)
        torch.cuda.synchronize()
        paths1, l1 = _lm_mesh_f32(torch, mesh)
        _release(torch)
        paths2, l2 = _lm_mesh_bf16(torch, mesh, train_out)
    seconds = time.perf_counter() - t_phase
    print(f"[lm-mesh] phase L in {seconds:.1f}s")
    return {**paths1, **paths2}, {"L1": l1, "L2": l2, "seconds": seconds}


def mesh_families_phase(torch):
    """Phase N: the other LM families on the 1-rank NCCL mesh (1, 1, 1)
    against their mesh-less runs on the card. N1: Jamba's layout at phase
    7h's f32 cut (Mamba islands splitting channels over "model", MoE and
    dense FFNs), one loss and gradient at phase L1's limits, the expert
    kernels' launches counted; N2: xlstm-350m whole in bf16 through
    ``BatchedServer`` (the mLSTM/sLSTM islands), tokens equal; N3:
    paligemma-3b and musicgen-large at phase 7f's cut (frontends,
    cross-attention, codebook heads), the loss."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.configs import jamba_1_5_large_398b as jamba
    from repro_torch.launch import steps
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.mesh import make_mesh, single_rank_nccl
    from repro_torch.launch.train import batch_to
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import (
        ParallelConfig, shard_tree, unshard_tree)

    t_phase = time.perf_counter()
    out, paths = {}, {}
    pcfg = ParallelConfig(blk=16)

    def loss_grads(cfg, params, batch, m, grads=True):
        specs = lm.param_specs(cfg, pcfg)
        p = params if m is None else shard_tree(params, specs, pcfg, m)
        p = tree_map(lambda t: t.detach().requires_grad_(grads), p)
        seq = batch["labels"].shape[1]
        shape3 = (batch["labels"].shape[0], seq, cfg.d_model)
        x_spec = activation_spec(shape3, pcfg, m)
        _reset_expert_counts()
        with torch.set_grad_enabled(grads):
            total, _ = steps.make_loss_fn(cfg, pcfg, mesh=m,
                                          batch_shape3=shape3)(
                p, batch_to(batch_block(batch, x_spec, m), "cuda"))
        g = None
        if grads:
            g = torch.autograd.grad(total, tree_leaves(p), allow_unused=True)
            g = [torch.zeros_like(t) if x is None else x
                 for t, x in zip(tree_leaves(p), g)]
            if m is not None:
                it = iter(g)
                g = tree_leaves(unshard_tree(
                    tree_map(lambda _: next(it), p), specs,
                    lm.param_shapes(cfg), pcfg, m))
        torch.cuda.synchronize()
        launches, routes = _expert_counts()
        return float(total.detach()), g, launches, routes

    with single_rank_nccl():
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        for axes in (("pod",), ("data",), ("model",), ("pod", "data"),
                     ("pod", "data", "model")):
            mesh.all_reduce(torch.ones(1, device="cuda"), axes)
        torch.cuda.synchronize()

        # N1: Jamba's layout, f32, loss and gradient
        cfg = jamba.cut_config("reference", "float32")
        params = lm.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(7), device="cuda")
        batch = _family_batch(cfg, 2, 64, 7)
        ref_total, ref_g, _, _ = loss_grads(cfg, params, batch, None)
        total, g, launches, routes = loss_grads(cfg, params, batch, mesh)
        del params
        worst = 0.0
        for a, b in zip(g, ref_g):
            scale = b.abs().max().item()
            worst = max(worst, (a - b).abs().max().item() / (scale or 1.0))
        del g, ref_g
        _release(torch)
        rel = abs(total - ref_total) / abs(ref_total)
        n_moe = _moe_layers(cfg)
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"phase N1: total {total} vs mesh-less "
                                 f"{ref_total} (rel {rel})")
        if not worst <= TRAIN_GRAD_TOL:
            raise AssertionError(f"phase N1: a gathered grad leaf {worst} x "
                                 f"its max |grad| from the mesh-less one's")
        if routes != _f32_expert_routes(n_moe):
            raise AssertionError(f"phase N1: routes {routes}, expected "
                                 f"{_f32_expert_routes(n_moe)}")
        out["jamba"] = {"total": total, "total_rel_diff": rel,
                        "worst_grad_rel": worst, "launches": launches}
        paths["jamba_mesh_f32"] = (launches, routes)
        print(f"[mesh-families] N1 jamba layout ({cfg.num_layers} layers, "
              f"f32): total {total!r} (mesh-less rel {rel:.2e}), gathered "
              f"grads within {worst:.2e} x max |grad| (limit "
              f"{TRAIN_GRAD_TOL}); launches {launches}")

        # N2: xlstm-350m whole, bf16, the dense engine
        cfg = cfglib.get_config("xlstm-350m")
        params = lm.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        rng = np.random.default_rng(13)
        prompts = [rng.integers(0, cfg.vocab_size, size=LM_MESH_PROMPT)
                   for _ in range(LM_MESH_PROMPTS * 2)]
        runs = {}
        for m in (None, mesh):
            p = params if m is None else shard_tree(
                params, lm.param_specs(cfg, pcfg), pcfg, m)
            runs[m is not None] = _lm_mesh_decode(
                torch, cfg, pcfg, p, m, prompts, LM_MESH_NEW, len(prompts),
                LM_MESH_PROMPT + LM_MESH_NEW)
            del p
        del params
        _release(torch)
        plain, meshed = runs[False], runs[True]
        if meshed["tokens"] != plain["tokens"]:
            raise AssertionError(f"phase N2: tokens {meshed['tokens']} vs "
                                 f"{plain['tokens']}")
        lworst = max(((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(meshed["logits"], plain["logits"]))
        ticks = {k: statistics.median(r["times"]) * 1e3
                 for k, r in (("meshless", plain), ("mesh", meshed))}
        out["xlstm"] = {"tokens": meshed["tokens"], "worst_logit_rel": lworst,
                        "decode_tick_median_ms": ticks}
        print(f"[mesh-families] N2 xlstm-350m (24 layers, bf16): "
              f"{len(prompts)} greedy streams equal on the mesh and "
              f"mesh-less {meshed['tokens']}; logits within {lworst:.2e} x "
              f"max |logit|; decode tick median {ticks['mesh']:.2f} ms on "
              f"the mesh, {ticks['meshless']:.2f} ms mesh-less")

        # N3: the frontend families, f32, the loss
        out["frontends"] = {}
        for arch in ("paligemma-3b", "musicgen-large"):
            cfg = dataclasses.replace(cfglib.get_config(arch),
                                      num_layers=FRONTEND_REF_DEPTH,
                                      dtype="float32")
            params = lm.init_params(cfg, generator=torch.Generator(
                device="cuda").manual_seed(11), device="cuda")
            seq = FRONTEND_PREFILL + cfg.prefix_len if cfg.prefix_len else 64
            batch = _family_batch(cfg, 2, seq, 11)
            ref_total = loss_grads(cfg, params, batch, None, grads=False)[0]
            total = loss_grads(cfg, params, batch, mesh, grads=False)[0]
            del params
            _release(torch)
            rel = abs(total - ref_total) / abs(ref_total)
            if not rel <= TRAIN_LOSS_RTOL:
                raise AssertionError(f"phase N3 {arch}: total {total} vs "
                                     f"mesh-less {ref_total} (rel {rel})")
            out["frontends"][arch] = {"total": total, "total_rel_diff": rel}
            print(f"[mesh-families] N3 {arch} ({FRONTEND_REF_DEPTH} layers, "
                  f"f32): total {total!r} on the mesh, mesh-less rel "
                  f"{rel:.2e}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[mesh-families] phase N in {out['seconds']:.1f}s")
    return paths, out


def _hetero_layer(torch, w, seed=21):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, w["dtype"])
    d, f, e = w["d"], w["f"], w["e"]

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    p = {"router": randn(d, e, scale=0.02)}
    if w["glu"]:
        p.update(w_gate=randn(e, d, f, scale=0.02).to(dt),
                 w_up=randn(e, d, f, scale=0.02).to(dt),
                 w_down=randn(e, f, d, scale=0.02).to(dt))
    else:
        p.update(w1=randn(e, d, f, scale=0.02).to(dt),
                 b1=randn(e, f, scale=0.1), w2=randn(e, f, d, scale=0.02)
                 .to(dt), b2=randn(e, d, scale=0.1))
    x = randn(w["n"], d, scale=1.0).to(dt)
    return p, x


def _hetero_plain(ex, i, x, w):
    """Device i's program through the kernels' plain versions."""
    from repro_torch.core.reindex import build_reindex, scatter_rows
    from repro_torch.core.routing import route
    from repro_torch.kernels import esffn

    p = ex.device_params(i)
    xin = ex.device_input(i, x)
    n_valid = ex._programs[i][1][1] if ex.mode == "data_centric" else None
    vm = None
    if n_valid is not None and n_valid != xin.shape[0]:
        import torch
        vm = torch.arange(xin.shape[0], device=xin.device) < n_valid
    r = route(xin, p["router"], w["k"], valid_mask=vm)
    ri = build_reindex(r.expert_idx, r.gates, w["e"], 128)
    args = (xin, ri.row_token, ri.row_gate, ri.block_expert)
    if w["glu"]:
        sc = (tuple(p[f"{k}_scale"] for k in ("w_gate", "w_up", "w_down"))
              if "w_gate_scale" in p else None)
        ys = esffn.esffn_glu_plain(*args, p["w_gate"], p["w_up"],
                                   p["w_down"], w_scales=sc, act=w["act"])
    else:
        sc = ((p["w1_scale"], p["w2_scale"]) if "w1_scale" in p else None)
        ys = esffn.esffn_mlp_plain(*args, p["w1"], p.get("b1"), p["w2"],
                                   p.get("b2"), w_scales=sc, act=w["act"])
    return scatter_rows(ys, ri.row_token, xin.shape[0])


def hetero_phase(torch):
    """Phase H: the per-device programs of ``HeteroExecutor`` at two full
    widths, timed; every arm's programs checked after its timed run."""
    from repro_torch.core import espec
    from repro_torch.core.hetero import make_hetero_plan, uniform_counterpart
    from repro_torch.parallel.hetero_exec import HeteroExecutor

    fns = _swin_kernel_fns()
    t_phase = time.perf_counter()
    out, launches_by_path, checks = {}, {}, []
    for wname, w in HETERO_WIDTHS.items():
        p, x = _hetero_layer(torch, w)
        kname = "esffn_glu" if w["glu"] else "esffn_mlp"
        tol_rel = (ESFFN_TOL["bfloat16"] if w["dtype"] == "bfloat16"
                   else SWIN_KERNEL_TOL)
        kw = dict(num_experts=w["e"], top_k=w["k"], act=w["act"],
                  glu=w["glu"], blk=128)
        full = espec.hexa_moe_ffn(x, p, num_experts=w["e"], top_k=w["k"],
                                  act=w["act"], glu=w["glu"], blk=128).y
        res = {}
        # the 8-bit class's launches go to the 8-bit branch's entry
        launches, routes, quant = 0, {}, {}
        qroute = HETERO_QUANT_ROUTE[kname]
        runs = [(lname, lat, None) for lname, lat in HETERO_LATENCIES.items()]
        runs.append(("skew_2x_int8", HETERO_LATENCIES["skew_2x"], (16, 8)))
        for lname, lat, bits in runs:
            plan = make_hetero_plan(lat, global_batch=w["n"],
                                    hidden_size=w["f"], token_quantum=128,
                                    hidden_quantum=128, expert_bits=bits)
            arms = {"proportional": plan}
            if bits is None:
                arms["uniform"] = uniform_counterpart(plan)
            for mode in ("data_centric", "model_centric"):
                for arm, pl in arms.items():
                    ex = HeteroExecutor(p, plan=pl, mode=mode, **kw)
                    # the counts cover the timed run only, not the checks
                    _reset_launches(fns)
                    q0 = dict(fns[kname].launches_quant)
                    st = ex.timed_step(x, rounds=HETERO_ROUNDS)
                    torch.cuda.synchronize()
                    nq = 0
                    for m, n in fns[kname].launches_quant.items():
                        quant[m] = quant.get(m, 0) + n - q0[m]
                        nq += n - q0[m]
                    launches += fns[kname].launches - nq
                    for r, n in fns[kname].launches_by_route.items():
                        routes[r] = (routes.get(r, 0) + n
                                     - (nq if r == qroute else 0))
                    key = f"{lname}/{mode}/{arm}"
                    res[key] = {
                        "splits": list(pl.token_counts
                                       if mode == "data_centric"
                                       else pl.hidden_splits),
                        "device_ms": [t * 1e3 for t in st.device_times_s],
                        "skews": list(ex.skews),
                        "step_ms": st.step_latency_s * 1e3,
                        "device_param_bytes": list(ex.device_param_bytes())}
                    # each device program against its plain version, and
                    # the combined output against the unsplit layer (but
                    # for the 8-bit class, which computes another layer)
                    worst = 0.0
                    for i in range(len(ex.skews)):
                        r0 = dict(fns[kname].launches_by_route)
                        q0 = sum(fns[kname].launches_quant.values())
                        kern = ex.run_device(i, x)
                        if sum(fns[kname].launches_quant.values()) > q0 \
                                and fns[kname].launches_by_route[qroute] \
                                == r0[qroute]:
                            raise AssertionError(
                                f"phase H {wname} {key} device {i}: the "
                                f"8-bit branch ran off {qroute}")
                        err, tol = _check(
                            f"phase H {wname} {key} device {i}", kern,
                            _hetero_plain(ex, i, x, w), tol_rel)
                        worst = max(worst, err / tol)
                    c = {"width": wname, "run": key,
                         "worst_device_err_over_tol": worst}
                    if bits is None:
                        err, tol = _check(f"phase H {wname} {key} vs "
                                          f"unsplit", st.y, full, tol_rel)
                        c["unsplit_err_over_tol"] = err / tol
                    checks.append(c)
                    del ex, st
            for mode in ("data_centric", "model_centric"):
                if "uniform" in arms:
                    u = res[f"{lname}/{mode}/uniform"]["step_ms"]
                    pr = res[f"{lname}/{mode}/proportional"]["step_ms"]
                    print(f"[hetero] {wname} {lname} {mode}: uniform "
                          f"{res[f'{lname}/{mode}/uniform']['device_ms']} ms "
                          f"-> step {u:.3f} ms; proportional "
                          f"{res[f'{lname}/{mode}/proportional']['splits']} "
                          f"{res[f'{lname}/{mode}/proportional']['device_ms']}"
                          f" ms -> step {pr:.3f} ms ({u / pr:.3f} x)")
                else:
                    r = res[f"{lname}/{mode}/proportional"]
                    print(f"[hetero] {wname} {lname} {mode}: splits "
                          f"{r['splits']}, device ms {r['device_ms']}, step "
                          f"{r['step_ms']:.3f} ms, expert bytes "
                          f"{r['device_param_bytes']}")
        launches_by_path[f"hetero_{wname}"] = {kname: launches}
        mine = [c for c in checks if c["width"] == wname]
        print(f"[hetero] checks {wname}: {len(mine)} arms, worst device "
              f"err / limit {max(c['worst_device_err_over_tol'] for c in mine):.3g}"
              f", worst vs unsplit "
              f"{max(c.get('unsplit_err_over_tol', 0.0) for c in mine):.3g}")
        out[wname] = {**w, "runs": res, "launches_by_route": routes,
                      "launches_quant": {m: n for m, n in quant.items() if n}}
        del p, x, full
        _release(torch)
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t_phase
    return launches_by_path, out


def roofline_phase(torch):
    """Phase R: the card's bf16 matmul peak and memory rate against
    ``autotune.H100_SXM``, and the data-/model-centric crossovers."""
    from repro_torch.parallel import autotune

    t_phase = time.perf_counter()
    n = 8192
    a = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    b = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    mm_ms = time_ms(torch, lambda: torch.matmul(a, b), flush, iters=30)
    peak = 2 * n ** 3 / (mm_ms / 1e3)
    del a, b
    nbytes = 2 * 2 ** 30
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    src.fill_(1)
    cp_ms = time_ms(torch, lambda: dst.copy_(src), flush, iters=20)
    hbm = 2 * nbytes / (cp_ms / 1e3)             # read + write
    del src, dst, flush
    _release(torch)
    hw = autotune.H100_SXM
    rel = {"peak_flops": peak / hw.peak_flops - 1,
           "hbm_bw": hbm / hw.hbm_bw - 1}
    print(f"[roofline] bf16 {n}^3 matmul {mm_ms:.3f} ms: {peak / 1e12:.1f} "
          f"TFLOP/s (H100_SXM.peak_flops {hw.peak_flops / 1e12:.1f}, "
          f"{rel['peak_flops']:+.2%}); 2 GiB copy {cp_ms:.3f} ms: "
          f"{hbm / 1e12:.3f} TB/s (H100_SXM.hbm_bw {hw.hbm_bw / 1e12:.3f}, "
          f"{rel['hbm_bw']:+.2%}); link_bw {hw.link_bw / 1e9:.0f} GB/s "
          f"(NVIDIA's published NVLink figure, not measured)")
    for k, v in rel.items():
        if not abs(v) <= ROOFLINE_TOL:
            raise AssertionError(f"phase R: measured {k} is {v:+.2%} from "
                                 f"autotune.H100_SXM's: update the profile")
    cross = {}
    for name, (d, f, e, k) in (("swin_small_stage3", (384, 1536, 8, 1)),
                               ("swin_small_stage4", (768, 3072, 8, 1)),
                               ("qwen3_moe_30b_a3b", (2048, 768, 128, 8))):
        cross[name] = {tp: autotune.crossover_tokens(d, f, e, k, n_dev=tp)
                       for tp in (2, 4, 8)}
    print(f"[roofline] crossover tokens (model- -> data-centric, bf16, "
          f"H100_SXM) at TP 2/4/8: {cross}")
    return {"matmul_ms": mm_ms, "peak_flops": peak, "copy_ms": cp_ms,
            "hbm_bw": hbm, "profile": dataclasses.asdict(hw),
            "rel_diff": rel, "crossover_tokens": cross,
            "seconds": time.perf_counter() - t_phase}


SERVE_OBS_ARGV = ["--arch", "qwen3-moe-30b-a3b", "--paged", "--layers",
                  str(4), "--slots", "8", "--requests", "8", "--max-new",
                  "16", "--device", "cuda", "--seed", "0"]
#: the short run whose every paged_attention / esffn_glu launch is held to
#: its plain version (8 prefill chunks and 3 decode steps of 4 layers)
SERVE_OBS_HELD = ["--max-new", "4"]


class _ServerLog:
    """While active, every ``PagedServer`` the serve CLI builds is kept in
    ``servers``, its ``run`` timed (``run_s``) and its router drain's
    ``flush`` calls timed (``flush_ms``, with the pending pushes each
    took)."""

    def __init__(self):
        self.servers = []
        self.flush_ms = []
        self.run_s = []

    def __enter__(self):
        from repro_torch.launch import serve as serve_lib

        self._lib, self._orig = serve_lib, serve_lib.PagedServer
        log = self

        class Logged(self._orig):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                log.servers.append(self)
                drain = self.router_drain
                if drain is not None:
                    flush = drain.flush

                    def timed():
                        n = len(drain._pending)
                        t0 = time.perf_counter()
                        flush()
                        log.flush_ms.append(
                            ((time.perf_counter() - t0) * 1e3, n))

                    drain.flush = timed

            def run(self, *a, **kw):
                t0 = time.perf_counter()
                out = super().run(*a, **kw)
                log.run_s.append(time.perf_counter() - t0)
                return out

        serve_lib.PagedServer = Logged
        return self

    def __exit__(self, *exc):
        self._lib.PagedServer = self._orig


def _prom_series(path, name):
    """{labels: value} of one Prometheus family in a text dump."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith(name + "{"):
                labels, value = line.rsplit(" ", 1)
                out[labels[len(name):]] = float(value)
    return out


def serve_obs_phase(torch):
    """Phase O: the serve CLI (``repro_torch.launch.serve.main``) with the
    paged engine on qwen3-moe-30b-a3b at full width cut to 4 layers (seeded
    bf16 weights, ~5.1 GB), 8 slots, 8 requests of 8 prompt + 16 new
    tokens, three times: without the obs flags, with ``--metrics``
    (``--metrics-interval 4``), ``--trace-out`` and ``--events-out``, and
    without them again, under ``torch.use_deterministic_algorithms`` (the
    combine's bf16 ``index_add_``). The greedy tokens must be equal; the
    drained per-expert counts must sum
    to ``top_k`` x the routed-token counter (in the drain and in the
    Prometheus dump); the mean gate entropy must lie in [0, ln E] and the
    hexa path drop nothing; the trace's span coverage must be 1 and its
    TTFT equal the engine's ``ttft_s`` bit for bit; the kernels' launches
    must be exactly 4 ``esffn_glu`` (stream) a prefill chunk and a decode
    step and 4 ``paged_attention`` a decode step. Then one prefill chunk's
    per-expert counts against a host ``np.bincount`` of the same
    forward's routing decisions (captured at ``core.routing.route``),
    bitwise, and a short fourth run (``SERVE_OBS_HELD``) with every
    ``paged_attention`` and ``esffn_glu`` launch held to its plain version
    (``_HeldToPlain``). Prints the decode-step medians with and without
    telemetry and the drain's flush times. Returns (launches, routes,
    result); the launches are the second run's (path ``serve_obs``)."""
    import math
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import obs
    from repro_torch.core import espec
    from repro_torch.launch import serve as serve_lib

    t_phase = time.perf_counter()
    fns = _paged_kernel_fns()
    d = tempfile.mkdtemp(prefix="serve_obs_")
    paths = {k: os.path.join(d, k) for k in ("m.prom", "t.json", "e.jsonl")}
    obs_argv = ["--metrics", paths["m.prom"], "--metrics-interval", "4",
                "--trace-out", paths["t.json"], "--events-out",
                paths["e.jsonl"]]
    runs = {}
    # deterministic algorithms: the combine's bf16 index_add_ adds a
    # token's rows in the atomics' order otherwise, and two runs' greedy
    # tokens part (phase F's finding)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for tag, extra in (("plain", []), ("obs", obs_argv),
                           ("plain_again", [])):
            _reset_paged_counts(fns)
            with _ServerLog() as log:
                done = serve_lib.main(SERVE_OBS_ARGV + extra)
            torch.cuda.synchronize()
            srv = log.servers[0]
            launches, routes, _ = _paged_counts(fns)
            runs[tag] = {"tokens": {r.rid: list(r.out) for r in done},
                         "server": srv, "launches": launches,
                         "routes": routes, "flush_ms": log.flush_ms,
                         "forwards": _forwards(srv.trace),
                         "decode_ms": [t * 1e3 for t in
                                       srv.decode_times_s[1:]]}
            if tag == "obs":
                runs[tag]["ttft_trace"], _ = obs.derive_request_latencies(
                    obs.tracer.events)
                runs[tag]["coverage"] = obs.span_coverage(obs.tracer.events)
                runs[tag]["events"] = len(obs.events.records)
                # the next run records nothing
                obs.configure(metrics=False, tracing=False, event_log=False)
            else:
                runs[tag]["server"] = None    # its weights may go
                del srv
                _release(torch)
        srv = runs["obs"]["server"]
        drain = srv.router_drain
        k, e = srv.cfg.moe.top_k, srv.cfg.moe.num_experts
        depth = srv.cfg.num_layers
        if not runs["obs"]["tokens"] == runs["plain"]["tokens"] \
                == runs["plain_again"]["tokens"]:
            raise AssertionError("phase O: the greedy tokens change with "
                                 "the obs flags on")
        if int(drain.total.sum()) != k * drain.total_tokens \
                or drain.total_tokens == 0:
            raise AssertionError(f"phase O: per-expert counts sum to "
                                 f"{int(drain.total.sum())}, not {k} x "
                                 f"{drain.total_tokens} routed tokens")
        per_expert = _prom_series(paths["m.prom"],
                                  "repro_router_expert_tokens_total")
        routed = _prom_series(paths["m.prom"],
                              "repro_router_routed_tokens_total")
        if len(per_expert) != e or sum(per_expert.values()) \
                != k * sum(routed.values()):
            raise AssertionError("phase O: the Prometheus dump's router "
                                 "series do not sum to top_k x routed")
        entropy = drain.entropy_sum / drain.total_tokens
        if not 0.0 <= entropy <= math.log(e) or drain.total_dropped:
            raise AssertionError(f"phase O: gate entropy {entropy} outside "
                                 f"[0, ln {e}] or {drain.total_dropped} "
                                 f"dropped on the hexa path")
        if runs["obs"]["ttft_trace"] != srv.ttft_s \
                or runs["obs"]["coverage"] < 1.0:
            raise AssertionError(f"phase O: TTFT from the trace "
                                 f"{runs['obs']['ttft_trace']} against "
                                 f"ttft_s {srv.ttft_s}, coverage "
                                 f"{runs['obs']['coverage']}")
        for tag, r in runs.items():
            chunks, steps, _ = r["forwards"]
            want = {"esffn_glu": depth * (chunks + steps),
                    "paged_attention": depth * steps}
            got = {n: r["launches"][n] for n in want}
            if got != want or r["routes"]["esffn_glu"].get("stream") \
                    != want["esffn_glu"]:
                raise AssertionError(f"phase O ({tag}): launches {got}, "
                                     f"routes {r['routes']['esffn_glu']}, "
                                     f"expected {want} on stream")

        # one prefill chunk's counts against a host recount of the routing
        # decisions it made, captured where the islands call it
        picks = []
        route = espec.route

        def capture(*a, **kw):
            out = route(*a, **kw)
            picks.append(out.expert_idx)
            return out

        espec.route = capture
        try:
            toks = torch.arange(16, dtype=torch.int32, device=srv.device) \
                * 997 % srv.cfg.vocab_size
            row = torch.zeros(srv.max_pages_per_slot, dtype=torch.int32,
                              device=srv.device)  # the sink page only
            _, srv.cache, one = srv.prefill_step(srv.params, toks, 16, 0,
                                                 row, srv.cache)
        finally:
            espec.route = route
        recount = np.bincount(torch.cat(picks).reshape(-1).cpu().numpy(),
                              minlength=e).astype(np.int32)
        counts = one["expert_tokens"].cpu().numpy()
        if len(picks) != depth or not np.array_equal(counts, recount) \
                or int(one["tokens"]) != depth * 16:
            raise AssertionError(f"phase O: device counts {counts.tolist()}"
                                 f" against the host recount "
                                 f"{recount.tolist()} ({len(picks)} routes)")
        runs["obs"]["server"] = srv = drain = None
        _release(torch)

        with _HeldToPlain("phase O's path") as held, _ServerLog():
            serve_lib.main(SERVE_OBS_ARGV + SERVE_OBS_HELD + obs_argv)
        if not held.checks["paged_attention"] or not held.checks["esffn_glu"]:
            raise AssertionError(f"phase O: nothing held {held.checks}")
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        obs.configure(metrics=False, tracing=False, event_log=False,
                      reset=True)
        shutil.rmtree(d, ignore_errors=True)

    res = {"card": card_line(), "tokens_equal": True,
           "forwards": {t: r["forwards"] for t, r in runs.items()},
           "launches": {t: r["launches"] for t, r in runs.items()},
           "decode_median_ms": {t: float(np.median(r["decode_ms"]))
                                for t, r in runs.items()},
           "decode_steps_timed": {t: len(r["decode_ms"])
                                  for t, r in runs.items()},
           "flush_ms": runs["obs"]["flush_ms"],
           "entropy_mean": entropy, "routed_tokens": int(sum(
               routed.values())),
           "span_coverage": runs["obs"]["coverage"],
           "events": runs["obs"]["events"],
           "bincount_equal": True,
           "held_checks": held.checks, "held_worst": held.worst,
           "seconds": time.perf_counter() - t_phase}
    med = res["decode_median_ms"]
    print(f"[serve-obs] decode step median without telemetry "
          f"{med['plain']:.3f} and {med['plain_again']:.3f} ms, with it "
          f"{med['obs']:.3f} ms; drain flushes "
          f"{[(round(ms, 3), n) for ms, n in res['flush_ms']]} (ms, pushes); "
          f"{res['card']}")
    return ({"serve_obs": runs["obs"]["launches"]},
            {"serve_obs": runs["obs"]["routes"]}, res)


def train_obs_phase(torch):
    """The train_obs step: phase F's model (qwen3-moe-30b-a3b at full width
    cut to ``FT_DEPTH`` layer, bf16, ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens) through ``repro_torch.launch.train.main --metrics`` for 2
    steps (no checkpoint is written): the per-expert router series must be
    in the dump, one a expert, and sum to ``top_k`` x the routed-token
    counter, which must be the steps' tokens x the MoE layers. Returns
    (launches, routes, result) of the expert kernels (path
    ``train_obs``)."""
    import shutil
    import tempfile

    from repro_torch import configs as cfglib
    from repro_torch import obs
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    cfg = cfglib.get_config("qwen3-moe-30b-a3b")
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="train_obs_", dir=ROOT / "build")
    prom = os.path.join(d, "m.prom")
    steps = 2
    try:
        _reset_expert_counts()
        log = train.main(["--arch", "qwen3-moe-30b-a3b", "--layers",
                          str(FT_DEPTH), "--steps", str(steps),
                          "--global-batch", str(TRAIN_BATCH), "--seq-len",
                          str(TRAIN_SEQ), "--device", "cuda",
                          "--save-every", "1000", "--ckpt-dir",
                          os.path.join(d, "ck"), "--metrics", prom])
        torch.cuda.synchronize()
        launches, routes = _expert_counts()
        per_expert = _prom_series(prom, "repro_router_expert_tokens_total")
        routed = _prom_series(prom, "repro_router_routed_tokens_total")
    finally:
        obs.configure(metrics=False, tracing=False, event_log=False,
                      reset=True)
        shutil.rmtree(d, ignore_errors=True)
    want_routed = steps * TRAIN_BATCH * TRAIN_SEQ * FT_DEPTH
    k = cfg.moe.top_k
    if len(per_expert) != cfg.moe.num_experts \
            or sum(routed.values()) != want_routed \
            or sum(per_expert.values()) != k * want_routed:
        raise AssertionError(f"train_obs: {len(per_expert)} expert series "
                             f"summing to {sum(per_expert.values())}, "
                             f"routed {routed}, expected {k} x "
                             f"{want_routed}")
    want = {"esffn_glu": 2 * FT_DEPTH * steps, "esmm": 5 * FT_DEPTH * steps,
            "estmm": 3 * FT_DEPTH * steps}
    if launches != want:
        raise AssertionError(f"train_obs: launches {launches}, expected "
                             f"{want}")
    res = {"losses": [m["loss"] for m in log], "routed_tokens": want_routed,
           "expert_tokens_sum": sum(per_expert.values()),
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    return {"train_obs": launches}, {"train_obs": routes}, res


def compression_phase(torch):
    """``optim.compression.compressed_psum`` on a 1-rank NCCL mesh
    (("pod", "data", "model") = (1, 1, 1)) over a 256 MiB f32 gradient:
    its sum must equal a local quantise-dequantise of the same gradient
    bit for bit (one rank: the sum is its own payload) and the residual
    be ``g`` minus that, rounded once (``compression._residual``); then 3
    error-feedback steps, each residual ``g + r`` less its
    reconstruction. Timed with CUDA events (median of
    5 calls)."""
    from repro_torch.launch.mesh import make_mesh, single_rank_nccl
    from repro_torch.optim.compression import _residual, compressed_psum
    from repro_torch.quant.core import _per, dequantize_int8, quantize_int8

    gen = torch.Generator(device="cuda").manual_seed(31)
    g = torch.randn(64 * 2 ** 20, generator=gen, device="cuda")   # 256 MiB
    with single_rank_nccl():
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        out, res = compressed_psum(g, mesh, "pod")
        scale = _per(g.abs().max(), 127.0)
        q = quantize_int8(g, scale)
        want = dequantize_int8(q, scale)
        if not (torch.equal(out, want)
                and torch.equal(res, _residual(g, q, scale))):
            raise AssertionError("compressed_psum on one rank is not the "
                                 "local quantise-dequantise")
        r = None
        for _ in range(3):
            gf = g if r is None else g + r
            out, r_new = compressed_psum(g, mesh, "pod", r)
            sc = _per(gf.abs().max(), 127.0)
            q = quantize_int8(gf, sc)
            if not (torch.equal(out, dequantize_int8(q, sc))
                    and torch.equal(r_new, _residual(gf, q, sc))):
                raise AssertionError("compressed_psum's error feedback")
            r = r_new
        ts = []
        for _ in range(6):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            compressed_psum(g, mesh, "pod", r)
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
    res = {"bytes": g.numel() * 4, "ms": statistics.median(ts[1:]),
           "bitwise": True, "card": card_line()}
    print(f"[compression] compressed_psum of 256 MiB f32 on a 1-rank NCCL "
          f"mesh: {res['ms']:.3f} ms, equal to the local round trip; "
          f"{res['card']}")
    return res


def _release(torch):
    """Free what the last phase left: its objects in reference cycles (a
    ``SpecDecoder`` and its server point at each other, so their weights
    wait for the cycle collector) and then the allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


class _CpuLane:
    """The CPU sides of the reference phases, run beside the card's phases.

    A phase runs its card side, copies what its CPU side needs to the host
    and hands that side, checks included, to ``submit``. One worker thread
    runs the jobs in order, with ``LANE_THREADS`` intra-op threads
    (``LANE_FULL``'s jobs the host's count) at niceness ``LANE_NICE``, both
    set on the worker's own threads, so the thread that drives the card
    keeps its cores. A job's failed check
    fails the run: ``submit``, ``result``, ``drain`` and ``join`` raise the
    first failure, and ``main`` joins before it prints any result.
    ``submit`` waits while the jobs queued and running hold more than
    ``LANE_GB`` of host tensors (each job states its bytes). Every job
    prints ``[cpu-lane] NAME Ns``; ``join`` prints the lane's busy seconds
    and how long the card's thread waited for it."""

    def __init__(self):
        # (LANE_THREADS, the host's count for LANE_FULL jobs), set by
        # ``main``; None leaves the thread count alone
        self.threads = None
        self._cv = threading.Condition()
        self._jobs = collections.deque()
        self._held = 0
        self._busy = False
        self._results, self._failure = {}, None
        self._thread = None
        self.busy_s = self.waited_s = 0.0

    def submit(self, name, nbytes, fn, *args, full=False):
        """Queue ``fn(*args)`` as job ``name`` holding ``nbytes`` of host
        tensors; ``full``: at the host's thread count (``LANE_FULL``)."""
        t0 = time.perf_counter()
        with self._cv:
            self._cv.wait_for(lambda: self._failure or not self._held
                              or self._held + nbytes <= LANE_GB * 1e9)
            self._raise()
            self._held += nbytes
            self._jobs.append((name, nbytes, fn, args, full))
            self._cv.notify_all()
        self.waited_s += time.perf_counter() - t0
        if self._thread is None:
            self._thread = threading.Thread(target=self._work, daemon=True,
                                            name="cpu-lane")
            self._thread.start()

    def result(self, name):
        """Job ``name``'s return value, once it has run."""
        self._wait(lambda: name in self._results)
        return self._results[name]

    def drain(self):
        """Wait until every job submitted has run (before a phase that
        swaps a module global the jobs read)."""
        self._wait(lambda: not self._jobs and not self._busy)

    def join(self):
        self.drain()
        print(f"[cpu-lane] {len(self._results)} jobs, busy "
              f"{self.busy_s:.1f}s; the card's thread waited "
              f"{self.waited_s:.1f}s for the lane", flush=True)

    def _wait(self, ready):
        t0 = time.perf_counter()
        with self._cv:
            self._cv.wait_for(lambda: self._failure or ready())
            self._raise()
        self.waited_s += time.perf_counter() - t0

    def _raise(self):
        if self._failure:
            name, exc = self._failure
            raise AssertionError(f"CPU lane job {name}: {exc}") from exc

    def _work(self):
        try:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(),
                           LANE_NICE)
        except OSError as exc:     # the lane runs all the same
            print(f"[cpu-lane] niceness {LANE_NICE} not set: {exc}",
                  flush=True)
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._jobs)
                name, nbytes, fn, args, full = self._jobs.popleft()
                self._busy = True
            if self.threads:
                import torch
                torch.set_num_threads(self.threads[bool(full)])
            t0 = time.perf_counter()
            try:
                out, failure = fn(*args), None
            except Exception as exc:          # held for the card's thread
                out, failure = None, (name, exc)
                import traceback
                traceback.print_exc()
            del fn, args
            dt = time.perf_counter() - t0
            print(f"[cpu-lane] {name} {dt:.1f}s", flush=True)
            with self._cv:
                self._results[name] = out
                self._failure = self._failure or failure
                self._held -= nbytes
                self._busy = False
                self.busy_s += dt
                self._cv.notify_all()


_LANE = _CpuLane()


def _host_bytes(tree):
    """Bytes of the tensors in a tree of dicts and lists."""
    from repro_torch.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if hasattr(t, "element_size"))


def _this_thread_only(wrapper, real):
    """``wrapper`` for the calls made on the thread that makes this, and
    ``real`` for the CPU lane's: a module global swapped by a phase on the
    card's thread must not see (or count) the lane's CPU runs."""
    me = threading.get_ident()

    def call(*a, **kw):
        return (wrapper if threading.get_ident() == me else real)(*a, **kw)

    return call


def _print_phase_seconds():
    """Wrap every module-level ``*_phase`` and ``*_cases`` function so it
    prints its wall seconds as it returns (``[phase-time] name s``): the
    script's budget is read from these lines."""
    g = globals()
    for name, fn in list(g.items()):
        if name.startswith("_") or not callable(fn) or not (
                name.endswith("_phase") or name.endswith("_cases")):
            continue

        def timed(*args, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                print(f"[phase-time] {_name} "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)

        g[name] = timed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    _print_phase_seconds()
    print(card_line())
    t_start = t0 = time.perf_counter()
    logs = build.build()
    print(f"[build] {sorted(build.KERNELS)} in {time.perf_counter() - t0:.1f}s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _LANE.threads = (LANE_THREADS, torch.get_num_threads())
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    esffn_res = esffn_cases(torch, flush)
    esffn_checks = esffn_check_cases(torch)
    attn_res, attn_checks, attn_neg = paged_attention_cases(torch, flush)
    for c in esffn_res + attn_res:
        print(f"[kernel] {json.dumps(c)}")
    print(f"[check] paged_attention: {len(attn_checks)} cases, worst "
          f"per-slot err / limit "
          f"{max(c['worst_slot_err_over_tol'] for c in attn_checks):.3g}")
    print(f"[negative-control] {attn_neg['kernel']} {attn_neg['fault']}: "
          f"fails at {attn_neg['err_over_tol']:.3g} x the limit")
    quant_res = quant_kernel_cases(torch, flush)
    for k in ("esffn_glu", "paged_attention", "esmm", "esffn_mlp"):
        for c in quant_res[k]:
            print(f"[kernel-quant] {k} {json.dumps(c)}")
    for c in quant_res["negative_controls"]:
        print(f"[negative-control] {c['kernel']} {c['fault']}: fails at "
              f"{c['err_over_tol']:.3g} x the limit")
    print(f"[check] paged_attention int8: "
          f"{len(quant_res['paged_attention_checks'])} cases, worst per-slot "
          f"err / limit {max(c['worst_slot_err_over_tol'] for c in quant_res['paged_attention_checks']):.3g}")
    jamba_res = jamba_kernel_cases(torch, flush)
    for k in ("esffn_glu", "paged_attention"):
        for c in jamba_res[k]:
            print(f"[kernel-jamba] {k} {json.dumps(c)}")
    for c in jamba_res["negative_controls"]:
        print(f"[negative-control] {c['kernel']} {c['fault']}: fails at "
              f"{c['err_over_tol']:.3g} x the limit")
    fw_kernels = fullwidth_kernel_cases(torch, flush)
    for k in ("esffn_glu", "paged_attention"):
        for c in fw_kernels[k]:
            print(f"[kernel-fullwidth] {k} {json.dumps(c)}")
    sampling_res = sampling_phase(torch, flush)
    del flush
    _release(torch)

    serve_ref = reference_phase(torch)
    _release(torch)
    pm_paths, pm_routes, pm_res = paged_mesh_phase(torch, serve_ref)
    print(f"[paged-mesh] {json.dumps(pm_res)}")
    _release(torch)
    spec_ref = spec_reference_phase(torch)
    _release(torch)
    prefix_ref = prefix_reference_phase(torch)
    _release(torch)
    quant_ref = quant_reference_phase(torch)
    _release(torch)
    hybrid_ref = {}
    for tag, arch in (("4j", "jamba-1.5-large-398b"), ("4x", "xlstm-350m")):
        hybrid_ref[tag] = hybrid_reference_phase(torch, arch, tag)
        _release(torch)
    fw_ref = {}
    for arch in FULLWIDTH:
        fw_ref[arch] = fullwidth_reference_phase(torch, arch)
        _release(torch)
    serve_launches, serve_res = serve_phase(torch)
    print(f"[serve] {json.dumps({**serve_res, 'reference': serve_ref, 'spec_reference': spec_ref, 'prefix_reference': prefix_ref, 'sampling': sampling_res})}")
    _release(torch)           # the serve phase's weights are gone
    quant_serve = quant_serve_phase(torch, serve_res["peak_allocated_gb"])
    print(f"[quant-serve] {json.dumps(quant_serve)}")
    _release(torch)           # the quantized serve's weights are gone
    hybrid_serve = {}
    for tag, arch in (("5j", "jamba-1.5-large-398b"), ("5x", "xlstm-350m")):
        hybrid_serve[tag] = hybrid_serve_phase(torch, arch, tag)
        _release(torch)
    print(f"[hybrid] {json.dumps({'reference': hybrid_ref, 'serve': hybrid_serve})}")
    _release(torch)
    fw_serve = {}
    for arch in FULLWIDTH:
        fw_serve[arch] = fullwidth_serve_phase(torch, arch)
        _release(torch)
    print(f"[fullwidth] {json.dumps({'reference': fw_ref, 'serve': fw_serve})}")
    _LANE.drain()      # phase O turns on the engines' global telemetry
    so_paths, so_routes, so_res = serve_obs_phase(torch)
    print(f"[serve-obs] {json.dumps(so_res)}")

    _release(torch)           # the serve phase's weights are gone
    print(f"[train] device memory allocated before training: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    train_res = train_kernel_cases(torch, flush)
    for c in train_res["esmm"] + train_res["estmm"] + train_res["esffn_glu"]:
        print(f"[kernel-train] {json.dumps(c)}")
    jt_res = jamba_train_kernel_cases(torch, flush)
    for k in ("esffn_glu", "esmm", "estmm"):
        for c in jt_res[k]:
            print(f"[kernel-jamba-train] {k} {json.dumps(c)}")
    for c in train_res["negative_controls"] + jt_res["negative_controls"]:
        print(f"[negative-control] {c['kernel']} {c['fault']}: fails at "
              f"{c['err_over_tol']:.3g} x the limit")
    del flush
    _release(torch)
    train_ref = train_reference_phase(torch)
    _release(torch)
    qat_ref = train_qat_reference_phase(torch)
    _release(torch)
    bf16_ref = train_reference_bf16_phase(torch)
    _release(torch)
    train_launches, train_out = train_phase(torch)
    print(f"[train] {json.dumps({**train_out, 'reference': train_ref, 'reference_qat': qat_ref, 'reference_bf16': bf16_ref})}")
    _release(torch)               # the qwen training state is gone
    ft_launches, ft_routes, ft_res = ft_train_phase(torch)
    print(f"[train-ft] {json.dumps(ft_res)}")
    _release(torch)
    to_paths, to_routes, to_res = train_obs_phase(torch)
    print(f"[train-obs] {json.dumps(to_res)}")
    _release(torch)
    lm_mesh_paths, lm_mesh_res = lm_mesh_phase(torch, train_out)
    print(f"[lm-mesh] {json.dumps(lm_mesh_res)}")
    _release(torch)
    family_ref = {"7h": hybrid_train_reference_phase(torch),
                  "7f": frontend_reference_phase(torch)}
    family_train = family_train_phase(torch)
    print(f"[train-families] {json.dumps({'reference': family_ref, 'train': family_train})}")
    _release(torch)
    fw_train = {arch: fullwidth_train_phase(torch, arch) for arch in FULLWIDTH}
    print(f"[fullwidth-train] {json.dumps(fw_train)}")
    _release(torch)
    family_mesh_paths, family_mesh_res = mesh_families_phase(torch)
    print(f"[mesh-families] {json.dumps(family_mesh_res)}")
    _release(torch)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    swin_res = swin_kernel_cases(torch, flush)
    for k in ("esffn_mlp", "esfk", "ess", "esmm", "estmm"):
        for c in swin_res[k]:
            print(f"[kernel-swin] {json.dumps(c)}")
    for c in swin_res["negative_controls"]:
        print(f"[negative-control] {c['kernel']} {c['fault']}: fails at "
              f"{c['err_over_tol']:.3g} x the limit")
    mlp_checks = esffn_mlp_check_cases(torch)
    print(f"[check] esffn_mlp: {len(mlp_checks)} cases, worst err / limit "
          f"{max(c['max_abs_err'] / c['tolerance'] for c in mlp_checks):.3g}")
    gemm_checks = esmm_esfk_check_cases(torch)
    for k in ("esmm", "esfk", "estmm"):
        cs_ = [c for c in gemm_checks if c["kernel"] == k]
        ran = [c for c in cs_ if c["route"] != "refused"]
        worst = max(max([c["max_abs_err"],
                         *c.get("max_abs_err_splits", {}).values()])
                    / c["tolerance"] for c in ran)
        routes = collections.Counter(c["route"] for c in cs_)
        print(f"[check] {k}: {len(cs_)} cases {dict(routes)}, worst err / "
              f"limit {worst:.3g}")
    del flush
    _release(torch)
    swin_ref = swin_reference_phase(torch)
    _release(torch)
    swin_launches, swin_out = swin_train_phase(torch)
    print(f"[swin] {json.dumps({**swin_out, 'reference': swin_ref})}")
    _release(torch)               # the Swin training state is gone
    _LANE.drain()      # T7/8 wraps the router and the reindexing
    t78 = tables78_phase(torch)
    print(f"[t78] {json.dumps(t78)}")
    _release(torch)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flash_launches, flash_routes, flash_res, flash_neg = flash_cases(
        torch, flush)
    for c in flash_res:
        print(f"[kernel-flash] {json.dumps(c)}")
    for c in flash_neg:
        print(f"[negative-control] {c['kernel']} {c['fault']}: fails at "
              f"{c['err_over_tol']:.3g} x the limit")
    del flush
    _release(torch)
    mesh_launches, mesh_res = mesh_phase(torch)
    print(f"[mesh] {json.dumps(mesh_res)}")
    _release(torch)
    hetero_launches, hetero_res = hetero_phase(torch)
    print(f"[hetero] {json.dumps(hetero_res)}")
    _release(torch)
    roofline_res = roofline_phase(torch)
    print(f"[roofline] {json.dumps(roofline_res)}")
    _release(torch)
    compression_res = compression_phase(torch)
    print(f"[compression] {json.dumps(compression_res)}")
    _LANE.join()
    print(f"[done] every phase in {time.perf_counter() - t_start:.1f}s")

    # Each kernel's launches on the main paths that ran it: the paged and
    # the dense serve runs, the speculative one and the prefix-sharing and
    # disaggregated ones (phases 5, 5s, 5p), the qwen train steps and the
    # QAT steps (phases 8, 8q), the Swin train steps and the
    # unfused-backward pass (phase 11), the fault-tolerant train loop's
    # runs (phase F), the Jamba layout's training
    # (phases 7h, 8j), the paged engine on the mesh (phase P), the serve
    # CLI with telemetry (phase O), the train CLI with --metrics
    # (train_obs) and the five configurations at full width (phases 4d,
    # 5d with their window crossings, 8d).
    qat_paths = {f"qwen_qat_{m}": r["launches"]
                 for m, r in train_out["qat"].items()}
    hybrid_paths = {f"hybrid_{tag}": r["launches"]
                    for tag, r in hybrid_ref.items()}
    hybrid_paths.update({f"hybrid_{tag}_{kind}": {
        "paged_attention": r[kind]["launches"]["paged_attention"]}
        for tag, r in hybrid_serve.items() for kind in ("paged", "dense")})
    jamba_train = {"jamba_train_7h": family_ref["7h"]["jamba-1.5-large-398b"],
                   "jamba_train_8j": family_train["8j"]}
    # phases 4d, 5d, 8d: the five configurations at full width (the 8-bit
    # esffn_glu launches of mixtral-8x7b's 5d runs stand in qpaths)
    fw_paths = {}
    for arch in FULLWIDTH:
        fw_paths[f"fullwidth_4d_{arch}"] = fw_ref[arch]["launches"][
            "paged cuda"]
        fw_paths[f"fullwidth_4d_{arch}_dense"] = fw_ref[arch]["launches"][
            "dense cuda"]
        for kind, r in fw_ref[arch].get("cross", {}).items():
            if isinstance(r, dict) and "launches" in r:
                fw_paths[f"fullwidth_4d_{arch}_cross_{kind}"] = r["launches"]
        quant = fw_serve[arch]["weights"] != "bf16"
        runs = {kind: fw_serve[arch][kind] for kind in ("paged", "dense")}
        runs.update({f"cross_{kind}": r for kind, r in fw_serve[arch].get(
            "cross", {}).items() if isinstance(r, dict) and "launches" in r})
        for kind, r in runs.items():
            fw_paths[f"fullwidth_5d_{arch}_{kind}"] = (
                {"paged_attention": r["launches"]["paged_attention"]}
                if quant else r["launches"])
        if fw_train[arch]["launches"]["esffn_glu"]:
            fw_paths[f"fullwidth_8d_{arch}"] = fw_train[arch]["launches"]
    paths = {**serve_launches, "qwen_train": train_launches,
             "train_ft": ft_launches, **qat_paths,
             **swin_launches, **hybrid_paths,
             **{p: r["launches"] for p, r in jamba_train.items()},
             **fw_paths, **mesh_launches, **hetero_launches,
             **{p: c for p, (c, _) in lm_mesh_paths.items()},
             **{p: c for p, (c, _) in family_mesh_paths.items()},
             **pm_paths, **so_paths, **to_paths}
    by_path = {}
    for path, counts in paths.items():
        for name, n in counts.items():
            if n:
                by_path.setdefault(name, {})[path] = n

    route_paths = {"serve": serve_res["launches_by_route"],
                   "serve_dense": serve_res["dense"]["launches_by_route"],
                   "serve_spec": serve_res["spec_launches_by_route"],
                   **serve_res["prefix_launches_by_route"],
                   "qwen_train": train_out["launches_by_route"],
                   "train_ft": ft_routes,
                   **{f"qwen_qat_{m}": r["launches_by_route"]
                      for m, r in train_out["qat"].items()},
                   **swin_out["launches_by_route"],
                   **{f"hybrid_{tag}": r["launches_by_route"]
                      for tag, r in hybrid_ref.items()},
                   **{p: r["launches_by_route"]
                      for p, r in jamba_train.items()},
                   **{f"fullwidth_8d_{a}": r["launches_by_route"]
                      for a, r in fw_train.items()
                      if r["launches"]["esffn_glu"]},
                   **{f"swin_mesh_{k.replace('/', '_')}":
                      r["launches_by_route"] for k, r in mesh_res.items()
                      if isinstance(r, dict) and "launches_by_route" in r},
                   **{f"hetero_{k}": {("esffn_glu" if r["glu"]
                                       else "esffn_mlp"):
                                      r["launches_by_route"]}
                      for k, r in hetero_res.items() if k in HETERO_WIDTHS},
                   **{p: r for p, (_, r) in lm_mesh_paths.items()},
                   **{p: r for p, (_, r) in family_mesh_paths.items()},
                   **pm_routes, "paged_mesh_p2":
                       serve_res["paged_mesh_launches_by_route"],
                   **so_routes, **to_routes}

    def by_route(name, cases, routes, paths=route_paths):
        """Each route of a kernel with several: its launches on each path
        and its first (head) case (None where no case ran on it)."""
        out = {}
        for route in routes:
            head = next((c for c in cases if c["kernel_route"] == route),
                        None)
            out[route] = {"launches_by_path": {
                p: r[name][route] for p, r in paths.items()
                if r.get(name, {}).get(route)}, "head_case": head and {
                    "ms": head["kernel_ms"], "bound_ms": head["bound_ms"],
                    "library_ms": head.get("library_ms"),
                    "max_abs_err": head["max_abs_err"],
                    "shape": head["shape"], "dtype": head["dtype"]}}
        return out

    def entry(name, source, replaces, cases, **extra):
        head = cases[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path.get(name, {}).values()),
                "launches_by_path": by_path.get(name, {}),
                "max_abs_err": head["max_abs_err"],
                "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head.get("library_ms"),
                "shape": head["shape"], "dtype": head["dtype"],
                "tolerance": head["tolerance"], "cases": cases, **extra}

    # The 8-bit branches' launches on the paths that ran them: the int8
    # and fp8 serve runs (phase Q3), the reference paths (phase Q2:
    # serve, the frozen-expert backward, the Swin forward), Jamba's serve
    # (5j) and phase H's 8-bit device class.
    qpaths = {**{f"quant_serve_{m}": {"esffn_glu": {m: r["launches"][
        "esffn_glu"]}, "paged_attention": {"int8": r["launches"][
            "paged_attention"]}} for m, r in quant_serve.items()},
        **{f"quant_{p}": c for p, c in quant_ref["launches"].items()},
        **{f"hybrid_{tag}_{kind}": r[kind]["launches_quant"]
           for tag, r in hybrid_serve.items() for kind in ("paged", "dense")},
        **{f"fullwidth_5d_{a}_{kind}": r[kind]["launches_quant"]
           for a, r in fw_serve.items() if r["weights"] != "bf16"
           for kind in ("paged", "dense")},
        **{f"fullwidth_5d_{a}_cross_{kind}": x["launches_quant"]
           for a, r in fw_serve.items() if r["weights"] != "bf16"
           for kind, x in r.get("cross", {}).items()
           if isinstance(x, dict) and "launches_quant" in x},
        **{f"hetero_{k}": {("esffn_glu" if r["glu"] else "esffn_mlp"):
                           r["launches_quant"]}
           for k, r in hetero_res.items() if k in HETERO_WIDTHS}}

    # PERF.md's rows of the five's new kernel shapes: each one's time and
    # bound (phase 3d; paged_attention at 5d's lengths) beside its
    # launches on its own configuration's paths (4d, 5d, crossings, 8d)
    timing = ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for arch in FULLWIDTH:
        mine = {p: n for p, n in by_path.get("paged_attention", {}).items()
                if p.startswith(f"fullwidth_4d_{arch}")
                or p.startswith(f"fullwidth_5d_{arch}")}
        for c in fw_kernels["paged_attention"]:
            if c["case"] == f"{arch} heads, 5d lengths":
                row = {"arch": arch, "window": c["shape"]["window"],
                       "heads": [c["shape"][k] for k in ("Hq", "Hkv", "hd")],
                       **{k: c.get(k) for k in timing},
                       "launches": sum(mine.values()),
                       "launches_by_path": mine}
                print(f"[fullwidth-shape] paged_attention {json.dumps(row)}")
    mine = {p: sum(q.get("esffn_glu", {}).values())
            for p, q in qpaths.items()
            if p.startswith("fullwidth_5d_mixtral-8x7b")}
    for c in fw_kernels["esffn_glu"]:
        row = {"N": c["shape"]["N"], "route": c["kernel_route"],
               **{k: c.get(k) for k in timing},
               "launches": sum(mine.values()), "launches_by_path": mine}
        print(f"[fullwidth-shape] esffn_glu int8 {json.dumps(row)}")

    def qentry(kernel, source, replaces, branch, cases, **extra):
        by = {p: sum(c.get(kernel, {}).values()) for p, c in qpaths.items()}
        by = {p: n for p, n in by.items() if n}
        head = cases[0]
        return {"name": f"{kernel} ({branch})", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": sum(by.values()), "launches_by_path": by,
                "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
                "kernel_ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                **{k: head[k] for k in ("bound_tf32x2_ms", "bound_fma_ms")
                   if k in head},
                "library_ms": None, "library": head["library"],
                "shape": head["shape"], "dtype": head["dtype"],
                "tolerance": head["tolerance"], "cases": cases,
                "negative_controls": [
                    c for c in quant_res["negative_controls"]
                    + jamba_res["negative_controls"]
                    if c["kernel"] == kernel], **extra}

    print(json.dumps({"kernels": [
        entry("esffn_glu", "src/repro_torch/csrc/esffn.cu",
              "src/repro/kernels/esffn.py:280",
              esffn_res + train_res["esffn_glu"] + jt_res["esffn_glu"],
              kernel_routes=by_route(
                  "esffn_glu", train_res["esffn_glu"] + esffn_res,
                  ("wgmma", "stream")),
              negative_controls=[
                  c for c in train_res["negative_controls"]
                  + jt_res["negative_controls"] if c["kernel"] == "esffn_glu"],
              small_width_checks=esffn_checks),
        entry("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention.py:295",
              attn_res + jamba_res["paged_attention"]
              + fw_kernels["paged_attention"],
              negative_controls=[attn_neg], checks=attn_checks),
        entry("esmm", "src/repro_torch/csrc/esmm.cu",
              "src/repro/kernels/esmm.py:80",
              train_res["esmm"] + swin_res["esmm"] + jt_res["esmm"],
              kernel_routes=by_route(
                  "esmm", train_res["esmm"] + swin_res["esmm"],
                  ("wgmma", "mma_tf32x3", "simt")),
              negative_controls=[
                  c for c in train_res["negative_controls"]
                  + swin_res["negative_controls"] if c["kernel"] == "esmm"],
              small_width_checks=[c for c in gemm_checks
                                  if c["kernel"] == "esmm"]),
        entry("estmm", "src/repro_torch/csrc/estmm.cu",
              "src/repro/kernels/estmm.py:43",
              train_res["estmm"] + swin_res["estmm"] + jt_res["estmm"],
              kernel_routes=by_route(
                  "estmm", train_res["estmm"] + swin_res["estmm"],
                  ("wgmma", "mma_tf32x3", "simt")),
              route_sources={"mma_tf32x3": "src/repro_torch/csrc/esfk.cu "
                                           "(esfk_dw_launch)"},
              negative_controls=[
                  c for c in train_res["negative_controls"]
                  + swin_res["negative_controls"] if c["kernel"] == "estmm"],
              small_width_checks={
                  "wgmma": train_res["checks"],
                  "float32": [c for c in gemm_checks
                              if c["kernel"] == "estmm"]}),
        entry("esffn_mlp", "src/repro_torch/csrc/esffn.cu",
              "src/repro/kernels/esffn.py:339", swin_res["esffn_mlp"],
              kernel_routes=by_route("esffn_mlp", swin_res["esffn_mlp"],
                                     ("mma_tf32x3", "mma_bf16")),
              bound_route=swin_res["esffn_mlp"][0]["bound_route"],
              bound_fma_ms=swin_res["esffn_mlp"][0]["bound_fma_ms"],
              negative_controls=[c for c in swin_res["negative_controls"]
                                 if c["kernel"] == "esffn_mlp"],
              small_width_checks=mlp_checks),
        entry("esfk", "src/repro_torch/csrc/esfk.cu",
              "src/repro/kernels/esfk.py:82", swin_res["esfk"],
              kernel_routes=by_route("esfk", swin_res["esfk"],
                                     ("mma_tf32x3",)),
              bound_fma_ms=swin_res["esfk"][0]["bound_fma_ms"],
              negative_controls=[c for c in swin_res["negative_controls"]
                                 if c["kernel"] == "esfk"],
              small_width_checks=[c for c in gemm_checks
                                  if c["kernel"] == "esfk"]),
        entry("ess", "src/repro_torch/csrc/ess.cu",
              "src/repro/kernels/ess.py:43", swin_res["ess"]),
        # no model path runs it (launches_by_path is empty): its path is
        # its own entry point, driven once a case in phase 12
        {**entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:80", flash_res,
                 kernel_routes=by_route(
                     "flash_attention", flash_res, ("wgmma", "simt"),
                     {"phase_12": {"flash_attention": flash_routes}}),
                 negative_controls=flash_neg),
         "launches": flash_launches,
         "launches_from": "phase 12, the public entry point"},
        qentry("esffn_glu", "src/repro_torch/csrc/esffn.cu",
               "src/repro/kernels/esffn.py:280", "int8/fp8 weights",
               quant_res["esffn_glu"] + jamba_res["esffn_glu"]
               + fw_kernels["esffn_glu"],
               tpu_branch="w_scales: _wtile, src/repro/kernels/esffn.py:118"),
        qentry("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
               "src/repro/kernels/paged_attention.py:295", "int8 KV",
               quant_res["paged_attention"],
               tpu_branch="k_scale/v_scale: the quantized branch of "
                          "_paged_kernel, src/repro/kernels/"
                          "paged_attention.py:218",
               checks=quant_res["paged_attention_checks"]),
        qentry("esmm", "src/repro_torch/csrc/esmm.cu",
               "src/repro/kernels/esmm.py:80", "int8/fp8 weights",
               quant_res["esmm"],
               tpu_branch="w_scales: has_scale, src/repro/kernels/esmm.py:61"),
        qentry("esffn_mlp", "src/repro_torch/csrc/esffn.cu",
               "src/repro/kernels/esffn.py:339", "int8/fp8 weights",
               quant_res["esffn_mlp"],
               tpu_branch="w_scales=(s1, s2): _wtile, "
                          "src/repro/kernels/esffn.py:118"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
