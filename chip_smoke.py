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
   the same prompts (8, not 16: one wave of the 8 slots, so the phase
   adds about half a minute), odd rids sampled at 0.8, 16 new tokens,
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

The qwen training state is then freed, and every other LM family trains
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
   under ``HYBRID_TRAIN_GRAD_TOL``, at two seeds, and once more with the
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
8x, 8p, 8m. The same for xlstm-350m (one 8-layer period of its 24, 7
   mLSTM and 1 sLSTM: the sLSTM's step loop paces the host),
   paligemma-3b (256 patches + 768 tokens a row) and musicgen-large
   (1,024 frames, 64 conditioning rows, 4 codebooks a row), at full width
   and (but 8x) depth, none launching an
   expert kernel; in 8m ``embed`` and ``head`` alone have a zero
   gradient, as in JAX (the inputs are frames and the 4 codebook heads
   replace the head): their first moments must be exactly 0; 8p and 8m then run a dense prefill and
   ``FRONTEND_DECODES`` decodes from the trained weights: logits finite,
   the lengths advancing.

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
   are recorded); then Swin-MoE-Small and -Base at full width and depth,
   f32, at every point of ``T78_AXES`` (8 experts, top-1/2, batch
   64; Table 8's 4 experts at top-k 1-4, batch 32, and at top-1, batch
   16-128; Table 7's 8 experts at top-k 1, 2, 4, 8, batch 16), each
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

It then prints the kernels' JSON line (the 8-bit branches as entries of
their own), and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
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
SPEC_SERVE_REQUESTS = 8
SPEC_SERVE_PAIRS = 2
# Phases 4p and 5p, the prefix-sharing paged engine: requests opening with
# one PREFIX_SHARED-token prompt (four PREFIX_PAGE-token pages) and a tail
# of their own; 4p in f32 at 2 layers (equalities asserted), 5p at phase
# 5's 48 bf16 layers.
PREFIX_PAGE, PREFIX_SHARED = 16, 64
PREFIX_REF_REQUESTS, PREFIX_REF_SLOTS = 6, 3
PREFIX_SERVE_REQUESTS, PREFIX_OWN, PREFIX_NEW = 16, 8, 16
# Phase 8q: quantization-aware training on phase 8's state, one warm-up
# and QAT_STEPS timed steps a mode; 7q holds it to the CPU at phase 7's
# size with phase 7's limits.
QAT_MODES = ("int8", "fp8")
QAT_STEPS = 2
TRAIN_DEPTH = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3
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
SWIN_REF_DEPTHS, SWIN_REF_BATCH = (2, 2, 2, 2), 2
# Phase T7/8, the paper's Tables 7/8 on the card: Swin-MoE-Small and -Base
# at full width and depth, f32, blk 128, hexa against tutel (capacity
# factor 1.25) and megablocks, along these axes, each a list of points
# (config, experts, top-k, batch): the first grid (8 experts, top-1 and top-2,
# batch 64: every activation is kept, and megablocks' buffer of E N k rows
# a MoE block adds about 229 MB (Small) or 305 MB (Base) x batch x k);
# Table 8's latency grid (benchmarks/latency_table.py: Small, 4 experts,
# top-k 1-4, batch 32) and its batch axis (top-1 at batch 16, 32, 64 and
# 128; the batch-32 point is the grid's cell); Table 7's memory against
# top-k (benchmarks/memory_table.py: 8 experts, top-k 1, 2, 4, 8, batch 16).
T78_CONFIGS = ("swin_moe_small", "swin_moe_base")
T78_TOP_K = (1, 2)
T78_IMPLS = ("hexa", "tutel", "megablocks")
T78_EXPERTS, T78_BATCH, T78_STEPS = 8, 64, 3
T78_AXES = {
    **{f"table7_batch64_{c[9:]}": [(c, T78_EXPERTS, k, T78_BATCH)
                                   for k in T78_TOP_K] for c in T78_CONFIGS},
    "table8_topk": [("swin_moe_small", 4, k, 32) for k in (1, 2, 3, 4)],
    "table8_batch": [("swin_moe_small", 4, 1, b) for b in (16, 32, 64, 128)],
    **{f"table7_topk_{c[9:]}": [(c, 8, k, 16) for k in (1, 2, 4, 8)]
       for c in T78_CONFIGS},
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
# chunked prefill; 4x runs every request on both CPU engines.
JAMBA_DEPTH = 8
HYBRID_REF_FFN = 1024
HYBRID_REF_REQUESTS, HYBRID_REF_NEW = 4, 6
HYBRID_CHUNK_TOL = {"jamba-1.5-large-398b": ATTN_TOL["float32"],
                    "xlstm-350m": 3e-3}
HYBRID_CPU = {"jamba-1.5-large-398b": (("paged",), 1),
              "xlstm-350m": (("paged", "reference_stream"),
                             HYBRID_REF_REQUESTS)}
HYBRID_SERVE_REQUESTS, HYBRID_SERVE_NEW = 16, 16
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
HYBRID_TRAIN_SEEDS = (7, 8)
# 8j/8x/8p/8m: the leaves whose gradient is zero in JAX too (musicgen's
# inputs are frames, and its codebook heads replace the head).
ZERO_GRAD_LEAVES = {"musicgen-large": ("embed", "head")}
# 8x trains one period of xlstm-350m's layer pattern: its 24 layers took
# 17.7 s a step on an H100 80GB HBM3 at 700 W (3 sLSTM step loops of
# 1,024 host-paced steps each)
XLSTM_TRAIN_DEPTH = 8
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
    (``_card_vs_cpu_loss``); the GPU run's expert kernels exactly
    ``_f32_expert_routes``: every f32 esmm and estmm on mma_tf32x3."""
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
          f"GPU {r['loss_gpu']!r} CPU {r['loss_cpu']!r}, total GPU "
          f"{r['total_gpu']!r} CPU {r['total_cpu']!r} (rel diff "
          f"{r['total_rel_diff']:.3e}); {r['grad_leaves']} grad leaves, "
          f"worst max |diff| / max |grad| {r['worst_grad_rel']:.3e}; routes "
          f"{r['launches_by_route']}")
    return r


def train_qat_reference_phase(torch):
    """Phase 7q: phase 7's model (2 layers at full width, f32, 2 x 64
    tokens, blk 16, seed 7) with ``quant="int8"``. Every expert weight's
    int8 payload and scales on the card equal the CPU's; one QAT
    ``loss_fn`` forward and backward on the card and on the CPU (plain
    versions) agree within ``TRAIN_LOSS_RTOL`` and ``TRAIN_GRAD_TOL``;
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
    cpu = tree_map(lambda t: t.cpu(), params)
    levels, blocks = 0, 0
    for layer, clayer in zip(params["layers"], cpu["layers"]):
        for name in qcore.EXPERT_WEIGHT_KEYS:
            if name not in layer["ffn"]:
                continue
            qg, sg = qcore.quantize_blockwise(layer["ffn"][name], mode="int8")
            qc, sc = qcore.quantize_blockwise(clayer["ffn"][name],
                                              mode="int8")
            levels += int((qg.cpu() != qc).sum())
            blocks += int((sg.cpu() != sc).sum())
            del qg, sg, qc, sc
    if levels or blocks:
        raise AssertionError(f"QAT reference: {levels} int8 levels and "
                             f"{blocks} scales differ between card and CPU")
    batch = TokenSource(DataConfig(seq_len=64, global_batch=2,
                                   vocab_size=cfg.vocab_size,
                                   seed=7)).batch(0)
    loss_fn = steps.make_loss_fn(cfg, pcfg)
    out = {}
    for device, p0 in (("cuda", params), ("cpu", cpu)):
        p = tree_map(lambda t: t.detach().requires_grad_(), p0)
        total, _ = loss_fn(p, batch_to(batch, device))
        grads = torch.autograd.grad(total, tree_leaves(p), allow_unused=True)
        out[device] = (float(total.detach()),
                       [None if g is None else g.cpu() for g in grads])
        del p, grads
    (tg, gg), (tc, gc) = out["cuda"], out["cpu"]
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
    del out, gg, gc, cpu
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
    print(f"[qat-reference] 2-layer full-width f32, int8: payloads and "
          f"scales card == CPU; loss GPU {tg!r} CPU {tc!r} (rel diff "
          f"{abs(tg - tc) / abs(tc):.3e}), worst grad max |diff| / max "
          f"|grad| {worst:.3e}; one layer, QAT == plain on dequant(quant(w)):"
          f" loss {lq!r} vs {ld!r}, worst grad {ste_worst:.3e}; "
          f"{seconds:.1f}s")
    return {"loss_gpu": tg, "loss_cpu": tc, "total_rel_diff":
            abs(tg - tc) / abs(tc), "worst_grad_rel": worst,
            "flipped_levels": levels, "ste_loss": [lq, ld],
            "ste_worst_grad_rel": ste_worst, "seconds": seconds}


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
                      grad_tol=TRAIN_GRAD_TOL):
    """One ``loss_fn`` forward and backward from ``params`` (on the card)
    and from their copy on the CPU (the plain versions) on ``batch``: the
    totals within TRAIN_LOSS_RTOL and every grad leaf within ``grad_tol``
    x its max |grad| (every leaf is measured before any is judged).
    Returns the numbers and the expert kernels' launches and routes of the
    card run, counted from 0."""
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to

    loss_fn = steps.make_loss_fn(cfg, pcfg)
    names = [n for n, _ in _named_leaves(params)]
    out, wall = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = tree_map(lambda t: t.detach().to(device).requires_grad_(), params)
        if device == "cuda":
            _reset_expert_counts()
        total, metrics = loss_fn(p, batch_to(batch, device))
        grads = torch.autograd.grad(total, tree_leaves(p), allow_unused=True)
        if device == "cuda":
            torch.cuda.synchronize()
            launches, routes = _expert_counts()
        out[device] = (float(metrics["loss"].detach()), float(total.detach()),
                       [None if g is None else g.cpu() for g in grads])
        wall[device] = time.perf_counter() - t0
        del p, grads
    (lg, tg, gg), (lc, tc, gc) = out["cuda"], out["cpu"]
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
    return {"grad_tol": grad_tol, "loss_gpu": lg, "loss_cpu": lc, "total_gpu": tg, "total_cpu": tc,
            "total_rel_diff": rel, "grad_leaves": len(gc),
            "worst_grad_rel": worst, "worst_leaf": worst_leaf,
            "worst_grad_rel_by_part": by_kind, "launches": launches,
            "launches_by_route": routes, "wall_s": wall}


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
    rounding of h) under ``TRAIN_GRAD_TOL``."""
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves
    from repro_torch.configs import jamba_1_5_large_398b as jamba
    from repro_torch.models import lm, xlstm
    from repro_torch.parallel.sharding import ParallelConfig

    xl = dataclasses.replace(cfglib.get_config("xlstm-350m"), dtype="float32")
    runs = [("jamba-1.5-large-398b", jamba.cut_config("reference",
                                                      "float32"), 7, True)]
    runs += [("xlstm-350m", xl, seed, True) for seed in HYBRID_TRAIN_SEEDS]
    runs += [("xlstm-350m", xl, HYBRID_TRAIN_SEEDS[0], False)]
    res = {}
    for arch, cfg, seed, h_bf16 in runs:
        key = arch if not res.get(arch) else (
            f"{arch} seed {seed}" if h_bf16 else f"{arch} h f32")
        t0 = time.perf_counter()
        pcfg = ParallelConfig(blk=16)
        params = lm.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda")
        n_params = sum(t.numel() for t in tree_leaves(params))
        tol = (HYBRID_TRAIN_GRAD_TOL.get(arch, TRAIN_GRAD_TOL) if h_bf16
               else TRAIN_GRAD_TOL)
        xlstm.SLSTM_H_DTYPE = torch.bfloat16 if h_bf16 else torch.float32
        try:
            r = _card_vs_cpu_loss(torch, "7h", cfg, pcfg, params,
                                  _family_batch(cfg, 2, 64, seed),
                                  grad_tol=tol)
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
              f"64 tokens, seed {seed}: total GPU {r['total_gpu']!r} CPU "
              f"{r['total_cpu']!r} (rel {r['total_rel_diff']:.3e}); "
              f"{r['grad_leaves']} grad leaves, worst max |diff| / max "
              f"|grad| {r['worst_grad_rel']:.3e} at {r['worst_leaf']} "
              f"(limit {r['grad_tol']:.3g}); by "
              f"part {json.dumps(r['worst_grad_rel_by_part'])}; launches "
              f"{r['launches']}; {r['seconds']:.1f}s")
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
    (4j's limit) and the cache lengths advancing by one a decode."""
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
                              _family_batch(cfg, 2, seq, 11))
        if any(r["launches"].values()):
            raise AssertionError(f"phase 7f {arch}: expert kernels launched "
                                 f"{r['launches']}")
        cpu = tree_map(lambda t: t.cpu(), params)
        steps_out = {}
        for device, p in (("cuda", params), ("cpu", cpu)):
            steps_out[device], total = _frontend_serve(torch, cfg, pcfg, p,
                                                    device, 2, 12)
        errs = []
        for i, (a, b) in enumerate(zip(steps_out["cuda"], steps_out["cpu"])):
            err, tol = _check(f"phase 7f {arch}: step {i} logits", a, b,
                              ESFFN_TOL["float32"])
            errs.append(err / tol)
        r.update(arch=arch, layers=FRONTEND_REF_DEPTH, params=n_params,
                 prefill_rows=total, decodes=FRONTEND_DECODES,
                 logits_shape=list(steps_out["cuda"][0].shape),
                 worst_logit_err_over_tol=max(errs),
                 seconds=time.perf_counter() - t0)
        print(f"[7f] {arch}, {FRONTEND_REF_DEPTH} layers at full width, "
              f"{n_params / 1e9:.3f} B parameters, f32: loss batch 2 x {seq}"
              f" rows: total GPU {r['total_gpu']!r} CPU {r['total_cpu']!r} "
              f"(rel {r['total_rel_diff']:.3e}); {r['grad_leaves']} grad "
              f"leaves, worst {r['worst_grad_rel']:.3e} at "
              f"{r['worst_leaf']}; dense prefill of {total} rows and "
              f"{FRONTEND_DECODES} decodes, logits {r['logits_shape']}, worst"
              f" err / limit {max(errs):.3g}; {r['seconds']:.1f}s")
        res[arch] = r
        del params, cpu
        _release(torch)
    return res


def _family_train(torch, tag, cfg, batch, seq, *, expect=None,
                  serve=False):
    """Phases 8j/8x/8p/8m: ``cfg`` in bf16, AdamW with f32 masters,
    ``remat="block"``, blk 128, the train CLI's batches of ``batch`` x
    ``seq`` rows: one warm-up step, then TRAIN_STEPS steps with the expert
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
               for i in range(TRAIN_STEPS + 1)]

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
    for i in range(1, TRAIN_STEPS + 1):
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
    want = {k: (expect or {}).get(k, 0) * TRAIN_STEPS for k in launches}
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
    (``_family_train``)."""
    from repro_torch import configs as cfglib

    from repro_torch.configs import jamba_1_5_large_398b as jamba_cfg

    jamba = jamba_cfg.cut_config("train", "bfloat16")
    n = _moe_layers(jamba)
    out = {"8j": _family_train(
        torch, "8j", jamba, TRAIN_BATCH, TRAIN_SEQ,
        expect={"esffn_glu": 2 * n, "esmm": 5 * n, "estmm": 3 * n})}
    xlstm = dataclasses.replace(cfglib.get_config("xlstm-350m"),
                                num_layers=XLSTM_TRAIN_DEPTH)
    for tag, cfg in (("8x", xlstm),
                     ("8p", cfglib.get_config("paligemma-3b")),
                     ("8m", cfglib.get_config("musicgen-large"))):
        out[tag] = _family_train(torch, tag, cfg, TRAIN_BATCH, TRAIN_SEQ,
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
    hexa against tutel and megablocks) on the card: Swin-MoE-Small and
    -Base at full width and depth, f32, at every point of T78_AXES (a
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
    each path are counted from 0."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.configs import swin_moe_small
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.kernels import esffn, esmm, paged_attention
    from repro_torch.launch import serve, steps
    from repro_torch.launch.train import batch_to
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
    streams = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), params)
        server = serve.PagedServer(
            cfg, ParallelConfig(blk=16), num_slots=2, page_size=16,
            num_pages=9, max_pages_per_slot=4, params=p, kv_quant="int8",
            device=device)
        for i, pr in enumerate(prompts):
            server.submit(serve.Request(rid=i, prompt=pr, max_new=4))
        _reset_quant(*kernels)
        streams[device] = {r.rid: r.out for r in server.run()}
        if device == "cuda":
            out["launches"]["reference_serve"] = _quant_counts(*kernels)
        del p, server
    if streams["cuda"] != streams["cpu"] or len(streams["cuda"]) != 3:
        raise AssertionError(f"quant reference: GPU tokens {streams['cuda']}"
                             f" != CPU tokens {streams['cpu']}")
    served = out["launches"]["reference_serve"]
    if served["esffn_glu"]["int8"] <= 0 or \
            served["paged_attention"]["int8"] <= 0:
        raise AssertionError(f"quant reference: launches {served}")
    print(f"[quant-reference] 2-layer full-width f32, int8 experts + int8 "
          f"KV: GPU == CPU greedy tokens {streams['cuda']}; launches "
          f"{served}")

    # one loss forward + backward, experts frozen: grads of every float
    # leaf but the scales (embeddings, attention, norms, routers, head)
    batch = TokenSource(DataConfig(seq_len=64, global_batch=2,
                                   vocab_size=cfg.vocab_size,
                                   seed=25)).batch(0)
    loss_fn = steps.make_loss_fn(cfg, ParallelConfig(blk=16))
    res = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.detach().to(device), params)
        named = [(n, t) for n, t in _named_leaves(p)
                 if t.dtype == torch.float32 and not n.endswith("_scale")]
        leaves = [t for _, t in named]
        for t in leaves:
            t.requires_grad_(True)
        _reset_quant(*kernels)
        esmm.esmm.launches_by_route = dict.fromkeys(
            esmm.esmm.launches_by_route, 0)
        total, metrics = loss_fn(p, batch_to(batch, device))
        grads = torch.autograd.grad(total, leaves)
        if device == "cuda":
            torch.cuda.synchronize()
            out["launches"]["reference_backward"] = _quant_counts(*kernels)
            esmm_routes = dict(esmm.esmm.launches_by_route)
        res[device] = (float(total.detach()), [g.cpu() for g in grads],
                       [n for n, _ in named])
        del p, leaves, grads
    (tg, gg, leaf_names), (tc, gc, _) = res["cuda"], res["cpu"]
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
    if not abs(tg - tc) <= TRAIN_LOSS_RTOL * abs(tc):
        raise AssertionError(f"quant reference: GPU loss {tg} vs CPU {tc}")
    worst = _grad_err(gg, gc, TRAIN_GRAD_TOL, "quant reference")
    print(f"[quant-reference] loss + grads, 2 x 64 tokens, int8 experts "
          f"frozen: total GPU {tg!r} CPU {tc!r} (rel diff "
          f"{abs(tg - tc) / abs(tc):.3e}); {len(gc)} grad leaves (incl. "
          f"{sum(n.endswith('router') for n in leaf_names)} routers), worst "
          f"max |diff| / max |grad| {worst:.3e}; launches "
          f"{back}")
    out.update(loss_gpu=tg, loss_cpu=tc, loss_rel_diff=abs(tg - tc) / abs(tc),
               worst_grad_rel=worst)
    del params

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
    spcfg = ParallelConfig(blk=128)
    logits = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), sp)
        _reset_quant(*kernels)
        with torch.no_grad():
            logits[device] = swin.swin_forward(p, images.to(device), scfg,
                                               spcfg)[0].float().cpu()
        if device == "cuda":
            out["launches"]["reference_swin"] = _quant_counts(*kernels)
        del p
    n_moe = sum("moe" in blk for st in sp["stages"] for blk in st["blocks"])
    sw = out["launches"]["reference_swin"]
    if sw["esffn_mlp"]["int8"] != n_moe:
        raise AssertionError(f"quant swin: launches {sw}, expected {n_moe} "
                             f"int8 esffn_mlp")
    err, tol = _check("quant swin forward", logits["cuda"], logits["cpu"],
                      SWIN_KERNEL_TOL)
    print(f"[quant-reference] Swin-MoE-Small full width and depth, int8 MoE "
          f"experts, {QUANT_SWIN_BATCH} images: logits max |diff| {err:.3e} "
          f"(limit {tol:.3e}); launches {sw}")
    out.update(swin_logits_err=err, swin_tolerance=tol)
    return out


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

    for mode, n_req in (("int8", 16), ("fp8", QUANT_FP8_REQUESTS)):
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
    route, and on the CPU (the plain versions). The routers' top-k picks
    of both runs are recorded: a pick that differs sends a token's grads to
    another expert, which the limits below allow for."""
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.core import espec
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.kernels import esffn, esmm, estmm
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to
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
    loss_fn = steps.make_loss_fn(cfg, pcfg)
    picks = {}
    route = espec.route
    out = {}
    try:
        for device in ("cuda", "cpu"):
            sink = picks.setdefault(device, [])

            def recording(*a, sink=sink, **kw):
                r = route(*a, **kw)
                sink.append(torch.sort(r.expert_idx, dim=-1)[0].cpu())
                return r

            espec.route = recording
            before = {fn.__name__: dict(fn.launches_by_route)
                      for fn in routed}
            p = tree_map(lambda t: t.detach().to(device).requires_grad_(),
                         params)
            total, metrics = loss_fn(p, batch_to(batch, device))
            grads = torch.autograd.grad(total, tree_leaves(p))
            if device == "cuda":
                torch.cuda.synchronize()
                routes = {fn.__name__: {r: fn.launches_by_route[r]
                                        - before[fn.__name__][r]
                                        for r in fn.launches_by_route}
                          for fn in routed}
            out[device] = (float(metrics["loss"].detach()),
                           float(total.detach()),
                           [g.float().cpu() for g in grads])
            del p, grads
    finally:
        espec.route = route
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
    flips = [int((a != b).any(dim=-1).sum())
             for a, b in zip(picks["cuda"], picks["cpu"])]
    (lg, tg, gg), (lc, tc, gc) = out["cuda"], out["cpu"]
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
          f"differ, per layer: {flips}; routes {routes}")
    res = {"loss_gpu": lg, "loss_cpu": lc, "total_rel_diff": rel,
           "worst_grad_frobenius_rel": worst_f, "worst_leaf": worst_leaf,
           "worst_grad_max_rel": worst_max, "routing_flips": flips,
           "routes": routes}
    if not rel <= BF16_REF_LOSS_RTOL:
        raise AssertionError(f"bf16 train reference: GPU total {tg} vs CPU "
                             f"{tc} (rel {rel})")
    if not worst_f <= BF16_REF_GRAD_TOL:
        raise AssertionError(f"bf16 train reference: grad leaf {worst_leaf}"
                             f" |diff| / |grad| {worst_f} > "
                             f"{BF16_REF_GRAD_TOL}")
    return res


def reference_phase(torch):
    """2 layers at full width in f32: the dense ``BatchedServer`` on the GPU
    must give the same greedy tokens as ``PagedServer`` and the batch-1
    ``reference_stream``, each on the GPU (kernels) and on the CPU (plain
    versions), from the same weights. Returns the tokens and each run's
    wall time."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_map
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    pcfg = ParallelConfig(blk=16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(3)]
    max_new, max_seq = 4, 64

    def engine(kind, device, p):
        if kind == "dense":
            return serve.BatchedServer(cfg, pcfg, num_slots=2,
                                       max_seq=max_seq, params=p,
                                       device=device)
        return serve.PagedServer(
            cfg, pcfg, num_slots=2, page_size=16, num_pages=9,
            max_pages_per_slot=4, params=p, device=device)

    streams, wall = {}, {}
    for kind, device, p in (("dense", "cuda", params),
                            ("paged", "cuda", params),
                            ("paged", "cpu", cpu_params),
                            ("reference_stream", "cuda", params),
                            ("reference_stream", "cpu", cpu_params)):
        t0 = time.perf_counter()
        reqs = [serve.Request(rid=i, prompt=pr, max_new=max_new)
                for i, pr in enumerate(prompts)]
        if kind == "reference_stream":
            out = {r.rid: serve.reference_stream(cfg, pcfg, p, r,
                                                 max_seq=max_seq)
                   for r in reqs}
        else:
            server = engine(kind, device, p)
            for r in reqs:
                server.submit(r)
            out = {r.rid: r.out for r in server.run()}
        streams[f"{kind} {device}"] = out
        wall[f"{kind} {device}"] = time.perf_counter() - t0
    want = streams["dense cuda"]
    if len(want) != 3 or any(len(o) != max_new for o in want.values()) \
            or any(st != want for st in streams.values()):
        raise AssertionError(f"reference phase: greedy tokens differ: "
                             f"{streams}")
    print(f"[reference] 2-layer full-width f32: dense BatchedServer (GPU) == "
          f"PagedServer (GPU, CPU) == reference_stream (GPU, CPU) greedy "
          f"tokens {want}; wall s {json.dumps(wall)}")
    return {"tokens": {str(k): v for k, v in want.items()},
            "engines": sorted(streams), "wall_s": wall}


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
    return {"serve": launches, "serve_dense": dense_launches,
            "serve_spec": {"esffn_glu": spec_launches},
            **prefix_launches}, {
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
    CPU's speculative engine (the plain versions) gives the card's
    streams."""
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
        srv = _audited(serve.PagedServer(
            cfg, pcfg, num_slots=2, page_size=16, num_pages=9,
            max_pages_per_slot=4, params=p, device=device))
        if drafter is not None:
            spec.SpecDecoder(srv, drafter, k=SPEC_K)
        for r in reqs:
            srv.submit(serve.Request(**r))
        t0 = time.perf_counter()
        out = {r.rid: r.out for r in srv.run()}
        wall[what] = time.perf_counter() - t0
        _drained(srv, f"spec reference ({what})")
        if len(out) != len(reqs):
            raise AssertionError(f"spec reference ({what}): unfinished")
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
    _, cpu_on = run("ngram cpu", cpu_params, "cpu", mix, spec.NGramDrafter())
    if cpu_on != off:
        raise AssertionError(f"spec reference: CPU streams {cpu_on} vs the "
                             f"card's {off}")
    res = {"streams": {str(k): v for k, v in off.items()},
           "ngram": ngram.spec.stats(), "wrong": sw, "model_self": ss,
           "sampled_streams_off_greedy": moved, "wall_s": wall}
    print(f"[spec-reference] 2-layer full-width f32, k {SPEC_K}: NGram "
          f"speculation (card) == off == reference_stream == NGram on the "
          f"CPU, streams {off}; NGram {res['ngram']}; wrong drafter {sw}; "
          f"self-drafting ModelDrafter {ss}; {moved} of 2 sampled streams "
          f"off greedy; pool checked every tick and drained; wall s "
          f"{json.dumps(wall)}")
    return res


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
    prompts (8 of 16, one wave of the 8 slots: the 16 took 70 s), odd rids
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
          f"(cut to one wave of the slots, to keep the script's time), k "
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
    requests), 2 slots so both engines refill a slot: every stream
    equal. The paged card run's kernel launches, counted from 0, are
    exactly one ``esffn_glu`` a MoE layer and one ``paged_attention`` an
    attention layer a forward (one forward a prompt token, the token-wise
    prefill, and one a decode step), all ``esffn_glu`` on ``stream``.
    ``steps.make_prefill_step`` (the chunked scans) gives last logits
    within HYBRID_CHUNK_TOL of the token-wise path's on the card and
    within ESFFN_TOL of its own on the CPU."""
    import numpy as np
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.launch import serve, steps
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    t_phase = time.perf_counter()
    cfg = _hybrid_config(arch, "float32")
    pcfg = ParallelConfig(blk=16)
    params = lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(41), device="cuda")
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    cpu_params = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(HYBRID_REF_REQUESTS)]
    max_seq = 64
    per_fwd = _hybrid_launch_counts(cfg)

    cpu_kinds, cpu_requests = HYBRID_CPU[arch]
    streams, wall, counts = {}, {}, {}
    for kind, device, p in (("dense", "cuda", params),
                            ("paged", "cuda", params),
                            ("reference_stream", "cuda", params),
                            *((k, "cpu", cpu_params) for k in cpu_kinds)):
        reqs = [serve.Request(rid=i, prompt=pr, max_new=HYBRID_REF_NEW)
                for i, pr in enumerate(prompts)]
        if device == "cpu":
            reqs = reqs[:cpu_requests]
        t0 = time.perf_counter()
        _reset_counts()
        if kind == "reference_stream":
            out = {r.rid: serve.reference_stream(cfg, pcfg, p, r,
                                                 max_seq=max_seq)
                   for r in reqs}
        else:
            if kind == "dense":
                server = serve.BatchedServer(cfg, pcfg, num_slots=2,
                                             max_seq=max_seq, params=p,
                                             device=device)
            else:
                server = serve.PagedServer(
                    cfg, pcfg, num_slots=2, page_size=16, num_pages=9,
                    max_pages_per_slot=4, params=p, device=device)
            for r in reqs:
                server.submit(r)
            out = {r.rid: r.out for r in server.run()}
        key = f"{kind} {device}"
        streams[key], wall[key] = out, time.perf_counter() - t0
        if key == "paged cuda":
            counts = _read_counts()
            fwds = sum(len(r.prompt) for r in reqs) + len(
                server.decode_times_s)
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
            st != {rid: want[rid] for rid in range(
                cpu_requests if key.endswith("cpu") else len(want))}
            for key, st in streams.items()):
        raise AssertionError(f"phase {tag}: greedy tokens differ: {streams}")

    tokens = np.stack(prompts)
    b = tokens.shape[0]
    logits = {}
    for device, p in (("cuda", params), ("cpu", cpu_params)):
        t0 = time.perf_counter()
        lg, _ = steps.make_prefill_step(cfg, pcfg)(
            p, {"tokens": torch.from_numpy(tokens).to(device)},
            lm.init_cache(cfg, b, max_seq, device))
        logits[device] = lg[:, -1].float().cpu()
        wall[f"make_prefill_step {device}"] = time.perf_counter() - t0
    step = steps.make_serve_step(cfg, pcfg)
    cache = lm.init_cache(cfg, b, max_seq, "cuda")
    for t in range(tokens.shape[1]):
        lg, cache = step(params, {"tokens": torch.from_numpy(
            tokens[:, t:t + 1]).cuda()}, cache)
    tokenwise = lg[:, -1].float().cpu()
    err_tw, tol_tw = _check(f"phase {tag}: chunked vs token-wise logits",
                            logits["cuda"], tokenwise, HYBRID_CHUNK_TOL[arch])
    err_cpu, tol_cpu = _check(f"phase {tag}: card vs CPU logits",
                              logits["cuda"], logits["cpu"],
                              ESFFN_TOL["float32"])
    res = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "moe_d_ff": cfg.moe.d_ff if cfg.moe else None,
           "weights_gb": n_bytes / 1e9, "tokens": {str(k): v for k, v in
                                                   want.items()},
           "engines": sorted(streams), "cpu_requests": cpu_requests,
           "launches": {
               k: counts[k] for k in ("esffn_glu", "paged_attention")},
           "launches_per_forward": {"esffn_glu": per_fwd[0],
                                    "paged_attention": per_fwd[1]},
           "launches_by_route": {"esffn_glu": counts["esffn_glu_routes"]},
           "chunked_vs_tokenwise_err": err_tw,
           "chunked_vs_tokenwise_tol": tol_tw,
           "card_vs_cpu_logit_err": err_cpu, "card_vs_cpu_logit_tol": tol_cpu,
           "wall_s": wall, "seconds": time.perf_counter() - t_phase}
    print(f"[{tag}] {arch}, {cfg.num_layers} layers, f32, {n_bytes / 1e9:.2f}"
          f" GB: greedy tokens {want} equal on {sorted(streams)} (the CPU "
          f"engines on the first {cpu_requests} requests); launches "
          f"{res['launches']} ({per_fwd} a forward); prefill logits chunked "
          f"vs token-wise err {err_tw:.3g} (limit {tol_tw:.3g}), card vs "
          f"CPU {err_cpu:.3g} (limit {tol_cpu:.3g}); in "
          f"{res['seconds']:.1f}s, wall s {json.dumps(wall)}")
    return res


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
    out["seconds"] = time.perf_counter() - t_phase
    return launches_by_path, out


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


def _release(torch):
    """Free what the last phase left: its objects in reference cycles (a
    ``SpecDecoder`` and its server point at each other, so their weights
    wait for the cycle collector) and then the allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


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
    sampling_res = sampling_phase(torch, flush)
    del flush
    _release(torch)

    serve_ref = reference_phase(torch)
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
    family_ref = {"7h": hybrid_train_reference_phase(torch),
                  "7f": frontend_reference_phase(torch)}
    family_train = family_train_phase(torch)
    print(f"[train-families] {json.dumps({'reference': family_ref, 'train': family_train})}")
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
    print(f"[done] every phase in {time.perf_counter() - t_start:.1f}s")

    # Each kernel's launches on the main paths that ran it: the paged and
    # the dense serve runs, the speculative one and the prefix-sharing and
    # disaggregated ones (phases 5, 5s, 5p), the qwen train steps and the
    # QAT steps (phases 8, 8q), the Swin train steps and the
    # unfused-backward pass (phase 11), the Jamba layout's training
    # (phases 7h, 8j).
    qat_paths = {f"qwen_qat_{m}": r["launches"]
                 for m, r in train_out["qat"].items()}
    hybrid_paths = {f"hybrid_{tag}": r["launches"]
                    for tag, r in hybrid_ref.items()}
    hybrid_paths.update({f"hybrid_{tag}_{kind}": {
        "paged_attention": r[kind]["launches"]["paged_attention"]}
        for tag, r in hybrid_serve.items() for kind in ("paged", "dense")})
    jamba_train = {"jamba_train_7h": family_ref["7h"]["jamba-1.5-large-398b"],
                   "jamba_train_8j": family_train["8j"]}
    paths = {**serve_launches, "qwen_train": train_launches, **qat_paths,
             **swin_launches, **hybrid_paths,
             **{p: r["launches"] for p, r in jamba_train.items()},
             **mesh_launches, **hetero_launches}
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
                   **{f"qwen_qat_{m}": r["launches_by_route"]
                      for m, r in train_out["qat"].items()},
                   **swin_out["launches_by_route"],
                   **{f"hybrid_{tag}": r["launches_by_route"]
                      for tag, r in hybrid_ref.items()},
                   **{p: r["launches_by_route"]
                      for p, r in jamba_train.items()},
                   **{f"swin_mesh_{k.replace('/', '_')}":
                      r["launches_by_route"] for k, r in mesh_res.items()
                      if isinstance(r, dict) and "launches_by_route" in r},
                   **{f"hetero_{k}": {("esffn_glu" if r["glu"]
                                       else "esffn_mlp"):
                                      r["launches_by_route"]}
                      for k, r in hetero_res.items() if k in HETERO_WIDTHS}}

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
        **{f"hetero_{k}": {("esffn_glu" if r["glu"] else "esffn_mlp"):
                           r["launches_quant"]}
           for k, r in hetero_res.items() if k in HETERO_WIDTHS}}

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
              attn_res + jamba_res["paged_attention"],
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
               quant_res["esffn_glu"] + jamba_res["esffn_glu"],
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
