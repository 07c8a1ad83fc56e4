#!/usr/bin/env python3
"""Drive the PyTorch port's ViCaS serving paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--max_new_tokens N] [--parallel_only]

Phases, each printed on its own line(s); any failure raises and the
script exits non-zero without printing a result:

  0. environment: the card (nvidia-smi name, power limit), torch, CUDA,
     nvcc; TF32 off for matmuls and convolutions.
  1. build: the CUDA kernels compile from `video_llava_seg_torch/csrc`;
     the ptxas registers and spills of attention_sm90.cu (K2 and the
     online form at head dims 64 / 80 / 96), attention_short_sm90.cu
     (K3), attention_bwd_sm90.cu (K6a / K6b), attention_short_bwd_sm90.cu
     (K6a + K6b in one pass, eight instances), w4a8_sm90.cu (K5's
     prefill), w4a8_gemv_sm90.cu (K5's decode, sixteen instances: rows
     1-8, bf16 / fp32 out), w8a8_sm90.cu (gemm_s8), gemm_bf16_sm90.cu
     (the bf16 denses of K1 and K4, three instances), layernorm_sm90.cu
     (K1's / K4's LayerNorms, five instances: 1-5 vectors a lane),
     pool_sm90.cu (K4's shortcut pool) and w8a8_rows_sm90.cu (K8's row
     quantizers, eight instances: 4 / 5 vectors a lane after a LayerNorm
     with bf16 or fp32 gamma, 4 / 5 / 16 / 20 without, with each
     instance's SASS instructions a lane-element), and the wgmma (HGMMA bf16, IGMMA
     int8; IDP, dp4a, for w4a8_gemv_sm90.cu; SHFL / HMNMX2 for the row
     streams) and UTMALDG (TMA load; UBLKCP, the 1-D bulk copy, for the
     row streams) counts in the SASS of each instance of their kernels
     (a zero, or a missing instance, fails).
  2. per-kernel checks at the shapes the main paths give them: K1..K4 in
     bf16 against their plain PyTorch versions run in fp32 on the same
     bf16 inputs (K2 also with the per-key bias of a left-padded batch-2
     prefill); K5 (W4A8) at every Llama-3-8B dense shape in the decode
     and the batch-2 prefill regimes, held to EXACT equality with its
     plain version. CUDA-event times of kernel, plain version and the
     one-call library equivalent where there is one; the bound (least
     time the card could take) from the bytes and operations each call
     needs, against the H100 SXM's published peaks, with the TFLOP/s
     and share of the bound; K2 (attention_sm90.cu at head dim 128) also
     beside attention.cu's online form, which it replaced, and K5's
     prefill (w4a8_sm90.cu) beside w4a8.cu's mma.sync tile, its decode
     (w4a8_gemv_sm90.cu) beside w4a8.cu's GEMV; then K5's five decode
     denses by device time (`[k5]` lines: CUDA graphs over weight copies
     past the L2) on both entries and `_int_mm`, and one decode step's
     129 products in one graph on both entries and on `_int_mm`. K3 runs on
     the mask decoder's [B, S, H, 16] views through
     attention_short_sm90.cu (the route asserted), timed over 10 launches
     back to back beside attention.cu's two-pass form, which it replaced,
     and SDPA, and also by device time alone (a CUDA graph of the 10
     launches: at these shapes the host's cost of a call exceeds it); K3
     also at the SAM2 image predictor's `predict` (q [1, 8, 4096, 16], 9
     keys: a box, the pad point, 6 output tokens) and the automatic mask
     generator's point batch ([64, 8, 4096, 16], 8 keys), and K4 also at
     each block kind of SAM2.1-hiera-tiny over one 1024^2 image.
  3. the bf16 slice at full width (CLIP-L/14-336 over 32 frames,
     Llama-3-8B, SAM2.1-hiera-small at 1024^2 over 8 frames), seeded
     random bf16 weights built on the card: one caption query and one
     referral query through `inference.main.get_model_output_frames`,
     with the launch counts of K1..K5 taken over exactly that run; every
     path's check also asserts that each K3 launch took
     attention_short_sm90.cu, and that attention_sm90.cu served every
     K2 launch, the attention link of every K1 / K8 layer and every
     trunk block K4 sends it (`trunk_sm90_blocks`: the 3 global ones),
     that window_attention_sm90.cu served the 13 windowed blocks of
     every K4 trunk (and every K7 call), that gemm_bf16_sm90.cu served
     every dense of K1 (6 a layer) and K4 (67 a trunk: 4 a block and 3
     shortcut projections) and gemm_bf16.cu none, that
     layernorm_sm90.cu served both LayerNorms of every K1 layer and K4
     block and pool_sm90.cu the 3 shortcut pools a trunk (layernorm.cu
     and pool.cu none); then a warm repeat of the referral query,
     outside the counted run, its seg_encode printed beside the cold
     one's.
  4. the quantized batched slice at full width: the same tower,
     projector and seg head in bf16, the LLM built by
     `llama.init_quantized(bits=4, act_quant=True)` and fused
     (`fuse_qkv_gateup`), int8 KV cache; the caption and the referral
     query in ONE `inference.main.get_model_output_batched` call, with
     the launch counts of K1..K5 taken over exactly that call, K5's by C
     entry (129 x decode steps + 1 on w4a8_gemv_sm90.cu, 128 on
     w4a8_sm90.cu, 0 on w4a8.cu).
  5. agreement on a small input: the tiny config through both entry
     points, bf16 and W4A8 batched, on the card (kernels, bf16) and on
     the CPU (plain, fp32).
  6. the flash backward at the train step's shapes: K2 / K3 with their
     logsumexp output and K6a (dQ) / K6b (dK, dV) against the plain
     versions (`flash_forward_plain`, `flash_backward_plain`) at the
     Llama-3-8B causal GQA attention over the synthetic batch's spliced
     length, the mask decoder's image->token attention (its [B, S, H, 16]
     views; K3 timed as in phase 2), and one per-key
     bias case with masked keys; times of kernel, plain version and the
     backward of `scaled_dot_product_attention`; at head dim 128, where
     attention_bwd_sm90.cu serves K6a / K6b, also attention_bwd.cu's time
     at the same shape. The mask decoder's backward takes
     attention_short_bwd_sm90.cu (the route asserted): dQ, dK and dV in
     one call, held to the plain backward within BOUNDS["K6a"] /
     ["K6b"] and bit-identical over two calls, timed as K3 (10 launches
     back to back and by device time) beside attention_bwd.cu's pair,
     which it replaced, under both the K6a and the K6b name (the same
     call), with the one pass's byte bound; then a small GQA 2, causal,
     per-key-bias case on it (masked keys' dK / dV exactly zero).
  7. gradients through the fused forward kernels: every kernel op's
     output carries a grad_fn when an input requires grad, and the K1 /
     K4 recompute gradients equal the plain layer's autograd.
  8. the stage-3 QLoRA train slice at full width (CLIP-L/14-336 x 32
     frames, Llama-3-8B int8 base + fp32 LoRA r=64, SAM2.1-hiera-small at
     1024^2 x 8 seg frames, 8 objects): three `make_train_step` steps
     over `synthetic_batches`, with the launch counts of K1..K6b taken
     over each step (the flash backward's by C entry: 2 on
     attention_short_bwd_sm90.cu, 32 + 32 on attention_bwd_sm90.cu, 0 on
     attention_bwd.cu), stage times, peak memory, a bit-identical frozen
     base and LoRA moving from step 2.
  9. train agreement on a small input: one tiny stage-3 QLoRA step on
     the card (kernels, bf16 activations) against the CPU (plain, fp32);
     then the training CLI on the card (tiny, 4 steps, a checkpoint at
     step 2, resume, the complete flag), its checkpoint-4 kept for
     phase 23.

The line before the last is the card's name and power limit, the one
before it the kernels' JSON, the last line is {"ok": true, "device":
{...}}. There is no CPU mode: without a CUDA device the script exits
non-zero. In the kernels JSON, `launches` is the count of the train
step (phase 8) for the kernels it runs, of the W4A8 batched call (phase
4) for K5, of the per-op Hiera trunk (phase 13) for K7, of the CLIP-L
W8A8 encode (phase 12) for K8 and gemm_s8 (its w8a8_sm90.cu launches)
and of the bf16 slice (phase 3) for gemm_bf16, layernorm and
maxpool2x2 (their sm90 entries' launches), of the Hiera-L video
propagation (phase 18) for K2_hd256 (K2 at head dim 256),
K4_hiera_large and K7_hiera_large (window_attention_sm90.cu at head dim
72), of Hiera-B+'s set_image (phase 19) for K7_hiera_base_plus (head
dim 56), of each family's W4A8 batched call (phases 24 / 25) for
K2_window / K2_alibi; `launches_by_path` holds every
path's counts (gemm_s8's by route, on the W8A8 encodes, the only paths
with `kernel_qa` denses; gemm_bf16's, layernorm's and maxpool2x2's by
route), phases 21-23's among them (K5's also by C entry over the W4A8
beam and sampled calls).

The vision slice, numbered apart: phase 10 runs after phase 2, 11-13
after phase 4, 14 after phase 5; the SAM2 image slice, 15-17, after 14;
the SAM2 video slice, 18-20, after 17; the serving entry point's
sampling, beams and checkpoints, 21-23, after 9; the Mistral and MPT
families, 24-25, after 23; the training data path, 26, after 8.

 10. K7 at every window kind of the per-op SAM2.1-hiera-small trunk over
     8 frames at 1024^2 on window_attention_sm90.cu (the route asserted)
     against `window_attention_plain`, two calls bit-identical, over 10
     launches back to back and by device time, beside
     window_attention.cu (forced by `route`), SDPA over the partitioned
     windows (partition copy timed apart), K4's old attention stage
     (partition + [a 2x2 pool of q] + attention_sm90.cu + unpartition
     + crop) and K4's call of the new kernel (the crop written directly,
     held to the stage), and their sums over a trunk's blocks;
     K8 (the W8A8 layer: `csrc/w8a8_sm90.cu`, `csrc/w8a8.cu`'s row
     kernels, attention_sm90.cu) at the CLIP-L and RADIO-H serving shapes
     against `vit_layer_plain` over the same quantized tree; gemm_s8
     (w8a8_sm90.cu) at each tower's six dense shapes with their
     epilogues, at fc1 in int32 mode and at the projector's second dense,
     bit-equal to w8a8.cu and to `gemm_s8_plain` (k_proj also to
     nn.dense's epilogue), timed (10 launches back to back per timing)
     beside w8a8.cu and, in int32 mode, `torch._int_mm`, with its bound
     and its launches per W8A8 encode. Then the attention link of K1's /
     K8's chain (head dims 64 and 80) and the trunk's global block (head
     dim 96) on attention_sm90.cu (the route asserted), timed apart
     beside attention.cu's online form and SDPA, with their bounds and
     their share of the layer. Then gemm_bf16 (`kernels.gemm`, every
     dense of K1 and K4) at each distinct main-path shape and epilogue
     (`dense_cases`: CLIP-L and RADIO-H over 32 frames, each block kind
     of the Hiera trunk over 8 frames at 1024^2) on gemm_bf16_sm90.cu
     (the route asserted), it and gemm_bf16.cu (forced by `route`) held
     against `gemm_plain`, timed (10 launches back to back) beside
     gemm_bf16.cu and `torch.addmm(bias, a, b)`, with each call's bound.
     Then the row streams (`link_cases`: K1's and K4's LayerNorms on
     layernorm_sm90.cu, K4's shortcut pools on pool_sm90.cu, the routes
     asserted) at every main-path shape and at ragged ones
     (LINK_RAGGED): the LayerNorm within one bf16 step of its plain twin
     element by element (`ln_bound`), layernorm.cu within 2e-2, both
     pools bit-equal to theirs, two calls bit-identical; `[links]` rows
     with the time over 10 launches back to back and by device time
     over input copies rotated past the L2 (`rotated_device_ms`), beside
     the old kernel, `F.layer_norm` / `F.max_pool2d` and the byte bound;
     then K8's row quantizers (`ln_quant_rows`, `quant_rows`) at
     CLIP-L's and RADIO-H's shapes (`w8a8_row_cases`) and at ragged ones
     (QUANT_ROWS_RAGGED) on w8a8_rows_sm90.cu (the route asserted):
     `quant_rows` bit-equal to `quantize_activations_rowwise` (q and
     scale), `ln_quant_rows` within one int8 step of its twin with under
     1e-3 of the elements differing and the scales within rtol 1e-2, two
     calls bit-identical; timed the same way beside w8a8.cu (forced by
     `route`), with the byte bound, the instruction bound of the
     instance's SASS and the launches per W8A8 encode.
 11. RADIO serving: the bf16 path of phase 3 with the RADIO-H/16@384
     tower (K1 32 per query, K8 0), stage seconds.
 12. W8A8 encode: `llava.encode_video` over `quantize_tree(bits=8,
     act_quant=True)` of tower + projector, CLIP-L and RADIO-H (K8 23 and
     32, K1 0; gemm_s8 on w8a8_sm90.cu 6 x 23 + 2 and 6 x 32 + 2, on
     w8a8.cu 0; the row quantizers on w8a8_rows_sm90.cu 4 x 23 and 4 x
     32, 2 ln_quant_rows + 2 quant_rows a layer, on w8a8.cu 0), relative error of the slow features against the bf16
     tower's (mean, p99); W8A8 and bf16 encode seconds, interleaved over
     7 rounds (median, min, max).
 13. the per-op Hiera trunk (`USE_FUSED_BLOCK = False`) over 8 frames at
     1024^2: K7 13 (all on window_attention_sm90.cu), K2 3, K4 0; its
     pyramid against the K4 path's; the two trunks' seconds, interleaved
     over 7 rounds (median, min, max). Then SAM2.1-hiera-large's per-op
     trunk over one frame: K7 45 (all on window_attention_sm90.cu at head
     dim 72), K2 3 (head dim 72 padded to 80), K4 0, its pyramid against
     the K4 path's.
 14. tiny card-vs-CPU agreement of a RADIO tower (head dim 80), S2, a
     W8A8 tower and the per-op trunk.
 15. the SAM2 image predictor at full width: `build_sam2_image_predictor(
     "tiny", seed=)` (SAM2.1-hiera-tiny, random bf16 weights) on a 1080 x
     1920 frame: `set_image` (launches by C entry over one call: K4 12,
     gemm_bf16_sm90.cu 51, window_attention_sm90.cu 9, attention_sm90.cu
     3, layernorm_sm90.cu 24, pool_sm90.cu 3, the old entries 0; derived
     from the tiny config by the trunk helpers), two calls bit-identical;
     `predict` with a box (K3 2, all on attention_short_sm90.cu; two calls
     bit-identical), with 3 points, with box + points + the previous
     low-res logits as the mask input (one mask); output shapes, finite
     logits clipped to +-32; warm `set_image` and `predict` medians and
     their device busy time (torch.profiler) beside the card's name and
     power limit; `set_image_batch` of two frames and `predict_batch`;
     a predictor with max_hole_area = max_sprinkle_area = 64
     (`fill_holes_and_sprinkles` on the card), and connected components
     on the card equal to the CPU's.
 16. the automatic mask generator over a 1024^2 frame through that
     predictor: the defaults (32 x 32 points, batches of 64), IoU and
     stability thresholds 0 (the masks reach NMS and RLE;
     AMG_ZERO_POINTS_PER_SIDE points a side), and one crop layer with
     min_mask_region_area 25 (AMG_CROP_POINTS_PER_SIDE points a side);
     seconds per image split into set_image, decode, the masks'
     transfer to the host and the host's filters; K4 12 a crop and K3 2 a
     point batch by C entry; well-formed records.
 17. tiny card-vs-CPU agreement of sam2-test-tiny through set_image +
     predict and generate.
 18. the SAM2 video predictor at full width, SAM2.1-hiera-large, then
     SAM2.1-hiera-tiny, at 1024^2 (`build_sam2_video_predictor(variant,
     seed=)`, random bf16 weights, the object-score bias raised by
     OBJ_SCORE_BIAS): 16 uint8 frames of 480 x 854, one point on frame 0,
     `propagate_in_video` (the JAX bench's config 2). The first run
     counts launches by name and C entry, each step from 0: init_state
     (K4 once a block), the prompt (K3 2, K2 0: no memory yet), the
     first yield (the trunks of the 15 frames not encoded yet, 2 chunks
     of <= 8), each tracked frame (K2 8 = 2 x 4 memory-attention layers,
     all on attention_sm90.cu at head dim 256, K3 2, K4 0, attention.cu
     0); Hiera-L's trunk takes window_attention_sm90.cu for its 45
     windowed blocks (head dim 72), window_attention.cu for none, and
     attention_sm90.cu for its 3 global ones (padded to 80). Masks stay
     on the card, finite, [1, 1, 480, 854].
     A warm run (best of 2) gives frames/s by the host clock (synchronised
     after the last frame) and torch.profiler the device busy time.
 19. K2 at head dim 256 (attention_sm90.cu) at memory attention's self
     shape (4096 queries and keys) and a full bank's cross shape (7 x
     4096 + 64 keys) against `flash_forward_plain`, timed beside it and
     SDPA (also by device time), with the bound; K4 at each block kind of
     Hiera-L (the padded global block among them) against
     `hiera_block_plain`. Then K7 at every window kind of Hiera-L (head
     dim 72: ws 8, 4, 16, plain and pooled) and Hiera-B+ (56: ws 8, 4,
     14, 7, pooled 8 / 4 / 14) over 8 frames at 1024^2 on
     window_attention_sm90.cu (`k7_kind_check`, as phase 10's `[k7]`
     lines: the route asserted, against `window_attention_plain`, beside
     window_attention.cu, SDPA over partitioned windows and the partition
     copy, by device time too), their sums over a trunk, and a map whose
     head 1 holds inf and NaN (the other heads bit-equal to the clean
     map's); then Hiera-B+'s image predictor `set_image` counted by C
     entry (K4 24, window_attention_sm90.cu 21, window_attention.cu 0).
 20. tiny card-vs-CPU agreement of sam2-test-tiny's video predictor over
     6 frames with two objects: the logits without hole filling, the
     signs with it.
 21. beam search at full width on phase 3's bf16 tree, then on phase 4's
     W4A8 + int8-KV tree: `llama.beam_generate(num_beams=1)` token-exact
     with `greedy_generate`; the referral query with num_beams 4 through
     `get_model_output_frames` (launches counted over that call: K2 = the
     batch-1 prefill's 32, K5 by C entry 129 x decode steps + 1 on
     w4a8_gemv_sm90.cu, 128 on w4a8_sm90.cu, 0 on w4a8.cu), its mask
     logits from the winning beam's hidden states, its text reproduced
     by `beam_generate` on the same embeddings; the winner's and
     greedy's length-penalised scores, each from its decode's own
     log-probs and rescored by one prefill (within BEAM_RESCORE_BOUND);
     a decode step's host time beside greedy's, the device time of a
     decode step at 4 rows and at 1 (torch.profiler) and of the cache
     reorder a step (a CUDA graph).
 22. sampling at full width: phase 4's W4A8 batched call (caption +
     referral, left pad) at temperature 0.2, top_p 0.9 through
     `get_model_output_batched` (K5 by C entry), the same seed again
     through `llava.generate` (the same tokens), top_p 1e-9 (the greedy
     tokens), greedy; a decode step's host time beside greedy's.
 23. train -> serve -> score: phase 9's checkpoint-4 through
     `run_inference` on the card (--load_4bit --num_beams 2) over a
     synthetic ViCaS directory written here (.npy clip and frames, read
     by `ArrayFetcher`: the machine has no OpenCV or PIL), the JSON equal
     to serving the same tree merged in memory (`prepare_params`);
     `inference.eval` scores it, a tiny seg-head tree's referral and the
     ground truth itself (1.0); phase 8's full-width QLoRA tree (int8
     base, adapters attached) served from memory on one caption query
     (K1 23, K2 32, nothing else).
 24. Mistral-7B at full width (`LlamaConfig.mistral_7b()`: 32 layers, GQA
     32 / 8, sliding window 4096; the mistral_instruct template; CLIP-L
     over 32 frames, SAM2.1-hiera-small at 1024^2 x 8): K2 with the window
     (attention_sm90.cu) at the caption prefill [1, 32, S, 128] and the
     left-padded batch-2 prefill against `attention_reference(window=)` in
     fp32 (`K2_window` lines; timed over 10 launches back to back and by
     device time beside the twin, K2 without the window on the same inputs
     and SDPA with the boolean band mask; the bound
     4 D heads sum_i min(i + 1, 4096) operations), the prompt asserted to
     exceed the window by >= 1000 rows, windows 1, 100 and past the prompt
     checked; then the W4A8 + int8-KV + fused batched call (caption +
     referral) and the bf16 batch-1 caption, each counted: K2 32 a
     prefill, all on attention_sm90.cu, 0 on attention.cu; K5 by C entry
     (4 x 32 on w4a8_sm90.cu, 129 x decode steps + 1 on
     w4a8_gemv_sm90.cu, 0 on w4a8.cu); K1 / K3 / K4 as phases 3 / 4; the
     bf16 tree's decode step's device time (torch.profiler).
 25. MPT-7B the same way (`mpt_7b()`: MHA, ALiBi, LayerNorm, erf-GELU MLP,
     tied head; the mpt template): K2 with ALiBi as the per-head key bias
     against `attention_reference(alibi=True)` (slope_h * (j - i)), SDPA
     with the bf16 float mask as its library column (`K2_alibi` lines); K5
     128 a step (no head: it is tied) and 4 x 32 on w4a8_sm90.cu; the tied
     head's bf16 product timed. Then both families' tiny decoders (head
     dim 128) on the card vs the CPU: prefill logits within AGREE_BOUND,
     greedy tokens equal up to the first step whose CPU top-two margin is
     below TINY_FAMILY_MARGIN x the prefill logits' largest difference, at
     batch 1 and a left-padded batch 2.
 26. the training data path at full width: a ViCaS fixture written here
     (two videos of 48 frames at 480 x 854 and 8 ground-truth frames as
     .npy, COCO-RLE masks of two tracks, a caption, a reworded caption
     and two referrals each) and a Llama-3-format tokenizer.json written
     without `tokenizers` (the 256 byte symbols, 400 merges learned here,
     254 specials at 128000, so <sf_vid_separator> / <vid_seg> get 128254
     / 128255, inside the embedding); `initialize_vision_tokenizer`; the
     port's ViCaSDataset (.npy readers), collator, length-grouped sampler
     and CUDA-stream prefetcher feed four stage-3 QLoRA steps on phase
     8's trained tree with a new optimizer (a referral, two captions, a
     warm referral): launches by kernel and C entry as phase 8 at the
     bucketed length, the prefetched tensors equal to the host batch,
     `num_text_tokens` equal to the host labels' count, finite losses,
     LoRA b unchanged after step 1 and moving after, the int8 base
     bit-identical; each step's seconds beside the prefetcher's wait and
     the seg head's share. Then the tiny training CLI with `--dataset
     vicas --tokenizer <dir>` on the card from the same fixture, its
     checkpoint (given the tokenizer's files) served by `run_inference`
     with the tokenizer `load_model` reads from it, a caption decoded for
     each video. (Phase 23 serves phase 8's tree after these steps.)
 27. tensor-parallel serving at tp = 2 (`parallel/`): K2 and K5 at one
     rank's shard shapes against their plain versions (`K2_tp2`,
     `K5_tp2` lines: Llama-3-8B's 16 / 4 heads, MPT-7B's 16 / 16 with
     rank 1's ALiBi slopes; every K5 product of a rank at the prefill
     rows and one decode row, the row-parallel wo / w_down with unit
     scales and fp32 output, exact); then Llama-3-8B in bf16 and W4A8
     and MPT-7B in W4A8 (32 layers, full width; CLIP-L and the seg head
     whole on each rank) served on the phase-23 fixture by this process
     and by two ranks sharing the card (gloo, spawned here) through
     `run_inference --model_parallel 2` (TP_MAX_NEW tokens): W4A8
     prefill logits and every greedy token bit-equal to the one
     process's; bf16 prefill logits within TP_BF16_LOGIT_ATOL and the
     tokens equal up to a near tie (TP_MARGIN), with a control (layer
     0's sums left out) that must exceed the limit; rank 0 alone writing
     the JSON; each rank's launches by C entry printed and asserted (K2
     all on attention_sm90.cu, K5 on w4a8_sm90.cu / w4a8_gemv_sm90.cu);
     each rank's seconds split into its collectives and the rest.
 28. a one-rank NCCL group runs phase 26's first two steps through the
     --fsdp code from the same trainable leaves and device batches:
     losses, grad norms and parameters bit-equal.
 29. --fsdp on the two ranks of phase 27 (FSDP_LAYERS layers, full
     width): the stage-3 QLoRA state sharded, a row of the global batch
     each: steps 1-2 through the trainer's loop, step 3 in memory, then a
     fresh state resumed from rank 0's gathered checkpoint-2 to step 3,
     bitwise. Against this process's FSDP_STEPS steps over both rows:
     the loss and grad norm of every step within FSDP_LOSS_RTOL /
     FSDP_GRAD_NORM_RTOL, and the trainable leaves after the two
     nonzero-lr updates within FSDP_UPDATE_RTOL of the update and 3 x lr
     an update of each other; the control (one process on row 0 alone)
     must fail them. Each rank's peak memory is printed. Two ranks
     sharing one card measure no multi-GPU speed.
 30. tensor-parallel training at tp = 2: K2 with the logsumexp and K6a /
     K6b at one rank's shard of the train step (16 query / 4 KV heads,
     causal) against their plain versions, timed beside SDPA's forward /
     backward (`K2_tp2_lse`, `K6a_tp2` / `K6b_tp2` lines); then the
     stage-3 QLoRA state of phase 29 (FSDP_LAYERS layers, full width)
     split over the 'model' group of the two ranks of phase 27
     (`--model_parallel 2`: each rank its query / KV heads, MLP and
     vocabulary columns and their LoRA factors; tower, projector and seg
     head whole), both ranks on the one row of the global batch: steps
     1-2 through the trainer's loop, step 3 in memory, then a fresh state
     resumed from rank 0's gathered checkpoint-2 to step 3, bitwise.
     Against this process's steps on that row (phase 29's control run):
     loss and grad norm within TP_TRAIN_LOSS_RTOL / TP_TRAIN_GRAD_NORM_RTOL
     (bf16 TP rounds otherwise than one process: see the constants), the
     trainable leaves within FSDP_UPDATE_RTOL of the update, the int8
     base bit-identical; a control on the ranks that leaves out the
     'model' sum of the LoRA partial gradients must fail them. Each
     rank's launches by C entry (K2 on attention_sm90.cu, K6a / K6b at
     head dim 128 on attention_bwd_sm90.cu, none on attention.cu /
     attention_bwd.cu), its peak memory and its seconds split into
     collectives and the rest. (The 2 x 2 --fsdp mesh runs in the CPU
     tests only: four ranks would share the one card.)

 31. ring-attention context parallelism (`parallel/ring_attention.py`):
     K2 non-causal with the logsumexp and K6a / K6b non-causal from the
     merged O and lse of two blocks at one rank's block (Llama-3-8B's 32
     / 8 heads over the one-clip prefill's rows; `K2_cp2`, `K6a_cp2` /
     `K6b_cp2` lines, timed beside SDPA's forward / backward), and the
     merge of the diagonal and an earlier block against one pass over
     both; then two ranks sharing the card (gloo) run `cp_forward` of
     Llama-3-8B bf16 (32 layers, full width, seeded) over CP x that many
     tokens: hidden and logits against this tree's one-process
     `llama.forward` on rank 0 within RING_HIDDEN_RTOL / RING_LOGIT_ATOL,
     the argmax equal on rows of a wide one-process margin, a control
     (the merge without its rescale) beyond the limits; then at
     RING_BWD_LAYERS layers the token cross-entropy's gradient of every
     leaf (`reduce_grads`) against the one process's, both summing
     controls beyond RING_GRAD_RTOL. Launches by C entry per rank: K2 32
     x (rank + 1) forward, K6a = K6b = 4 x (rank + 1) backward, all on
     attention_sm90.cu / attention_bwd_sm90.cu; each rank's seconds split
     into collectives (the ring's shifts, the gather, the gradient sums)
     and the rest.

    python3 chip_smoke.py --parallel_only    # the build, phases 27 / 29 / 30
    python3 chip_smoke.py --ring_only        # the build, phase 31
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import zlib
from typing import Optional

import numpy as np
import torch

REPLACES = {
    "K1": "video_llava_seg_tpu/ops/vit_block.py:61",
    "K2": "video_llava_seg_tpu/ops/attention.py:145",
    "K3": "video_llava_seg_tpu/ops/attention.py:215",
    "K4": "video_llava_seg_tpu/ops/hiera_block.py:111",
    "K5": "video_llava_seg_tpu/ops/int4.py:67",
    "K6a": "video_llava_seg_tpu/ops/attention.py:475",
    "K6b": "video_llava_seg_tpu/ops/attention.py:522",
    "K7": "video_llava_seg_tpu/ops/window_attention.py:32",
    "K8": "video_llava_seg_tpu/ops/vit_block.py:216",
    # K8's per-row activation quantization (`_quant_rows_f32`, after
    # `_ln_f32` for the two LayerNorms: vit_block.py:240-243, 300-301, 322)
    "quant_rows": "video_llava_seg_tpu/ops/vit_block.py:197",
    # K8's int8 dense (`_dense_i8`), which gemm_s8 also serves outside the
    # layer for XLA's int8 dot of nn.dense (video_llava_seg_tpu/ops/nn.py:77)
    "gemm_s8": "video_llava_seg_tpu/ops/vit_block.py:206",
    # the dense products inside K1 (`_vit_kernel`, vit_block.py:90-182)
    # and K4 (`_block_kernel` / `_mlp_tail`, hiera_block.py:111 / :87)
    "gemm_bf16": "video_llava_seg_tpu/ops/vit_block.py:90",
    # the LayerNorm stages of K1 (`_vit_kernel`; nn.layer_norm in its XLA
    # twin, vit_block.py:501 / :516) and K4 (`_ln_f32`, hiera_block.py:80)
    "layernorm": "video_llava_seg_tpu/ops/hiera_block.py:80",
    # the shortcut max-pool inside K4's `_block_kernel`
    "maxpool2x2": "video_llava_seg_tpu/ops/hiera_block.py:111",
}
SOURCES = {
    # the attention link (head dims 64 / 80) on attention_sm90.cu
    # the six denses on gemm_bf16_sm90.cu (gemm_bf16.cu kept for the calls
    # gemm_bf16_entry refuses)
    # the two LayerNorms on layernorm_sm90.cu (layernorm.cu kept for the
    # widths layernorm_entry refuses)
    "K1": ("video_llava_seg_torch/ops/vit_block.py",
           ["layernorm_sm90.cu", "layernorm.cu", "gemm_bf16_sm90.cu",
            "gemm_bf16.cu", "attention_sm90.cu"]),
    # head dim 128 (the LLM), the per-op Hiera trunk's global blocks
    # (head dim 96) and SAM2's memory attention (head dim 256) on
    # attention_sm90.cu; attention.cu keeps head dims 16 / 32, a bias
    # below 128 and fewer than FLASH_SM90_MIN_KEYS keys
    "K2": ("video_llava_seg_torch/csrc/attention_sm90.cu",
           ["attention_sm90.cu", "attention.cu"]),
    # head dim 16 over <= 64 keys (the mask decoder) on
    # attention_short_sm90.cu; the two-pass form elsewhere on attention.cu
    "K3": ("video_llava_seg_torch/csrc/attention_short_sm90.cu",
           ["attention_short_sm90.cu", "attention.cu"]),
    # every block's attention (head dim 96, 16-4096 keys) on
    # attention_sm90.cu
    # every windowed block's attention on window_attention_sm90.cu, the
    # global blocks' on attention_sm90.cu
    # norm1 / norm2 on layernorm_sm90.cu, the shortcut pool on
    # pool_sm90.cu (layernorm.cu / pool.cu kept for the shapes their
    # routes refuse)
    "K4": ("video_llava_seg_torch/ops/hiera_block.py",
           ["layernorm_sm90.cu", "layernorm.cu", "gemm_bf16_sm90.cu",
            "gemm_bf16.cu", "window_attention_sm90.cu", "attention_sm90.cu",
            "pool_sm90.cu", "pool.cu"]),
    # <= 8 rows at TMA-aligned widths (every decode product and the
    # lm_head: most launches) on w4a8_gemv_sm90.cu, more (the LLM prefill)
    # on w4a8_sm90.cu; other widths on w4a8.cu
    "K5": ("video_llava_seg_torch/csrc/w4a8_gemv_sm90.cu",
           ["w4a8_gemv_sm90.cu", "w4a8_sm90.cu", "w4a8.cu"]),
    # head dim 128 (the LLM) on attention_bwd_sm90.cu; the mask decoder
    # (head dim 16 over <= 64 keys) on attention_short_bwd_sm90.cu, K6a and
    # K6b in one pass; attention_bwd.cu keeps the other head dims
    "K6a": ("video_llava_seg_torch/csrc/attention_bwd_sm90.cu",
            ["attention_bwd_sm90.cu", "attention_short_bwd_sm90.cu",
             "attention_bwd.cu"]),
    "K6b": ("video_llava_seg_torch/csrc/attention_bwd_sm90.cu",
            ["attention_bwd_sm90.cu", "attention_short_bwd_sm90.cu",
             "attention_bwd.cu"]),
    # head dims 96 / 56 / 72 (every windowed block of Hiera-T / S / B+ /
    # L) on window_attention_sm90.cu; other head dims on window_attention.cu
    "K7": ("video_llava_seg_torch/csrc/window_attention_sm90.cu",
           ["window_attention_sm90.cu", "window_attention.cu"]),
    # gemm_s8 on w8a8_sm90.cu where K and N are multiples of 16 (every
    # dense of both towers), on w8a8.cu elsewhere
    # the row quantizers on w8a8_rows_sm90.cu (w8a8.cu kept for the
    # widths quant_rows_entry refuses)
    "K8": ("video_llava_seg_torch/ops/vit_block.py",
           ["w8a8_rows_sm90.cu", "w8a8_sm90.cu", "w8a8.cu",
            "attention_sm90.cu"]),
    "quant_rows": ("video_llava_seg_torch/csrc/w8a8_rows_sm90.cu",
                   ["w8a8_rows_sm90.cu", "w8a8.cu"]),
    "gemm_s8": ("video_llava_seg_torch/csrc/w8a8_sm90.cu",
                ["w8a8_sm90.cu", "w8a8.cu"]),
    "gemm_bf16": ("video_llava_seg_torch/csrc/gemm_bf16_sm90.cu",
                  ["gemm_bf16_sm90.cu", "gemm_bf16.cu"]),
    "layernorm": ("video_llava_seg_torch/csrc/layernorm_sm90.cu",
                  ["layernorm_sm90.cu", "layernorm.cu"]),
    "maxpool2x2": ("video_llava_seg_torch/csrc/pool_sm90.cu",
                   ["pool_sm90.cu", "pool.cu"]),
}
# H100 SXM published dense peaks (NVIDIA data sheet, 700 W): the bound of
# a call is max(bytes / HBM rate, operations / peak of their type)
HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
# max |kernel - plain| / max |plain|, plain in fp32 on the same bf16
# inputs. bf16 has an 8-bit mantissa (2^-8 = 3.9e-3 relative per
# rounding); the kernels round q/k/v/P and each layer's intermediates to
# bf16 where the fp32 plain path does not, so a few roundings stack up.
# Measured on an H100 (700 W) at these shapes: K1 4.9e-3, K2 2.5e-3,
# K3 2.8e-3, K4 6.8e-3 (worst block kind). The bounds keep ~3-4x of
# headroom over that for other seeds; K1/K4 chain 7-9 launches with bf16
# hand-offs, hence their wider bound.
# K5 (integer sums, a fixed two-multiply epilogue) must be bit-equal: None
# K6a / K6b take the kernel forward's bf16 output and its fp32 logsumexp,
# as the plain backward does, and round dS (and P for dV) to bf16 before
# their products where the fp32 plain version does not; their sums run
# over up to 5.1k keys (dQ) or 4 heads x 5.1k queries (dK, dV). Measured
# on an H100 (700 W) at the three shapes of phase 6: K6a 3.4e-3..5.6e-3,
# K6b 2.4e-3..3.0e-3; the bound keeps ~3.5x of headroom.
# K7 is one attention per window, as K3 (plain softmax, bf16 P): the
# same bound as K2 / K3. K8 is held against `vit_layer_plain` over the
# same quantized tree in bf16 (the int8 semantics depend on the
# activations' type); the two round the attention and the activation at
# other places, and a bf16 last-bit difference at an int8 rounding
# boundary moves one row by one quantization step (row amax / 127).
# Measured on an H100 (700 W): K7 3.8e-3..5.0e-3 over the seven window
# kinds, K8 1.0e-2 (CLIP-L) and 9.2e-3 (RADIO-H); ~2-3x of headroom.
# gemm_bf16 (one dense) against `gemm_plain`, which rounds the same fp32
# result to bf16 once: the two differ by the sums' order (K up to 5,120
# fp32 terms) and so by at most about one bf16 step (2^-8 = 3.9e-3 of an
# element) where they round apart; the bound keeps ~2.5x over one step.
BOUNDS = {"K1": 2e-2, "K2": 1e-2, "K3": 1e-2, "K4": 2e-2, "K5": None,
          "K6a": 2e-2, "K6b": 2e-2, "K7": 1e-2, "K8": 3e-2,
          # integer sums, the epilogue's steps in a fixed order
          "gemm_s8": None, "gemm_bf16": 1e-2,
          # layernorm_sm90.cu is first held element by element (`ln_bound`:
          # one bf16 step); relative to the largest element a step is at
          # most 2^-7. A max rounds nothing: the pool is exact
          "layernorm": 2 ** -7, "maxpool2x2": None,
          # K2 at head dim 256 (memory attention) is K2: one softmax over
          # up to 28,736 keys, P rounded to bf16; K4 at Hiera-L is K4's
          # chain at head dim 72 (its global block padded to 80)
          "K2_hd256": 1e-2, "K4_hiera_large": 2e-2,
          # K7 at Hiera-L's head dim 72 and Hiera-B+'s 56: K7
          "K7_hiera_large": 1e-2, "K7_hiera_base_plus": 1e-2,
          # K2 with Mistral's window (fewer keys a row) and with MPT's
          # ALiBi (the same products, the scores in natural units): K2
          "K2_window": 1e-2, "K2_alibi": 1e-2,
          # K2 and K5 at one tensor-parallel rank's shard shapes: K2, K5
          "K2_tp2": 1e-2, "K5_tp2": None,
          # K2 with the logsumexp and K6a / K6b at a rank's shard of the
          # train step: K2, K6a, K6b
          "K2_tp2_lse": 1e-2, "K6a_tp2": 2e-2, "K6b_tp2": 2e-2,
          # the ring's forms at a rank's block (phase 31): K2 non-causal
          # with the logsumexp; K6a / K6b non-causal from the merged O and
          # lse of two blocks: K2, K6a, K6b
          "K2_cp2": 1e-2, "K6a_cp2": 2e-2, "K6b_cp2": 2e-2}
# |kernel lse - plain lse| (natural-log units), plain in fp32 on the same
# bf16 inputs: both sum exp() in fp32 over the same scores, the kernel
# with __expf and another order. Measured on an H100 (700 W): 1.9e-6 at
# the LLM shape (lse ~ 9), 9.5e-7 at the other two; ~5x of headroom.
LSE_BOUND = 1e-5
# K1 / K4 backward: the recompute Function's gradients vs autograd of the
# plain layer on the same inputs (the same ops; bit-equal on an H100 at
# 700 W in the first run)
GRAD_RECOMPUTE_BOUND = 1e-5


def log(msg: str):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5, warmup: int = 1, flush=None,
            train: int = 1) -> float:
    """Median of `reps` CUDA-event timings after `warmup` calls. flush:
    run before each timed call, outside the timed region (to start from
    a cold L2 where the real caller would). train: calls back to back
    between the two events, the time divided by their number, so that
    the host's cost of a launch (Python wrapper, tensor-map encoding)
    hides under the previous call's device time as on the main path;
    with train 1 (the default) the first launch's host cost is timed."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(train):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / train)
    return statistics.median(times)


def graph_ms(fn, n: int = 10, reps: int = 5) -> float:
    """Device time of one call: n calls captured back to back in a CUDA
    graph, its replay timed by CUDA events (median of `reps`), over n.
    The replay launches without the host's per-call cost (Python, the
    wrappers' checks, tensor-map encoding), which `cuda_ms` includes where
    it exceeds the device time."""
    return graph_seq_ms([fn] * n, reps)


def graph_seq_ms(fns, reps: int = 5) -> float:
    """Device time of the calls `fns`, captured once each in order in a
    CUDA graph, its replay timed by CUDA events (median of `reps`), over
    their number. Each runs once eagerly first (on a side stream, as
    capture wants)."""
    n = len(fns)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def f32(tree):
    from video_llava_seg_torch.bridge import tree_map
    return tree_map(lambda t: t.float(), tree)


def perturb(tree, g, scale=0.05):
    """Give the zero biases and unit norm scales of an init some spread
    (in place), so every epilogue term is exercised."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not torch.is_tensor(v):
                perturb(v, g, scale)
            elif k in ("bias", "scale"):
                v.add_((scale * torch.randn(v.shape, generator=g,
                                            device=v.device)).to(v.dtype))
    elif isinstance(tree, list):
        for v in tree:
            perturb(v, g, scale)
    return tree


class SmokeTokenizer:
    """Deterministic stand-in for the Llama-3 tokenizer (the card's
    machine has no `transformers`): the template's special tokens map to
    fixed ids at the top of the vocabulary; every word, number or
    punctuation mark is one id (crc32-hashed), about the granularity of
    Llama-3's BPE on English prompts."""

    SPECIALS = ("<|begin_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>", "<vid_seg>")
    _PIECE = re.compile(r"\s*(\w+|[^\w\s])")

    def __init__(self, vocab_size: int):
        self.ids = {s: vocab_size - len(self.SPECIALS) + i
                    for i, s in enumerate(self.SPECIALS)}
        self.bos_token_id = self.ids["<|begin_of_text|>"]
        self.span = vocab_size - len(self.SPECIALS) - 8
        self._split = re.compile(
            "(" + "|".join(re.escape(s) for s in self.SPECIALS) + ")")

    def __call__(self, text: str):
        out = [self.bos_token_id]
        for part in self._split.split(text):
            if part in self.ids:
                out.append(self.ids[part])
            else:
                out.extend(8 + zlib.crc32(w.encode()) % self.span
                           for w in self._PIECE.findall(part))
        return types.SimpleNamespace(input_ids=out)

    def convert_tokens_to_ids(self, tok):
        return self.ids.get(tok, -1)

    def decode(self, ids, skip_special_tokens=True):
        inv = {v: k for k, v in self.ids.items()}
        return " ".join(("" if skip_special_tokens else inv[int(i)])
                        if int(i) in inv else f"t{int(i)}" for i in ids)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (there is no CPU mode)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # as the training CLI: deterministic convolution backward, so that a
    # step repeats bit for bit (phases 28 / 29)
    torch.backends.cudnn.deterministic = True
    log(f"[env] card: {smi}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices "
        f"{torch.cuda.device_count()}")
    log(f"[env] nvcc: {nvcc_v.splitlines()[-1]}")
    sync()
    return smi


def phase_build():
    from video_llava_seg_torch import kernels

    t0 = time.perf_counter()
    kernels.LIBRARY.get()
    log(f"[build] {kernels.LIBRARY.path.name} from "
        f"{len(list(kernels.CSRC.glob('*.cu')))} sources: nvcc "
        f"{kernels.LIBRARY.build_seconds:.1f} s, load "
        f"{time.perf_counter() - t0:.1f} s")
    for line in kernels.LIBRARY.build_log.splitlines():
        if "spill" in line and "0 bytes spill stores" not in line:
            log(f"[build] ptxas: {line.strip()}")
    report_sm90_build(kernels)
    sync()


# the TMA + wgmma sources and the kernels in each whose SASS must hold
# wgmma (HGMMA for bf16, IGMMA for int8) and TMA loads (UTMALDG)
SM90_KERNELS = {"attention_sm90.cu": ("flash_fwd_sm90",),
                "attention_short_sm90.cu": ("attention_short_sm90_kernel",),
                "attention_bwd_sm90.cu": ("flash_bwd_dq_sm90",
                                          "flash_bwd_dkv_sm90"),
                "attention_short_bwd_sm90.cu": (
                    "attention_short_bwd_sm90_kernel",),
                "w4a8_sm90.cu": ("w4a8_sm90_kernel",),
                "w4a8_gemv_sm90.cu": ("w4a8_gemv_sm90_kernel",),
                "w8a8_sm90.cu": ("gemm_s8_sm90_kernel",),
                "gemm_bf16_sm90.cu": ("gemm_bf16_sm90_kernel",),
                "window_attention_sm90.cu": (
                    "window_attention_sm90_kernel",),
                "layernorm_sm90.cu": ("layernorm_sm90_kernel",),
                "pool_sm90.cu": ("maxpool2x2_sm90_kernel",),
                "w8a8_rows_sm90.cu": ("quant_rows_sm90_kernel",)}
# the instances of a templated kernel: attention_sm90.cu's <head dim,
# bias>: D 64 / 80 / 96 / 128 / 256, the bias at 128; gemm_bf16_sm90.cu's
# <activation>: none, quick_gelu, erf-GELU; attention_short_bwd_sm90.cu's
# <key tile, bias>: 8 / 16 / 32 / 64 keys, with and without a bias;
# window_attention_sm90.cu's <head dim, key tile, q pool>: head dims 56 /
# 72 / 96, 64 and 208 (256 at 72) without, 128 and 208 (256) with;
# w4a8_gemv_sm90.cu's <rows, fp32 out>: 1-8 rows, bf16 and
# fp32 out; layernorm_sm90.cu's <vectors a lane>: 1-5;
# w8a8_rows_sm90.cu's <vectors a lane, LayerNorm, fp32 gamma>: 1-5 with a
# LayerNorm (bf16 and fp32 gamma), 4, 5, 16, 20 without
SM90_INSTANCES = {"attention_sm90.cu": 6, "gemm_bf16_sm90.cu": 3,
                  "attention_short_bwd_sm90.cu": 8,
                  "window_attention_sm90.cu": 12, "w4a8_gemv_sm90.cu": 16,
                  "layernorm_sm90.cu": 5, "w8a8_rows_sm90.cu": 8}
# the sources with TMA loads but no wgmma, and the SASS op each must hold
# instead (w4a8_gemv_sm90.cu: __dp4a; the row streams, whose loads are 1-D
# bulk copies (UBLKCP) rather than tensor-map loads: the group shuffles of
# layernorm_sm90.cu and w8a8_rows_sm90.cu, the bf16x2 max of pool_sm90.cu)
SM90_NO_WGMMA = {"w4a8_gemv_sm90.cu": "IDP", "layernorm_sm90.cu": "SHFL",
                 "pool_sm90.cu": "HMNMX2", "w8a8_rows_sm90.cu": "SHFL"}
SM90_BULK_ONLY = ("layernorm_sm90.cu", "pool_sm90.cu", "w8a8_rows_sm90.cu")
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UBLKCP", "IDP", "SHFL", "HMNMX2")
# the ops counted besides in w8a8_rows_sm90.cu's instances, for its instruction
# bound: the division's reciprocal (MUFU) and range check (FCHK), the fp32
# arithmetic, the byte packs (PRMT), the int8 stores (STG)
ROW_SASS_OPS = ("MUFU", "FCHK", "FFMA", "FMUL", "FADD", "FMNMX", "PRMT",
                "F2FP", "LDS", "STG", "CALL")
# {instance: {op: count, "total": instructions}} of w8a8_rows_sm90.cu,
# filled by the build phase
ROW_SASS = {}


def row_sass_per_element(kern: str) -> float:
    """SASS instructions a lane spends on one element in the instance
    `kern` of w8a8_rows_sm90.cu (`quant_rows_sm90_kernel<NV, LN, GF32>`):
    the difference of the instruction counts of this instance and the
    nearest other of its kind (NV n; the smaller where there is one), over
    the 8 |NV - n| elements it adds (the unrolled loops grow by that much;
    the set-up, the producer and the per-row divisions stay the same)."""
    nv, kind = kern.split("<")[1].rstrip(">").split(", ", 1)
    nv = int(nv)
    others = [int(k.split("<")[1].split(",")[0]) for k in ROW_SASS
              if k.split(", ", 1)[1] == kind + ">" and k != kern]
    n = min(others, key=lambda o: (abs(o - nv), o > nv))
    other = ROW_SASS[f"quant_rows_sm90_kernel<{n}, {kind}>"]["total"]
    return (ROW_SASS[kern]["total"] - other) / (8 * (nv - n))


def _instance(base, mangled):
    """`base<args>` from a mangled kernel name: its integer and bool
    template arguments (`Li96E`, `Lb0E`), or `base` for a plain kernel."""
    args = [v if t == "i" else ("false", "true")[int(v)]
            for t, v in re.findall(r"L([ib])(\d+)E", mangled)]
    return f"{base}<{', '.join(args)}>" if args else base


def report_sm90_build(kernels):
    """The ptxas report (registers, spills, wgmma serialization warnings)
    of each TMA + wgmma source and of the row streams, and the counts of
    wgmma (HGMMA, IGMMA), TMA load (UTMALDG) and bulk copy (UBLKCP)
    instructions in the SASS of each of its kernels; fails if a kernel
    has no wgmma (or its SM90_NO_WGMMA op) or no TMA load (bulk copy for
    SM90_BULK_ONLY)."""
    log_text = kernels.LIBRARY.build_log
    for src in SM90_KERNELS:
        start = log_text.index(f"== {src}")
        end = log_text.find("\n== ", start + 1)
        for line in log_text[start:end if end >= 0 else None].splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill stores|"
                         r"wgmma", line):
                log(f"[build] {src} ptxas: {line.strip()}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(kernels.LIBRARY.path)],
                          capture_output=True, text=True,
                          check=True).stdout
    # one count per kernel instance: a template's instances are told apart
    # by their integer and bool arguments (attention_sm90.cu's <D, bias>)
    counts = {}
    kern = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            base = next((k for ks in SM90_KERNELS.values() for k in ks
                         if k in m.group(1)), None)
            kern = None if base is None else _instance(base, m.group(1))
            if kern is not None:
                counts.setdefault(kern, dict.fromkeys(SASS_OPS, 0))
        elif kern is not None:
            for op in SASS_OPS:
                counts[kern][op] += bool(re.search(rf"\b{op}\b", line))
            if kern.startswith("quant_rows_sm90_kernel"):
                row = ROW_SASS.setdefault(
                    kern, dict.fromkeys(ROW_SASS_OPS + ("total",), 0))
                row["total"] += bool(re.search(r"/\*[0-9a-f]{4,}\*/\s+\S",
                                               line))
                for op in ROW_SASS_OPS:
                    row[op] += bool(re.search(rf"\b{op}\b", line))
    for src, ks in SM90_KERNELS.items():
        found = [k for k in counts if k.split("<")[0] in ks]
        if len(found) < SM90_INSTANCES.get(src, len(ks)):
            raise AssertionError(f"{src}: {len(found)} kernel instances in "
                                 f"the SASS, expected "
                                 f"{SM90_INSTANCES.get(src, len(ks))}")
        for k in sorted(found):
            c = counts[k]
            log(f"[build] {src} SASS {k}: "
                + ", ".join(f"{c[op]} {op}" for op in SASS_OPS if c[op]))
            need = SM90_NO_WGMMA.get(src)
            compute = c[need] if need else c["HGMMA"] + c["IGMMA"]
            load = "UBLKCP" if src in SM90_BULK_ONLY else "UTMALDG"
            if not compute or not c[load]:
                raise AssertionError(f"{src}: no {need or 'wgmma'} or no "
                                     f"{load} in the SASS of {k}: {c}")
    for k, c in sorted(ROW_SASS.items()):
        log(f"[build] w8a8_rows_sm90.cu SASS {k}: {c['total']} "
            f"instructions ({row_sass_per_element(k):.2f} a lane-element), "
            + ", ".join(f"{c[op]} {op}" for op in ROW_SASS_OPS))


def bound_of(nbytes: float, ops: float, peak: float):
    """(bound ms, 'bytes' | 'operations') for one call."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _check(name, tag, run_kernel, run_plain, run_reference, results, work,
           run_library=None, flush=None, time_kernel=None,
           run_previous=None, previous="attention.cu", train=1,
           device_time=False):
    """Hold one kernel call against its plain version and time it.

    run_reference: the plain version in fp32 (checked against BOUNDS) or,
    for a kernel held to exact equality (BOUNDS None), the plain version
    itself. work: (bytes, operations, peak rate) of the call.
    time_kernel: the call to time when run_kernel does more than launch
    (joins several outputs for the comparison). run_previous: the kernel
    this one replaced, timed beside it (`previous` names it: K2,
    attention.cu's online form; K3, its two-pass form; K6a / K6b,
    attention_bwd.cu; K5, w4a8.cu's mma.sync tile and GEMV; gemm_s8,
    w8a8.cu). train: launches per timing of kernel, library and previous
    kernel (`cuda_ms`). device_time: also their device times without the
    host's cost (`graph_ms`), for kernels whose device time is below it."""
    got = run_kernel()
    want = run_reference()
    sync()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-6)
    bound = BOUNDS[name]
    if bound is None:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{name} {tag}: not bit-equal to its plain "
                                 f"version (max abs err {err:.3e})")
    elif not math.isfinite(rel) or rel > bound:
        raise AssertionError(f"{name} {tag}: rel err {rel:.3e} > bound "
                             f"{bound:.0e}")
    del got, want
    ms = cuda_ms(time_kernel or run_kernel, flush=flush, train=train)
    plain_ms = cuda_ms(run_plain, reps=3, flush=flush)
    lib_ms = (cuda_ms(run_library, flush=flush, train=train)
              if run_library is not None else None)
    prev_ms = (cuda_ms(run_previous, flush=flush, train=train)
               if run_previous is not None else None)
    b_ms, b_by = bound_of(*work)
    dev_ms = {}
    if device_time:
        for key, fn in (("device_ms", time_kernel or run_kernel),
                        ("library_device_ms", run_library),
                        ("previous_device_ms", run_previous)):
            if fn is not None:
                dev_ms[key] = graph_ms(fn)
        log(f"[check] {name} {tag}: device time (CUDA graph, 10 launches) "
            + ", ".join(f"{k[:-3].replace('_', ' ')} {v:.4f} ms"
                        for k, v in dev_ms.items())
            + f" ({b_ms / dev_ms['device_ms']:.3f} of the bound)")
    log(f"[check] {name} {tag}: max_abs_err {err:.4e}, rel {rel:.3e} "
        f"({'exact' if bound is None else f'bound {bound:.0e}'}); kernel "
        f"{ms:.4f} ms ({work[1] / ms / 1e9:.1f} "
        f"{'TFLOP/s' if work[2] == PEAK_BF16 else 'TOP/s'}, "
        f"{b_ms / ms:.3f} of the bound), plain {plain_ms:.4f} ms, library "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{b_ms:.4f} ms ({b_by})"
        f"{'' if prev_ms is None else f', {previous} {prev_ms:.4f} ms'}")
    r = results.setdefault(name, {"max_abs_err": 0.0, "rel_err": 0.0,
                                  "ms": 0.0, "plain_ms": 0.0,
                                  "library_ms": 0.0, "bound_ms": 0.0,
                                  "bound_by_ms": {"bytes": 0.0,
                                                  "operations": 0.0},
                                  "shapes": []})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["rel_err"] = max(r["rel_err"], rel)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["library_ms"] = (None if lib_ms is None or r["library_ms"] is None
                       else r["library_ms"] + lib_ms)
    r["bound_ms"] += b_ms
    r["bound_by_ms"][b_by] += b_ms
    r["shapes"].append({"shape": tag, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "max_abs_err": err})
    if prev_ms is not None:
        r["shapes"][-1]["previous_ms"] = prev_ms
    r["shapes"][-1].update(dev_ms)
    torch.cuda.empty_cache()


def attention_cu(q, k, v, *, two_pass=False, causal=False, kv_mask=None,
                 with_lse=False):
    """attention.cu, forced by `route`: its online form ran K2 at head dim
    128 before attention_sm90.cu took the LLM's calls, its two-pass form
    K3 before attention_short_sm90.cu took the mask decoder's; timed
    beside the new kernels in the same run."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.attention import MASK_VALUE

    bias = (None if kv_mask is None else
            torch.where(kv_mask, 0.0, MASK_VALUE).float().contiguous())
    return kernels.attention(q, k, v, scale=q.shape[-1] ** -0.5,
                             causal=causal, kv_bias=bias, two_pass=two_pass,
                             with_lse=with_lse, route="vls_attention_bf16")


def check_k3_route(hd, n_tok, heads):
    """The mask decoder's K3 calls (two-pass, head dim hd over n_tok keys
    and `heads` kv heads) take attention_short_sm90.cu."""
    from video_llava_seg_torch import kernels

    entry = kernels.attention_entry(hd, True, n_tok, heads)
    if entry != K3_ENTRY:
        raise AssertionError(f"K3 at head dim {hd} over {n_tok} keys routes "
                             f"to {entry}, not {K3_ENTRY}")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def hiera_block_ops(blk, bt, hw, din, dout, ws, pool):
    """Operations one Hiera block needs on [bt, hw, hw, din] (windows
    padded up to a multiple of ws, as the block pads its map)."""
    t_in = bt * hw * hw
    ho = hw // 2 if pool else hw
    t_out = bt * ho * ho
    ops = 2 * t_in * din * blk["qkv"]["kernel"].shape[1]
    if "proj" in blk:
        ops += 2 * t_in * din * dout
    if ws == 0:
        ops += 4 * bt * (ho * ho) * (hw * hw) * dout
    else:
        side = -(-hw // ws) * ws
        n_win = bt * (side // ws) ** 2
        q_win = (ws // 2) ** 2 if pool else ws * ws
        ops += 4 * n_win * q_win * ws * ws * dout
    ops += 2 * t_out * dout * dout
    for layer in blk["mlp"]["layers"]:
        ops += 2 * t_out * layer["kernel"].shape[0] * layer["kernel"].shape[1]
    return ops


def phase_kernel_checks(cfg, prefill_len: int, batch_len: int, pad: int,
                        seed: int, dev):
    """K1..K4 at the main paths' shapes (K3 and K4 also at the SAM2 image
    predictor's and the automatic mask generator's). prefill_len: the
    batch-1 caption prefill; batch_len / pad: the batch-2 prefill and the
    left pad of its shorter row (K2 with a per-key bias)."""
    import torch.nn.functional as F

    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.models.sam2.config import sam2_config
    from video_llava_seg_torch.models.seg_head import make_sam2_cfg
    from video_llava_seg_torch.ops.attention import (
        attention,
        attention_reference,
    )
    from video_llava_seg_torch.ops.quantization import quantized_nbytes
    from video_llava_seg_torch.ops.vit_block import (
        vit_layer,
        vit_layer_plain,
    )

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    # K1: one CLIP-L layer over the 32 frames x 577 tokens
    vc = cfg.vision
    layer = perturb(vit.init(dataclasses.replace(vc, num_layers=1), g, dev,
                             bf)["layers"][0], g)
    x = randn(cfg.num_frames, vc.num_patches + 1, vc.hidden_size)
    kw = dict(num_heads=vc.num_heads, eps=vc.layernorm_eps,
              kv_len=x.shape[1])
    f, n, d = x.shape
    dense_ops = sum(2 * f * n * p["kernel"].shape[0] * p["kernel"].shape[1]
                    for k, p in layer.items() if "kernel" in p)
    work = (2 * _nbytes(x) + quantized_nbytes(layer),
            dense_ops + 4 * f * n * n * d, PEAK_BF16)
    _check("K1", f"x{list(x.shape)} h{vc.num_heads}",
           lambda: vit_layer(layer, x, **kw),
           lambda: vit_layer_plain(layer, x, **kw),
           lambda: vit_layer_plain(f32(layer), x.float(), **kw), results,
           work)
    del layer, x

    # K2: Llama-3-8B causal GQA prefill over the spliced caption prompt
    lc = cfg.llm
    s = prefill_len
    q = randn(1, lc.num_heads, s, lc.head_dim)
    k = randn(1, lc.num_kv_heads, s, lc.head_dim)
    v = randn(1, lc.num_kv_heads, s, lc.head_dim)
    work = (2 * _nbytes(q, k, v, q),
            4 * lc.num_heads * lc.head_dim * s * (s + 1) // 2, PEAK_BF16)
    _check("K2", f"q{list(q.shape)} kv{list(k.shape)} causal",
           lambda: attention(q, k, v, causal=True),
           lambda: attention_reference(q, k, v, causal=True),
           lambda: attention_reference(q.float(), k.float(), v.float(),
                                       causal=True), results, work,
           run_library=lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True),
           run_previous=lambda: attention_cu(q, k, v, causal=True))
    del q, k, v

    # K2 under left padding: the batch-2 prefill, row 1 padded by `pad`
    # keys (per-key bias); pad query rows attend to masked keys only and
    # are compared for finiteness, the real rows against the twin
    s = batch_len
    q = randn(2, lc.num_heads, s, lc.head_dim)
    k = randn(2, lc.num_kv_heads, s, lc.head_dim)
    v = randn(2, lc.num_kv_heads, s, lc.head_dim)
    kv_mask = torch.ones(2, s, dtype=torch.bool, device=dev)
    kv_mask[1, :pad] = False
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    sdpa_mask = causal[None, None] & kv_mask[:, None, None, :]
    got = attention(q, k, v, causal=True, kv_mask=kv_mask)
    sync()
    if not torch.isfinite(got.float()).all():
        raise AssertionError("K2 with kv_bias: non-finite output (pad rows "
                             "included)")
    del got
    real = slice(pad, None)
    work = (2 * _nbytes(q, k, v, q) + 4 * 2 * s,
            4 * lc.num_heads * lc.head_dim
            * (s * (s + 1) // 2 + (s - pad) * (s - pad + 1) // 2), PEAK_BF16)
    _check("K2", f"q{list(q.shape)} kv{list(k.shape)} causal, row 1 "
           f"left-padded by {pad} (kv_bias), real query rows compared",
           lambda: attention(q, k, v, causal=True,
                             kv_mask=kv_mask)[:, :, real],
           lambda: attention_reference(q, k, v, causal=True,
                                       kv_mask=kv_mask)[:, :, real],
           lambda: attention_reference(q.float(), k.float(), v.float(),
                                       causal=True,
                                       kv_mask=kv_mask)[:, :, real],
           results, work,
           run_library=lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=sdpa_mask, enable_gqa=True),
           run_previous=lambda: attention_cu(q, k, v, causal=True,
                                             kv_mask=kv_mask))
    del q, k, v, sdpa_mask, causal

    # K3: mask-decoder image->token attention, 8 frames x 1 object; q / k
    # / v as the decoder builds them, [B, S, H, 16] dense outputs viewed
    # [B, H, S, 16]
    sc = make_sam2_cfg(cfg.seg)
    # [obj score] + iou + mask tokens + the one sparse prompt per row
    n_out = int(sc.pred_obj_scores) + 1 + (sc.num_multimask_outputs + 1)
    k3_check(sc, cfg.seg.max_seg_frames, n_out + 1, g, dev, results)
    # the SAM2 image predictor (SAM2.1-hiera-tiny, the same decoder
    # widths): `predict` with a box (2 corner points + the pad point), one
    # image; the automatic mask generator's batch of 64 points (the point
    # + the pad point)
    tc = sam2_config("tiny")
    k3_check(tc, 1, n_out + 3, g, dev, results, "predict, box")
    k3_check(tc, 64, n_out + 2, g, dev, results, "AMG point batch")

    # K4: one Hiera-small block of each kind over the 8 seg frames, then
    # one Hiera-tiny block of each kind over one image (set_image)
    k4_kind_checks(sc, cfg.seg.max_seg_frames, g, dev, results)
    k4_kind_checks(tc, 1, g, dev, results, "set_image")
    torch.cuda.empty_cache()
    sync()
    return results


def k3_check(sc, bt, n_tok, g, dev, results, what=None):
    """K3 at the mask decoder's image->token attention of config sc over
    bt rows and n_tok tokens (keys), against its plain twin, timed beside
    attention.cu's two-pass form and SDPA."""
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.attention import (
        attention,
        attention_reference,
    )

    heads = sc.twoway_heads
    hd = sc.hidden_dim // sc.attention_downsample_rate // heads
    nq = sc.image_embedding_size ** 2
    check_k3_route(hd, n_tok, heads)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q = randn(bt, nq, heads, hd).transpose(1, 2)
    k = randn(bt, n_tok, heads, hd).transpose(1, 2)
    v = randn(bt, n_tok, heads, hd).transpose(1, 2)
    work = (_nbytes(q, k, v, q), 4 * bt * heads * nq * n_tok * hd,
            PEAK_BF16)
    _check("K3", f"q{list(q.shape)} kv{list(k.shape)}"
           + (f" ({what})" if what else ""),
           lambda: attention(q, k, v),
           lambda: attention_reference(q, k, v),
           lambda: attention_reference(q.float(), k.float(), v.float()),
           results, work,
           run_library=lambda: F.scaled_dot_product_attention(q, k, v),
           time_kernel=lambda: kernels.attention(q, k, v, scale=hd ** -0.5,
                                                 two_pass=True),
           run_previous=lambda: attention_cu(q, k, v, two_pass=True),
           previous="attention.cu two-pass", train=10, device_time=True)


def k4_kind_checks(sc, bt, g, dev, results, what=None, name="K4"):
    """K4 at one block of each kind (windowed, q-pool, padded, global) the
    trunk of config sc has, over bt images at its image size, against the
    plain twin; recorded under `name` in results."""
    from video_llava_seg_torch.models.sam2 import hiera
    from video_llava_seg_torch.ops.hiera_block import (
        hiera_block,
        hiera_block_plain,
    )
    from video_llava_seg_torch.ops.quantization import quantized_nbytes

    hc = sc.hiera
    blocks = hiera.init(hc, g, dev, torch.bfloat16)["blocks"]
    dims = hiera.block_dims(hc)
    side = sc.image_size // hc.patch_stride
    kinds = {}
    for i, (din, dout, nh, ws, pool) in enumerate(dims):
        hw = side // (2 ** sum(1 for j in range(i) if dims[j][4]))
        kind = ("global" if ws == 0 else "q-pool" if pool
                else "padded" if hw % ws else "windowed")
        kinds.setdefault(kind, (i, hw, din, dout, nh, ws, pool))
    for kind in ("windowed", "q-pool", "padded", "global"):
        if kind not in kinds:      # Hiera-L's windows divide every map
            continue
        i, hw, din, dout, nh, ws, pool = kinds[kind]
        blk = perturb(blocks[i], g)
        x = torch.randn((bt, hw, hw, din), generator=g, device=dev).to(
            torch.bfloat16)
        ho = hw // 2 if pool else hw
        work = (_nbytes(x) + 2 * bt * ho * ho * dout + quantized_nbytes(blk),
                hiera_block_ops(blk, bt, hw, din, dout, ws, pool), PEAK_BF16)
        kw = dict(num_heads=nh, ws=ws, q_stride=hc.q_stride if pool else None)
        _check(name, f"{sc.name} block {i} {kind} x{list(x.shape)} ws{ws}"
               + (f" ({what})" if what else ""),
               lambda: hiera_block(blk, x, **kw),
               lambda: hiera_block_plain(blk, x, eps=1e-6, **kw),
               lambda: hiera_block_plain(f32(blk), x.float(), eps=1e-6,
                                         **kw), results, work)
        del x
    del blocks
    torch.cuda.empty_cache()


def phase_w4a8_checks(cfg, prefill_rows: int, seed: int, dev, results):
    """K5 at every dense of the fused W4A8 Llama-3-8B: decode (rows = the
    batch, 2) and the batch-2 prefill (rows = 2 x its length; the lm_head
    runs on the last position only, so rows = 2 there, fp32 out).
    Exact equality with the plain version; decode timings start from a
    cold L2, as each layer's weights stream once per token. The decode
    shapes run csrc/w4a8_gemv_sm90.cu, the prefill shapes csrc/
    w4a8_sm90.cu; w4a8.cu's GEMV and mma.sync tile, which served them
    before, are timed beside them."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.int4 import (
        unpack_int4,
        w4a8_matmul_plain,
    )

    denses = k5_denses(cfg.llm)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for name, in_dim, out in denses:
        packed = torch.randint(-128, 128, (in_dim // 2, out), generator=g,
                               device=dev, dtype=torch.int8)
        w_scale = torch.rand(out, generator=g, device=dev) * 1e-2 + 1e-4
        # the library's int8 product over the unpacked weight, column-major
        # as cuBLASLt takes it (unpacked outside the timed region)
        w_i8 = torch.cat(unpack_int4(packed)).t().contiguous().t()
        regimes = [(2, True)] if name == "lm_head" else [(2, True),
                                                        (prefill_rows, False)]
        for rows, decode in regimes:
            dt = torch.float32 if name == "lm_head" else torch.bfloat16
            xq = torch.randint(-127, 128, (rows, in_dim), generator=g,
                               device=dev, dtype=torch.int8)
            a_scale = torch.rand(rows, 1, generator=g, device=dev) + 1e-3
            # torch._int_mm takes more than 16 rows: decode pads to 32
            xq_lib = (torch.cat([xq, xq.new_zeros(30, in_dim)])
                      if rows < 17 else xq)
            out_bytes = rows * out * (4 if dt == torch.float32 else 2)
            work = (_nbytes(xq, a_scale, packed, w_scale) + out_bytes,
                    2 * rows * in_dim * out, PEAK_INT8)
            entry = kernels.w4a8_entry(rows, in_dim // 2, out)
            if entry != (kernels.W4A8_GEMV_ENTRY if decode
                         else "vls_w4a8_sm90"):
                raise AssertionError(f"K5 {name} [{rows}]: routed to {entry}")
            _check("K5", f"{name} [{rows}, {in_dim}] x [{in_dim}, {out}] "
                   f"{'decode' if decode else 'prefill'} -> "
                   f"{str(dt).split('.')[-1]} ({entry})",
                   lambda: kernels.w4a8_matmul(xq, a_scale, packed, w_scale,
                                               dt),
                   lambda: w4a8_matmul_plain(xq, a_scale, packed, w_scale,
                                             dt),
                   lambda: w4a8_matmul_plain(xq, a_scale, packed, w_scale,
                                             dt),
                   results, work,
                   run_library=lambda: torch._int_mm(xq_lib, w_i8),
                   flush=scratch.zero_ if decode else None,
                   run_previous=lambda: kernels.w4a8_matmul(
                       xq, a_scale, packed, w_scale, dt, route="vls_w4a8"),
                   previous="w4a8.cu")
            del xq, a_scale, xq_lib
        del packed, w_scale, w_i8
        torch.cuda.empty_cache()
    del scratch
    sync()


def k5_denses(lc):
    """(name, in, out) of the fused W4A8 LLM's four denses a layer and
    its lm_head."""
    d, q_dim = lc.hidden_size, lc.num_heads * lc.head_dim
    kv_dim = lc.num_kv_heads * lc.head_dim
    return [("wqkv", d, q_dim + 2 * kv_dim), ("wo", q_dim, d),
            ("w_gateup", d, 2 * lc.intermediate_size),
            ("w_down", lc.intermediate_size, d),
            ("lm_head", d, lc.vocab_size)]


L2_BYTES = 50e6


def in_turns(runs):
    """{name: device ms} of each list of calls in `runs` (`graph_seq_ms`),
    timed in turns, first to last and back (a, b, c, c, b, a), the mean of
    each's two: a clock or power state that drifts during the run weighs
    on all alike."""
    times = {k: [] for k in runs}
    for k in list(runs) + list(reversed(runs)):
        times[k].append(graph_seq_ms(runs[k]))
    return {k: statistics.mean(v) for k, v in times.items()}


def phase_w4a8_decode_device(cfg, seed: int, dev, results, rows: int = 2):
    """K5 at decode by device time, where the host's cost of a call does
    not show. Per dense: CUDA graphs over enough distinct weight copies
    that their bytes exceed 4x the 50 MB L2, so every launch streams its
    weights from device memory as in decode; the new kernel
    (w4a8_gemv_sm90.cu), w4a8.cu's GEMV (forced by `route`) and
    `torch._int_mm` over int8 weights of the unpacked size (column-major,
    the activations padded to 32 rows: it takes more than 16), timed in
    turns (`in_turns`). The host's
    cost of a call is phase 2's `cuda_ms` (one launch) minus this. Then
    one decode step's 129 products (32 layers' four denses over distinct
    weights, then the lm_head: ~3.75 GB) in one graph on each entry,
    against the step's byte bound."""
    from video_llava_seg_torch import kernels

    lc = cfg.llm
    denses = k5_denses(lc)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    host = {sh["shape"].split()[0]: sh for sh in results["K5"]["shapes"]
            if "decode" in sh["shape"]}

    def randint8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    xs, rows_out = {}, []
    for name, in_dim, out in denses:
        dt = torch.float32 if name == "lm_head" else torch.bfloat16
        if in_dim not in xs:
            xs[in_dim] = (randint8(rows, in_dim).clamp_(min=-127),
                          torch.rand(rows, 1, generator=g, device=dev)
                          + 1e-3)
        xq, a_scale = xs[in_dim]
        copies = max(2, math.ceil(4 * L2_BYTES / (in_dim // 2 * out)))
        packed = [randint8(in_dim // 2, out) for _ in range(copies)]
        w_i8 = [randint8(out, in_dim).t() for _ in range(copies)]
        w_scale = torch.rand(out, generator=g, device=dev) + 1e-3
        xq_lib = torch.cat([xq, xq.new_zeros(32 - rows, in_dim)])
        dev_ms = in_turns({
            "device_ms": [lambda p=p: kernels.w4a8_matmul(
                xq, a_scale, p, w_scale, dt) for p in packed],
            "previous_device_ms": [lambda p=p: kernels.w4a8_matmul(
                xq, a_scale, p, w_scale, dt, route="vls_w4a8")
                for p in packed],
            "library_device_ms": [lambda w=w: torch._int_mm(xq_lib, w)
                                  for w in w_i8]})
        nbytes = (_nbytes(xq, a_scale, packed[0], w_scale)
                  + rows * out * (4 if dt == torch.float32 else 2))
        b_ms, b_by = bound_of(nbytes, 2 * rows * in_dim * out, PEAK_INT8)
        sh = host[name]
        row = {"dense": name, "shape": [rows, in_dim, out], "copies": copies,
               "bound_ms": b_ms, "bound_by": b_by, **dev_ms,
               "ms": sh["ms"], "previous_ms": sh["previous_ms"],
               "library_ms": sh["library_ms"],
               "host_ms": sh["ms"] - dev_ms["device_ms"],
               "previous_host_ms": (sh["previous_ms"]
                                    - dev_ms["previous_device_ms"])}
        sh.update(dev_ms)
        log(f"[k5] {name} [{rows}, {in_dim}] x [{in_dim}, {out}] decode by "
            f"device time (a CUDA graph over {copies} weight copies): "
            f"w4a8_gemv_sm90.cu {row['device_ms']:.4f} ms "
            f"({b_ms / row['device_ms']:.3f} of the bound), w4a8.cu "
            f"{row['previous_device_ms']:.4f} ms, _int_mm "
            f"{row['library_device_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}); host's cost of a call (phase 2's one-launch time "
            f"minus this) {row['host_ms']:.4f} ms, w4a8.cu "
            f"{row['previous_host_ms']:.4f} ms")
        rows_out.append(row)
        del packed, w_i8, w_scale, xq_lib
        torch.cuda.empty_cache()

    # one decode step: 32 layers x 4 denses over distinct weights, then
    # the lm_head, on each entry in one graph
    layers = [[(randint8(i // 2, o), name) for name, i, o in denses[:4]]
              for _ in range(lc.num_layers)]
    _, hd_in, hd_out = denses[4]
    head = randint8(hd_in // 2, hd_out)
    scales = {name: torch.rand(o, generator=g, device=dev) + 1e-3
              for name, _, o in denses}

    def step(route):
        fns = [lambda p=p, n=n: kernels.w4a8_matmul(
                   *xs[2 * p.shape[0]], p, scales[n], torch.bfloat16,
                   route=route)
               for layer in layers for p, n in layer]
        fns.append(lambda: kernels.w4a8_matmul(
            *xs[hd_in], head, scales["lm_head"], torch.float32,
            route=route))
        return fns

    def call_bytes(p, out_size):
        # xq, a_scale, the packed weight, w_scale read; y written
        return (rows * 2 * p.shape[0] + rows * 4 + p.numel()
                + 4 * p.shape[1] + rows * p.shape[1] * out_size)

    # the library's step: the same 129 products on `torch._int_mm` over
    # int8 weights of the unpacked size, as the per-dense rows time it
    xs_lib = {i: torch.cat([xq, xq.new_zeros(32 - rows, i)])
              for i, (xq, _) in xs.items()}
    lib_weights = [randint8(o, i).t() for _ in range(lc.num_layers)
                   for _, i, o in denses[:4]]
    lib_weights.append(randint8(hd_out, hd_in).t())
    lib_step = [lambda w=w: torch._int_mm(xs_lib[w.shape[0]], w)
                for w in lib_weights]

    n_calls = 4 * lc.num_layers + 1
    nbytes = (sum(call_bytes(p, 2) for layer in layers for p, _ in layer)
              + call_bytes(head, 4))
    step_bound = nbytes / HBM_BYTES_S * 1e3
    step_ms = {k: v * n_calls for k, v in in_turns(
        {"device_ms": step(None), "previous_device_ms": step("vls_w4a8"),
         "library_device_ms": lib_step}).items()}
    log(f"[k5] one decode step's {n_calls} W4A8 products at [{rows}, *] by "
        f"device time (one CUDA graph, {nbytes / 1e9:.3f} GB): "
        f"w4a8_gemv_sm90.cu {step_ms['device_ms']:.4f} ms "
        f"({step_bound / step_ms['device_ms']:.3f} of the bound), w4a8.cu "
        f"{step_ms['previous_device_ms']:.4f} ms, _int_mm over int8 weights "
        f"{step_ms['library_device_ms']:.4f} ms, bound {step_bound:.4f} ms "
        f"(bytes)")
    del layers, head, scales, xs, xs_lib, lib_weights, lib_step
    torch.cuda.empty_cache()
    sync()
    return {"denses": rows_out, "step": {"calls": n_calls,
                                         "bound_ms": step_bound, **step_ms}}


def _smoke_inputs(seed, n_frames, hw, n_seg):
    r = np.random.default_rng(seed)
    frames = r.integers(0, 256, (n_frames, *hw, 3), dtype=np.uint8)
    seg = r.integers(0, 256, (n_seg, *hw, 3), dtype=np.uint8)
    meta = {"orig_image_size": hw,
            "filenames": [f"{t:05d}.jpg" for t in range(n_seg)]}
    return frames, seg, meta


def phase_slice(cfg, seed, max_new_tokens, dev, hw=(480, 854),
                tag="slice"):
    """The bf16 batch-1 path: a caption and a referral query through
    `get_model_output_frames`. Returns (launch counts, summary)."""
    from video_llava_seg_torch import bridge, kernels
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.models import llava

    t0 = time.perf_counter()
    params = llava.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev, torch.bfloat16)
    sync()
    sizes = []
    bridge.tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    log(f"[{tag}] init: {n_params / 1e9:.2f} B bf16 params on the card in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    tok = SmokeTokenizer(cfg.llm.vocab_size)
    eos = [tok.convert_tokens_to_ids("<|eot_id|>")]
    stops = serve.keyword_stop_sequences(tok, "llava_llama_3")
    frames, seg, meta = _smoke_inputs(seed, cfg.num_frames, hw,
                                      cfg.seg.max_seg_frames)
    queries = [("caption", serve.CAPTION_PROMPT, {}),
               ("referral", "\nthe person on the left Please output the "
                "segmentation mask.",
                {"seg_frames_u8": seg, "seg_meta": meta})]

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync()
    t_all = time.perf_counter()
    outs = []
    for name, qs, kw in queries:
        timings = {}
        t1 = time.perf_counter()
        text, logits = serve.get_model_output_frames(
            params, cfg, tok, frames, qs, "llava_llama_3", max_new_tokens,
            eos_token_ids=eos, stop_sequences=stops, timings=timings, **kw)
        sync()
        total = time.perf_counter() - t1
        outs.append((name, text, logits, timings, total))
    e2e = time.perf_counter() - t_all
    counts = snapshot_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # a warm repeat of the referral query, outside the counted run: its
    # seg head (the one serving stage that carries the trunk) ran above
    # as the process's first seg head on this tree
    name, qs, kw = queries[1]
    warm = {}
    serve.get_model_output_frames(
        params, cfg, tok, frames, qs, "llava_llama_3", max_new_tokens,
        eos_token_ids=eos, stop_sequences=stops, timings=warm, **kw)
    sync()
    log(f"[{tag}] referral seg_encode: cold {outs[1][3]['seg_encode']:.3f} "
        f"s, warm {warm['seg_encode']:.3f} s (the warm repeat: "
        + ", ".join(f"{k} {v:.3f}" for k, v in warm.items()) + " s)")

    for name, text, logits, timings, total in outs:
        stages = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        log(f"[{tag}] {name}: {total:.3f} s end to end ({stages} s); "
            f"caption[:60] {text[:60]!r}")
    log(f"[{tag}] both queries: {e2e:.3f} s; peak allocated {peak:.1f} GiB")

    cap_text, ref_text = outs[0][1], outs[1][1]
    if not cap_text or not ref_text:
        raise AssertionError("empty caption")
    logits = outs[1][2]
    want_shape = (1, cfg.seg.max_seg_frames, *hw)
    if logits is None or logits.shape != want_shape:
        raise AssertionError(f"mask logits shape "
                             f"{None if logits is None else logits.shape} "
                             f"!= {want_shape}")
    if not np.isfinite(logits).all():
        raise AssertionError("mask logits are not finite")
    log(f"[{tag}] mask logits {list(logits.shape)} finite; "
        f"{(logits > 0).mean():.4f} of pixels positive")

    n_tower = llava.vit.num_layers_run(cfg.vision)
    sc = llava.seg_head.make_sam2_cfg(cfg.seg)
    expect = {"K1": 2 * n_tower, "K2": 2 * cfg.llm.num_layers,
              "K3": sc.twoway_depth, "K4": sc.hiera.depth, "K5": 0,
              "K6a": 0, "K6b": 0, "K7": 0, "K8": 0}
    why = {"K1": f"{n_tower} tower layers x 2 queries (each query encodes "
                 "the clip, as the JAX CLI does)",
           "K2": f"{cfg.llm.num_layers} prefill layers x 2 queries",
           "K3": "image->token attention in the 2 two-way blocks, referral "
                 "query only",
           "K4": "16 Hiera blocks, 8 seg frames batched, referral query "
                 "only",
           "K5": "none: a bf16 tree has no W4A8 dense",
           "K6a": "none: serving runs no backward",
           "K6b": "none: serving runs no backward",
           "K7": "none: K4 runs every Hiera block",
           "K8": "none: a bf16 tower has no W8A8 layer"}
    check_launches(tag, counts, expect, why)

    # the generation itself: tokens in range, hidden states finite, and
    # the same greedy tokens as the main path's caption
    from video_llava_seg_torch.inference.utils import clip_preprocess_frames
    from video_llava_seg_torch.mm_utils import tokenizer_image_token

    video = clip_preprocess_frames(torch.from_numpy(frames).to(dev),
                                   cfg.vision.image_size)[None].to(
        torch.bfloat16)
    ids = np.asarray(tokenizer_image_token(
        serve.build_prompt(cfg, serve.CAPTION_PROMPT, "llava_llama_3"),
        tok))[None]
    tokens, hidden, n = llava.generate(params, cfg, ids, video,
                                       max_new_tokens=max_new_tokens,
                                       eos_token_ids=tuple(eos),
                                       stop_sequences=tuple(stops))
    sync()
    toks = tokens[0, :n].cpu().numpy()
    if n <= 0 or toks.min() < 0 or toks.max() >= cfg.llm.vocab_size:
        raise AssertionError(f"bad tokens: n={n}, range "
                             f"[{toks.min()}, {toks.max()}]")
    if not torch.isfinite(hidden[0, :n].float()).all():
        raise AssertionError("hidden states are not finite")
    if tok.decode(toks).strip() != cap_text:
        raise AssertionError("a second greedy run gave another caption")
    log(f"[{tag}] generate: {n} tokens in range, hidden "
        f"{list(hidden.shape)} finite, caption reproduced")
    del params, video, tokens, hidden
    torch.cuda.empty_cache()
    sync()
    return counts, {"seconds": e2e, "peak_gib": peak, "queries": {
        name: {"seconds": total, "stages": timings}
        for name, _, _, timings, total in outs}, "warm_referral": warm}


# the C entry that must serve every dense of K1 and K4 (kernels.gemm)
GEMM_SM90_ENTRY = "vls_gemm_bf16_sm90"


def seg_sam2_cfg():
    """The seg head's SAM2 config (SAM2.1-hiera-small at 1024^2), which
    the trunk helpers below count for unless given another."""
    from video_llava_seg_torch.config import VideoLlavaConfig
    from video_llava_seg_torch.models.seg_head import make_sam2_cfg

    return make_sam2_cfg(VideoLlavaConfig().seg)


def trunk_dense_calls(sc=None):
    """kernels.gemm calls per pass of a SAM2 config's trunk (default: the
    seg head's SAM2.1-hiera-small) through K4: qkv, proj, fc1 and fc2 of
    every block and the shortcut projection of every block that changes
    the width (`ops/hiera_block.py::_hiera_block_cuda`)."""
    from video_llava_seg_torch.models.sam2 import hiera

    dims = hiera.block_dims((sc or seg_sam2_cfg()).hiera)
    return sum(4 + (din != dout) for din, dout, _, _, _ in dims)


# the C entry that must serve every K3 launch of the main paths (the mask
# decoder's image->token attention), counted apart by kernels.attention
K3_ENTRY = "vls_attention_short_sm90"
# the C entry of every K2 launch (head dim 128 for the LLM, 96 for the
# per-op trunk's global blocks) and of the attention link of every K1 /
# K8 layer (head dims 64 / 80 over 577 keys) and of K4's global blocks
SM90_ENTRY = "vls_flash_fwd_sm90"
CUDA_C_ENTRY = "vls_attention_bf16"
# the C entry of every K7 call at head dim 96 and of every windowed block
# of a K4 trunk (kernels.window_entry)
WINDOW_SM90_ENTRY = "vls_window_attention_sm90"
# the C entry of the mask decoder's flash backward (K6a + K6b in one
# pass), counted apart by kernels.ATTENTION_BWD_LAUNCHES with the pairs'
# entries: attention_bwd_sm90.cu's for the LLM layers, attention_bwd.cu's
K6_SHORT_ENTRY = "vls_attention_short_bwd_sm90"
K6_SM90_PAIR = ("vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90")
K6_CUDA_C_PAIR = ("vls_attention_bwd_dq", "vls_attention_bwd_dkv")


def _trunk_block_kinds(sc=None):
    """(head dim, ws, pooled, keys, heads) of every block of a SAM2
    config's trunk (default: the seg head's) at its image size: ws 0 for
    a global block, keys over a window or the whole map."""
    from video_llava_seg_torch.models.sam2 import hiera

    sc = sc or seg_sam2_cfg()
    dims = hiera.block_dims(sc.hiera)
    side = sc.image_size // sc.hiera.patch_stride
    out = []
    for i, (_, dout, nh, ws, pool) in enumerate(dims):
        hw = side // (2 ** sum(1 for j in range(i) if dims[j][4]))
        out.append((dout // nh, ws, pool, ws * ws if ws else hw * hw, nh))
    return out


def trunk_sm90_blocks(sc=None):
    """(blocks per trunk, of them those whose attention K4 sends to
    attention_sm90.cu) for a SAM2 config's trunk (default: the seg
    head's): the global blocks (one kernels.attention call each over the
    whole map's keys, at the head dim `attention_head_dim` pads theirs
    to) where `attention_entry` names it."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.hiera_block import attention_head_dim

    kinds = _trunk_block_kinds(sc)
    n = sum(not ws
            and kernels.attention_entry(attention_head_dim(hd), False, keys,
                                        nh) == SM90_ENTRY
            for hd, ws, pool, keys, nh in kinds)
    return len(kinds), n


def trunk_window_launches(sc=None):
    """kernels.window_attention launches by C entry per pass of a SAM2
    config's trunk (default: the seg head's), through K4 or per op (K7):
    one a windowed block, on the entry `kernels.window_entry` names."""
    from video_llava_seg_torch import kernels

    out = dict.fromkeys(kernels.WINDOW_ROUTES, 0)
    for hd, ws, pool, _, _ in _trunk_block_kinds(sc):
        if ws:
            out[kernels.window_entry(hd, ws, 1 + pool)] += 1
    return out


# the C entries of every LayerNorm of K1 and K4 (kernels.layernorm) and
# of K4's shortcut pools (kernels.maxpool2x2)
LAYERNORM_SM90_ENTRY = "vls_layernorm_sm90"
MAXPOOL_SM90_ENTRY = "vls_maxpool2x2_sm90"
QUANT_ROWS_SM90_ENTRY = "vls_quant_rows_sm90"


def trunk_pool_launches(sc=None):
    """pool_sm90.cu launches per pass of a SAM2 config's trunk (default:
    the seg head's) through K4: the shortcut of every q-pool block."""
    return sum(pool for _, _, pool, _, _ in _trunk_block_kinds(sc))


def reset_launches():
    """Zero the K1..K8 counts and kernels.attention's, the flash
    backward's and kernels.gemm's counts by C entry, just before a main
    path runs."""
    from video_llava_seg_torch import kernels

    kernels.LAUNCHES.reset()
    kernels.ATTENTION_LAUNCHES.reset()
    kernels.ATTENTION_BWD_LAUNCHES.reset()
    kernels.GEMM_BF16_LAUNCHES.reset()
    kernels.WINDOW_LAUNCHES.reset()
    kernels.LAYERNORM_LAUNCHES.reset()
    kernels.MAXPOOL_LAUNCHES.reset()
    kernels.W4A8_LAUNCHES.reset()
    kernels.QUANT_ROWS_LAUNCHES.reset()


def snapshot_launches():
    """The K1..K8 counts just after a main path ran, under "K3 entry" the
    launches of attention_short_sm90.cu among them, under "sm90 entry"
    those of attention_sm90.cu, under "attention.cu entry" those of
    attention.cu, the flash backward's launches (K6a / K6b),
    kernels.gemm's (the denses of K1 and K4), kernels.window_attention's
    (K7 and K4's windowed blocks), kernels.w4a8_matmul's (K5),
    kernels.layernorm's, kernels.maxpool2x2's and the row quantizers' (K8)
    by C entry."""
    from video_llava_seg_torch import kernels

    counts = kernels.LAUNCHES.snapshot()
    by_entry = kernels.ATTENTION_LAUNCHES.snapshot()
    counts["K3 entry"] = by_entry[K3_ENTRY]
    counts["sm90 entry"] = by_entry[SM90_ENTRY]
    counts["attention.cu entry"] = by_entry[CUDA_C_ENTRY]
    counts.update(kernels.ATTENTION_BWD_LAUNCHES.snapshot())
    counts.update(kernels.GEMM_BF16_LAUNCHES.snapshot())
    counts.update(kernels.WINDOW_LAUNCHES.snapshot())
    counts.update(kernels.W4A8_LAUNCHES.snapshot())
    counts.update(kernels.LAYERNORM_LAUNCHES.snapshot())
    counts.update(kernels.MAXPOOL_LAUNCHES.snapshot())
    counts.update(kernels.QUANT_ROWS_LAUNCHES.snapshot())
    return counts


def check_launches(tag, counts, expect, why, bwd=None, sc=None):
    """Every kernel the path runs launched, exactly as often as expected,
    every K3 launch took attention_short_sm90.cu, attention_sm90.cu
    served every K2 launch, the attention link of every K1 / K8 layer and
    the trunk's blocks `trunk_sm90_blocks` names, gemm_bf16_sm90.cu every
    dense of K1 and K4 (`trunk_dense_calls`), window_attention_sm90.cu
    every windowed block of a K4 trunk and every K7 call
    (`trunk_window_launches`), layernorm_sm90.cu the two LayerNorms of
    every K1 layer and K4 block, pool_sm90.cu what
    `trunk_pool_launches` counts and w8a8_rows_sm90.cu the four row
    quantizers of every K8 layer (layernorm.cu, pool.cu and w8a8.cu's
    row quantizers none). bwd:
    the flash backward's launches expected by C entry (a path with a
    backward). sc: the SAM2 config whose trunk K4 ran (default: the seg
    head's)."""
    from video_llava_seg_torch import kernels

    for name in kernels.LaunchCounts.NAMES:
        log(f"[{tag}] launches {name}: {counts[name]} (expected "
            f"{expect[name]}: {why[name]})")
        if expect[name] and counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
        if counts[name] != expect[name]:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{expect[name]}")
    log(f"[{tag}] K3 launches on attention_short_sm90.cu: "
        f"{counts['K3 entry']} of {counts['K3']}")
    if counts["K3 entry"] != counts["K3"]:
        raise AssertionError(f"{tag}: {counts['K3'] - counts['K3 entry']} K3 "
                             f"launches did not take {K3_ENTRY}")
    n_blocks, per_trunk = trunk_sm90_blocks(sc)
    trunk = counts["K4"] // n_blocks * per_trunk
    links = counts["K1"] + counts["K8"]
    want = counts["K2"] + links + trunk
    log(f"[{tag}] attention_sm90.cu launches: {counts['sm90 entry']} "
        f"(expected {want}: K2 {counts['K2']}, ViT links {links}, trunk "
        f"blocks {trunk}, {per_trunk} of each trunk's {n_blocks})")
    if counts["sm90 entry"] != want:
        raise AssertionError(f"{tag}: {counts['sm90 entry']} launches of "
                             f"{SM90_ENTRY}, expected {want}")
    denses = trunk_dense_calls(sc)
    want = {GEMM_SM90_ENTRY: 6 * counts["K1"]
            + counts["K4"] // n_blocks * denses,
            "vls_gemm_bf16": 0}
    got = {e: counts[e] for e in want}
    log(f"[{tag}] kernels.gemm launches by C entry: {got} (expected "
        f"{want}: 6 denses x {counts['K1']} K1 layers, {denses} denses "
        f"per {n_blocks}-block trunk x {counts['K4'] // n_blocks} trunks)")
    if got != want:
        raise AssertionError(f"{tag}: kernels.gemm routes {got}, expected "
                             f"{want}")
    trunks = counts["K4"] // n_blocks
    win = trunk_window_launches(sc)
    per_op = counts["K7"] // max(sum(win.values()), 1)
    want = {e: (trunks + per_op) * win[e] for e in win}
    got = {e: counts[e] for e in want}
    log(f"[{tag}] kernels.window_attention launches by C entry: {got} "
        f"(expected {want}: {win} per trunk x {trunks} K4 trunks + "
        f"{per_op} per-op trunks)")
    if got != want:
        raise AssertionError(f"{tag}: kernels.window_attention routes {got}, "
                             f"expected {want}")
    pools = trunk_pool_launches(sc)
    want = {MAXPOOL_SM90_ENTRY: trunks * pools, "vls_maxpool2x2_bf16": 0}
    got = {e: counts[e] for e in want}
    log(f"[{tag}] kernels.maxpool2x2 launches by C entry: {got} (expected "
        f"{want}: {pools} shortcut pools per K4 trunk x "
        f"{trunks})")
    if got != want:
        raise AssertionError(f"{tag}: kernels.maxpool2x2 routes {got}, "
                             f"expected {want}")
    want = {LAYERNORM_SM90_ENTRY: 2 * (counts["K1"] + counts["K4"]),
            "vls_layernorm_bf16": 0}
    got = {e: counts[e] for e in want}
    log(f"[{tag}] kernels.layernorm launches by C entry: {got} (expected "
        f"{want}: 2 per K1 layer x {counts['K1']} + 2 per K4 block x "
        f"{counts['K4']})")
    if got != want:
        raise AssertionError(f"{tag}: kernels.layernorm routes {got}, "
                             f"expected {want}")
    want = {QUANT_ROWS_SM90_ENTRY: 4 * counts["K8"], "vls_quant_rows": 0}
    got = {e: counts[e] for e in want}
    log(f"[{tag}] row quantizer launches by C entry: {got} (expected "
        f"{want}: 2 ln_quant_rows + 2 quant_rows per K8 layer x "
        f"{counts['K8']})")
    if got != want:
        raise AssertionError(f"{tag}: the row quantizers route {got}, "
                             f"expected {want}")
    k5 = sum(counts[e] for e in kernels.W4A8_ROUTES)
    if k5 != counts["K5"]:
        raise AssertionError(f"{tag}: {k5} w4a8_matmul launches by C entry, "
                             f"{counts['K5']} K5 launches")
    if bwd is not None:
        got = {e: counts[e] for e in bwd}
        log(f"[{tag}] flash backward launches by C entry: {got} (expected "
            f"{bwd})")
        if got != bwd:
            raise AssertionError(f"{tag}: flash backward routes {got}, "
                                 f"expected {bwd}")


def llm_bf16_nbytes(lc) -> int:
    """Bytes of the float LLM tree (`llama.init`) in bf16."""
    d = lc.hidden_size
    q, kv = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    layer = d * (q + 2 * kv) + q * d + 3 * d * lc.intermediate_size + 2 * d
    head = 0 if lc.tie_word_embeddings else d * lc.vocab_size
    return 2 * (lc.vocab_size * d + lc.num_layers * layer + d + head)


REFERRAL = ("\nthe person on the left Please output the segmentation "
            "mask.")


def build_quant_params(cfg, seed, dev):
    """The serving tree of the quantized path, seeded random weights on
    `dev`: tower, projector and seg head in bf16, the LLM W4A8
    (`init_quantized`, one layer at a time) with fused qkv / gate-up.
    Returns (params, cfg with the int8 KV cache on)."""
    from video_llava_seg_torch.models import llama, projector, seg_head, vit

    bf = torch.bfloat16
    qcfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, kv_cache_int8=True))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    params = {
        "llm": llama.fuse_qkv_gateup(llama.init_quantized(
            qcfg.llm, g, dev, bf, bits=4, act_quant=True)),
        "vision_tower": perturb(vit.init(cfg.vision, g, dev, bf), g),
        "mm_projector": projector.init(cfg.projector, g, dev, bf),
        "seg_head": perturb(seg_head.init(cfg.seg, cfg.llm.hidden_size, g,
                                          dev, bf), g),
    }
    return params, qcfg


def phase_quant_slice(cfg, seed, max_new_tokens, dev, hw=(480, 854)):
    """The W4A8 + int8-KV + fused batched path at full width: one
    `get_model_output_batched` call serves the caption and the referral
    query about one clip."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.inference.utils import clip_preprocess_frames
    from video_llava_seg_torch.models import llava, seg_head, vit
    from video_llava_seg_torch.ops.quantization import quantized_nbytes

    bf = torch.bfloat16
    t0 = time.perf_counter()
    params, qcfg = build_quant_params(cfg, seed, dev)
    sync()
    llm_bytes = quantized_nbytes(params["llm"])
    bf16_bytes = llm_bf16_nbytes(cfg.llm)
    log(f"[quant] init: W4A8 LLM (fused qkv / gate-up) + bf16 tower, "
        f"projector, seg head on the card in {time.perf_counter() - t0:.1f} "
        f"s; LLM weights {llm_bytes / 1e9:.3f} GB vs {bf16_bytes / 1e9:.3f} "
        f"GB in bf16 ({llm_bytes / bf16_bytes:.3f}); allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    if not llm_bytes < 0.35 * bf16_bytes:
        raise AssertionError("W4A8 LLM weights are not under 0.35 x bf16")

    tok = SmokeTokenizer(cfg.llm.vocab_size)
    eos = [tok.convert_tokens_to_ids("<|eot_id|>")]
    stops = serve.keyword_stop_sequences(tok, "llava_llama_3")
    frames, seg, meta = _smoke_inputs(seed, cfg.num_frames, hw,
                                      cfg.seg.max_seg_frames)
    queries = [(serve.CAPTION_PROMPT, False), (REFERRAL, True)]

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync()
    timings = {}
    t1 = time.perf_counter()
    outs = serve.get_model_output_batched(
        params, qcfg, tok, frames, queries, "llava_llama_3", max_new_tokens,
        seg_frames_u8=seg, seg_meta=meta, eos_token_ids=eos,
        stop_sequences=stops, timings=timings)
    sync()
    e2e = time.perf_counter() - t1
    counts = snapshot_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
    log(f"[quant] caption + referral in one batched call: {e2e:.3f} s "
        f"({stages} s); peak allocated {peak:.1f} GiB")
    (cap_text, cap_logits), (ref_text, logits) = outs
    log(f"[quant] caption[:60] {cap_text[:60]!r}; referral[:60] "
        f"{ref_text[:60]!r}")
    if not cap_text or cap_logits is not None:
        raise AssertionError("caption row: empty text or a mask")
    want_shape = (1, cfg.seg.max_seg_frames, *hw)
    if logits is None or logits.shape != want_shape:
        raise AssertionError(f"mask logits shape "
                             f"{None if logits is None else logits.shape} "
                             f"!= {want_shape}")
    if not np.isfinite(logits).all():
        raise AssertionError("mask logits are not finite")
    log(f"[quant] mask logits {list(logits.shape)} finite; "
        f"{(logits > 0).mean():.4f} of pixels positive")

    # the number of decode steps, from a second greedy run on the same
    # batch, which must reproduce both texts
    ids, lens = serve.batch_prompt_ids(cfg, tok, [q for q, _ in queries],
                                       "llava_llama_3")
    video = clip_preprocess_frames(torch.from_numpy(frames).to(dev),
                                   cfg.vision.image_size)[None].to(bf)
    tokens, hidden, n = llava.generate(
        params, qcfg, ids, video, max_new_tokens=max_new_tokens,
        eos_token_ids=tuple(eos), stop_sequences=tuple(stops),
        pad_side="left", input_lens=lens)
    sync()
    texts = [tok.decode(t).strip() for t in tokens[:, :n].cpu().numpy()]
    if texts != [cap_text, ref_text]:
        raise AssertionError("a second greedy run gave other texts")
    if not torch.isfinite(hidden[:, :n].float()).all():
        raise AssertionError("hidden states are not finite")
    log(f"[quant] generate: {n} decode steps, both texts reproduced")

    n_tower = vit.num_layers_run(cfg.vision)
    sc = seg_head.make_sam2_cfg(cfg.seg)
    per_step = 4 * cfg.llm.num_layers + 1
    expect = {"K1": n_tower, "K2": cfg.llm.num_layers,
              "K3": sc.twoway_depth, "K4": sc.hiera.depth,
              "K5": per_step * (1 + n), "K6a": 0, "K6b": 0, "K7": 0,
              "K8": 0}
    why = {"K1": f"{n_tower} tower layers, the clip encoded once for both "
                 "rows",
           "K2": f"{cfg.llm.num_layers} layers of one batch-2 prefill",
           "K3": "image->token attention in the 2 two-way blocks, the "
                 "referral row only",
           "K4": "16 Hiera blocks, 8 seg frames batched",
           "K5": f"{per_step} = {cfg.llm.num_layers} layers x 4 fused "
                 f"denses + lm_head, in the prefill and in each of {n} "
                 "decode steps",
           "K6a": "none: serving runs no backward",
           "K6b": "none: serving runs no backward",
           "K7": "none: K4 runs every Hiera block",
           "K8": "none: the tower is bf16 (only the LLM is W4A8)"}
    check_launches("quant", counts, expect, why)
    # by C entry: the prefill's four denses a layer on w4a8_sm90.cu; every
    # decode product and the prefill's lm_head (the last position, 2 rows)
    # on w4a8_gemv_sm90.cu
    layers = cfg.llm.num_layers
    want = {kernels.W4A8_GEMV_ENTRY: per_step * n + 1,
            "vls_w4a8_sm90": 4 * layers, "vls_w4a8": 0}
    got = {e: counts[e] for e in want}
    log(f"[quant] w4a8_matmul launches by C entry: {got} (expected {want}: "
        f"{per_step} x {n} decode steps + the prefill's lm_head, 4 x "
        f"{layers} prefill denses, none on w4a8.cu)")
    if got != want:
        raise AssertionError(f"quant: w4a8_matmul routes {got}, expected "
                             f"{want}")
    del params, video, tokens, hidden
    torch.cuda.empty_cache()
    sync()
    return counts, {"seconds": e2e, "stages": timings, "peak_gib": peak,
                    "llm_bytes": llm_bytes, "llm_bf16_bytes": bf16_bytes,
                    "decode_steps": n}


def _tiny_cfg():
    from video_llava_seg_torch.config import SegHeadConfig, VideoLlavaConfig

    return dataclasses.replace(
        VideoLlavaConfig.tiny(),
        seg=SegHeadConfig(seg_backbone="tiny", image_size=64,
                          max_seg_frames=4, max_objects=2))


def _agree(tag, got, want, bound):
    rel = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))
    sign = float(((got > 0) == (want > 0)).mean())
    log(f"[agree] {tag} mask logits {list(got.shape)}: card bf16 kernels vs "
        f"CPU fp32 plain: rel err {rel:.3e} (bound {bound:.0e}), sign "
        f"agreement {sign:.4f}")
    if got.shape != want.shape or not rel <= bound:
        raise AssertionError(f"{tag}: kernels disagree with plain")


def phase_small_agreement(seed):
    """Tiny config through get_model_output_frames: kernels (card, bf16)
    vs plain (CPU, fp32), same weights and inputs. seg_token_idx is unset,
    so the mask always comes from the index-0 fallback, i.e. from the
    prefill's last hidden state, whatever tokens each side samples."""
    from video_llava_seg_torch.bridge import cast_tree
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.models import llava

    cfg = _tiny_cfg()
    params = llava.init(cfg, torch.Generator().manual_seed(seed), "cpu",
                        torch.float32)
    # round the weights to bf16 once so both sides hold the same values
    params = cast_tree(cast_tree(params, "cpu", torch.bfloat16), "cpu",
                       torch.float32)
    tok = SmokeTokenizer(cfg.llm.vocab_size)
    frames, seg, meta = _smoke_inputs(seed, cfg.num_frames, (48, 64), 3)
    qs = "\nthe bright region Please output the segmentation mask."
    _, want = serve.get_model_output_frames(
        params, cfg, tok, frames, qs, "llava_llama_3", 4,
        seg_frames_u8=seg, seg_meta=meta)
    _, got = serve.get_model_output_frames(
        cast_tree(params, "cuda", torch.bfloat16), cfg, tok, frames, qs,
        "llava_llama_3", 4, seg_frames_u8=seg, seg_meta=meta)
    sync()
    _agree("tiny bf16 slice", got, want, AGREE_BOUND)


def phase_small_agreement_quant(seed):
    """The tiny config on the quantized batched path (every LLM dense
    W4A8, fused, int8 KV, caption + referral in one batched call): card
    (K5 and the other kernels, bf16 activations) vs CPU (plain, fp32).
    Both sides hold the same int8 weights and fp32 scales (quantized
    once on the CPU from bf16-rounded weights); the mask comes from the
    referral row's prefill hidden state (index-0 fallback)."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.bridge import cast_tree
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.models import llama, llava
    from video_llava_seg_torch.ops.quantization import quantize_tree

    cfg = _tiny_cfg()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, kv_cache_int8=True))
    params = llava.init(cfg, torch.Generator().manual_seed(seed), "cpu",
                        torch.float32)
    params = cast_tree(cast_tree(params, "cpu", torch.bfloat16), "cpu",
                       torch.float32)
    params["llm"] = llama.fuse_qkv_gateup(quantize_tree(
        params["llm"], 4, act_quant=True, min_size=0))
    tok = SmokeTokenizer(cfg.llm.vocab_size)
    frames, seg, meta = _smoke_inputs(seed, cfg.num_frames, (48, 64), 3)
    queries = [(serve.CAPTION_PROMPT, False),
               ("\nthe bright region Please output the segmentation mask.",
                True)]
    kw = dict(seg_frames_u8=seg, seg_meta=meta)
    want = serve.get_model_output_batched(params, cfg, tok, frames, queries,
                                          "llava_llama_3", 4, **kw)[1][1]
    before = kernels.LAUNCHES.snapshot()["K5"]
    got = serve.get_model_output_batched(
        cast_tree(params, "cuda", torch.bfloat16), cfg, tok, frames, queries,
        "llava_llama_3", 4, **kw)[1][1]
    sync()
    if kernels.LAUNCHES.snapshot()["K5"] <= before:
        raise AssertionError("tiny W4A8 slice: K5 was not launched")
    _agree("tiny W4A8 batched slice", got, want, QUANT_AGREE_BOUND)


# ---------------------------------------------------------------------------
# the vision slice: K7, K8, RADIO, W8A8 towers, the per-op Hiera trunk
# ---------------------------------------------------------------------------

def radio_cfg(cfg):
    """`cfg` with the published training scripts' tower, RADIO-H/16 at
    384 (32 layers, d 1280, 16 heads of 80, 576 patches + 1 register
    token) and a projector from its 1280 channels."""
    from video_llava_seg_torch.config import ProjectorConfig, VisionTowerConfig

    return dataclasses.replace(
        cfg, vision=VisionTowerConfig.radio(),
        projector=ProjectorConfig(mm_hidden_size=1280,
                                  hidden_size=cfg.llm.hidden_size))


def vit_dense_calls(rows, d, dff, heads, act):
    """kernels.gemm's calls in one K1 layer over `rows` tokens
    (`ops/vit_block.py::_vit_layer_cuda`): [(dense, m, k, n, epilogue)],
    epilogue the keyword arguments of `kernels.gemm` besides the bias
    (which every call has; "residual" True for a residual)."""
    return [("q_proj", rows, d, d, {"scale": 1.0 / math.sqrt(d // heads)}),
            ("k_proj", rows, d, d, {}), ("v_proj", rows, d, d, {}),
            ("out_proj", rows, d, d, {"residual": True}),
            ("fc1", rows, d, dff, {"act": act}),
            ("fc2", rows, dff, d, {"residual": True})]


def hiera_dense_calls(bt, hw, din, dout, ws, pool, hidden):
    """kernels.gemm's calls in one K4 block on [bt, hw, hw, din]
    (`ops/hiera_block.py::_hiera_block_cuda`): the shortcut projection
    where the width changes, qkv over the window-padded map, proj with the
    (pooled) shortcut, the erf-GELU MLP (`hidden` wide); as
    `vit_dense_calls`."""
    ho = hw // 2 if pool else hw
    wp = -(-hw // ws) * ws if ws else hw
    calls = [("proj", bt * hw * hw, din, dout, {})] if din != dout else []
    return calls + [
        ("qkv", bt * wp * wp, din, 3 * dout, {}),
        ("proj_attn", bt * ho * ho, dout, dout, {"residual": True}),
        ("mlp fc1", bt * ho * ho, dout, hidden, {"act": "gelu"}),
        ("mlp fc2", bt * ho * ho, hidden, dout, {"residual": True})]


def dense_cases(cfg):
    """Every distinct dense call `kernels.gemm` gets on the main paths:
    K1's six denses at CLIP-L/14-336 and RADIO-H/16-384 over the clip's
    frames, K4's at each block kind of the seg head's Hiera trunk over its
    frames at its image size. Returns [(path, dense, m, k, n, epilogue,
    launches)], launches the count per bf16 query (towers) or per trunk
    pass."""
    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.models.sam2 import hiera
    from video_llava_seg_torch.models.seg_head import make_sam2_cfg

    cases = []
    for name, vc in (("CLIP-L/14-336", cfg.vision),
                     ("RADIO-H/16-384", radio_cfg(cfg).vision)):
        n_tok = (vc.num_patches + int(vc.use_cls_token)
                 + vc.num_register_tokens)
        for call in vit_dense_calls(
                cfg.num_frames * n_tok, vc.hidden_size, vc.intermediate_size,
                vc.num_heads, "gelu" if vc.is_radio else "quick_gelu"):
            cases.append((name, *call, vit.num_layers_run(vc)))
    sc = make_sam2_cfg(cfg.seg)
    hc = sc.hiera
    side = sc.image_size // hc.patch_stride
    trunk, pools = {}, 0
    for din, dout, _, ws, pool in hiera.block_dims(hc):
        for dense, m, k, n, ep in hiera_dense_calls(
                cfg.seg.max_seg_frames, side >> pools, din, dout, ws, pool,
                int(dout * hc.mlp_ratio)):
            key = (dense, m, k, n)
            trunk[key] = (ep, trunk.get(key, (ep, 0))[1] + 1)
        pools += bool(pool)
    for (dense, m, k, n), (ep, count) in trunk.items():
        cases.append((sc.name, dense, m, k, n, ep, count))
    return cases


def link_cases(cfg):
    """Every distinct LayerNorm and 2x2 max-pool call of K1's and K4's
    chains on the main paths (`kernels.layernorm`, `kernels.maxpool2x2`):
    K1's two LayerNorms at CLIP-L/14-336 and RADIO-H/16-384 over the
    clip's frames, K4's norm1 / norm2 and the shortcut pool of its q-pool
    blocks over the trunk's frames at its image size. Returns [(kernel,
    path, shape, launches)], shape (rows, cols) for "layernorm" and (n, h,
    w, c) for "maxpool2x2", launches the count per bf16 query (towers) or
    per trunk pass."""
    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.models.sam2 import hiera
    from video_llava_seg_torch.models.seg_head import make_sam2_cfg

    cases = []
    for name, vc in (("CLIP-L/14-336", cfg.vision),
                     ("RADIO-H/16-384", radio_cfg(cfg).vision)):
        n_tok = (vc.num_patches + int(vc.use_cls_token)
                 + vc.num_register_tokens)
        cases.append(("layernorm", name,
                      (cfg.num_frames * n_tok, vc.hidden_size),
                      2 * vit.num_layers_run(vc)))
    sc = make_sam2_cfg(cfg.seg)
    hc = sc.hiera
    side = sc.image_size // hc.patch_stride
    bt = cfg.seg.max_seg_frames
    trunk, pools = {}, 0
    for din, dout, _, _, pool in hiera.block_dims(hc):
        hw = side >> pools
        ho = hw // 2 if pool else hw
        calls = [("layernorm", (bt * hw * hw, din)),
                 ("layernorm", (bt * ho * ho, dout))]
        if pool:
            calls.append(("maxpool2x2", (bt, hw, hw, dout)))
        for key in calls:
            trunk[key] = trunk.get(key, 0) + 1
        pools += bool(pool)
    for (kernel, shape), count in trunk.items():
        cases.append((kernel, sc.name, shape, count))
    return cases


def hiera_window_kinds(sc):
    """{(ws, pooled, map side): [first block, padded side, dout, heads,
    blocks of the kind]} of the windowed blocks of a SAM2 config's trunk
    at its image size, in block order."""
    from video_llava_seg_torch.models.sam2 import hiera

    dims = hiera.block_dims(sc.hiera)
    side = sc.image_size // sc.hiera.patch_stride
    kinds = {}
    for i, (_, dout, nh, ws, pool) in enumerate(dims):
        hw = side // (2 ** sum(1 for j in range(i) if dims[j][4]))
        if ws:
            kinds.setdefault((ws, pool, hw),
                             [i, -(-hw // ws) * ws, dout, nh, 0])[4] += 1
    return kinds


def k7_kind_check(name, tag, qkv, nh, ws, ps, results):
    """K7 at one window kind: the route asserted to be
    window_attention_sm90.cu, two calls bit-identical, held against
    `window_attention_plain` (fp32) within BOUNDS[name] and timed over 10
    launches back to back and by device time beside window_attention.cu
    (forced by `route`), SDPA over windows partitioned beforehand, the
    partition copy (timed apart) and the plain version. Returns the row
    of times and the partition's inputs (q, k, v)."""
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.window_attention import (
        window_attention,
        window_attention_plain,
    )

    bt, hp, _, c3 = qkv.shape
    dout = c3 // 3
    hd = dout // nh
    q_pool = (2, 2) if ps == 2 else None
    qs, nwr = ws // ps, hp // ws
    n_win = bt * nwr * nwr
    route = kernels.window_entry(hd, ws, ps)
    if route != WINDOW_SM90_ENTRY:
        raise AssertionError(f"K7 at ws {ws}, pool {ps}, head dim {hd} "
                             f"routes to {route}")

    def partition():
        x = qkv.view(bt, nwr, ws, nwr, ws, 3, nh, hd).permute(
            0, 1, 3, 5, 6, 2, 4, 7).reshape(n_win, 3, nh, ws, ws, hd)
        q = x[:, 0]
        if ps == 2:
            q = q.reshape(n_win, nh, qs, 2, qs, 2, hd).amax(dim=(3, 5))
        return (q.reshape(n_win, nh, qs * qs, hd),
                x[:, 1].reshape(n_win, nh, ws * ws, hd),
                x[:, 2].reshape(n_win, nh, ws * ws, hd))

    q, k, v = partition()
    kw = dict(num_heads=nh, ws=ws, scale=hd ** -0.5, ps=ps)
    out_bytes = bt * (hp // ps) ** 2 * dout * 2
    got = window_attention(qkv, num_heads=nh, ws=ws, q_pool=q_pool)
    if not torch.equal(got, window_attention(qkv, num_heads=nh, ws=ws,
                                             q_pool=q_pool)):
        raise AssertionError(f"{name} {tag}: two calls differ")
    del got
    _check(name, tag,
           lambda: window_attention(qkv, num_heads=nh, ws=ws, q_pool=q_pool),
           lambda: window_attention_plain(qkv, **kw),
           lambda: window_attention_plain(qkv.float(), **kw), results,
           (_nbytes(qkv) + out_bytes,
            4 * n_win * nh * qs * qs * ws * ws * hd, PEAK_BF16),
           run_library=lambda: F.scaled_dot_product_attention(q, k, v),
           run_previous=lambda: kernels.window_attention(
               qkv, **kw, route="vls_window_attention"),
           previous="window_attention.cu", train=10, device_time=True)
    r = results[name]["shapes"][-1]
    part_ms = cuda_ms(partition, train=10)
    row = {"shape": tag, "k7_ms": r["ms"], "k7_device_ms": r["device_ms"],
           "bound_ms": r["bound_ms"], "plain_ms": r["plain_ms"],
           "window_attention_cu_ms": r["previous_ms"],
           "window_attention_cu_device_ms": r["previous_device_ms"],
           "sdpa_ms": r["library_ms"],
           "sdpa_device_ms": r["library_device_ms"], "partition_ms": part_ms,
           "keys": ws * ws, "queries": qs * qs}
    return row, (q, k, v)


def phase_k7_checks(cfg, seed, dev, results):
    """K7 at every window kind of the per-op SAM2.1-hiera-small trunk over
    the 8 seg frames (`k7_kind_check`: window_attention_sm90.cu at head
    dim 96, the route asserted, against `window_attention_plain`, beside
    window_attention.cu, SDPA and the partition copy); beside them K4's
    attention stage (partition + [a 2x2 pool of q] + attention_sm90.cu +
    unpartition + crop) and K4's call of the new kernel (the crop written
    directly). Returns the comparison rows."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.models.seg_head import make_sam2_cfg
    from video_llava_seg_torch.ops.hiera_block import attention_stage

    g = torch.Generator(device=dev).manual_seed(seed + 5)
    bt = cfg.seg.max_seg_frames
    rows = []
    for (ws, pool, hw), (i, hp, dout, nh, blocks) in hiera_window_kinds(
            make_sam2_cfg(cfg.seg)).items():
        qkv = torch.randn((bt, hp, hp, 3 * dout), generator=g,
                          device=dev).to(torch.bfloat16)
        ps = 2 if pool else 1
        hd = dout // nh
        kw = dict(num_heads=nh, ws=ws, scale=hd ** -0.5, ps=ps)
        tag = (f"block {i} ws{ws}{' q-pool' if pool else ''} on {hw}^2"
               f"{f' (padded to {hp})' if hp != hw else ''}: qkv "
               f"{list(qkv.shape)} h{nh}")
        row, qkv_win = k7_kind_check("K7", tag, qkv, nh, ws, ps, results)
        oh = hw // ps
        crop = (oh, oh)
        stage = attention_stage(qkv, num_heads=nh, ws=ws, ps=ps)[
            :, :oh, :oh].contiguous()
        new = kernels.window_attention(qkv, **kw, out_hw=crop)
        sync()
        rel = ((new.float() - stage.float()).abs().max()
               / stage.float().abs().max()).item()
        if not math.isfinite(rel) or rel > BOUNDS["K2"]:
            raise AssertionError(f"K4's window call {tag}: the new kernel and "
                                 f"the stage differ by {rel:.3e}")
        del new, stage
        k4_stage_ms = cuda_ms(lambda: attention_stage(
            qkv, num_heads=nh, ws=ws, ps=ps)[:, :oh, :oh].contiguous(),
            train=10)
        k4_new_ms = cuda_ms(lambda: kernels.window_attention(
            qkv, **kw, out_hw=crop), train=10)
        row.update(blocks=blocks, k4_stage_ms=k4_stage_ms,
                   k4_new_ms=k4_new_ms)
        rows.append(row)
        log(f"[k7] {tag}: window_attention_sm90.cu {row['k7_ms']:.4f} ms "
            f"(device {row['k7_device_ms']:.4f}, "
            f"{row['bound_ms'] / row['k7_device_ms']:.3f} of the bound "
            f"{row['bound_ms']:.4f}); window_attention.cu "
            f"{row['window_attention_cu_ms']:.4f} ms; SDPA "
            f"{row['sdpa_ms']:.4f} ms + its partition copy "
            f"{row['partition_ms']:.4f} ms; K4: its old attention stage "
            f"{k4_stage_ms:.4f} ms, the new kernel with the crop "
            f"{k4_new_ms:.4f} ms (they differ by {rel:.2e})")
        del qkv, qkv_win
        torch.cuda.empty_cache()
    per_trunk = {key: sum(row[key] * row["blocks"] for row in rows)
                 for key in ("k7_ms", "bound_ms", "k4_stage_ms", "k4_new_ms",
                             "window_attention_cu_ms")}
    log(f"[k7] per trunk (blocks x kinds): "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_trunk.items()))
    sync()
    return rows


def k7_variant_checks(variant, seed, dev, results, bt: int = 8):
    """K7 at every window kind of SAM2.1-`variant`'s trunk at 1024^2 over
    bt frames (`k7_kind_check`, recorded under K7_hiera_<variant>): the
    kinds as the per-op trunk hands them to K7 (the map padded to whole
    windows), and the sums over a trunk's blocks; then a map whose head 1
    holds inf and NaN at the head dim's ws 8 and its largest window: the
    other heads' output bit-equal to the clean map's. Returns the rows."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.models.sam2.config import sam2_config

    sc = sam2_config(variant)
    name = f"K7_hiera_{variant}"
    kinds = hiera_window_kinds(sc)
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    rows = []
    for (ws, pool, hw), (i, hp, dout, nh, blocks) in kinds.items():
        qkv = torch.randn((bt, hp, hp, 3 * dout), generator=g,
                          device=dev).to(torch.bfloat16)
        ps = 2 if pool else 1
        tag = (f"{sc.name} block {i} (x{blocks}) ws{ws}"
               f"{' q-pool' if pool else ''} on {hw}^2"
               f"{f' (padded to {hp})' if hp != hw else ''}: qkv "
               f"{list(qkv.shape)} h{nh} hd{dout // nh}")
        row, qkv_win = k7_kind_check(name, tag, qkv, nh, ws, ps, results)
        row["blocks"] = blocks
        rows.append(row)
        log(f"[k7] {tag}: window_attention_sm90.cu {row['k7_ms']:.4f} ms "
            f"(device {row['k7_device_ms']:.4f}, "
            f"{row['bound_ms'] / row['k7_device_ms']:.3f} of the bound "
            f"{row['bound_ms']:.4f}); window_attention.cu "
            f"{row['window_attention_cu_ms']:.4f} ms (device "
            f"{row['window_attention_cu_device_ms']:.4f}); SDPA "
            f"{row['sdpa_ms']:.4f} ms (device {row['sdpa_device_ms']:.4f}) "
            f"+ its partition copy {row['partition_ms']:.4f} ms; plain "
            f"{row['plain_ms']:.4f} ms")
        del qkv, qkv_win
        torch.cuda.empty_cache()
    keys = ("k7_ms", "k7_device_ms", "bound_ms", "window_attention_cu_ms",
            "window_attention_cu_device_ms", "sdpa_ms", "sdpa_device_ms",
            "partition_ms", "plain_ms")
    per_trunk = {key: sum(row[key] * row["blocks"] for row in rows)
                 for key in keys}
    n_blocks = sum(r["blocks"] for r in rows)
    log(f"[k7] {sc.name} per trunk of {bt} frames ({n_blocks} windowed "
        f"blocks): " + ", ".join(f"{k} {v:.4f}" for k, v in per_trunk.items())
        + f"; device {per_trunk['bound_ms'] / per_trunk['k7_device_ms']:.3f}"
        f" of the bound")
    hd = dout // nh
    for ws, ps in ((8, 1), (max(w for w, _, _ in kinds), 2)):
        heads, side = 3, 2 * ws
        qkv = torch.randn((1, side, side, 3 * heads * hd), generator=g,
                          device=dev).to(torch.bfloat16)
        bad = qkv.clone().view(1, side, side, 3, heads, hd)
        bad[..., 1, :] = float("nan")
        bad[..., 1, ::2] = float("inf")
        kw = dict(num_heads=heads, ws=ws, scale=hd ** -0.5, ps=ps)
        got = kernels.window_attention(bad.view_as(qkv), **kw)
        want = kernels.window_attention(qkv, **kw)
        sync()
        keep = [0, 2]
        got, want = (t.view(*t.shape[:3], heads, hd)[..., keep, :]
                     for t in (got, want))
        if not torch.isfinite(got).all() or not torch.equal(got, want):
            raise AssertionError(f"{name}: a non-finite head 1 reached heads "
                                 f"0 / 2 at ws {ws}, pool {ps}")
        log(f"[k7] {sc.name} head dim {hd} ws {ws} pool {ps}: head 1 of q / "
            f"k / v inf and NaN, heads 0 and 2 bit-equal to the clean map's")
    sync()
    return rows


def phase_k8_checks(cfg, seed, dev, results):
    """K8 (one W8A8 layer) at the CLIP-L and RADIO-H serving shapes
    against `vit_layer_plain` over the same quantized tree, and gemm_s8
    at each tower's dense shapes (`gemm_s8_checks`). Returns the gemm
    rows."""
    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.ops.quantization import (
        quantize_tree,
        quantized_nbytes,
    )
    from video_llava_seg_torch.ops.vit_block import (
        vit_layer,
        vit_layer_plain,
    )

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    gemm_rows = []
    for name, vc in (("CLIP-L/14-336", cfg.vision),
                     ("RADIO-H/16-384", radio_cfg(cfg).vision)):
        layer = quantize_tree(perturb(vit.init(
            dataclasses.replace(vc, num_layers=1), g, dev, bf)["layers"][0],
            g), 8, act_quant=True)
        n_tok = (vc.num_patches + int(vc.use_cls_token)
                 + vc.num_register_tokens)
        d, dff = vc.hidden_size, vc.intermediate_size
        x = torch.randn((cfg.num_frames, n_tok, d), generator=g,
                        device=dev).to(bf)
        kw = dict(num_heads=vc.num_heads, eps=vc.layernorm_eps, kv_len=n_tok,
                  act="gelu" if vc.is_radio else "quick_gelu")
        rows = cfg.num_frames * n_tok
        # int8 products at the int8 peak, attention's at the bf16 peak,
        # counted in int8-peak time
        ops = (2 * rows * (4 * d * d + 2 * d * dff)
               + 4 * cfg.num_frames * n_tok * n_tok * d
               * PEAK_INT8 / PEAK_BF16)
        _check("K8", f"{name} layer x{list(x.shape)} h{vc.num_heads}",
               lambda: vit_layer(layer, x, **kw),
               lambda: vit_layer_plain(layer, x, **kw),
               lambda: vit_layer_plain(layer, x, **kw), results,
               (2 * _nbytes(x) + quantized_nbytes(layer), ops, PEAK_INT8))
        del x

        gemm_rows += gemm_s8_checks(
            name, layer, vc, rows, cfg.num_frames * vc.num_patches,
            cfg.llm.hidden_size, kw["act"], g, dev, results)
        del layer
        torch.cuda.empty_cache()
    sync()
    return gemm_rows


def phase_attention_links(cfg, seed, dev, results):
    """The attention link of K1's / K8's chain (head dim 64, CLIP-L, and
    80, RADIO-H, over the 577 tokens of 32 frames, kv_len and scale as
    the chain gives them) and of the trunk's global blocks (head dim 96
    over 4,096 keys: K4's attention stage and the per-op trunk's K2),
    through `kernels.attention` as the chains call it: the route asserted
    (attention_sm90.cu), held against attention_reference in fp32 within
    BOUNDS["K2"], timed (10 launches back to back) beside attention.cu's
    online form (forced by `route`, which served these calls before) and
    SDPA on the same views, with each call's bound. Returns the rows, each
    with the link's share of its layer's time in this run (K1, K8 from
    phases 2 and 10)."""
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.models.sam2 import hiera
    from video_llava_seg_torch.models.seg_head import make_sam2_cfg
    from video_llava_seg_torch.ops.attention import attention_reference

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    # the layers' times in this run: K1 at CLIP-L (phase 2), K8 at both
    # towers (phase 10), keyed by the tower's name
    k8_ms = {sh["shape"].split(" ")[0]: sh["ms"]
             for sh in results["K8"]["shapes"]}
    layer_ms = {"CLIP-L/14-336": {"K1": results["K1"]["shapes"][0]["ms"]},
                "RADIO-H/16-384": {}}
    cases = []
    for name, vc in (("CLIP-L/14-336", cfg.vision),
                     ("RADIO-H/16-384", radio_cfg(cfg).vision)):
        n = vc.num_patches + int(vc.use_cls_token) + vc.num_register_tokens
        cases.append((f"K1 / K8 link, {name}", cfg.num_frames, n, n,
                      vc.num_heads, vc.hidden_size // vc.num_heads, n,
                      dict(layer_ms[name], K8=k8_ms[name])))
    sc = make_sam2_cfg(cfg.seg)
    side = sc.image_size // sc.hiera.patch_stride
    pools = 0
    for din, dout, nh, ws, pool in hiera.block_dims(sc.hiera):
        hw = side // (2 ** pools)
        pools += bool(pool)
        if ws == 0:
            sq = (hw // 2) ** 2 if pool else hw * hw
            cases.append(("trunk global block (K4, per-op K2)",
                          cfg.seg.max_seg_frames, sq, hw * hw, nh,
                          dout // nh, -1, {}))
            break
    rows = []
    for tag, bt, sq, skv, h, hd, kv_len, layers in cases:
        # q / k / v as the chains build them: [B, S, H, D] views of the
        # denses' outputs (q pre-scaled, scale 1); the online form, as
        # K1 / K8 / K4 call it and as ops.attention takes > 1024 keys
        q = (torch.randn((bt, sq, h, hd), generator=g, device=dev)
             * hd ** -0.5).to(bf).transpose(1, 2)
        k, v = (torch.randn((bt, skv, h, hd), generator=g,
                            device=dev).to(bf).transpose(1, 2)
                for _ in range(2))
        entry = kernels.attention_entry(hd, False, skv, h)
        if entry != SM90_ENTRY:
            raise AssertionError(f"{tag}: routes to {entry}, not "
                                 f"{SM90_ENTRY}")

        def run(route=None):
            return kernels.attention(q, k, v, scale=1.0, kv_len=kv_len,
                                     route=route)

        want = attention_reference(q.float(), k.float(), v.float(),
                                   scale=1.0)
        rels = {}
        for name, fn in (("kernel", run),
                         ("attention.cu", lambda: run(CUDA_C_ENTRY))):
            got = fn()
            sync()
            rels[name] = ((got.float() - want).abs().max()
                          / want.abs().max()).item()
            if not math.isfinite(rels[name]) or rels[name] > BOUNDS["K2"]:
                raise AssertionError(f"{tag} ({name}): rel err "
                                     f"{rels[name]:.3e}")
            del got
        del want
        ms = cuda_ms(run, train=10)
        prev_ms = cuda_ms(lambda: run(CUDA_C_ENTRY), train=10)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0), train=10)
        ms2 = cuda_ms(run, train=10)
        b_ms, b_by = bound_of(_nbytes(q, k, v, q),
                              4 * bt * h * sq * skv * hd, PEAK_BF16)
        row = {"link": tag, "shape": f"q{list(q.shape)} kv{list(k.shape)}",
               "entry": entry, "ms": ms, "ms_again": ms2,
               "previous_ms": prev_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
               "rel_err": rels,
               "share_of_layer": {n: ms / t for n, t in layers.items()}}
        rows.append(row)
        log(f"[link] {tag} {row['shape']} on {entry}: {ms:.4f} ms, again "
            f"{ms2:.4f} ({b_ms / ms:.3f} of the bound), attention.cu "
            f"{prev_ms:.4f} ms ({prev_ms / ms:.1f}x), SDPA {lib_ms:.4f} ms "
            f"({ms / lib_ms:.2f}x of it), bound {b_ms:.4f} ms ({b_by}), "
            "rel err "
            + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
            + "".join(f", {x:.3f} of the {n} layer ({layers[n]:.4f} ms)"
                      for n, x in row["share_of_layer"].items()))
        del q, k, v
        torch.cuda.empty_cache()
    sync()
    return rows


def phase_dense_checks(cfg, seed, dev, results):
    """gemm_bf16 (every dense of K1 and K4) at each distinct main-path
    shape with its epilogue (`dense_cases`): the route `gemm_bf16_entry`
    names asserted (gemm_bf16_sm90.cu), the kernel and gemm_bf16.cu
    (forced by `route`) held against `gemm_plain` within
    BOUNDS["gemm_bf16"], timed (10 launches back to back) beside
    gemm_bf16.cu and `torch.addmm(bias, a, b)` (the product and the bias
    alone: the library yardstick), with the call's bound. Returns the rows
    for the vision-slice JSON."""
    from video_llava_seg_torch import kernels

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    rows = []
    for path, dense, m, k, n, ep, launches in dense_cases(cfg):
        a = torch.randn((m, k), generator=g, device=dev).to(bf)
        b = (torch.randn((k, n), generator=g, device=dev) * k ** -0.5).to(bf)
        bias = (torch.randn(n, generator=g, device=dev) * 0.1).to(bf)
        res = (torch.randn((m, n), generator=g, device=dev).to(bf)
               if ep.get("residual") else None)
        kw = dict(residual=res, scale=ep.get("scale", 1.0),
                  act=ep.get("act", "none"))
        entry = kernels.gemm_bf16_entry(m, k, n)
        if entry != GEMM_SM90_ENTRY:
            raise AssertionError(f"gemm_bf16 {path} {dense}: routed to "
                                 f"{entry}")
        want = kernels.gemm_plain(a, b, bias, **kw)
        old = kernels.gemm(a, b, bias, route="vls_gemm_bf16", **kw)
        sync()
        rel_old = ((old.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
        if not math.isfinite(rel_old) or rel_old > BOUNDS["gemm_bf16"]:
            raise AssertionError(f"gemm_bf16 {path} {dense}: gemm_bf16.cu "
                                 f"rel err {rel_old:.3e}")
        del want, old
        mode = ", ".join(["bias"] + [f"{key} {v:.4g}" if key == "scale"
                                     else v if key == "act" else key
                                     for key, v in ep.items()])
        tag = f"{path} {dense} [{m}, {k}] x [{k}, {n}] {mode}"
        nbytes = _nbytes(a, b, bias) + m * n * 2 * (1 + (res is not None))
        _check("gemm_bf16", tag,
               lambda: kernels.gemm(a, b, bias, **kw),
               lambda: kernels.gemm_plain(a, b, bias, **kw),
               lambda: kernels.gemm_plain(a, b, bias, **kw), results,
               (nbytes, 2 * m * k * n, PEAK_BF16),
               run_library=lambda: torch.addmm(bias, a, b),
               run_previous=lambda: kernels.gemm(a, b, bias,
                                                 route="vls_gemm_bf16",
                                                 **kw),
               previous="gemm_bf16.cu", train=10)
        r = results["gemm_bf16"]["shapes"][-1]
        r.update(launches=launches, previous_rel_err=rel_old)
        rows.append({"path": path, "dense": dense, "m": m, "k": k, "n": n,
                     "epilogue": mode, "launches": launches,
                     "ms": r["ms"], "gemm_bf16_cu_ms": r["previous_ms"],
                     "addmm_ms": r["library_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "max_abs_err": r["max_abs_err"],
                     "previous_rel_err": rel_old})
        del a, b, bias, res
        torch.cuda.empty_cache()
    sync()
    return rows


def rotated_device_ms(runs, inputs, l2_multiple: int = 4):
    """{name: device ms of one call} of each `runs[name](x)` over copies of
    the inputs `inputs()` makes, enough that their bytes exceed
    l2_multiple x the L2 (so each call reads its input from device memory,
    as on the main path, where the input was written long before): one
    CUDA graph of a call on each copy, timed in turns (`in_turns`); the
    outputs stay alive until the graph is gone, so they rotate too."""
    first = inputs()
    size = sum(_nbytes(t) for t in first)
    copies = [first] + [inputs() for _ in range(
        max(1, math.ceil(l2_multiple * L2_BYTES / size)) - 1)]
    keep = []
    out = in_turns({name: [lambda c=c, fn=fn: keep.append(fn(*c))
                           for c in copies] for name, fn in runs.items()})
    keep.clear()
    del copies, first
    torch.cuda.empty_cache()
    return out


def ln_bound(x, gamma, beta, eps, want):
    """The LayerNorm kernels' bound per element: one bf16 step of the
    plain output `want` (the kernel and the plain twin compute the same
    fp32 value up to the sums' order and contractions, so their roundings
    to bf16 differ by at most a step, near a rounding boundary), plus
    2^-20 of the affine's terms |x_hat * gamma| + |beta| for an element
    they cancel to near zero (a few fp32 roundings of terms that size)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(
        (xf - mean).square().mean(dim=-1, keepdim=True) + eps)
    mag = (xhat * gamma.float()).abs() + beta.float().abs()
    step = torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp_min(2.0 ** -126))) - 7)
    return step + 2.0 ** -20 * mag


# the row streams' ragged shapes besides the main path's: one row, fewer
# rows than a stage, a multiple of a stage plus one (96 columns: 64-row
# tiles; 1280: 8-row tiles), an odd number of output rows, odd sides
LINK_RAGGED = [("layernorm", (1, 96)), ("layernorm", (5, 96)),
               ("layernorm", (64 * 37 + 1, 96)), ("layernorm", (7, 1280)),
               ("layernorm", (8 * 2309 + 1, 1280)),
               ("maxpool2x2", (2, 6, 10, 192)),
               ("maxpool2x2", (3, 7, 9, 384)),
               ("maxpool2x2", (8, 130, 258, 192))]


def phase_link_checks(cfg, seed, dev, results):
    """The LayerNorms of K1 and K4 (layernorm_sm90.cu) and K4's shortcut
    pool (pool_sm90.cu) at every main-path shape (`link_cases`) and at
    the ragged ones (LINK_RAGGED): the route asserted, the LayerNorm held
    to its plain twin element by element (`ln_bound`) and layernorm.cu
    (forced by `route`) within 2e-2 relative, the pool and pool.cu bit-
    equal to the plain twin. At the main-path shapes, timed over 10
    launches back to back and by device time over input copies rotated
    past the L2 (`rotated_device_ms`), beside the old kernel and
    `F.layer_norm` / `F.max_pool2d` (the NHWC map's channels-last view),
    with the byte bound (input read once, output written once). Returns
    the `[links]` rows."""
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops import nn
    from video_llava_seg_torch.ops.hiera_block import max_pool_2x2

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    eps = 1e-6
    main = [(k, p, sh, n) for k, p, sh, n in link_cases(cfg)]
    rows = []
    for kernel, path, shape, launches in main + [
            (k, "ragged", sh, 0) for k, sh in LINK_RAGGED]:
        timed = path != "ragged"
        if kernel == "layernorm":
            cols = shape[1]

            def inputs(shape=shape, cols=cols):
                return (3 * torch.randn(shape, generator=g, device=dev)
                        + 0.5).to(bf),

            (x,) = inputs()
            gam = torch.randn(cols, generator=g, device=dev).to(bf)
            bet = torch.randn(cols, generator=g, device=dev).to(bf)
            entry = kernels.layernorm_entry(*shape)
            want_entry, old_entry = LAYERNORM_SM90_ENTRY, "vls_layernorm_bf16"

            def run(x, route=None, gam=gam, bet=bet):
                return kernels.layernorm(x, gam, bet, eps, route=route)

            def plain(x, gam=gam, bet=bet):
                return nn.layer_norm({"scale": gam, "bias": bet}, x, eps)

            def library(x, gam=gam, bet=bet, cols=cols):
                return F.layer_norm(x, (cols,), gam, bet, eps)

            got, old = run(x), run(x, old_entry)
            want = nn.layer_norm({"scale": gam, "bias": bet}, x.float(), eps)
            sync()
            excess = ((got.float() - want).abs()
                      - ln_bound(x, gam, bet, eps, want)).max().item()
            rel_old = ((old.float() - want).abs().max()
                       / want.abs().max()).item()
            if not excess <= 0 or not rel_old <= 2e-2:
                raise AssertionError(
                    f"layernorm {list(shape)}: {excess:.3e} past the "
                    f"element bound, layernorm.cu rel err {rel_old:.3e}")
            nbytes = 2 * _nbytes(x) + _nbytes(gam, bet)
            reference = lambda: want  # noqa: E731
        else:
            def inputs(shape=shape):
                return torch.randn(shape, generator=g, device=dev).to(bf),

            (x,) = inputs()
            entry = kernels.maxpool_entry(*shape)
            want_entry, old_entry = MAXPOOL_SM90_ENTRY, "vls_maxpool2x2_bf16"

            def run(x, route=None):
                return kernels.maxpool2x2(x, route=route)

            plain = max_pool_2x2

            def library(x):
                return F.max_pool2d(x.permute(0, 3, 1, 2), 2)

            got, want = run(x), max_pool_2x2(x)
            even = shape[1] % 2 == 0 and shape[2] % 2 == 0
            old = run(x, old_entry) if even else want
            sync()
            if not torch.equal(got, want) or not torch.equal(old, want):
                raise AssertionError(f"maxpool2x2 {list(shape)}: not bit-"
                                     "equal to max_pool_2x2 (pool_sm90.cu "
                                     f"{torch.equal(got, want)}, pool.cu "
                                     f"{torch.equal(old, want)})")
            nbytes = _nbytes(x) + _nbytes(got)
            reference = lambda: want  # noqa: E731
        if entry != want_entry:
            raise AssertionError(f"{kernel} {list(shape)}: routes to "
                                 f"{entry}, not {want_entry}")
        if not torch.equal(run(x), got):
            raise AssertionError(f"{kernel} {list(shape)}: two calls differ")
        del got, old
        if not timed:
            log(f"[check] {kernel} {list(shape)} (ragged) on {entry}: "
                "within its bound")
            continue
        tag = f"{path} {list(shape)}"
        _check(kernel, tag, lambda: run(x), lambda: plain(x), reference,
               results, (nbytes, 0, PEAK_BF16),
               run_library=lambda: library(x),
               run_previous=lambda: run(x, old_entry),
               previous=old_entry, train=10)
        del want
        dev_ms = rotated_device_ms(
            {"device_ms": run,
             "previous_device_ms": lambda x: run(x, old_entry),
             "library_device_ms": library}, inputs)
        r = results[kernel]["shapes"][-1]
        r.update(dev_ms, launches=launches)
        row = {"kernel": kernel, "path": path, "shape": list(shape),
               "entry": entry, "launches": launches, "ms": r["ms"],
               "previous": old_entry, "previous_ms": r["previous_ms"],
               "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
               **dev_ms}
        rows.append(row)
        b = r["bound_ms"]
        d_ms = dev_ms["device_ms"]
        per = "trunk" if path.startswith("sam2") else "bf16 query"
        log(f"[links] {kernel} {tag} on {entry}: device {d_ms:.4f} ms "
            f"({b / d_ms:.3f} of the bound), 10 back to back "
            f"{r['ms']:.4f} ms; {old_entry} device "
            f"{dev_ms['previous_device_ms']:.4f} / {r['previous_ms']:.4f} "
            f"ms; library device {dev_ms['library_device_ms']:.4f} / "
            f"{r['library_ms']:.4f} ms; byte bound {b:.4f} ms; "
            f"{launches} a {per}")
        del x
        torch.cuda.empty_cache()
    rows += w8a8_row_times(cfg, g, dev, results)
    sync()
    return rows


# K8's row quantizers at ragged shapes besides the main path's (8-row
# tiles at these widths): one row, fewer rows than a tile, a multiple of a
# tile plus one; gamma / beta in fp32 (a tree stored in fp32) or bf16
QUANT_ROWS_RAGGED = [("ln_quant_rows", (1, 1024), torch.bfloat16),
                     ("ln_quant_rows", (5, 1280), torch.float32),
                     ("ln_quant_rows", (8 * 37 + 1, 1280), torch.bfloat16),
                     ("ln_quant_rows", (8 * 2309 + 1, 1024), torch.float32),
                     ("quant_rows", (1, 5120), None),
                     ("quant_rows", (3, 1024), None),
                     ("quant_rows", (8 * 11 + 1, 4096), None),
                     ("quant_rows", (8 * 2309 + 1, 1280), None)]
# ln_quant_rows against its twin, the criteria of
# tests/test_torch_kernels_cuda.py::test_quant_rows_bit_exact: the norm
# sums in another order, so a bf16 value may move by one step, and at an
# int8 rounding boundary its code by one
QUANT_ROWS_LN_STEPS = 1
QUANT_ROWS_LN_FRACTION = 1e-3
QUANT_ROWS_LN_SCALE_RTOL = 1e-2


def w8a8_row_cases(cfg):
    """K8's row quantizer calls in a W8A8 encode of CLIP-L and RADIO-H:
    [(fn, tower, (rows, cols), launches an encode)]: `ln_quant_rows` over
    the tower's tokens (twice a layer), `quant_rows` over the attention
    output and over fc1's (once a layer each)."""
    from video_llava_seg_torch.models import vit

    out = []
    for name, vc in (("CLIP-L/14-336", cfg.vision),
                     ("RADIO-H/16-384", radio_cfg(cfg).vision)):
        m = cfg.num_frames * (vc.num_patches + int(vc.use_cls_token)
                              + vc.num_register_tokens)
        d, dff = vc.hidden_size, vc.intermediate_size
        layers = vit.num_layers_run(vc)
        out += [("ln_quant_rows", name, (m, d), 2 * layers),
                ("quant_rows", name, (m, d), layers),
                ("quant_rows", name, (m, dff), layers)]
    return out


def quant_rows_agree(tag, fn, got, want):
    """Hold a row quantizer's (q, scale) to its twin's: `quant_rows`
    bit-equal, `ln_quant_rows` within QUANT_ROWS_LN_STEPS int8 steps with
    under QUANT_ROWS_LN_FRACTION of the elements differing and the scales
    within QUANT_ROWS_LN_SCALE_RTOL. Returns (max step, fraction of the
    elements differing, max relative scale error)."""
    (q, s), (wq, ws) = got, want
    steps = (q.int() - wq.int()).abs().max().item()
    frac = (q != wq).float().mean().item()
    srel = ((s - ws).abs() / ws.abs()).max().item()
    if fn == "quant_rows":
        ok = torch.equal(q, wq) and torch.equal(s, ws)
    else:
        ok = (steps <= QUANT_ROWS_LN_STEPS and frac < QUANT_ROWS_LN_FRACTION
              and srel <= QUANT_ROWS_LN_SCALE_RTOL)
    if not ok:
        raise AssertionError(f"{tag}: off its twin (max step {steps}, "
                             f"{frac:.3e} of the elements differ, scale "
                             f"rel err {srel:.3e})")
    return steps, frac, srel


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout
    return float(out.split()[0]) * 1e6


def w8a8_row_times(cfg, g, dev, results):
    """K8's row quantizers at CLIP-L's and RADIO-H's shapes
    (`w8a8_row_cases`) and at QUANT_ROWS_RAGGED on w8a8_rows_sm90.cu (the
    route asserted): held to their twin (`kernels.quant_rows_plain`;
    `quant_rows_agree`), two calls bit-identical. At the main-path shapes,
    with gamma / beta in bf16 as the tree stores them: timed over 10
    launches back to back and by device time over rotated inputs beside
    w8a8.cu (forced by `route`, fp32 gamma / beta as it takes them), the
    plain twin timed once a call, with the byte bound (bf16 read; int8
    and an fp32 scale a row written; gamma and beta read once) and the
    instruction bound (the instance's SASS instructions a lane-element,
    `row_sass_per_element`, over 4 warp instructions a clock on every SM
    at the card's highest clock). Adds results["quant_rows"]; returns the
    `[links]` rows."""
    from video_llava_seg_torch import kernels

    bf = torch.bfloat16
    eps = 1e-6
    old = "vls_quant_rows"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_hz()
    rows = []
    r = results.setdefault("quant_rows", {
        "max_abs_err": 0, "frac_differing": 0.0, "scale_rel_err": 0.0,
        "ms": 0.0, "plain_ms": 0.0, "previous_ms": 0.0, "bound_ms": 0.0,
        "device_ms": 0.0, "previous_device_ms": 0.0,
        "instruction_bound_ms": 0.0,
        "shapes": []})
    cases = ([(fn, tower, shape, n, bf)
              for fn, tower, shape, n in w8a8_row_cases(cfg)]
             + [(fn, "ragged", shape, 0, gdt)
                for fn, shape, gdt in QUANT_ROWS_RAGGED])
    for fn, path, shape, launches, gdt in cases:
        m, cols = shape
        ln = fn == "ln_quant_rows"

        def inputs(shape=shape):
            return (3 * torch.randn(shape, generator=g, device=dev)
                    + 0.5).to(bf),

        (x,) = inputs()
        gam = bet = None
        if ln:
            gam = (torch.rand(cols, generator=g, device=dev) + 0.5).to(gdt)
            bet = (0.1 * torch.randn(cols, generator=g, device=dev)).to(gdt)

        def run(x, route=None, gam=gam, bet=bet, ln=ln):
            if ln:
                return kernels.ln_quant_rows(x, gam, bet, eps, route=route)
            return kernels.quant_rows(x, route=route)

        def plain(x, gam=gam, bet=bet):
            return kernels.quant_rows_plain(x, gam, bet, eps)

        entry = kernels.quant_rows_entry(m, cols, ln)
        if entry != QUANT_ROWS_SM90_ENTRY:
            raise AssertionError(f"{fn} {list(shape)}: routes to {entry}, "
                                 f"not {QUANT_ROWS_SM90_ENTRY}")
        tag = f"{fn} {path} {list(shape)}"
        got = run(x)
        steps, frac, srel = quant_rows_agree(tag, fn, got, plain(x))
        again = run(x)
        sync()
        if not (torch.equal(again[0], got[0])
                and torch.equal(again[1], got[1])):
            raise AssertionError(f"{tag}: two calls differ")
        del got, again
        r["max_abs_err"] = max(r["max_abs_err"], steps)
        r["frac_differing"] = max(r["frac_differing"], frac)
        r["scale_rel_err"] = max(r["scale_rel_err"], srel)
        if path == "ragged":
            log(f"[check] {tag} on {entry}, gamma {gdt}: max step {steps}, "
                f"{frac:.2e} of the elements differ, scale rel err "
                f"{srel:.2e}; two calls bit-identical")
            continue
        gam32 = None if gam is None else gam.float()
        bet32 = None if bet is None else bet.float()

        def run_old(x, gam32=gam32, bet32=bet32, ln=ln):
            if ln:
                return kernels.ln_quant_rows(x, gam32, bet32, eps, route=old)
            return kernels.quant_rows(x, route=old)

        ms = cuda_ms(lambda: run(x), train=10)
        prev_ms = cuda_ms(lambda: run_old(x), train=10)
        plain_ms = cuda_ms(lambda: plain(x), reps=3)
        del x
        dev_ms = rotated_device_ms(
            {"device_ms": run, "previous_device_ms": run_old}, inputs)
        nbytes = 3 * m * cols + 4 * m + (_nbytes(gam, bet) if ln else 0)
        b_ms, _ = bound_of(nbytes, 0, PEAK_BF16)
        plan = kernels.quant_rows_sm90_plan(m, cols, ln, sms)
        kern = (f"quant_rows_sm90_kernel<{plan.vecs}, "
                f"{str(ln).lower()}, false>")
        ipe = row_sass_per_element(kern)
        instr_ms = m * cols * ipe / 32 / (sms * 4 * clock) * 1e3
        d_ms = dev_ms["device_ms"]
        row = {"kernel": fn, "path": path, "shape": [m, cols],
               "entry": entry, "launches": launches, "ms": ms,
               "previous": old, "previous_ms": prev_ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": "bytes",
               "instruction_bound_ms": instr_ms, "sass_per_element": ipe,
               "instance": kern, "max_step": steps,
               "frac_differing": frac, **dev_ms}
        rows.append(row)
        r["shapes"].append(row)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("previous_ms", prev_ms), ("bound_ms", b_ms),
                         ("device_ms", d_ms),
                         ("instruction_bound_ms", instr_ms),
                         ("previous_device_ms",
                          dev_ms["previous_device_ms"])):
            r[key] += val
        log(f"[links] {tag} on {entry}: device {d_ms:.4f} ms "
            f"({b_ms / d_ms:.3f} of the byte bound), 10 back to back "
            f"{ms:.4f} ms; w8a8.cu device "
            f"{dev_ms['previous_device_ms']:.4f} / {prev_ms:.4f} ms; plain "
            f"{plain_ms:.4f} ms; byte bound {b_ms:.4f} ms, instruction bound "
            f"{instr_ms:.4f} ms ({ipe:.2f} SASS instructions a "
            f"lane-element of {kern}); {launches} a W8A8 encode; max step "
            f"{steps}, {frac:.2e} differing")
        torch.cuda.empty_cache()
    return rows


def gemm_s8_checks(name, layer, vc, rows, proj_rows, hidden, act, g, dev,
                   results):
    """gemm_s8 at the six denses of one tower's W8A8 layer as the layer
    runs them (dense mode, `rows` activation rows), at fc1 in int32 mode
    and at the projector's second dense (int32 over the tower's
    `proj_rows` patch rows, `hidden` wide, as `int_matmul` runs it):
    csrc/w8a8_sm90.cu (the route `gemm_s8_entry` names) bit-equal to
    w8a8.cu (forced by `route`) and to `gemm_s8_plain`, timed beside both
    and, in int32 mode, `torch._int_mm`. Launches per W8A8 encode: each
    layer dense once per tower layer, the projector's two int32 denses
    once. Returns the rows for the vision-slice JSON."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.ops.int4 import gemm_s8_plain, int_matmul_plain

    bf = torch.bfloat16
    d, dff = vc.hidden_size, vc.intermediate_size
    n_layers = vit.num_layers_run(vc)
    cases = [  # (dense, K, N, dense-mode epilogue or None, per encode)
        ("q_proj", d, d, dict(scale=1.0 / math.sqrt(d // vc.num_heads)),
         n_layers),
        ("k_proj", d, d, {}, n_layers), ("v_proj", d, d, {}, n_layers),
        ("out_proj", d, d, dict(residual=True), n_layers),
        ("fc1", d, dff, dict(act=act), n_layers),
        ("fc2", dff, d, dict(residual=True), n_layers),
        ("fc1", d, dff, None, 0),
        ("projector.layers[1]", hidden, hidden, None, 1)]
    out = []
    for dense, k, n, ep, per_encode in cases:
        m = rows if dense in layer else proj_rows
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        if dense in layer:
            b = layer[dense]["kernel_qa"]
        else:
            b = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                              dtype=torch.int8)
        args, kw = (), {}
        nbytes = _nbytes(a, b) + m * n * (4 if ep is None else 2)
        if ep is not None:
            a_s = torch.rand(m, 1, generator=g, device=dev) * 2e-3 + 1e-4
            w_s = layer[dense]["kernel_scale"].float().contiguous()
            bias = layer[dense]["bias"].to(bf).contiguous()
            res = (torch.randn((m, n), generator=g, device=dev).to(bf)
                   if ep.get("residual") else None)
            args = (a_s, w_s)
            kw = dict(bias=bias, residual=res, scale=ep.get("scale"),
                      act=ep.get("act", "none"))
            nbytes += _nbytes(a_s, w_s, bias) + (
                0 if res is None else _nbytes(res))
        entry = kernels.gemm_s8_entry(m, k, n)
        if entry != "vls_gemm_s8_sm90":
            raise AssertionError(f"gemm_s8 {name} {dense}: routed to {entry}")
        got = kernels.gemm_s8(a, b, *args, **kw)
        old = kernels.gemm_s8(a, b, *args, route="vls_gemm_s8", **kw)
        if got.dtype != old.dtype or not torch.equal(got, old):
            raise AssertionError(f"gemm_s8 {name} {dense}: w8a8_sm90.cu and "
                                 "w8a8.cu differ")
        if ep == {} and not torch.equal(got, (int_matmul_plain(a, b).float()
                                              * a_s * w_s).to(bf) + bias):
            raise AssertionError(f"gemm_s8 {name} {dense}: dense epilogue "
                                 "not bit-equal to nn.dense's")
        del got, old
        if ep is None:
            mode = "int32"
        else:
            mode = ("dense: bias" + (", q scale" if "scale" in ep else "")
                    + (f", {ep['act']}" if "act" in ep else "")
                    + (", residual" if "residual" in ep else ""))
        tag = f"{name} {dense} [{m}, {k}] x [{k}, {n}] {mode} ({entry})"
        b_cm = b.t().contiguous().t() if ep is None else None
        _check("gemm_s8", tag,
               lambda: kernels.gemm_s8(a, b, *args, **kw),
               lambda: gemm_s8_plain(a, b, *args, **kw),
               lambda: gemm_s8_plain(a, b, *args, **kw), results,
               (nbytes, 2 * m * k * n, PEAK_INT8),
               run_library=(None if b_cm is None
                            else lambda: torch._int_mm(a, b_cm)),
               run_previous=lambda: kernels.gemm_s8(a, b, *args,
                                                    route="vls_gemm_s8",
                                                    **kw),
               previous="w8a8.cu", train=10)
        r = results["gemm_s8"]["shapes"][-1]
        r["launches_per_encode"] = per_encode
        out.append({"shape": tag, "ms": r["ms"],
                    "w8a8_cu_ms": r["previous_ms"],
                    "int_mm_ms": r["library_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "launches_per_encode": per_encode})
        del a, b, b_cm, args, kw
        torch.cuda.empty_cache()
    return out


# relative error of W8A8 slow features against the bf16 tower's, |q -
# bf| / std(bf) (bench.py's int8 leg); the JAX package's own measurement
# of the same random-weight CLIP-L tower is mean 0.0145, p99 0.048
# (BENCH_DETAIL.json); measured here on an H100 (700 W): mean 0.022 /
# 0.024, p99 0.075 / 0.077 (CLIP-L / RADIO-H, perturbed norms and
# biases); the bounds keep ~2-3x of that
W8A8_ERR_BOUNDS = {"mean": 0.05, "p99": 0.25}


def wall_seconds(fns, reps: int = 7):
    """Host-clock seconds of each of `fns`, synchronised around every
    call, the calls interleaved over `reps` rounds so that a drift of the
    card's clock or of the host's load falls on all of them alike. Per fn:
    median, min and max."""
    times = [[] for _ in fns]
    for _ in range(reps):
        for t, fn in zip(times, fns):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            t.append(time.perf_counter() - t0)
    return [{"median": statistics.median(t), "min": min(t), "max": max(t),
             "reps": reps} for t in times]


def fmt_wall(st) -> str:
    return (f"{st['median']:.4f} s (min {st['min']:.4f}, max "
            f"{st['max']:.4f}, {st['reps']} reps)")


def phase_w8a8_encode(cfg, seed, dev):
    """`llava.encode_video` on `quantize_tree(bits=8, act_quant=True)` of
    tower + projector (bench.py config 3's int8 leg), CLIP-L and RADIO-H,
    against the bf16 tower's features; launch counts of the W8A8 call.
    Returns ({tower: counts, tower_gemm_s8: gemm_s8 launches by route,
    tower_quant_rows: the row quantizers' by route}, {tower: summary})."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.inference.utils import clip_preprocess_frames
    from video_llava_seg_torch.models import llava, projector, vit
    from video_llava_seg_torch.ops.quantization import quantize_tree

    bf = torch.bfloat16
    counts_by, out = {}, {}
    frames, _, _ = _smoke_inputs(seed, cfg.num_frames, (480, 854), 1)
    for name, c in (("clip", cfg), ("radio", radio_cfg(cfg))):
        g = torch.Generator(device=dev).manual_seed(seed + 7)
        params = {"vision_tower": perturb(vit.init(c.vision, g, dev, bf), g),
                  "mm_projector": projector.init(c.projector, g, dev, bf)}
        params_q = quantize_tree(params, bits=8, act_quant=True)
        video = clip_preprocess_frames(torch.from_numpy(frames).to(dev),
                                       c.vision.image_size)[None].to(bf)
        llava.encode_video(params_q, c, video)        # warm-up
        s_bf, _ = llava.encode_video(params, c, video)
        sync()
        reset_launches()
        kernels.GEMM_S8_LAUNCHES.reset()
        s_q, _ = llava.encode_video(params_q, c, video)
        sync()
        counts = snapshot_launches()
        gemm_counts = kernels.GEMM_S8_LAUNCHES.snapshot()
        t_q, t_bf = wall_seconds(
            [lambda: llava.encode_video(params_q, c, video),
             lambda: llava.encode_video(params, c, video)])
        n_tower = vit.num_layers_run(c.vision)
        expect = {n: 0 for n in kernels.LaunchCounts.NAMES}
        expect["K8"] = n_tower
        why = {n: "none: the W8A8 encode runs the tower and projector only"
               for n in kernels.LaunchCounts.NAMES}
        why["K8"] = (f"{n_tower} W8A8 tower layers (the projector's "
                     "kernel_qa denses run gemm_s8 through int_matmul, which "
                     "counts nothing)")
        check_launches(f"w8a8-{name}", counts, expect, why)
        # gemm_s8: the six denses of every tower layer and the projector's
        # two kernel_qa denses (int_matmul), all on w8a8_sm90.cu
        n_proj = len(params_q["mm_projector"]["layers"])
        want = {"vls_gemm_s8_sm90": 6 * n_tower + n_proj, "vls_gemm_s8": 0}
        log(f"[w8a8-{name}] gemm_s8 launches by route: {gemm_counts} "
            f"(expected {want}: 6 x {n_tower} layer denses + {n_proj} "
            "projector denses)")
        if gemm_counts != want:
            raise AssertionError(f"W8A8 {name}: gemm_s8 routes {gemm_counts}, "
                                 f"expected {want}")
        counts_by[f"{name}_gemm_s8"] = gemm_counts
        # the row quantizers (asserted by check_launches: 4 a K8 layer on
        # w8a8_rows_sm90.cu, 0 on w8a8.cu)
        counts_by[f"{name}_quant_rows"] = {
            e: counts[e] for e in kernels.QUANT_ROWS_ROUTES}
        log(f"[w8a8-{name}] row quantizers: {2 * n_tower} ln_quant_rows + "
            f"{2 * n_tower} quant_rows on {QUANT_ROWS_SM90_ENTRY} "
            f"({counts[QUANT_ROWS_SM90_ENTRY]} launches), "
            f"{counts['vls_quant_rows']} on w8a8.cu")
        ref = s_bf.float()
        rel = ((s_q.float() - ref).abs() / (ref.std() + 1e-9)).cpu().numpy()
        err = {"mean": float(rel.mean()),
               "p99": float(np.percentile(rel, 99.0))}
        if not (np.isfinite(rel).all() and s_q.shape == s_bf.shape):
            raise AssertionError(f"W8A8 {name}: bad features")
        log(f"[w8a8-{name}] encode_video {list(video.shape)} -> slow "
            f"{list(s_q.shape)}: W8A8 {fmt_wall(t_q)} vs bf16 "
            f"{fmt_wall(t_bf)}; rel "
            f"err vs bf16 mean {err['mean']:.4f} (bound "
            f"{W8A8_ERR_BOUNDS['mean']}), p99 {err['p99']:.4f} (bound "
            f"{W8A8_ERR_BOUNDS['p99']})")
        if any(err[k] > W8A8_ERR_BOUNDS[k] for k in err):
            raise AssertionError(f"W8A8 {name}: features off the bf16 tower")
        counts_by[name] = counts
        out[name] = {"w8a8_seconds": t_q, "bf16_seconds": t_bf,
                     "rel_err": err}
        del params, params_q, video, s_bf, s_q, ref
        torch.cuda.empty_cache()
    sync()
    return counts_by, out


# per-op trunk (cuBLAS denses, plain LayerNorm, K7, K2) vs the K4 chain
# (gemm_bf16, layernorm.cu, attention_sm90.cu; the LayerNorms on
# layernorm_sm90.cu since, within a bf16 step of layernorm.cu's), both bf16
# through 16 blocks:
# max |a - b| / max |b| per pyramid level. The two round every block's
# intermediates to bf16 at other places and the residual stream carries
# it on. Measured on an H100 (700 W): 8.7e-3, 1.2e-2, 2.8e-2, 1.9e-2 by
# level; the bound keeps ~3x over the worst
HIERA_PER_OP_BOUND = 8e-2


def per_op_trunk(sc, frames, seed, dev, tag, timed=False):
    """A SAM2 config's Hiera trunk over `frames` frames at its image size
    with `USE_FUSED_BLOCK = False`: K7 for the windowed blocks (on the
    entries `window_entry` names), K2 for the global ones (head dims 56 /
    72 zero-padded to 64 / 80), no K4, counted by C entry; the pyramid
    against the K4 path's; with `timed` the two trunks' seconds,
    interleaved over 7 rounds. Returns the launches and a summary."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.models.sam2 import hiera

    hc = sc.hiera
    g = torch.Generator(device=dev).manual_seed(seed)
    trunk = perturb(hiera.init(hc, g, dev, torch.bfloat16), g)
    x = torch.randn((frames, sc.image_size, sc.image_size, 3), generator=g,
                    device=dev).to(torch.bfloat16)

    def run(fused):
        saved = hiera.USE_FUSED_BLOCK
        hiera.USE_FUSED_BLOCK = fused
        try:
            outs = hiera.apply(trunk, hc, x)
            sync()
            return outs
        finally:
            hiera.USE_FUSED_BLOCK = saved

    run(False)                                        # warm-up
    want = run(True)
    reset_launches()
    got = run(False)
    counts = snapshot_launches()
    dims = hiera.block_dims(hc)
    n_global = sum(1 for d in dims if d[3] == 0)
    hd = dims[-1][1] // dims[-1][2]
    expect = {n: 0 for n in kernels.LaunchCounts.NAMES}
    expect.update(K7=len(dims) - n_global, K2=n_global)
    why = {n: "none: the per-op trunk runs no other kernel"
           for n in kernels.LaunchCounts.NAMES}
    why.update(K7=f"{len(dims) - n_global} windowed blocks",
               K2=f"{n_global} global blocks ({(sc.image_size // 16) ** 2} "
                  f"keys each, head dim {hd})",
               K4="none: USE_FUSED_BLOCK is off")
    check_launches(tag, counts, expect, why, sc=sc)
    rels = [((a.float() - b.float()).abs().max()
             / b.float().abs().max()).item() for a, b in zip(got, want)]
    out = {"rel_err": rels,
           "launches": {e: counts[e] for e in kernels.WINDOW_ROUTES}}
    if timed:
        out["per_op_seconds"], out["k4_seconds"] = wall_seconds(
            [lambda: run(False), lambda: run(True)])
    log(f"[{tag}] {sc.name}: {len(dims)} blocks over x{list(x.shape)}, "
        f"window launches by C entry {out['launches']}; "
        + (f"per-op {fmt_wall(out['per_op_seconds'])} vs K4 path "
           f"{fmt_wall(out['k4_seconds'])}; " if timed else "")
        + f"pyramid {[list(o.shape) for o in got]} rel err vs the K4 path "
        f"{[f'{r:.3e}' for r in rels]} (bound {HIERA_PER_OP_BOUND:.0e})")
    if not all(math.isfinite(r) and r <= HIERA_PER_OP_BOUND for r in rels):
        raise AssertionError(f"{tag}: the per-op Hiera trunk disagrees with "
                             f"the K4 path")
    del trunk, x, got, want
    torch.cuda.empty_cache()
    sync()
    return counts, out


def phase_hiera_per_op(cfg, seed, dev):
    """Phase 13: the per-op trunk (`per_op_trunk`) of SAM2.1-hiera-small
    over the 8 seg frames, timed against the K4 path (K7 13, K2 3), then
    SAM2.1-hiera-large's over one frame (K7 45 on window_attention_sm90.cu
    at head dim 72, K2 3 padded to 80)."""
    from video_llava_seg_torch.models.sam2.config import sam2_config
    from video_llava_seg_torch.models.seg_head import make_sam2_cfg

    counts, out = per_op_trunk(make_sam2_cfg(cfg.seg),
                               cfg.seg.max_seg_frames, seed + 8, dev,
                               "hiera-per-op", timed=True)
    _, out["hiera_large"] = per_op_trunk(sam2_config("large"), 1, seed + 9,
                                         dev, "hiera-per-op large")
    return counts, out


# tiny towers and trunk, card (kernels, bf16) vs CPU (plain, fp32) on the
# same bf16-rounded weights: each bf16 hand-off costs ~2^-8; the W8A8
# tower's per-row int8 levels move where bf16 and fp32 activations round
# apart, which stays within one quantization step per element. Measured
# on an H100 (700 W): RADIO 6.7e-3, S2 6.5e-3, W8A8 2.2e-2, per-op trunk
# 1.1e-2; ~5x of headroom
TINY_VISION_BOUNDS = {"radio": 5e-2, "s2": 5e-2, "w8a8": 1e-1,
                      "hiera_per_op": 5e-2}


def phase_tiny_vision_agreement(seed):
    """Tiny RADIO tower (16-wide heads of 80: the D = 80 attention), S2
    over a tiny CLIP tower, the W8A8 RADIO tower and the per-op trunk,
    each on the card (kernels) and on the CPU (plain)."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.bridge import cast_tree
    from video_llava_seg_torch.config import (
        VideoLlavaConfig,
        VisionTowerConfig,
    )
    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.models.sam2 import hiera
    from video_llava_seg_torch.models.sam2.config import HieraConfig
    from video_llava_seg_torch.ops.quantization import quantize_tree

    radio = VisionTowerConfig(
        name="radio-tiny", image_size=64, patch_size=16, hidden_size=160,
        intermediate_size=320, num_layers=2, num_heads=2, select_layer=-1,
        use_cls_token=False, is_radio=True, num_register_tokens=1,
        final_norm=True, layernorm_eps=1e-6)
    s2 = dataclasses.replace(VideoLlavaConfig.tiny().vision,
                             s2_scales=(56, 112))
    trunk_cfg = HieraConfig(embed_dim=32, num_heads=1, stages=(1, 2, 2, 1),
                            global_att_blocks=(4,),
                            window_pos_embed_bkg_spatial_size=(7, 7),
                            window_spec=(8, 4, 14, 7))
    r = np.random.default_rng(seed)

    def bf16_rounded(tree):
        return cast_tree(cast_tree(tree, "cpu", torch.bfloat16), "cpu",
                         torch.float32)

    g = torch.Generator().manual_seed(seed)
    radio_p = bf16_rounded(perturb(vit.init(radio, g, "cpu",
                                            torch.float32), g))
    cases = {
        "radio": (lambda p, t: vit.apply(p, radio, t), radio_p,
                  r.random((2, 64, 64, 3)), "K1"),
        "s2": (lambda p, t: vit.apply_s2(p, s2, t),
               bf16_rounded(perturb(vit.init(s2, g, "cpu", torch.float32),
                                    g)),
               r.standard_normal((2, 112, 112, 3)), "K1"),
        "w8a8": (lambda p, t: vit.apply(p, radio, t),
                 quantize_tree(radio_p, 8, act_quant=True, min_size=0),
                 r.random((2, 64, 64, 3)), "K8"),
        "hiera_per_op": (lambda p, t: hiera.apply(p, trunk_cfg, t)[-1],
                         bf16_rounded(perturb(hiera.init(
                             trunk_cfg, g, "cpu", torch.float32), g)),
                         r.standard_normal((1, 288, 288, 3)), "K7"),
    }
    rels = {}
    saved = hiera.USE_FUSED_BLOCK
    hiera.USE_FUSED_BLOCK = False
    try:
        for name, (fn, params, x, kname) in cases.items():
            x = torch.from_numpy(x.astype(np.float32))
            want = fn(params, x)
            before = kernels.LAUNCHES.snapshot()[kname]
            got = fn(cast_tree(params, "cuda", torch.bfloat16),
                     x.cuda().to(torch.bfloat16)).float().cpu()
            sync()
            if kernels.LAUNCHES.snapshot()[kname] <= before:
                raise AssertionError(f"tiny {name}: {kname} not launched")
            rels[name] = ((got - want).abs().max()
                          / want.abs().max()).item()
            log(f"[agree] tiny {name} {list(got.shape)}: card bf16 kernels "
                f"({kname}) vs CPU fp32 plain: rel err {rels[name]:.3e} "
                f"(bound {TINY_VISION_BOUNDS[name]:.0e})")
            if not (got.shape == want.shape
                    and rels[name] <= TINY_VISION_BOUNDS[name]):
                raise AssertionError(f"tiny {name}: kernels disagree with "
                                     "plain")
    finally:
        hiera.USE_FUSED_BLOCK = saved
    return rels


# ---------------------------------------------------------------------------
# the SAM2 image slice: SAM2ImagePredictor and the automatic mask generator
# ---------------------------------------------------------------------------

# the JAX bench's config 1: SAM2.1-hiera-tiny, one 1024^2-resized image
SAM2_IMAGE_VARIANT = "tiny"
# a non-square frame: the antialiased resize down to 1024^2 and the masks'
# resize back both run
SAM2_IMAGE_HW = (1080, 1920)
# the automatic mask generator's frame (a square one: the grid's points
# fall on whole pixels of the 1024^2 model frame)
AMG_HW = (1024, 1024)
# With IoU and stability thresholds 0 every mask survives to the host's
# numpy filters, NMS and RLE (3 a point), which took 76.4 s of the 84.0 s
# run at the default 32 x 32 points and 62.3 s of the crop pass at 8 x 8
# points a crop (a full run on an H100 80GB HBM3 host, 700 W). The
# thresholds-0 run takes a 16 x 16 grid (4 batches of 64) and the crop
# pass (crop_n_layers=1, 5 crops, min_mask_region_area=25, so that the
# masks reach the small-region pass) 4 x 4 a crop, for chip_smoke's time
# limit; the defaults run keeps 32 x 32
AMG_ZERO_POINTS_PER_SIDE = 16
AMG_CROP_POINTS_PER_SIDE = 4


def sam2_expect(sc, trunks: int, decodes: int, what: str):
    """(expect, why) for `check_launches` over `trunks` image encodes of
    config sc (K4 once a block, whatever the batch) and `decodes` mask
    decoder calls (K3 once a two-way block)."""
    from video_llava_seg_torch import kernels

    depth = sc.hiera.depth
    expect = {n: 0 for n in kernels.LaunchCounts.NAMES}
    expect.update(K4=trunks * depth, K3=decodes * sc.twoway_depth)
    why = {n: f"none: {what} runs no {n}"
           for n in kernels.LaunchCounts.NAMES}
    why.update(K4=f"{depth} Hiera blocks x {trunks} image encodes ({what})",
               K3=f"image->token attention in the {sc.twoway_depth} two-way "
                  f"blocks x {decodes} decoder calls ({what})")
    return expect, why


def check_sam2_launches(tag, counts, sc, trunks, decodes, what):
    """`check_launches` on a SAM2 image path, and no launch of attention.cu
    (a PR 1 entry; the other old entries are held to 0 there)."""
    expect, why = sam2_expect(sc, trunks, decodes, what)
    check_launches(tag, counts, expect, why, sc=sc)
    if counts["attention.cu entry"]:
        raise AssertionError(f"{tag}: {counts['attention.cu entry']} "
                             f"launches of {CUDA_C_ENTRY}")


def device_busy_ms(fn, warm: bool = True):
    """Device time of one warm call of fn: the sum of the device-side
    events (kernels, copies, fills) of a torch.profiler trace, not of the
    host ops that issued them (their device time is the same time again),
    and its five largest; (None, []) where the trace holds none. warm
    False: fn already ran, the profiled call is the only one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.key.startswith("Activity Buffer")
              and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    return (total or None), [(e.key[:60], e.self_device_time_total / 1e3)
                             for e in top]


def _check_prediction(tag, out, n_masks, hw):
    masks, ious, low = out
    want = (n_masks, *hw)
    if masks.shape != want or masks.dtype != np.bool_:
        raise AssertionError(f"{tag}: masks {masks.shape} {masks.dtype}, "
                             f"expected bool {want}")
    if ious.shape != (n_masks,) or not np.isfinite(ious).all():
        raise AssertionError(f"{tag}: ious {ious}")
    if low.shape[0] != n_masks or not np.isfinite(low).all() \
            or np.abs(low).max() > 32.0:
        raise AssertionError(f"{tag}: low-res logits {low.shape} not finite "
                             "or not clipped to +-32")
    log(f"[sam2-image] {tag}: masks {list(masks.shape)} "
        f"({masks.mean():.4f} positive), ious "
        f"{np.array2string(ious, precision=4)}, low-res {list(low.shape)} "
        "finite")


def phase_sam2_image(seed, dev, smi):
    """Phase 15: SAM2ImagePredictor at SAM2.1-hiera-tiny's full width,
    random bf16 weights from the seed, on a 1080 x 1920 frame."""
    from video_llava_seg_torch.models.sam2.build import (
        build_sam2_image_predictor,
    )
    from video_llava_seg_torch.models.sam2.image_predictor import (
        SAM2ImagePredictor,
    )
    from video_llava_seg_torch.ops.connected_components import (
        connected_components,
    )

    pred = build_sam2_image_predictor(SAM2_IMAGE_VARIANT, seed=seed,
                                      device=dev)
    sc = pred.cfg
    r = np.random.default_rng(seed)
    h, w = SAM2_IMAGE_HW
    img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    box = np.array([0.2 * w, 0.2 * h, 0.7 * w, 0.8 * h])
    points = np.array([[0.4 * w, 0.5 * h], [0.6 * w, 0.4 * h],
                       [0.1 * w, 0.1 * h]])
    labels = np.array([1, 1, 0])
    log(f"[sam2-image] {sc.name}: {sc.hiera.depth} Hiera blocks, image "
        f"{sc.image_size}^2, frame {h} x {w}, bf16 on {smi}")

    sync()
    t0 = time.perf_counter()
    pred.set_image(img)
    sync()
    cold = time.perf_counter() - t0
    embed = pred.get_image_embedding().clone()
    reset_launches()
    pred.set_image(img)
    sync()
    counts = {"set_image": snapshot_launches()}
    check_sam2_launches("sam2-image set_image", counts["set_image"], sc, 1,
                        0, "set_image")
    if not torch.equal(pred.get_image_embedding(), embed):
        raise AssertionError("two set_image calls on one frame differ")

    reset_launches()
    out_box = pred.predict(box=box)
    sync()
    counts["predict"] = snapshot_launches()
    check_sam2_launches("sam2-image predict", counts["predict"], sc, 0, 1,
                        "predict")
    again = pred.predict(box=box)
    if not all(np.array_equal(a, b) for a, b in zip(out_box, again)):
        raise AssertionError("two predict calls on one prompt differ")
    _check_prediction("predict(box), twice bit-identical", out_box, 3,
                      (h, w))
    _check_prediction("predict(3 points)", pred.predict(
        point_coords=points, point_labels=labels), 3, (h, w))
    low = out_box[2][np.argmax(out_box[1])][None]
    _check_prediction("predict(box + 2 points + mask input, one mask)",
                      pred.predict(point_coords=points[:2],
                                   point_labels=labels[:2], box=box,
                                   mask_input=low, multimask_output=False),
                      1, (h, w))

    t_set, t_pred = wall_seconds([lambda: pred.set_image(img),
                                  lambda: pred.predict(box=box)])
    busy_set, top_set = device_busy_ms(lambda: pred.set_image(img))
    busy_pred, top_pred = device_busy_ms(lambda: pred.predict(box=box))

    def fmt_busy(ms):
        return "not measured" if ms is None else f"{ms:.3f} ms"

    log(f"[sam2-image] warm set_image: {fmt_wall(t_set)} on {smi}; device "
        f"busy {fmt_busy(busy_set)} (torch.profiler); cold (the process's "
        f"first) {cold:.3f} s")
    log(f"[sam2-image] warm predict (box, 3 masks to {h} x {w}): "
        f"{fmt_wall(t_pred)} on {smi}; device busy {fmt_busy(busy_pred)}")
    for what, top in (("set_image", top_set), ("predict", top_pred)):
        log(f"[sam2-image] {what}'s largest kernels by device time: "
            + "; ".join(f"{k} {ms:.3f} ms" for k, ms in top))

    img2 = r.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    box2 = np.array([100.0, 80.0, 900.0, 600.0])
    reset_launches()
    pred.set_image_batch([img, img2])
    sync()
    counts["set_image_batch"] = snapshot_launches()
    check_sam2_launches("sam2-image set_image_batch(2)",
                        counts["set_image_batch"], sc, 1, 0,
                        "set_image_batch of 2")
    reset_launches()
    batch = pred.predict_batch(box_batch=[box, box2])
    sync()
    counts["predict_batch"] = snapshot_launches()
    check_sam2_launches("sam2-image predict_batch(2)",
                        counts["predict_batch"], sc, 0, 2,
                        "predict_batch of 2")
    for i, hw in enumerate(((h, w), (720, 1280))):
        _check_prediction(f"predict_batch image {i}",
                          [o[i] for o in batch], 3, hw)

    # hole filling and sprinkle removal on the card
    holes = SAM2ImagePredictor(pred.params, sc, max_hole_area=64,
                               max_sprinkle_area=64, device=dev)
    holes.set_image(img)
    out_holes = holes.predict(box=box)
    _check_prediction("predict(box), max_hole_area = max_sprinkle_area = "
                      "64", out_holes, 3, (h, w))
    (t_holes,) = wall_seconds([lambda: holes.predict(box=box)])
    low = torch.from_numpy(out_box[2])
    for tag, m in (("holes", low <= 0), ("sprinkles", low > 0)):
        lc, ac = connected_components(m.to(dev))
        lp, ap = connected_components(m)
        sync()
        if not (torch.equal(lc.cpu(), lp) and torch.equal(ac.cpu(), ap)):
            raise AssertionError(f"connected components ({tag}) on the card "
                                 "differ from the CPU's")
    log(f"[sam2-image] fill holes + sprinkles: predict {fmt_wall(t_holes)}; "
        f"{(out_holes[0] != out_box[0]).mean():.5f} of the mask pixels "
        "changed; connected components on the card equal the CPU's on "
        "the low-res masks (labels and areas)")
    del holes
    torch.cuda.empty_cache()
    return pred, counts, {
        "variant": sc.name, "frame_hw": [h, w], "cold_set_image_s": cold,
        "set_image_s": t_set, "predict_s": t_pred,
        "set_image_device_busy_ms": busy_set,
        "predict_device_busy_ms": busy_pred,
        "predict_fill_holes_s": t_holes, "card": smi}


def _check_records(tag, anns, hw):
    for a in anns:
        seg = a["segmentation"]
        x, y, bw, bh = a["bbox"]
        if (seg.shape != hw or seg.dtype != np.bool_
                or a["area"] != int(seg.sum())
                or not (0 <= x <= x + bw <= hw[1] and 0 <= y <= y + bh
                        <= hw[0])
                or not math.isfinite(a["predicted_iou"])
                or not math.isfinite(a["stability_score"])):
            raise AssertionError(f"{tag}: a malformed record {a['bbox']}, "
                                 f"area {a['area']}")


def phase_amg(pred, seed, dev, smi):
    """Phase 16: SAM2AutomaticMaskGenerator over an AMG_HW frame through the
    phase 15 predictor: the defaults (32 x 32 points in batches of 64),
    then IoU and stability thresholds 0 (random-weight masks reach NMS and
    RLE; AMG_ZERO_POINTS_PER_SIDE), then one crop layer with
    min_mask_region_area 25 (AMG_CROP_POINTS_PER_SIDE)."""
    from video_llava_seg_torch.models.sam2.amg import generate_crop_boxes
    from video_llava_seg_torch.models.sam2.automatic_mask_generator import (
        SAM2AutomaticMaskGenerator,
    )

    sc = pred.cfg
    hw = AMG_HW
    img = np.random.default_rng(seed + 16).integers(0, 256, (*hw, 3),
                                                    dtype=np.uint8)
    zero = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0)
    runs = [("defaults", dict(), pred),
            (f"thresholds 0, {AMG_ZERO_POINTS_PER_SIDE} x "
             f"{AMG_ZERO_POINTS_PER_SIDE} points",
             dict(zero, points_per_side=AMG_ZERO_POINTS_PER_SIDE), pred),
            (f"crop_n_layers 1, min_mask_region_area 25, thresholds 0, "
             f"{AMG_CROP_POINTS_PER_SIDE} x {AMG_CROP_POINTS_PER_SIDE} "
             "points", dict(zero, crop_n_layers=1, min_mask_region_area=25,
                            points_per_side=AMG_CROP_POINTS_PER_SIDE),
             (pred.params, sc))]
    counts, out = {}, {}
    for name, kw, model in runs:
        gen = SAM2AutomaticMaskGenerator(model, device=dev, **kw)
        crops, layers = generate_crop_boxes(hw, gen.crop_n_layers,
                                            gen.crop_overlap_ratio)
        per_crop = [-(-len(gen.point_grids[i]) // gen.points_per_batch)
                    for i in layers]
        batches = sum(per_crop)
        timings = {}
        reset_launches()
        sync()
        t0 = time.perf_counter()
        anns = gen.generate(img, timings=timings)
        sync()
        secs = time.perf_counter() - t0
        counts[name] = snapshot_launches()
        check_sam2_launches(f"amg {name}", counts[name], sc, len(crops),
                            batches, f"{len(crops)} crops, {batches} point "
                            "batches")
        _check_records(f"amg {name}", anns, hw)
        host = secs - sum(timings.values())
        log(f"[amg] {name}: {secs:.3f} s for the image on {smi} ("
            + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
            + f", host filters / NMS / RLE {host:.3f} s); {len(anns)} "
            f"masks; {len(crops)} crops x {per_crop[0]} batches of "
            f"{gen.points_per_batch} points, K3 "
            f"{counts[name]['K3']} launches on attention_short_sm90.cu "
            f"{counts[name]['K3 entry']}")
        out[name] = {"seconds": secs, "stages": timings, "host_s": host,
                     "masks": len(anns), "crops": len(crops),
                     "batches": batches, "k3_launches": counts[name]["K3"]}
        del gen, anns
        torch.cuda.empty_cache()
    return counts, out


# tiny SAM2 image paths, card (kernels, bf16) vs CPU (plain, fp32) on the
# same bf16-rounded weights: the seg head's tiny agreement bound
# (AGREE_BOUND) on the low-res logits; predicted IoUs within 0.05; each
# generator mask's pixels equal on at least 0.98 of the image (bf16 moves
# a mask's edge by a pixel or two)
SAM2_TINY_IOU_BOUND = 5e-2
SAM2_TINY_PIXEL_AGREEMENT = 0.98


def phase_tiny_sam2_agreement(seed, dev):
    """Phase 17: sam2-test-tiny through set_image + predict and generate,
    on the card `dev` (K4's chain; its decoder attends over 8 x 8 image
    tokens, below K3's 256) and on the CPU (plain, fp32)."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.bridge import cast_tree
    from video_llava_seg_torch.models.sam2 import base
    from video_llava_seg_torch.models.sam2.automatic_mask_generator import (
        SAM2AutomaticMaskGenerator,
    )
    from video_llava_seg_torch.models.sam2.config import sam2_config
    from video_llava_seg_torch.models.sam2.image_predictor import (
        SAM2ImagePredictor,
    )

    cfg = sam2_config("sam2-test-tiny")
    g = torch.Generator().manual_seed(seed)
    params = cast_tree(cast_tree(perturb(base.init(cfg, g, "cpu",
                                                   torch.float32), g),
                                 "cpu", torch.bfloat16), "cpu", torch.float32)
    cpu = SAM2ImagePredictor(params, cfg, device="cpu")
    card = SAM2ImagePredictor(params, cfg, device=dev)
    img = np.random.default_rng(seed + 17).integers(0, 256, (96, 160, 3),
                                                    dtype=np.uint8)
    before = kernels.LAUNCHES.snapshot()["K4"]
    card.set_image(img)
    sync()
    if kernels.LAUNCHES.snapshot()["K4"] - before != cfg.hiera.depth:
        raise AssertionError("tiny set_image: K4 not launched once a block")
    cpu.set_image(img)
    out = {}
    for name, kw in (("box", dict(box=np.array([20.0, 15.0, 120.0, 80.0]))),
                     ("points", dict(point_coords=np.array([[50.0, 40.0],
                                                            [100.0, 60.0]]),
                                     point_labels=np.array([1, 0])))):
        got, want = card.predict(**kw), cpu.predict(**kw)
        _agree(f"tiny sam2 predict({name}) low-res", got[2], want[2],
               AGREE_BOUND)
        d_iou = float(np.abs(got[1] - want[1]).max())
        log(f"[agree] tiny sam2 predict({name}): ious max abs diff "
            f"{d_iou:.3e} (bound {SAM2_TINY_IOU_BOUND:.0e})")
        if not d_iou <= SAM2_TINY_IOU_BOUND:
            raise AssertionError(f"tiny sam2 predict({name}): ious disagree")
        out[name] = d_iou
    kw = dict(points_per_side=4, points_per_batch=16, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, box_nms_thresh=1.0,
              multimask_output=False)
    recs = [{tuple(a["point_coords"][0]): a
             for a in SAM2AutomaticMaskGenerator(p, **kw).generate(img)}
            for p in (card, cpu)]
    if recs[0].keys() != recs[1].keys() or len(recs[0]) != 16:
        raise AssertionError(f"tiny generate: {len(recs[0])} / "
                             f"{len(recs[1])} records by point")
    agree = min(float((recs[0][k]["segmentation"]
                       == recs[1][k]["segmentation"]).mean())
                for k in recs[1])
    d_iou = max(abs(recs[0][k]["predicted_iou"] - recs[1][k]["predicted_iou"])
                for k in recs[1])
    log(f"[agree] tiny sam2 generate: 16 records, one a point; worst mask "
        f"pixel agreement {agree:.4f} (bound {SAM2_TINY_PIXEL_AGREEMENT}), "
        f"predicted IoU max abs diff {d_iou:.3e} (bound "
        f"{SAM2_TINY_IOU_BOUND:.0e})")
    if not (agree >= SAM2_TINY_PIXEL_AGREEMENT
            and d_iou <= SAM2_TINY_IOU_BOUND):
        raise AssertionError("tiny sam2 generate: card and CPU disagree")
    out["generate_pixel_agreement"] = agree
    out["generate_iou_diff"] = d_iou
    return out


# ---------------------------------------------------------------------------
# the SAM2 video slice
# ---------------------------------------------------------------------------

# the JAX bench's config 2: 16 frames of 480 x 854, one point on frame 0,
# propagate_in_video; Hiera-L, then Hiera-T, at 1024^2
SAM2_VIDEO_VARIANTS = ("large", "tiny")
SAM2_VIDEO_FRAMES = 16
SAM2_VIDEO_HW = (480, 854)
# the object-score head's last bias is raised by this much: at random
# weights the head calls every frame "no object" and every mask is the
# no-object score, so nothing real would reach the memory
OBJ_SCORE_BIAS = 20.0
# frames a batched trunk in precompute_image_features
SAM2_VIDEO_CHUNK = 8


def raise_obj_score(params):
    """Raise the last bias of the object-score head by OBJ_SCORE_BIAS (in
    place), so that random-weight frames hold objects."""
    head = params["mask_decoder"]["pred_obj_score_head"]
    last = head["layers"][-1] if "layers" in head else head
    last["bias"].add_(OBJ_SCORE_BIAS)
    return params


def sam2_video_expect(sc, trunks: int, decodes: int, tracked: int,
                      what: str):
    """`sam2_expect` for a video path: K2 twice a memory-attention layer
    (self- and cross-attention, both at head dim 256) on every frame
    conditioned on memory."""
    expect, why = sam2_expect(sc, trunks, decodes, what)
    per = 2 * sc.memory_attention.num_layers
    expect["K2"] = per * tracked
    why["K2"] = (f"memory attention: {per} a frame conditioned on memory x "
                 f"{tracked} ({what})")
    return expect, why


def check_sam2_video_launches(tag, counts, sc, trunks, decodes, tracked,
                              what):
    expect, why = sam2_video_expect(sc, trunks, decodes, tracked, what)
    check_launches(tag, counts, expect, why, sc=sc)
    if counts["attention.cu entry"]:
        raise AssertionError(f"{tag}: {counts['attention.cu entry']} "
                             f"launches of {CUDA_C_ENTRY}")


def _video_session(pred, frames, point, counts=None, per_frame=None):
    """One session: init_state, one point on frame 0, propagate_in_video;
    with `counts` (a dict), the launches of each step by name, each
    counted from 0; with `per_frame` (a list), the launches between two
    yielded frames. Returns the yielded (frame_idx, masks) and the
    propagation's host seconds (synchronised after the last frame)."""
    def step(name, fn):
        if counts is not None:
            reset_launches()
        out = fn()
        sync()
        if counts is not None:
            counts[name] = snapshot_launches()
        return out

    state = step("init_state", lambda: pred.init_state(frames))
    step("add_new_points", lambda: pred.add_new_points_or_box(
        state, 0, 1, points=[point], labels=[1]))
    if counts is not None:
        reset_launches()
    out = []
    t0 = time.perf_counter()
    for f, _, m in pred.propagate_in_video(state,
                                           precompute_chunk=SAM2_VIDEO_CHUNK):
        out.append((f, m))
        if per_frame is not None:
            sync()
            per_frame.append(snapshot_launches())
            reset_launches()
    sync()
    secs = time.perf_counter() - t0
    if counts is not None and per_frame is None:
        counts["propagate"] = snapshot_launches()
    return out, secs


def _sum_counts(snaps):
    return {k: sum(c[k] for c in snaps) for k in snaps[0]}


def phase_sam2_video(variant, seed, dev, smi):
    """Phase 18, one model: SAM2VideoPredictor at the full width of
    `variant` at 1024^2 (random bf16 weights from the seed, the
    object-score bias raised) over SAM2_VIDEO_FRAMES uint8 frames of
    SAM2_VIDEO_HW, one point on frame 0, propagate_in_video: a first run
    with the launches of init_state, the prompt, each trunk chunk and
    each tracked frame counted exactly by name and C entry; a warm run
    timed by the host clock; the device busy time of a session."""
    from video_llava_seg_torch.models.sam2.build import (
        build_sam2_video_predictor,
    )

    pred = build_sam2_video_predictor(variant, seed=seed, device=dev)
    raise_obj_score(pred.params)
    sc = pred.cfg
    h, w = SAM2_VIDEO_HW
    n = SAM2_VIDEO_FRAMES
    frames = np.random.default_rng(seed + 18).integers(
        0, 256, (n, h, w, 3), dtype=np.uint8)
    point = [0.5 * w, 0.5 * h]
    tag = f"sam2-video {sc.name}"
    log(f"[{tag}] {sc.hiera.depth} Hiera blocks, {n} frames of {h} x {w} "
        f"at {sc.image_size}^2, one point on frame 0, bf16 on {smi}")

    counts, per_frame = {}, []
    t0 = time.perf_counter()
    out, cold_prop = _video_session(pred, frames, point, counts, per_frame)
    cold = time.perf_counter() - t0
    check_sam2_video_launches(f"{tag} init_state", counts["init_state"], sc,
                              1, 0, 0, "init_state: frame 0's features")
    check_sam2_video_launches(f"{tag} add_new_points",
                              counts["add_new_points"], sc, 0, 1, 0,
                              "one point on frame 0, no memory yet")
    chunks = -(-(n - 1) // SAM2_VIDEO_CHUNK)
    # the first yield follows the preflight (memory encoder only) and the
    # batched trunks of the frames not encoded yet; each later one, one
    # frame conditioned on memory
    check_sam2_video_launches(f"{tag} propagate, frame 0",
                              per_frame[0], sc, chunks, 0, 0,
                              f"{chunks} trunk chunks of <= "
                              f"{SAM2_VIDEO_CHUNK} frames for frames 1.."
                              f"{n - 1}; frame 0 is consolidated")
    for i, c in enumerate(per_frame[1:], start=1):
        expect, _ = sam2_video_expect(sc, 0, 1, 1, "")
        got = {k: c[k] for k in expect}
        if got != expect or c["sm90 entry"] != expect["K2"] \
                or c["attention.cu entry"]:
            raise AssertionError(f"{tag} tracked frame {i}: launches {got}, "
                                 f"attention_sm90.cu {c['sm90 entry']}, "
                                 f"expected {expect}")
    log(f"[{tag}] each tracked frame 1..{n - 1}: K2 "
        f"{per_frame[1]['K2']} (all on attention_sm90.cu at head dim 256), "
        f"K3 {per_frame[1]['K3']}, K4 0, attention.cu 0")
    prop = _sum_counts(per_frame)
    check_sam2_video_launches(f"{tag} propagate", prop, sc, chunks, n - 1,
                              n - 1, f"{n} frames, {n - 1} tracked")
    counts["propagate"] = prop
    if [f for f, _ in out] != list(range(n)):
        raise AssertionError(f"{tag}: yielded frames {[f for f, _ in out]}")
    front = []
    for f, m in out:
        if (m.device.type != pred.device.type
                or tuple(m.shape) != (1, 1, h, w)
                or not torch.isfinite(m).all()):
            raise AssertionError(f"{tag}: frame {f} masks {m.shape} on "
                                 f"{m.device}, not finite or misshaped")
        front.append(float((m > 0).float().mean()))
    if max(front[1:]) <= 0.0:
        raise AssertionError(f"{tag}: no tracked frame holds the object")
    log(f"[{tag}] masks [1, 1, {h}, {w}] on the card, finite; share in "
        f"front per frame " + " ".join(f"{x:.3f}" for x in front))

    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        _, prop_s = _video_session(pred, frames, point)
        runs.append((time.perf_counter() - t0, prop_s))
    session_s, prop_s = min(runs, key=lambda r: r[1])
    busy, top = device_busy_ms(lambda: _video_session(pred, frames, point))
    fps = n / prop_s
    log(f"[{tag}] cold session {cold:.3f} s (propagate {cold_prop:.3f} s); "
        f"warm session {session_s:.3f} s, propagate_in_video {prop_s:.3f} "
        f"s = {fps:.2f} frames/s by the host clock (best of 2) on {smi}; "
        f"device busy "
        + ("not measured" if busy is None else
           f"{busy:.3f} ms a session, {busy / n:.3f} ms a frame")
        + " (torch.profiler)")
    log(f"[{tag}] a session's largest kernels by device time: "
        + "; ".join(f"{k} {ms:.3f} ms" for k, ms in top))
    del pred
    torch.cuda.empty_cache()
    return counts, {"variant": sc.name, "frames": n, "frame_hw": [h, w],
                    "cold_session_s": cold, "cold_propagate_s": cold_prop,
                    "session_s": session_s, "propagate_s": prop_s,
                    "frames_per_s": fps, "device_busy_ms": busy,
                    "device_busy_ms_per_frame": (None if busy is None
                                                 else busy / n),
                    "front_share": front, "card": smi}


def phase_video_kernel_checks(seed, dev, results):
    """Phase 19: K2 at head dim 256 (attention_sm90.cu) at memory
    attention's shapes, [1, 1, 4096, 256] self-attention and the
    cross-attention over a full bank (num_maskmem = 7 memories of 4096
    tokens + 16 pointers x 4 tokens), against `flash_forward_plain` in
    fp32 within BOUNDS["K2_hd256"], timed over 10 launches back to back
    and by device time beside its plain version and SDPA, with the bound;
    then K4 at each block kind of SAM2.1-hiera-large over one 1024^2
    image (head dim 72: windowed and q-pool blocks on
    window_attention_sm90.cu, the global block padded to 80 on
    attention_sm90.cu; its windows divide every map, so no block is
    padded) against hiera_block_plain; then K7 at every window kind of
    Hiera-L and Hiera-B+ (`k7_variant_checks`) and Hiera-B+'s set_image
    launches. Returns the K7 rows by variant and those launches."""
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.models.sam2.config import sam2_config
    from video_llava_seg_torch.ops.attention import flash_forward_plain

    sc = sam2_config("large")
    ma = sc.memory_attention
    d = ma.d_model // ma.num_heads
    hw = ma.rope_feat_size ** 2
    full_bank = sc.num_maskmem * hw + sc.max_obj_ptrs_in_encoder * (
        sc.hidden_dim // sc.mem_dim)
    g = torch.Generator(device=dev).manual_seed(seed + 19)
    for what, skv in (("self-attention", hw),
                      ("cross-attention, full bank", full_bank)):
        q, k, v = (torch.randn((1, n, 1, d), generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2)
                   for n in (hw, skv, skv))
        entry = kernels.attention_entry(d, False, skv, 1)
        if entry != SM90_ENTRY:
            raise AssertionError(f"K2 at head dim {d} routes to {entry}")
        scale = d ** -0.5
        _check("K2_hd256", f"memory attention {what} q{list(q.shape)} "
               f"kv{list(k.shape)}",
               lambda: kernels.attention(q, k, v, scale=scale),
               lambda: flash_forward_plain(q, k, v, scale=scale)[0],
               lambda: flash_forward_plain(q.float(), k.float(), v.float(),
                                           scale=scale)[0],
               results, (_nbytes(q, k, v, q), 4 * hw * skv * d, PEAK_BF16),
               run_library=lambda: F.scaled_dot_product_attention(
                   q, k, v, scale=scale),
               train=10, device_time=True)
        del q, k, v
    k4_kind_checks(sc, 1, torch.Generator(device=dev).manual_seed(seed + 20),
                   dev, results, name="K4_hiera_large")
    rows = {v: k7_variant_checks(v, seed, dev, results)
            for v in ("large", "base_plus")}
    return rows, base_plus_set_image_launches(seed, dev)


def base_plus_set_image_launches(seed, dev):
    """`SAM2ImagePredictor.set_image` at SAM2.1-hiera-base-plus's full
    width (random bf16 weights from the seed) on one 480 x 854 frame,
    counted by C entry: K4 once a block, the 21 windowed blocks (head dim
    56) on window_attention_sm90.cu, none on window_attention.cu; a
    finite embedding."""
    from video_llava_seg_torch.models.sam2.build import (
        build_sam2_image_predictor,
    )

    pred = build_sam2_image_predictor("base_plus", seed=seed, device=dev)
    sc = pred.cfg
    img = np.random.default_rng(seed + 22).integers(
        0, 256, (*SAM2_VIDEO_HW, 3), dtype=np.uint8)
    pred.set_image(img)
    sync()
    reset_launches()
    pred.set_image(img)
    sync()
    counts = snapshot_launches()
    check_sam2_launches(f"sam2-image {sc.name} set_image", counts, sc, 1, 0,
                        "set_image")
    if not torch.isfinite(pred.get_image_embedding()).all():
        raise AssertionError(f"{sc.name} set_image: a non-finite embedding")
    log(f"[k7] {sc.name} set_image: window_attention_sm90.cu "
        f"{counts[WINDOW_SM90_ENTRY]}, window_attention.cu "
        f"{counts['vls_window_attention']} launches; embedding finite")
    del pred
    torch.cuda.empty_cache()
    return counts


# tiny video path, card (kernels, bf16) vs CPU (plain, fp32) on the same
# bf16-rounded weights: the seg head's tiny bound (AGREE_BOUND) on the
# video-resolution logits relative to their largest, and the mask signs
# equal on SAM2_TINY_PIXEL_AGREEMENT of every frame's pixels. The logits
# are compared without hole filling: a pixel whose sign the two round
# apart can turn a small background region into a hole on one side
# only, and the hole takes 0.1 there (PR 19's first run, with hole
# filling: rel err 0.096 on a frame whose signs agreed on 0.9994, which
# such a jump explains); with the predictor's fill_hole_area 8 the signs
# are held alone
def phase_tiny_sam2_video_agreement(seed, dev):
    """Phase 20: sam2-test-tiny's video predictor over 6 frames of 96 x
    160, points for one object on frame 0 and a box for another on frame
    2, forward propagation, on the card and on the CPU, without and with
    hole filling."""
    from video_llava_seg_torch.bridge import cast_tree
    from video_llava_seg_torch.models.sam2 import base
    from video_llava_seg_torch.models.sam2.config import sam2_config
    from video_llava_seg_torch.models.sam2.video_predictor import (
        SAM2VideoPredictor,
    )

    cfg = sam2_config("sam2-test-tiny")
    g = torch.Generator().manual_seed(seed)
    params = raise_obj_score(perturb(base.init(cfg, g, "cpu",
                                               torch.float32), g))
    params = cast_tree(cast_tree(params, "cpu", torch.bfloat16), "cpu",
                       torch.float32)
    frames = np.random.default_rng(seed + 20).integers(
        0, 256, (6, 96, 160, 3), dtype=np.uint8)
    worst = {"rel": 0.0, "sign": 1.0, "sign_fill_holes": 1.0}
    for holes in (0, 8):
        outs = []
        for device in (dev, "cpu"):
            pred = SAM2VideoPredictor(params, cfg, fill_hole_area=holes,
                                      device=device)
            st = pred.init_state(frames)
            pred.add_new_points_or_box(st, 0, 1, points=[[50.0, 40.0]],
                                       labels=[1])
            pred.add_new_points_or_box(st, 2, 2,
                                       box=[20.0, 15.0, 120.0, 80.0])
            outs.append([(f, ids, m.float().cpu().numpy())
                         for f, ids, m in pred.propagate_in_video(st)])
        for (f, ids, got), (f2, ids2, want) in zip(*outs):
            if (f, ids) != (f2, ids2):
                raise AssertionError(f"tiny sam2 video: frame {f} {ids} vs "
                                     f"{f2} {ids2}")
            sign = float(((got > 0) == (want > 0)).mean())
            if holes:
                log(f"[agree] tiny sam2 video frame {f}, fill_hole_area "
                    f"{holes}: sign agreement {sign:.4f}")
                worst["sign_fill_holes"] = min(worst["sign_fill_holes"],
                                               sign)
            else:
                _agree(f"tiny sam2 video frame {f}", got, want, AGREE_BOUND)
                worst["rel"] = max(worst["rel"], float(
                    np.abs(got - want).max() / max(np.abs(want).max(),
                                                   1e-6)))
                worst["sign"] = min(worst["sign"], sign)
            if sign < SAM2_TINY_PIXEL_AGREEMENT:
                raise AssertionError(f"tiny sam2 video frame {f}: signs "
                                     f"agree on {sign:.4f}")
    return worst


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------

def train_tcfg(**over):
    """The stage-3 QLoRA TrainConfig of the train slice (the JAX CLI's
    `--stage stage3 --bits 8 --lora_enable` preset rates). With 100
    planned steps the 3-step warmup gives update 0 a zero learning rate
    (optax's schedule), so LoRA `b` moves from the second step."""
    from video_llava_seg_torch.config import OptimGroupLRs, TrainConfig
    from video_llava_seg_torch.train.train import STAGE_PRESETS

    kw = dict(bits=8, lora_enable=True, lora_rank=64,
              num_train_steps=100, gradient_accumulation_steps=1,
              gradient_checkpointing=True,
              lrs=OptimGroupLRs(**STAGE_PRESETS["stage3"]["lrs"]))
    kw.update(over)
    return TrainConfig(**kw)


def train_seq_len(cfg) -> int:
    """Spliced length of a `synthetic_batches` sample."""
    from video_llava_seg_torch.train.train import synthetic_batches

    return int(next(synthetic_batches(cfg, 1))["gather_idx"].shape[1])


def phase_flash_bwd_checks(cfg, seq_len, seed, dev, results):
    """K2 / K3 with the logsumexp and K6a / K6b at the train step's
    shapes. Each backward kernel gets the kernel forward's output and
    logsumexp, as in training; the plain backward runs in fp32 on the
    same values."""
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.models.seg_head import make_sam2_cfg
    from video_llava_seg_torch.ops.attention import (
        MASK_VALUE,
        flash_backward_plain,
        flash_forward_plain,
    )

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 3)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    lc, sc = cfg.llm, make_sam2_cfg(cfg.seg)
    n_tok = int(sc.pred_obj_scores) + 1 + (sc.num_multimask_outputs + 1) + 1
    heads = sc.twoway_heads
    hd = sc.hidden_dim // sc.attention_downsample_rate // heads
    bt = cfg.seg.max_seg_frames * cfg.seg.max_objects
    check_k3_route(hd, n_tok, heads)
    cases = [
        ("llm", 1, lc.num_heads, lc.num_kv_heads, seq_len, seq_len,
         lc.head_dim, True, None),
        ("mask decoder image->token", bt, heads, heads,
         sc.image_embedding_size ** 2, n_tok, hd, False, None),
        ("kv_bias, 337 + 41 keys masked", 2, lc.num_heads, lc.num_kv_heads,
         2048, 2048, lc.head_dim, False, (41, 337)),
    ]
    for tag, b, hq, hkv, sq, skv, d, causal, masked in cases:
        single = skv <= 1024
        if single:
            # the mask decoder's q / k / v: [B, S, H, 16] dense outputs
            # viewed [B, H, S, 16]
            q = randn(b, sq, hq, d).transpose(1, 2)
            k = randn(b, skv, hkv, d).transpose(1, 2)
            v = randn(b, skv, hkv, d).transpose(1, 2)
        else:
            q = randn(b, hq, sq, d)
            k, v = randn(b, hkv, skv, d), randn(b, hkv, skv, d)
        # dO as autograd hands it back through the head merge: the mask
        # decoder's a [B, H, S, 16] view of a [B, S, H * 16] gradient
        do = (randn(b, sq, hq, d).transpose(1, 2) if single
              else randn(b, hq, sq, d))
        bias, kv_mask = None, None
        if masked is not None:
            kv_mask = torch.ones(b, skv, dtype=torch.bool, device=dev)
            kv_mask[0, 100:100 + masked[0]] = False
            kv_mask[1, :masked[1]] = False
            bias = torch.where(kv_mask, 0.0, MASK_VALUE).float().contiguous()
        fwd = "K3" if single else "K2"
        scale = 1.0 / math.sqrt(d)
        kw = dict(scale=scale, causal=causal, kv_bias=bias)
        shape = (f"{tag}: q{list(q.shape)} kv{list(k.shape)}"
                 f"{' causal' if causal else ''}")
        # products of one QK^T-sized matmul, counting only visible tiles'
        # worth of work under the causal mask
        pairs = b * hq * (sq * (sq + 1) // 2 if causal else sq * skv)
        prod = 2 * pairs * d
        qb, kb = _nbytes(q), _nbytes(k)
        lse_b = 4 * b * hq * sq

        out, lse = kernels.attention(q, k, v, two_pass=single,
                                     with_lse=True, **kw)
        want_o, want_lse = flash_forward_plain(q.float(), k.float(),
                                               v.float(), bias, causal=causal,
                                               scale=scale)
        sync()
        lse_err = (lse - want_lse).abs().max().item()
        log(f"[flash] {fwd} {shape}: lse max abs err {lse_err:.3e} (bound "
            f"{LSE_BOUND:.0e})")
        if not math.isfinite(lse_err) or lse_err > LSE_BOUND:
            raise AssertionError(f"{fwd} lse off by {lse_err:.3e}")
        del want_o, want_lse
        qr = q.detach().requires_grad_(True)
        kr = k.detach().requires_grad_(True)
        vr = v.detach().requires_grad_(True)
        sdpa_kw = dict(is_causal=causal, enable_gqa=hkv != hq,
                       attn_mask=None if kv_mask is None
                       else kv_mask[:, None, None, :])
        _check(fwd, f"{shape}, with lse",
               lambda: kernels.attention(q, k, v, two_pass=single,
                                         with_lse=True, **kw)[0],
               lambda: flash_forward_plain(q, k, v, bias, causal=causal,
                                           scale=scale),
               lambda: flash_forward_plain(q.float(), k.float(), v.float(),
                                           bias, causal=causal,
                                           scale=scale)[0],
               results, (2 * qb + 2 * kb + lse_b, 2 * prod, PEAK_BF16),
               run_library=lambda: F.scaled_dot_product_attention(
                   q, k, v, **sdpa_kw),
               run_previous=lambda: attention_cu(
                   q, k, v, two_pass=single, causal=causal, kv_mask=kv_mask,
                   with_lse=True),
               previous="attention.cu two-pass" if single else "attention.cu",
               train=10 if single else 1, device_time=single)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qr, kr, vr, **sdpa_kw)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), do)

        lib_bwd = max(cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd), 0.0)
        ref = flash_backward_plain(q.float(), k.float(), v.float(), bias,
                                   out.float(), lse, do.float(),
                                   causal=causal, scale=scale)
        plain_bwd = (lambda: flash_backward_plain(
            q, k, v, bias, out, lse, do, causal=causal, scale=scale))
        route = kernels.attention_bwd_entry(d, skv, hkv)
        if single:
            if route != (K6_SHORT_ENTRY,):
                raise AssertionError(f"the mask decoder's backward routes "
                                     f"to {route}, not {K6_SHORT_ENTRY}")
            one_pass_checks(shape, q, k, v, out, do, lse, kw, ref,
                            plain_bwd, results,
                            (4 * qb + 4 * kb + lse_b, 5 * prod, PEAK_BF16))
        else:
            pair_checks(shape, d, q, k, v, out, do, lse, kw, kv_mask, ref,
                        plain_bwd, results, qb, kb, lse_b, prod)
        # the library's backward computes dQ, dK and dV in one call: its
        # time stands beside both kernels
        for name in ("K6a", "K6b"):
            r = results[name]
            r["shapes"][-1]["library_ms"] = lib_bwd
            r["library_ms"] = sum(sh["library_ms"] for sh in r["shapes"])
        log(f"[flash] SDPA backward (fwd+bwd - fwd) {shape}: "
            f"{lib_bwd:.4f} ms")
        del q, k, v, do, out, lse, ref, qr, kr, vr
        torch.cuda.empty_cache()
    one_pass_small_case(g, hd, dev)
    sync()


def pair_checks(shape, d, q, k, v, out, do, lse, kw, kv_mask, ref,
                plain_bwd, results, qb, kb, lse_b, prod,
                names=("K6a", "K6b")):
    """K6a (dQ) and K6b (dK, dV) of a two-kernel pair against the plain
    backward, timed (recorded under `names`); where attention_bwd_sm90.cu
    serves the head dim, attention_bwd.cu, which it replaced, timed
    beside it."""
    from video_llava_seg_torch import kernels

    _, delta = kernels.attention_bwd_dq(q, k, v, out, do, lse, **kw)
    if kv_mask is not None:
            dk, dv = kernels.attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
            dead = ~kv_mask
            if (dk.transpose(1, 2)[dead].any()
                    or dv.transpose(1, 2)[dead].any()):
                raise AssertionError("K6b: masked keys got a gradient")
            del dk, dv
    # where attention_bwd_sm90.cu serves the head dim, time
    # attention_bwd.cu, which it replaced, at the same shape
    prev_dq = prev_dkv = None
    if kernels.attention_bwd_entry(d, k.shape[2], k.shape[1]) \
            != K6_CUDA_C_PAIR:
        def prev_dq():
            return kernels._attention_bwd_dq(
                "vls_attention_bwd_dq", q, k, v, out, do, lse, **kw)

        def prev_dkv():
            return kernels._attention_bwd_dkv(
                "vls_attention_bwd_dkv", q, k, v, do, lse, delta, **kw)
    # K6a reads q, k, v, o, dO, lse and writes dQ and delta; K6b
    # reads q, k, v, dO, lse, delta and writes dK, dV
    _check(names[0], f"{shape}: dQ",
           lambda: kernels.attention_bwd_dq(q, k, v, out, do, lse, **kw)[0],
           plain_bwd, lambda: ref[0], results,
           (4 * qb + 2 * kb + 2 * lse_b, 3 * prod, PEAK_BF16),
           run_previous=prev_dq, previous="attention_bwd.cu")
    _check(names[1], f"{shape}: dK, dV",
           lambda: torch.cat(kernels.attention_bwd_dkv(
               q, k, v, do, lse, delta, **kw), dim=1),
           plain_bwd, lambda: torch.cat(ref[1:], dim=1), results,
           (2 * qb + 4 * kb + 2 * lse_b, 4 * prod, PEAK_BF16),
           time_kernel=lambda: kernels.attention_bwd_dkv(
               q, k, v, do, lse, delta, **kw),
           run_previous=prev_dkv, previous="attention_bwd.cu")


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-6)).item()


def one_pass_checks(shape, q, k, v, out, do, lse, kw, ref, plain_bwd,
                    results, work):
    """attention_short_bwd_sm90.cu (K6a + K6b in one call) against the
    plain backward: dQ within BOUNDS["K6a"], dK / dV within BOUNDS["K6b"],
    two calls bit-identical; the call timed over 10 launches back to back
    and by device time (as K3), beside attention_bwd.cu's pair (its dQ
    kernel with the delta pre-pass, then its dK / dV kernel), which it
    replaced. Its K6a and K6b lines time the same call. work: the one
    pass's bytes (Q, O, dO, lse and K, V read once, dQ, dK, dV written
    once) and operations (S, dP, dQ, dK, dV)."""
    from video_llava_seg_torch import kernels

    def one_pass():
        return kernels.attention_bwd(q, k, v, out, do, lse, **kw)

    def pair():
        dq, delta = kernels.attention_bwd_dq(q, k, v, out, do, lse, **kw)
        return (dq,) + kernels.attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 **kw)

    got = one_pass()
    again = one_pass()
    sync()
    errs = {"K6a": _rel_err(got[0], ref[0]),
            "K6b": max(_rel_err(got[1], ref[1]), _rel_err(got[2], ref[2]))}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[flash] one pass {shape}: dQ rel {errs['K6a']:.3e}, dK / dV rel "
        f"{errs['K6b']:.3e} (bounds {BOUNDS['K6a']:.0e} / "
        f"{BOUNDS['K6b']:.0e}); two calls bit-identical: {same}")
    for name, err in errs.items():
        if not math.isfinite(err) or err > BOUNDS[name]:
            raise AssertionError(f"{name} one pass: rel err {err:.3e}")
    if not same:
        raise AssertionError("one pass: two calls on the same inputs differ")
    del got, again
    prev = "attention_bwd.cu pair"
    _check("K6a", f"{shape}: dQ, dK, dV in one pass (dQ compared)",
           lambda: one_pass()[0], plain_bwd, lambda: ref[0], results, work,
           time_kernel=one_pass, run_previous=pair, previous=prev,
           train=10, device_time=True)
    _check("K6b", f"{shape}: the same call (dK, dV compared)",
           lambda: torch.cat(one_pass()[1:], dim=1), plain_bwd,
           lambda: torch.cat(ref[1:], dim=1), results, work,
           time_kernel=one_pass, run_previous=pair, previous=prev,
           train=10, device_time=True)


def one_pass_small_case(g, hd, dev):
    """attention_short_bwd_sm90.cu at GQA 2, causal with Sq > Skv (rows
    i < Sq - Skv see no key), a per-key bias with two masked keys and a
    13-key (16-wide) tile, on the decoder's [B, S, H, D] views: within the
    bounds of the plain backward, masked keys at exactly zero dK / dV,
    two calls bit-identical."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.attention import (
        MASK_VALUE,
        flash_backward_plain,
    )

    b, hq, hkv, sq, skv, dead = 2, 8, 4, 333, 13, [4, 9]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, do = (randn(b, sq, hq, hd).transpose(1, 2) for _ in range(2))
    k, v = (randn(b, skv, hkv, hd).transpose(1, 2) for _ in range(2))
    bias = (2 * torch.randn(b, skv, generator=g, device=dev)).float()
    bias[:, dead] = MASK_VALUE
    kw = dict(scale=hd ** -0.5, causal=True, kv_bias=bias)
    if kernels.attention_bwd_entry(hd, skv, hkv) != (K6_SHORT_ENTRY,):
        raise AssertionError("the small case does not take the one pass")
    out, lse = kernels.attention(q, k, v, two_pass=True, with_lse=True,
                                 **kw)
    got = kernels.attention_bwd(q, k, v, out, do, lse, **kw)
    again = kernels.attention_bwd(q, k, v, out, do, lse, **kw)
    ref = flash_backward_plain(q.float(), k.float(), v.float(), bias,
                               out.float(), lse, do.float(), causal=True,
                               scale=hd ** -0.5)
    sync()
    errs = [_rel_err(a, w) for a, w in zip(got, ref)]
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    zero = not any(t[:, :, dead].any() for t in got[1:])
    log(f"[flash] one pass q{list(q.shape)} kv{list(k.shape)} causal, bias "
        f"with keys {dead} masked: rel dQ {errs[0]:.3e}, dK {errs[1]:.3e}, "
        f"dV {errs[2]:.3e}; masked keys' dK / dV zero: {zero}; two calls "
        f"bit-identical: {same}")
    if not (errs[0] <= BOUNDS["K6a"] and max(errs[1:]) <= BOUNDS["K6b"]):
        raise AssertionError(f"one pass small case: rel errs {errs}")
    if not (zero and same):
        raise AssertionError("one pass small case: masked keys got a "
                             "gradient or two calls differ")


def phase_grad_checks(seed, dev):
    """Every kernel op keeps the autograd graph, and the K1 / K4
    recompute gradients equal the plain layer's autograd on the card."""
    from video_llava_seg_torch.bridge import tree_map
    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.models.sam2 import hiera
    from video_llava_seg_torch.models.sam2.config import sam2_config
    from video_llava_seg_torch.ops.attention import attention
    from video_llava_seg_torch.ops.hiera_block import (
        hiera_block,
        hiera_block_plain,
    )
    from video_llava_seg_torch.ops.vit_block import (
        vit_layer,
        vit_layer_plain,
    )
    from video_llava_seg_torch.config import VisionTowerConfig

    g = torch.Generator(device=dev).manual_seed(seed + 4)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    q = randn(1, 4, 1100, 128).requires_grad_(True)
    kv = randn(1, 2, 1100, 128)
    outs = {"K2": attention(q, kv, kv, causal=True),
            "K3": attention(q[:, :, :300], kv[:, :, :7], kv[:, :, :7])}
    vc = dataclasses.replace(VisionTowerConfig(), num_layers=1)
    layer = tree_map(lambda t: t.requires_grad_(True),
                     perturb(vit.init(vc, g, dev, torch.float32), g)
                     ["layers"][0])
    x = randn(2, 577, vc.hidden_size).requires_grad_(True)
    kw = dict(num_heads=vc.num_heads, eps=vc.layernorm_eps, kv_len=577)
    outs["K1"] = vit_layer(layer, x, **kw)
    hc = sam2_config("sam2.1-hiera-small").hiera
    blk = tree_map(lambda t: t.requires_grad_(True),
                   perturb(hiera.init(hc, g, dev, torch.float32), g)
                   ["blocks"][0])
    xh = randn(2, 64, 64, hc.embed_dim).requires_grad_(True)
    hkw = dict(num_heads=hc.num_heads, ws=hc.window_spec[0], q_stride=None)
    outs["K4"] = hiera_block(blk, xh, **hkw)
    for name, o in outs.items():
        if o.grad_fn is None:
            raise AssertionError(f"{name}: output has no grad_fn")
    for name, y, inputs, plain in (
            ("K1", outs["K1"], [x, layer["fc1"]["kernel"],
                                layer["q_proj"]["bias"]],
             lambda: vit_layer_plain(layer, x, **kw)),
            ("K4", outs["K4"], [xh, blk["qkv"]["kernel"],
                                blk["norm1"]["scale"]],
             lambda: hiera_block_plain(blk, xh, eps=1e-6, **hkw))):
        gy = randn(*y.shape)
        got = torch.autograd.grad(y, inputs, gy)
        want = torch.autograd.grad(plain(), inputs, gy)
        # the recompute runs the plain layer's own ops on the same inputs:
        # equal up to the last bits a library call may pick differently
        for a, b_ in zip(got, want):
            rel = ((a.float() - b_.float()).abs().max()
                   / b_.float().abs().max().clamp_min(1e-12)).item()
            if a.dtype != b_.dtype or not rel <= GRAD_RECOMPUTE_BOUND:
                raise AssertionError(f"{name}: recompute gradient differs "
                                     f"from the plain layer's autograd "
                                     f"(rel {rel:.3e})")
        log(f"[grad] {name}: recompute gradients of x {list(inputs[0].shape)}"
            f" ({str(got[0].dtype).split('.')[-1]}) and fp32 master "
            "weights equal the plain layer's autograd (bound "
            f"{GRAD_RECOMPUTE_BOUND:.0e})")
    log("[grad] K1, K2, K3, K4 outputs carry a grad_fn")
    del outs, layer, blk, x, xh, q, kv
    torch.cuda.empty_cache()
    sync()


def _bytes_of(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def train_step_expect(cfg):
    """(launches by kernel, why, the flash backward's by C entry) of one
    full-width stage-3 QLoRA train step at batch 1, whatever its length
    and whether its sample is a referral or a caption (the seg head runs
    either way, a caption on its dummy path)."""
    from video_llava_seg_torch.models import seg_head, vit

    n_tower = vit.num_layers_run(cfg.vision)
    sc = seg_head.make_sam2_cfg(cfg.seg)
    n_dec = sc.twoway_depth
    layers = cfg.llm.num_layers
    expect = {"K1": n_tower, "K2": 2 * layers, "K3": n_dec,
              "K4": sc.hiera.depth, "K5": 0, "K6a": layers + n_dec,
              "K6b": layers + n_dec, "K7": 0, "K8": 0}
    why = {"K1": f"{n_tower} tower layers forward; their backward "
                 "recomputes the plain layer",
           "K2": f"{layers} LLM layers forward + {layers} recomputed by "
                 "gradient checkpointing",
           "K3": f"image->token attention in the {n_dec} two-way blocks",
           "K4": f"{sc.hiera.depth} Hiera blocks forward over the 8 seg "
                 "frames; their backward recomputes the plain block",
           "K5": "none: the train-mode base is weight-only int8",
           "K6a": f"{layers} LLM layers + {n_dec} mask-decoder "
                  "image->token attentions",
           "K6b": f"{layers} LLM layers + {n_dec} mask-decoder "
                  "image->token attentions",
           "K7": "none: K4 runs every Hiera block",
           "K8": "none: the tower trains in bf16 over fp32 masters"}
    # the LLM layers' backward on attention_bwd_sm90.cu's pair, the mask
    # decoder's in one pass, none on attention_bwd.cu
    bwd = {K6_SHORT_ENTRY: n_dec, K6_SM90_PAIR[0]: layers,
           K6_SM90_PAIR[1]: layers, K6_CUDA_C_PAIR[0]: 0,
           K6_CUDA_C_PAIR[1]: 0}
    return expect, why, bwd


def phase_train_slice(cfg, seed, dev, steps: int = 3):
    """Three full-width stage-3 QLoRA train steps; returns (counts of the
    last step, summary, the trained params: int8 base, fp32 LoRA and
    masters, for phase 23 to serve)."""
    from video_llava_seg_torch.train.optimizer import leaves_with_paths
    from video_llava_seg_torch.train.train import (
        init_params,
        synthetic_batches,
    )
    from video_llava_seg_torch.train.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )
    from video_llava_seg_torch.train.trainer import step_generator

    tcfg = train_tcfg(seed=seed)
    t0 = time.perf_counter()
    params = init_params(cfg, tcfg, dev)
    state, tx = create_train_state(params, tcfg)
    sync()
    leaves = leaves_with_paths(params)
    train_b = _bytes_of(tx.params)
    frozen_b = _bytes_of([t for _, t in leaves]) - train_b
    base = {p: t.clone() for p, t in leaves if p.startswith("llm/")}
    lora_b = params["lora"]["llm"]["layers"][0]["attn"]["wq"]["kernel_q"]["b"]
    log(f"[train] init: Llama-3-8B int8 base (bf16 scales, embedding, "
        f"norms) + fp32 LoRA r={tcfg.lora_rank} + fp32 tower, projector, "
        f"seg head in {time.perf_counter() - t0:.1f} s; trainable "
        f"{train_b / 1e9:.3f} GB in {len(tx.params)} leaves, frozen "
        f"{frozen_b / 1e9:.3f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    timings = {}
    step_fn = make_train_step(cfg, tcfg, tx, timings=timings)
    data = synthetic_batches(cfg, 1, seed=seed)
    expect, why, bwd = train_step_expect(cfg)
    torch.cuda.reset_peak_memory_stats()
    seconds, rows, counts = [], [], None
    for step in range(steps):
        batch = batch_to_device(next(data), dev, torch.bfloat16)
        b_before = lora_b.detach().clone()
        timings.clear()
        reset_launches()
        sync()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch, step_generator(seed, step))
        sync()
        seconds.append(time.perf_counter() - t1)
        counts = snapshot_launches()
        m = {k: float(v) for k, v in metrics.items()}
        rows.append({"seconds": seconds[-1], "stages": dict(timings), **m})
        stages = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        log(f"[train] step {step + 1}: {seconds[-1]:.3f} s ({stages} s); "
            f"loss {m['loss']:.4f} (text {m['loss_text']:.4f}, mask "
            f"{m['loss_mask']:.4f}), grad_norm {m['grad_norm']:.4f}, "
            f"{int(m['num_text_tokens'])} text tokens over "
            f"{batch['gather_idx'].shape[1]}")
        check_launches(f"train step {step + 1}", counts, expect, why,
                       bwd=bwd)
        for k in ("loss", "loss_mask"):
            if not math.isfinite(m[k]):
                raise AssertionError(f"train step {step + 1}: {k} not finite")
        if not (math.isfinite(m["grad_norm"]) and m["grad_norm"] > 0):
            raise AssertionError(f"train step {step + 1}: bad grad_norm")
        moved = not torch.equal(lora_b, b_before)
        if moved != (step > 0):
            raise AssertionError(f"train step {step + 1}: LoRA b "
                                 f"{'moved' if moved else 'did not move'} "
                                 "(lr 0 at update 0, > 0 after)")
        for p, t in leaves_with_paths(params):
            if p in base and not torch.equal(t, base[p]):
                raise AssertionError(f"train step {step + 1}: frozen base "
                                     f"leaf {p} changed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] {steps} steps: steady {statistics.mean(seconds[1:]):.3f} "
        f"s/step (steps 2..{steps}), first {seconds[0]:.3f} s; peak "
        f"allocated {peak:.1f} GiB; LoRA b unchanged after step 1 (lr 0), "
        "changed after step 2; int8 base bit-identical after every step")
    del state, tx, base, step_fn, batch, lora_b, b_before
    torch.cuda.empty_cache()
    sync()
    return counts, {"steps": rows, "peak_gib": peak,
                    "trainable_bytes": train_b, "frozen_bytes": frozen_b,
                    "steady_seconds": statistics.mean(seconds[1:])}, params


# ---------------------------------------------------------------------------
# the training data path (phase 26)
# ---------------------------------------------------------------------------

# the Llama-3 pre-tokenizer pattern (a tokenizer.json's Split regex)
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")
# Llama-3's named special tokens, at 128000 + their index; the rest of the
# 128000-128253 range is reserved_special_token_3 ...; 128254 and 128255
# stay free for <sf_vid_separator> and <vid_seg>, which must fall inside
# the 128256 embeddings (nothing resizes them)
LLAMA3_NAMED = ("<|begin_of_text|>", "<|end_of_text|>",
                "<|reserved_special_token_0|>",
                "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                "<|reserved_special_token_2|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>",
                "<|python_tag|>")
LLAMA3_SPECIALS = 254
# the ViCaS fixture of phase 26: two videos of 48 frames at 480 x 854,
# every sixth frame a ground-truth frame (8), two tracks each
VICAS_FRAMES, VICAS_HW, VICAS_GT_EVERY = 48, (480, 854), 6
VICAS_CAPTIONS = {
    7: ("A man in a red jacket walks a brown dog along a wet city street "
        "at night, passing parked cars and shop windows while rain falls "
        "under the orange street lights.",
        "On a rainy night a man wearing a red coat leads his brown dog down "
        "a city sidewalk past shops and parked cars."),
    8: ("Two children kick a white ball across a grassy park on a sunny "
        "afternoon; one of them falls, gets up laughing and runs after "
        "the ball while trees sway in the background.",
        "In a sunny park two kids play football on the grass, one trips "
        "and gets back up, and the ball rolls toward the trees."),
}
VICAS_REFERRALS = {7: ("the man in the red jacket", "the brown dog"),
                   8: ("the child who falls", "the white ball")}


def write_llama3_tokenizer(path, corpus, n_merges: int,
                           special_base: Optional[int] = 128000,
                           n_specials: int = LLAMA3_SPECIALS):
    """A Llama-3-format tokenizer.json + tokenizer_config.json, written
    without the `tokenizers` library: the 256 byte symbols, `n_merges`
    BPE merges learned here from `corpus` (the most frequent pair first,
    ties by the pair), unused entries up to `special_base` (where the
    specials start; tokenizers numbers them from the vocabulary's size),
    `ignore_merges`, the Split / ByteLevel
    pre-tokenizer, the ByteLevel decoder, a TemplateProcessing BOS, and
    `n_specials` special tokens from `special_base` (the real file's
    range at the default; None: right after the base vocabulary).
    Returns `path`."""
    from collections import Counter

    from video_llava_seg_torch.tokenizer import (
        bytes_to_unicode,
        compile_pattern,
    )

    table = bytes_to_unicode()
    vocab = {table[b]: b for b in range(256)}
    regex = compile_pattern(LLAMA3_PATTERN)
    words = Counter("".join(table[b] for b in w.encode("utf-8"))
                    for text in corpus for w in regex.findall(text))
    seqs = {w: list(w) for w in words}
    merges = []
    while len(merges) < n_merges:
        pairs = Counter()
        for w, n in words.items():
            s = seqs[w]
            for a, b in zip(s, s[1:]):
                pairs[(a, b)] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append([a, b])
        vocab.setdefault(a + b, len(vocab))
        for w, s in seqs.items():
            out, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = out
    if special_base is None:
        special_base = len(vocab)
    if len(vocab) > special_base:
        raise ValueError("the base vocabulary overlaps the special tokens")
    # tokenizers numbers an added token from the model's vocabulary size,
    # so the vocabulary runs up to special_base: unused entries that no
    # pre-token can equal (letters, digits and symbols split apart)
    while len(vocab) < special_base:
        vocab[f"<unused_{len(vocab)}>"] = len(vocab)
    names = list(LLAMA3_NAMED) + [f"<|reserved_special_token_{i}|>"
                                  for i in range(3, n_specials
                                                 - len(LLAMA3_NAMED) + 3)]
    added = [{"id": special_base + i, "content": name, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, name in enumerate(names)]
    bos = {"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": "<|begin_of_text|>",
                                        "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {"<|begin_of_text|>": {
                 "id": "<|begin_of_text|>", "ids": [special_base],
                 "tokens": ["<|begin_of_text|>"]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as fh:
        json.dump(spec, fh, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as fh:
        json.dump({"bos_token": "<|begin_of_text|>",
                   "eos_token": "<|eot_id|>",
                   "clean_up_tokenization_spaces": True,
                   "model_max_length": 1000000000000000019884624838656,
                   "tokenizer_class": "PreTrainedTokenizerFast"}, fh)
    return path


def tokenizer_corpus():
    """The text phase 26's tokenizers learn their merges from: every
    caption and referral of the fixture, the ViCaS prompts and the
    llava_llama_3 template around them."""
    from video_llava_seg_torch.data.vicas import PROMPT_LIST
    from video_llava_seg_torch.inference import main as serve

    texts = [t for pair in VICAS_CAPTIONS.values() for t in pair]
    texts += [r for refs in VICAS_REFERRALS.values() for r in refs]
    texts += PROMPT_LIST + [serve.CAPTION_PROMPT, REFERRAL,
                            "Please output the segmentation mask.",
                            "You are a helpful language and vision "
                            "assistant.", "user\n\n", "assistant\n\n"]
    return texts


def npy_clip(data: bytes, num_frames: int, return_timestamps: bool = False):
    """`video_io.load_video_uniform` over a clip stored as .npy bytes."""
    import io

    from video_llava_seg_torch.data import video_io

    return video_io.load_video_uniform(np.load(io.BytesIO(data)),
                                       num_frames,
                                       return_timestamps=return_timestamps)


# the ViCaS datasets' decoders on this machine (no OpenCV, no PIL)
NPY_READERS = {"read_clip": npy_clip, "read_frame": np.load}


def write_vicas_train_fixture(root, seed, version="v0.1"):
    """A ViCaS layout with train and val splits of two videos
    (VICAS_CAPTIONS): clips of VICAS_FRAMES uint8 frames at VICAS_HW and
    their ground-truth frames as .npy (`NPY_READERS`, `ArrayFetcher`),
    COCO-RLE masks of two moving tracks on every ground-truth frame, a
    caption, a reworded caption and two referrals each."""
    from video_llava_seg_torch.ops.masks import encode_rle

    h, w = VICAS_HW
    vicas = os.path.join(root, "ViCaS")
    for d in ("videos", f"annotations/{version}", f"splits/{version}"):
        os.makedirs(os.path.join(vicas, d), exist_ok=True)
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    for vid, (caption, reworded) in VICAS_CAPTIONS.items():
        frames = rng.integers(0, 255, (VICAS_FRAMES, h, w, 3),
                              dtype=np.uint8)
        np.save(os.path.join(vicas, "videos", f"vid{vid}.npy"), frames)
        frames_dir = os.path.join(vicas, "video_frames", f"{vid:06d}")
        os.makedirs(frames_dir, exist_ok=True)
        segs = []
        for t in range(VICAS_FRAMES):
            name = f"{t:05d}.npy"
            if t % VICAS_GT_EVERY:
                segs.append({"filename": name, "is_gt": False,
                             "track_ids": [], "mask_rles": []})
                continue
            np.save(os.path.join(frames_dir, name), frames[t])
            box = np.zeros((h, w), np.uint8)
            box[100 + 2 * t:260 + 2 * t, 150 + 4 * t:330 + 4 * t] = 1
            disc = (((ys - 300) ** 2 + (xs - 600 + 3 * t) ** 2)
                    < 70 ** 2).astype(np.uint8)
            rles = []
            for m in (box, disc):
                rle = encode_rle(m)
                rle["counts"] = rle["counts"].decode("utf-8")
                rles.append(rle)
            segs.append({"filename": name, "is_gt": True,
                         "track_ids": [1, 2], "mask_rles": rles})
        content = {"video_id": vid, "filename": f"vid{vid}.npy",
                   "caption_raw_en": caption,
                   "caption_parsed_en_gpt": caption,
                   "reworded_en_captions": [reworded],
                   "object_referrals": [
                       {"prompt": p, "track_ids": [k + 1]}
                       for k, p in enumerate(VICAS_REFERRALS[vid])],
                   "segmentations": segs}
        with open(os.path.join(vicas, "annotations", version,
                               f"{vid:06d}.json"), "w") as fh:
            json.dump(content, fh)
    for split in ("train", "val"):
        with open(os.path.join(vicas, "splits", version, f"{split}.json"),
                  "w") as fh:
            json.dump(sorted(VICAS_CAPTIONS), fh)


def phase_train_data(cfg, params, seed, dev, smi, workdir, steps: int = 4):
    """Phase 26: the training data path at full width. A ViCaS fixture
    (`write_vicas_train_fixture`) and a Llama-3-format tokenizer written
    here; `initialize_vision_tokenizer`; the port's ViCaS dataset (.npy
    readers), collator, length-grouped sampler (`train.data_batches`) and
    CUDA prefetcher feed `steps` stage-3 QLoRA steps on phase 8's trained
    tree (a new optimizer: update 0 at lr 0); the sampler's order at seed
    0 gives a referral, two captions, then a warm referral. Per step: launches by
    kernel and C entry (`train_step_expect`) at the bucketed length, the
    prefetched tensors equal to the host batch, `num_text_tokens` equal
    to the host labels' count, finite losses, LoRA b unchanged after step
    1 and moving after, the int8 base bit-identical; seconds beside the
    prefetcher's wait and the seg head's share. Returns (the last step's
    counts, summary)."""
    from video_llava_seg_torch.config import DataConfig
    from video_llava_seg_torch.constants import IGNORE_INDEX
    from video_llava_seg_torch.data.collate import (
        make_supervised_data_module,
    )
    from video_llava_seg_torch.data.prefetch import (
        host_tensors,
        prefetch_to_device,
    )
    from video_llava_seg_torch.tokenizer import Tokenizer
    from video_llava_seg_torch.train.optimizer import leaves_with_paths
    from video_llava_seg_torch.train.train import (
        data_batches,
        initialize_vision_tokenizer,
    )
    from video_llava_seg_torch.train.train_step import (
        create_train_state,
        make_train_step,
    )
    from video_llava_seg_torch.train.trainer import RowGenerators

    t0 = time.perf_counter()
    root = os.path.join(workdir, "datasets")
    write_vicas_train_fixture(root, seed)
    tok_dir = write_llama3_tokenizer(os.path.join(workdir, "tokenizer"),
                                     tokenizer_corpus(), n_merges=400)
    tok = Tokenizer.from_pretrained(tok_dir)
    dcfg = initialize_vision_tokenizer(tok, cfg)
    log(f"[train-data] fixture and tokenizer written in "
        f"{time.perf_counter() - t0:.1f} s: {len(tok)} tokens "
        f"({tok.vocab_size} base, {LLAMA3_SPECIALS} specials, 2 added), "
        f"<vid_seg> "
        f"{dcfg.seg_token_idx}, <sf_vid_separator> "
        f"{dcfg.sf_separator_token_idx}")
    data_args = DataConfig(num_frames=dcfg.num_frames,
                           num_slow_frames=dcfg.num_slow_frames,
                           seg_image_size=dcfg.seg.image_size,
                           max_seg_frames=dcfg.seg.max_seg_frames)
    old_env = os.environ.get("VIDEONET_DATASETS_DIR")
    os.environ["VIDEONET_DATASETS_DIR"] = root
    try:
        module = make_supervised_data_module(tok, dcfg, data_args,
                                             **NPY_READERS)
    finally:
        if old_env is None:
            os.environ.pop("VIDEONET_DATASETS_DIR", None)
        else:
            os.environ["VIDEONET_DATASETS_DIR"] = old_env
    ds = module["train_dataset"]
    tcfg = train_tcfg(seed=seed)
    host = []

    def kept(batches):
        for b in batches:
            host.append(b)
            yield b

    prefetch = prefetch_to_device(
        kept(data_batches(ds, module["data_collator"], tcfg)), dev, size=2,
        dtype=torch.bfloat16)
    state, tx = create_train_state(params, tcfg)
    leaves = leaves_with_paths(params)
    base = {p: t.clone() for p, t in leaves if p.startswith("llm/")}
    lora_b = params["lora"]["llm"]["layers"][0]["attn"]["wq"]["kernel_q"]["b"]
    timings = {}
    step_fn = make_train_step(dcfg, tcfg, tx, timings=timings)
    expect, why, bwd = train_step_expect(dcfg)
    rows, counts = [], None
    # phase 28's reference: the trainable leaves before step 1 and after
    # FSDP_REF_STEPS steps, those steps' device batches and metrics
    fsdp_ref = {"start": {p: t.detach().clone() for p, t in leaves
                          if not p.startswith("llm/")},
                "batches": [], "metrics": [], "cfg": dcfg}
    for step in range(steps):
        batch = next(prefetch)
        wait = prefetch.waits[-1]
        want = host_tensors(host[step], torch.bfloat16)
        same = sorted(batch) == sorted(want) and all(
            torch.equal(batch[k].cpu(), want[k]) for k in want)
        if not same:
            raise AssertionError(f"train-data step {step + 1}: the "
                                 "prefetched batch differs from the host's")
        kind = "referral" if bool(host[step]["has_masks"].any()) \
            else "caption"
        length = int(batch["gather_idx"].shape[1])
        b_before = lora_b.detach().clone()
        timings.clear()
        reset_launches()
        sync()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch, RowGenerators(seed, step))
        sync()
        seconds = time.perf_counter() - t1
        counts = snapshot_launches()
        m = {k: float(v) for k, v in metrics.items()}
        if step < FSDP_REF_STEPS:
            fsdp_ref["batches"].append(batch)
            fsdp_ref["metrics"].append(m)
            if step + 1 == FSDP_REF_STEPS:
                fsdp_ref["after"] = {p: t.detach().clone() for p, t in
                                     leaves_with_paths(params)
                                     if p in fsdp_ref["start"]}
        n_text = int((host[step]["labels"][:, 1:] != IGNORE_INDEX).sum())
        share = timings.get("seg", 0.0) / seconds
        rows.append({"kind": kind, "length": length, "seconds": seconds,
                     "prefetch_wait_s": wait, "seg_share": share,
                     "stages": dict(timings), **m})
        stages = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        log(f"[train-data] step {step + 1} ({kind}, {length} tokens "
            f"bucketed from {int(host[step]['attn_mask'].sum())}): "
            f"{seconds:.3f} s ({stages} s), seg head {share:.3f} of the "
            f"step; prefetch wait {wait:.3f} s; loss {m['loss']:.4f} "
            f"(text {m['loss_text']:.4f}, mask {m['loss_mask']:.4f}), "
            f"grad_norm {m['grad_norm']:.4f}, {int(m['num_text_tokens'])} "
            f"text tokens; {smi}")
        check_launches(f"train-data step {step + 1}", counts, expect, why,
                       bwd=bwd)
        if int(m["num_text_tokens"]) != n_text:
            raise AssertionError(f"train-data step {step + 1}: "
                                 f"{int(m['num_text_tokens'])} text tokens, "
                                 f"the host labels count {n_text}")
        if length % 128 or length > dcfg.tokenizer_model_max_length:
            raise AssertionError(f"train-data step {step + 1}: length "
                                 f"{length} is not a bucket")
        for k in ("loss", "loss_mask"):
            if not math.isfinite(m[k]):
                raise AssertionError(f"train-data step {step + 1}: {k} not "
                                     "finite")
        if not (math.isfinite(m["grad_norm"]) and m["grad_norm"] > 0):
            raise AssertionError(f"train-data step {step + 1}: bad "
                                 "grad_norm")
        moved = not torch.equal(lora_b, b_before)
        if moved != (step > 0):
            raise AssertionError(f"train-data step {step + 1}: LoRA b "
                                 f"{'moved' if moved else 'did not move'} "
                                 "(lr 0 at update 0, > 0 after)")
        for p, t in leaves_with_paths(params):
            if p in base and not torch.equal(t, base[p]):
                raise AssertionError(f"train-data step {step + 1}: frozen "
                                     f"base leaf {p} changed")
    kinds = {r["kind"] for r in rows}
    if kinds != {"caption", "referral"}:
        raise AssertionError(f"train-data: the steps saw only {kinds}")
    log(f"[train-data] {steps} steps from the ViCaS fixture: LoRA b "
        "unchanged after step 1 (lr 0), changed after; int8 base "
        "bit-identical; every prefetched batch equal to the host's")
    prefetch.close()
    del state, tx, base, step_fn, batch, lora_b, b_before, prefetch
    torch.cuda.empty_cache()
    sync()
    return counts, {"steps": rows, "tokenizer_dir": tok_dir, "root": root,
                    "fsdp_ref": fsdp_ref}


def phase_train_data_cli(seed, dev, smi, workdir, root):
    """Phase 26, continued: the tiny training CLI on the card from the
    same fixture (`--dataset vicas --tokenizer <dir>`, .npy readers; the
    tiny model has no seg head, so its captions only), 2 steps with a
    checkpoint; the checkpoint given the tokenizer's files and served by
    `run_inference` with the tokenizer `load_model` reads from it (no
    SmokeTokenizer), a caption decoded for each video."""
    import shutil as sh

    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.tokenizer import Tokenizer
    from video_llava_seg_torch.train import train as train_cli

    tok_dir = write_llama3_tokenizer(
        os.path.join(workdir, "tokenizer_tiny"), tokenizer_corpus(),
        n_merges=150, special_base=None, n_specials=len(LLAMA3_NAMED))
    tok = Tokenizer.from_pretrained(tok_dir)
    out = os.path.join(workdir, "train_data")
    old_env = os.environ.get("VIDEONET_DATASETS_DIR")
    os.environ["VIDEONET_DATASETS_DIR"] = root
    try:
        t0 = time.perf_counter()
        state = train_cli.main([
            "--stage", "stage3", "--tiny", "--dataset", "vicas",
            "--tokenizer", tok_dir, "--bits", "8", "--lora_enable",
            "--device", dev.type, "--num_train_steps", "2",
            "--save_steps", "2", "--gradient_accumulation_steps", "1",
            "--output_dir", out], readers=NPY_READERS)
        sync()
        t_train = time.perf_counter() - t0
        with open(os.path.join(out, "train_log.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        if state.step != 2 or [r["step"] for r in logged] != [1, 2] or \
                not all(math.isfinite(r["loss"]) for r in logged):
            raise AssertionError(f"training CLI from the ViCaS fixture: "
                                 f"{logged}")
        ckpt = os.path.join(out, "checkpoint-2")
        for f in ("tokenizer.json", "tokenizer_config.json"):
            sh.copy(os.path.join(tok_dir, f), ckpt)
        loaded = serve.load_model(ckpt, device=dev)[2]
        if not isinstance(loaded, Tokenizer) or len(loaded) != len(tok):
            raise AssertionError("load_model: no port tokenizer read from "
                                 "the checkpoint")
        pred_dir = os.path.join(workdir, "pred_data")
        t0 = time.perf_counter()
        serve.run_inference(serve.parse_args([
            "-i", ckpt, "-o", pred_dir, "--max_new_tokens", "8",
            "--dataset_version", "v0.1", "--skip_seg", "--device",
            dev.type]), fetcher=ArrayFetcher(root))
        sync()
        t_serve = time.perf_counter() - t0
    finally:
        if old_env is None:
            os.environ.pop("VIDEONET_DATASETS_DIR", None)
        else:
            os.environ["VIDEONET_DATASETS_DIR"] = old_env
    captions = {}
    for vid in VICAS_CAPTIONS:
        with open(os.path.join(pred_dir, f"{vid:06d}.json")) as fh:
            captions[vid] = json.load(fh)["pred_caption"]
        if not isinstance(captions[vid], str):
            raise AssertionError(f"video {vid}: no caption")
    log(f"[train-data] tiny CLI --dataset vicas --tokenizer on the card: 2 "
        f"steps in {t_train:.1f} s, losses "
        f"{[round(r['loss'], 4) for r in logged]}; checkpoint-2 served by "
        f"run_inference with load_model's tokenizer ({len(loaded)} tokens) "
        f"in {t_serve:.1f} s: captions {captions}; {smi}")
    return {"cli_losses": [r["loss"] for r in logged],
            "cli_seconds": t_train, "serve_seconds": t_serve,
            "captions": captions}


def _tiny_train_cfg():
    from video_llava_seg_torch.config import SegHeadConfig, VideoLlavaConfig

    return dataclasses.replace(
        VideoLlavaConfig.tiny(), seg_token_idx=400,
        seg=SegHeadConfig(seg_backbone="sam2-test-tiny", image_size=64,
                          max_seg_frames=1, max_objects=2))


# the tiny stage-3 QLoRA step, bf16 activations over the same fp32
# masters (card) vs fp32 (CPU): relative error of the loss, the mask
# loss, grad_norm, and max |dLoRA| difference over max |dLoRA|. The
# gradients pass back through ~10 bf16 hand-offs (2^-8 each) and the
# int8 base's bf16 products. Measured on an H100 (700 W): loss 8.4e-5,
# loss_mask 8.7e-4, grad_norm 4.3e-3, LoRA gradients 6.2e-2; the bounds
# keep 3-10x of headroom.
TRAIN_AGREE_BOUNDS = {"loss": 1e-3, "loss_mask": 1e-2, "grad_norm": 2e-2,
                      "lora_grads": 2e-1}


def phase_train_agreement(seed, workdir):
    """One tiny stage-3 QLoRA step on the card and on the CPU, same
    weights and batch; then the training CLI on the card, its output in
    `workdir` (phase 23 serves its checkpoint-4). Returns (the agreement
    summary, the CLI's final params on the CPU)."""
    import os

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.bridge import tree_map
    from video_llava_seg_torch.models import llava
    from video_llava_seg_torch.ops.quantization import quantize_tree
    from video_llava_seg_torch.train import lora, train as train_cli
    from video_llava_seg_torch.train.optimizer import (
        global_norm,
        leaves_with_paths,
    )
    from video_llava_seg_torch.train.train import synthetic_batches
    from video_llava_seg_torch.train.train_step import (
        batch_to_device,
        compute_loss,
    )
    from video_llava_seg_torch.train.trainer import step_generator

    cfg = _tiny_train_cfg()
    g = torch.Generator().manual_seed(seed)
    params = llava.init(cfg, g, "cpu", torch.float32)
    params["llm"] = quantize_tree(params["llm"], bits=8, min_size=0,
                                  train_mode=True)
    params["lora"] = lora.init_lora(g, params, 8)
    # a non-zero b, so every adapter leaf gets a gradient
    for _, t in leaves_with_paths(params["lora"]):
        if not t.any():
            t.normal_(0.0, 0.02, generator=g)
    batch = next(synthetic_batches(cfg, 2, seed=seed))
    out = {}
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        p = tree_map(lambda t: t.detach().clone().to(dev), params)
        for _, t in leaves_with_paths(p["lora"]):
            t.requires_grad_(True)
        merged = lora.merge({k: v for k, v in p.items() if k != "lora"},
                            p["lora"], 16.0)
        before = kernels.LAUNCHES.snapshot()
        loss, m = compute_loss(merged, cfg, batch_to_device(batch, dev, dt),
                               step_generator(seed, 0), remat=True)
        loss.backward()
        grads = [t.grad.float().cpu() for _, t in
                 leaves_with_paths(p["lora"])]
        out[dev] = (float(loss.detach()), float(m["loss_mask"].detach()),
                    float(global_norm(grads)), torch.cat(
                        [x.flatten() for x in grads]))
        after = kernels.LAUNCHES.snapshot()
        if dev == "cuda" and not all(after[n] > before[n]
                                     for n in ("K1", "K3", "K4", "K6a",
                                               "K6b")):
            raise AssertionError("tiny train step: a kernel did not launch")
    rel = {k: abs(out["cuda"][i] - out["cpu"][i]) / max(abs(out["cpu"][i]),
                                                          1e-6)
           for i, k in enumerate(("loss", "loss_mask", "grad_norm"))}
    dg = out["cuda"][3] - out["cpu"][3]
    rel["lora_grads"] = float(dg.abs().max() / out["cpu"][3].abs().max())
    log("[train-agree] tiny stage-3 QLoRA step, card bf16 kernels vs CPU "
        "fp32 plain: " + ", ".join(
            f"{k} rel {v:.3e} (bound {TRAIN_AGREE_BOUNDS[k]:.0e})"
            for k, v in rel.items()))
    if not all(math.isfinite(v) and v <= TRAIN_AGREE_BOUNDS[k]
               for k, v in rel.items()):
        raise AssertionError("tiny train step: card and CPU disagree")

    tmp = workdir
    argv = ["--stage", "stage3", "--tiny", "--synthetic", "--bits", "8",
            "--lora_enable", "--device", "cuda", "--save_steps", "2",
            "--gradient_accumulation_steps", "1", "--output_dir", tmp]
    train_cli.main(argv + ["--num_train_steps", "2"])
    first = os.listdir(tmp)
    state = train_cli.main(argv + ["--num_train_steps", "4"])
    with open(os.path.join(tmp, "train_log.jsonl")) as fh:
        logged = [json.loads(line)["step"] for line in fh]
    ok = (logged == [1, 2, 3, 4] and "checkpoint-2" in first
          and os.path.exists(os.path.join(tmp, "checkpoint-4",
                                          "checkpoint_saved.flag"))
          and os.path.exists(os.path.join(tmp, "training_complete.flag")))
    log(f"[train-agree] CLI on the card: 2 steps with a checkpoint, then "
        f"resumed to 4: logged steps {logged}, files "
        f"{sorted(os.listdir(tmp))}")
    if not ok:
        raise AssertionError("training CLI: checkpoint / resume / "
                             "complete flag protocol broken")
    rel["cli_logged_steps"] = logged
    sync()
    return rel, tree_map(lambda t: t.detach().cpu(), state.params)


# the tiny slice runs ~20 layers end to end (tower, LLM, Hiera, decoder)
# in bf16 against fp32; each bf16 hand-off costs ~2^-8 relative. Measured
# on an H100 (700 W): 1.7e-2, with 0.998 of the mask signs equal; the
# bound keeps ~3x of headroom.
AGREE_BOUND = 5e-2
# the same tiny slice with every LLM dense W4A8, fused, int8 KV, batch 2:
# the per-row int8 quantization of bf16 (card) vs fp32 (CPU) activations
# may move single int8 levels, which the following layers carry on.
# Measured on an H100 (700 W): 1.75e-2, 0.9987 of the mask signs equal;
# the bound keeps ~3x of headroom.
QUANT_AGREE_BOUND = 5e-2


# ---------------------------------------------------------------------------
# the serving entry point's remaining surface: beams, sampling, and
# train -> serve -> score
# ---------------------------------------------------------------------------

# a decode's length-penalised score (the mean log-probability of its
# tokens) against the same tokens rescored by one prefill over prompt and
# tokens: the prefill runs K2 and 5k-row products where the decode runs
# the plain attention and 1- or 4-row products, so bf16 / int8 roundings
# differ. Measured on an H100 (700 W), two seeds: 5.8e-3-6.9e-3 (bf16),
# 4e-4-1.0e-2 (W4A8 + int8 KV: a per-row int8 level moved); ~2x of
# headroom. (A 4-beam search need not beat greedy: at random weights,
# rescored by one prefill, the winner scored 9.6e-4 and 3.4e-3 below
# greedy's sequence on those seeds; both are printed.)
BEAM_RESCORE_BOUND = 2e-2


def referral_input(cfg, tok, frames, dev):
    """The referral prompt's ids and the clip, preprocessed on `dev`."""
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.inference.utils import clip_preprocess_frames
    from video_llava_seg_torch.mm_utils import tokenizer_image_token

    ids = np.asarray(tokenizer_image_token(
        serve.build_prompt(cfg, REFERRAL, "llava_llama_3"), tok))[None]
    video = clip_preprocess_frames(torch.from_numpy(frames).to(dev),
                                   cfg.vision.image_size)[None]
    return ids, video.to(torch.bfloat16)


def teacher_forced_score(llm, lcfg, embeds, tokens, n: int,
                         length_penalty: float = 1.0) -> float:
    """Length-penalised score of tokens[0, :n] after the prompt `embeds`,
    from one prefill over the prompt and the tokens (the sum of each
    token's log-probability over n ** length_penalty)."""
    from video_llava_seg_torch.models import llama

    tok = tokens[:, :n]
    x = torch.cat([embeds, llama.embed(llm, tok[:, :-1]).to(embeds.dtype)],
                  dim=1)
    s = embeds.shape[1]
    cache = llama.init_kv_cache(lcfg, 1, x.shape[1], embeds.device,
                                dtype=embeds.dtype)
    _, hidden, _ = llama.prefill(llm, lcfg, x,
                                 torch.arange(x.shape[1],
                                              device=x.device)[None],
                                 cache, last_logit_only=True)
    lp = torch.log_softmax(llama.unembed(llm, lcfg, hidden[:, s - 1:]), -1)
    return float(lp[0].gather(1, tok[0, :, None]).sum()) / n ** \
        length_penalty


def step_device_ms(lcfg, llm, rows: int, prompt_len: int, max_new: int,
                   dtype, dev):
    """Device time of one decode step at `rows` rows and of one beam
    reorder there, at the middle of the decode (the average number of
    generated slots) on a cache of the serving shape: the step's
    torch.profiler busy time (its host time is the host's, not this) and
    the reorder (`_reorder_gen_slots` over K, V and, for an int8 cache,
    their scales) by a CUDA graph of 10."""
    from video_llava_seg_torch.models import llama

    cache = llama.init_kv_cache(lcfg, rows, prompt_len + max_new, dev,
                                dtype=dtype)._replace(
        length=prompt_len + max_new // 2)
    emb = llama.embed(llm, torch.zeros((rows, 1), device=dev,
                                       dtype=torch.long)).to(dtype)
    step, _ = device_busy_ms(lambda: llama.decode_step(llm, lcfg, emb,
                                                       cache))
    parents = torch.arange(rows, device=dev).roll(1)

    def reorder():
        for x in cache[:2] + cache[3:]:
            llama._reorder_gen_slots(x, parents, prompt_len, cache.length)

    ms = graph_ms(reorder) if rows > 1 else None
    del cache
    torch.cuda.empty_cache()
    return step, ms


def beam_checks(tag, params, cfg, tok, frames, seg, meta, max_new, dev,
                smi):
    """One tree's beam checks: num_beams 1 equals greedy; num_beams 4
    through `get_model_output_frames` on the referral query (launches
    counted over that call; its seg head reads the winning beam's
    hidden states), reproduced by `llama.beam_generate` on the same
    embeddings; the winner's and greedy's scores, each from its own
    decode and rescored by one prefill (the decode's score within
    BEAM_RESCORE_BOUND of the rescored one); a decode step's host time
    beside greedy's, the device time of a decode step at 4 rows and at
    1 and of the cache reorder. Returns (counts, summary)."""
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.models import llama, llava

    lcfg = cfg.llm
    eos = (tok.convert_tokens_to_ids("<|eot_id|>"),)
    stops = serve.keyword_stop_sequences(tok, "llava_llama_3")
    ids, video = referral_input(cfg, tok, frames, dev)
    embeds, _ = llava.embed_prompts(params, cfg, ids, video)
    kw = dict(max_new_tokens=max_new, eos_token_ids=eos,
              stop_sequences=tuple(stops))
    llm = params["llm"]
    g_info, b_info, g_time, b_time = {}, {}, {}, {}
    gt, gh, gn = llama.greedy_generate(llm, lcfg, embeds, info=g_info,
                                       timings=g_time, **kw)
    bt, bh, bn = llama.beam_generate(llm, lcfg, embeds, num_beams=1, **kw)
    sync()
    if bn != gn or not torch.equal(bt, gt):
        raise AssertionError(f"{tag}: num_beams=1 gave other tokens than "
                             "greedy")
    log(f"[{tag}] num_beams=1: {bn} tokens equal to greedy's, hidden "
        f"states within {float((bh.float() - gh.float()).abs().max()):.3e}")

    reset_launches()
    sync()
    t0 = time.perf_counter()
    text, logits = serve.get_model_output_frames(
        params, cfg, tok, frames, REFERRAL, "llava_llama_3", max_new,
        seg_frames_u8=seg, seg_meta=meta, eos_token_ids=list(eos),
        stop_sequences=stops, num_beams=4)
    sync()
    seconds = time.perf_counter() - t0
    counts = snapshot_launches()
    want_shape = (1, cfg.seg.max_seg_frames, *meta["orig_image_size"])
    if logits is None or logits.shape != want_shape or \
            not np.isfinite(logits).all():
        raise AssertionError(f"{tag}: mask logits "
                             f"{None if logits is None else logits.shape}, "
                             f"expected finite {want_shape}")
    tokens, hidden, n = llama.beam_generate(llm, lcfg, embeds, num_beams=4,
                                            info=b_info, timings=b_time,
                                            **kw)
    sync()
    if tok.decode(tokens[0, :n].cpu().numpy()).strip() != text:
        raise AssertionError(f"{tag}: beam_generate on the same embeddings "
                             "gave another text than the entry point")
    if not torch.isfinite(hidden[0, :n].float()).all():
        raise AssertionError(f"{tag}: winning hidden states not finite")
    score = {"beam": b_info["score"], "greedy": g_info["logprob"][0] / gn}
    rescored = {"beam": teacher_forced_score(llm, lcfg, embeds, tokens, n),
                "greedy": teacher_forced_score(llm, lcfg, embeds, gt, gn)}
    same = n == gn and torch.equal(tokens, gt)
    log(f"[{tag}] num_beams=4 referral query through "
        f"get_model_output_frames: {seconds:.3f} s ({n} tokens, "
        f"{b_info['steps']} decode steps), mask logits "
        f"{list(logits.shape)} finite from the winning beam's hidden "
        f"states; length-penalised score from the decode: beam "
        f"{score['beam']:.6f}, greedy {score['greedy']:.6f}; rescored by "
        f"one prefill: beam {rescored['beam']:.6f}, greedy "
        f"{rescored['greedy']:.6f} (the beam's tokens "
        f"{'equal' if same else 'differ from'} greedy's)")
    err = max(abs(score[k] - rescored[k]) for k in score)
    if not err <= BEAM_RESCORE_BOUND:
        raise AssertionError(f"{tag}: a decode's score is {err:.3e} from "
                             f"its rescored value (bound "
                             f"{BEAM_RESCORE_BOUND})")

    s = embeds.shape[1]
    dev_ms = {r: step_device_ms(lcfg, llm, r, s, max_new, embeds.dtype, dev)
              for r in (1, 4)}
    host = {"greedy": g_time["decode"] / g_info["steps"],
            "beams_4": b_time["decode"] / b_info["steps"]}
    fmt = (lambda v: "not measured" if v is None else f"{v:.3f} ms")
    log(f"[{tag}] decode step by the host clock: 4 beams "
        f"{host['beams_4'] * 1e3:.2f} ms, greedy {host['greedy'] * 1e3:.2f} "
        f"ms; device time of a decode step at 4 rows {fmt(dev_ms[4][0])}, "
        f"at 1 row {fmt(dev_ms[1][0])} (torch.profiler, mid-decode; the "
        f"beam's bookkeeping not included); cache reorder a step (4 beams, "
        f"{max_new // 2} generated slots) {dev_ms[4][1]:.4f} ms (CUDA "
        f"graph); {smi}")
    del embeds, video, gt, gh, bt, bh, tokens, hidden
    return counts, {"seconds": seconds, "tokens": n,
                    "decode_steps": b_info["steps"], "score": score,
                    "rescored": rescored, "host_s_per_step": host,
                    "step_device_ms": {"rows_4": dev_ms[4][0],
                                       "rows_1": dev_ms[1][0]},
                    "reorder_device_ms": dev_ms[4][1]}


def phase_beams(cfg, seed, max_new_tokens, dev, smi, hw=(480, 854)):
    """Phase 21: beam search at full width on phase 3's bf16 tree, then
    on phase 4's W4A8 + int8-KV tree (K5's launches by C entry over the
    beam call). Returns (bf16 counts, W4A8 counts, summary); the W4A8
    tree is returned too, for phase 22."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.models import llava, seg_head, vit

    tok = SmokeTokenizer(cfg.llm.vocab_size)
    frames, seg, meta = _smoke_inputs(seed, cfg.num_frames, hw,
                                      cfg.seg.max_seg_frames)
    params = llava.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev, torch.bfloat16)
    bf_counts, bf = beam_checks("beams bf16", params, cfg, tok, frames, seg,
                                meta, max_new_tokens, dev, smi)
    del params
    torch.cuda.empty_cache()
    n_tower = vit.num_layers_run(cfg.vision)
    sc = seg_head.make_sam2_cfg(cfg.seg)
    layers = cfg.llm.num_layers
    expect = {"K1": n_tower, "K2": layers, "K3": sc.twoway_depth,
              "K4": sc.hiera.depth, "K5": 0, "K6a": 0, "K6b": 0, "K7": 0,
              "K8": 0}
    why = {"K1": f"{n_tower} tower layers, one query",
           "K2": f"{layers} layers of the batch-1 prefill (the K beams "
                 "decode through the plain twin)",
           "K3": "image->token attention in the 2 two-way blocks",
           "K4": "16 Hiera blocks, 8 seg frames batched",
           "K5": "none: a bf16 tree has no W4A8 dense",
           "K6a": "none: serving runs no backward",
           "K6b": "none: serving runs no backward",
           "K7": "none: K4 runs every Hiera block",
           "K8": "none: a bf16 tower has no W8A8 layer"}
    check_launches("beams bf16", bf_counts, expect, why)

    qparams, qcfg = build_quant_params(cfg, seed, dev)
    q_counts, q = beam_checks("beams w4a8", qparams, qcfg, tok, frames, seg,
                              meta, max_new_tokens, dev, smi)
    per_step = 4 * layers + 1
    steps = q["decode_steps"]
    expect = dict(expect, K5=per_step * (steps + 1))
    why = dict(why, K5=f"{per_step} = {layers} layers x 4 fused denses + "
                       f"lm_head in each of {steps} decode steps at 4 rows, "
                       f"{4 * layers} prefill denses + the prefill's "
                       "lm_head", K8="none: the tower is bf16")
    check_launches("beams w4a8", q_counts, expect, why)
    want = {kernels.W4A8_GEMV_ENTRY: per_step * steps + 1,
            "vls_w4a8_sm90": 4 * layers, "vls_w4a8": 0}
    got = {e: q_counts[e] for e in want}
    log(f"[beams w4a8] w4a8_matmul launches by C entry over the num_beams=4 "
        f"call: {got} (expected {want}: {per_step} x {steps} decode steps "
        f"at 4 rows + the prefill's lm_head on w4a8_gemv_sm90.cu, 4 x "
        f"{layers} prefill denses on w4a8_sm90.cu, none on w4a8.cu)")
    if got != want:
        raise AssertionError(f"beams w4a8: w4a8_matmul routes {got}, "
                             f"expected {want}")
    q["k5_by_entry"] = got
    sync()
    return bf_counts, q_counts, {"bf16": bf, "w4a8": q}, (qparams, qcfg)


def phase_sampling(cfg, quant, seed, max_new_tokens, dev, smi,
                   hw=(480, 854)):
    """Phase 22: phase 4's W4A8 batched call (caption + referral, left
    pad) sampled at temperature 0.2, top_p 0.9 through
    `get_model_output_batched` (launches counted), then again through
    `llava.generate` with the same seed (identical tokens), at top_p
    1e-9 (the greedy tokens) and greedy, with the decode step's host
    time beside greedy's. Returns (counts, summary)."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.inference.utils import clip_preprocess_frames
    from video_llava_seg_torch.models import llava

    params, qcfg = quant
    tok = SmokeTokenizer(cfg.llm.vocab_size)
    eos = [tok.convert_tokens_to_ids("<|eot_id|>")]
    stops = serve.keyword_stop_sequences(tok, "llava_llama_3")
    frames, seg, meta = _smoke_inputs(seed, cfg.num_frames, hw,
                                      cfg.seg.max_seg_frames)
    queries = [(serve.CAPTION_PROMPT, False), (REFERRAL, True)]
    temp, top_p = 0.2, 0.9

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)

    reset_launches()
    sync()
    t0 = time.perf_counter()
    outs = serve.get_model_output_batched(
        params, qcfg, tok, frames, queries, "llava_llama_3", max_new_tokens,
        seg_frames_u8=seg, seg_meta=meta, eos_token_ids=eos,
        stop_sequences=stops, temperature=temp, top_p=top_p,
        generator=gen(seed))
    sync()
    seconds = time.perf_counter() - t0
    counts = snapshot_launches()
    logits = outs[1][1]
    if logits is None or not np.isfinite(logits).all():
        raise AssertionError("sampling: no finite mask logits")

    ids, lens = serve.batch_prompt_ids(cfg, tok, [q for q, _ in queries],
                                       "llava_llama_3")
    video = clip_preprocess_frames(torch.from_numpy(frames).to(dev),
                                   cfg.vision.image_size)[None].to(
        torch.bfloat16)
    kw = dict(max_new_tokens=max_new_tokens, eos_token_ids=tuple(eos),
              stop_sequences=tuple(stops), pad_side="left", input_lens=lens)
    runs = {}
    for name, extra in (
            ("sampled", dict(temperature=temp, top_p=top_p,
                             generator=gen(seed))),
            ("top_p 1e-9", dict(temperature=temp, top_p=1e-9,
                                generator=gen(seed + 1))),
            ("greedy", {})):
        timings = {}
        tokens, _, n = llava.generate(params, qcfg, ids, video,
                                      timings=timings, **kw, **extra)
        sync()
        runs[name] = (tokens[:, :n].cpu(), n, timings)
    texts = [tok.decode(t).strip() for t in runs["sampled"][0].numpy()]
    if texts != [outs[0][0], outs[1][0]]:
        raise AssertionError("sampling: a second run with the same seed "
                             "gave other tokens")
    if not torch.equal(runs["top_p 1e-9"][0], runs["greedy"][0]):
        raise AssertionError("sampling: top_p 1e-9 did not give the greedy "
                             "tokens")
    n = runs["sampled"][1]
    differ = not torch.equal(runs["sampled"][0], runs["greedy"][0])
    layers = qcfg.llm.num_layers
    want = {kernels.W4A8_GEMV_ENTRY: (4 * layers + 1) * n + 1,
            "vls_w4a8_sm90": 4 * layers, "vls_w4a8": 0}
    got = {e: counts[e] for e in want}
    if got != want or counts["K5"] != sum(want.values()):
        raise AssertionError(f"sampling: w4a8_matmul routes {got}, "
                             f"expected {want}")
    step = {k: v[2]["decode"] / v[1] for k, v in runs.items()}
    log(f"[sampling] W4A8 batch of 2 (caption + referral, left pad) at "
        f"temperature {temp}, top_p {top_p} through "
        f"get_model_output_batched: {seconds:.3f} s, {n} decode steps, K5 "
        f"by C entry {got}; a second run with the same seed gave the same "
        f"tokens; top_p 1e-9 gave the greedy tokens; the samples "
        f"{'differ from' if differ else 'equal'} greedy's")
    log(f"[sampling] decode step by the host clock: sampled "
        f"{step['sampled'] * 1e3:.2f} ms, top_p 1e-9 "
        f"{step['top_p 1e-9'] * 1e3:.2f} ms, greedy "
        f"{step['greedy'] * 1e3:.2f} ms; {smi}")
    del video
    return counts, {"seconds": seconds, "decode_steps": n,
                    "host_s_per_step": step, "differs_from_greedy": differ,
                    "k5_by_entry": got}


class ArrayFetcher:
    """`VideoAndFrameFetcher`'s surface over a ViCaS directory whose clip
    and frames are .npy arrays (the card's machine has neither OpenCV nor
    PIL to decode an mp4 or JPEGs)."""

    def __init__(self, root):
        self.root = root

    def get_video(self, filename):
        return np.load(os.path.join(self.root, "ViCaS", "videos", filename))

    def get_frames(self, content, gt_only=True):
        d = os.path.join(self.root, "ViCaS", "video_frames",
                         f"{content['video_id']:06d}")
        segs = [s for s in content["segmentations"]
                if s["is_gt"] or not gt_only]
        frames = np.stack([np.load(os.path.join(d, s["filename"]))
                           for s in segs])
        n = len(content["segmentations"])
        return frames, {"orig_image_size": frames.shape[1:3],
                        "video_id": content["video_id"],
                        "filenames": [s["filename"] for s in segs],
                        "timestamps": np.arange(len(segs), dtype=np.float32)
                        / max(n - 1, 1)}


def write_vicas_fixture(root, seed, video_id=7, n_frames=4, hw=(48, 64)):
    """The tests' synthetic ViCaS layout (videos/, video_frames/,
    annotations/v1.0/, splits/v1.0/val.json) with the clip and its frames
    as .npy (see ArrayFetcher): one video, one referral to track 1, whose
    ground-truth mask is a rectangle on every frame."""
    from video_llava_seg_torch.ops.masks import encode_rle

    h, w = hw
    vicas = os.path.join(root, "ViCaS")
    frames_dir = os.path.join(vicas, "video_frames", f"{video_id:06d}")
    for d in ("videos", "annotations/v1.0", "splits/v1.0"):
        os.makedirs(os.path.join(vicas, d))
    os.makedirs(frames_dir)
    frames = np.random.default_rng(seed).integers(0, 255, (n_frames, h, w, 3),
                                                  dtype=np.uint8)
    np.save(os.path.join(vicas, "videos", "vid7.npy"), frames)
    mask = np.zeros((h, w), np.uint8)
    mask[10:30, 10:40] = 1
    rle = encode_rle(mask)
    rle["counts"] = rle["counts"].decode("utf-8")
    segs = []
    for t in range(n_frames):
        np.save(os.path.join(frames_dir, f"{t:05d}.npy"), frames[t])
        segs.append({"filename": f"{t:05d}.npy", "is_gt": True,
                     "track_ids": [1], "mask_rles": [rle]})
    content = {"video_id": video_id, "filename": "vid7.npy",
               "caption_raw_en": "a synthetic scene",
               "caption_parsed_en_gpt": "a synthetic scene",
               "object_referrals": [{"prompt": "the bright region",
                                     "track_ids": [1]}],
               "segmentations": segs}
    with open(os.path.join(vicas, "annotations", "v1.0",
                           f"{video_id:06d}.json"), "w") as fh:
        json.dump(content, fh)
    with open(os.path.join(vicas, "splits", "v1.0", "val.json"), "w") as fh:
        json.dump([video_id], fh)
    return content


def phase_train_serve_score(cfg, workdir, cli_params, qlora_params, seed,
                            max_new_tokens, dev, smi):
    """Phase 23: phase 9's checkpoint-4 served by `run_inference` on the
    card (--load_4bit --num_beams 2, one video of a synthetic ViCaS
    directory; the tiny training config has no seg head, so captions
    only) to the JSON of the same tree merged in memory
    (`prepare_params`); the JSONs, the ground truth re-encoded as a
    prediction and a tiny tree with a seg head scored by
    `inference.eval`; then phase 8's full-width QLoRA tree (int8 base,
    adapters attached) served from memory on one caption query.
    Returns (QLoRA serving counts, summary)."""
    from video_llava_seg_torch.bridge import cast_tree
    from video_llava_seg_torch.inference import eval as vieval
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.models import llava, vit

    root = os.path.join(workdir, "datasets")
    content = write_vicas_fixture(root, seed)
    old_env = os.environ.get("VIDEONET_DATASETS_DIR")
    os.environ["VIDEONET_DATASETS_DIR"] = root
    try:
        ckpt = os.path.join(workdir, "train", "checkpoint-4")
        tcfg = serve.load_model(ckpt, device="cpu")[1]
        tok = SmokeTokenizer(tcfg.llm.vocab_size)
        fetcher = ArrayFetcher(root)
        out = {k: os.path.join(workdir, "pred", k)
               for k in ("ckpt", "memory", "seg", "gt")}

        def cli(model_path, out_dir, *flags):
            return serve.parse_args(["-i", model_path, "-o", out_dir,
                                     "--max_new_tokens", "4", "--device",
                                     dev.type, *flags])

        flags = ("--load_4bit", "--num_beams", "2", "--skip_seg")
        t0 = time.perf_counter()
        serve.run_inference(cli(ckpt, out["ckpt"], *flags), tokenizer=tok,
                            fetcher=fetcher)
        sync()
        t_ckpt = time.perf_counter() - t0
        params = serve.prepare_params(cli_params, 4, dev, torch.bfloat16)
        serve.run_inference(cli("unused", out["memory"], *flags),
                            model=(params, tcfg, tok), fetcher=fetcher)
        jsons = {}
        for k in ("ckpt", "memory"):
            with open(os.path.join(out[k], "000007.json")) as fh:
                jsons[k] = json.load(fh)
        if jsons["ckpt"] != jsons["memory"] or not \
                jsons["ckpt"]["pred_caption"]:
            raise AssertionError("the checkpoint served to another JSON "
                                 "than its tree merged in memory")
        log(f"[serve-ckpt] checkpoint-4 of the training CLI through "
            f"run_inference --load_4bit --num_beams 2 on the card: "
            f"{t_ckpt:.3f} s; the JSON equals the in-memory merge's; "
            f"caption[:40] {jsons['ckpt']['pred_caption'][:40]!r}")

        # a tiny tree with a seg head: its referral's masks to score
        scfg = _tiny_cfg()
        sparams = cast_tree(llava.init(scfg, torch.Generator().manual_seed(
            seed), "cpu", torch.float32), dev, torch.bfloat16)
        serve.run_inference(cli("unused", out["seg"]),
                            model=(sparams, scfg,
                                   SmokeTokenizer(scfg.llm.vocab_size)),
                            fetcher=fetcher)
        os.makedirs(out["gt"])
        with open(os.path.join(out["gt"], "000007.json"), "w") as fh:
            json.dump({"video_id": 7, "pred_lgvis_masks": [[
                {"filename": s["filename"], "mask_rles": s["mask_rles"]}
                for s in content["segmentations"]]]}, fh)
        gt_dir = os.path.join(root, "ViCaS", "annotations", "v1.0")
        scores = {k: vieval.evaluate_dirs(out[k], gt_dir)
                  for k in ("ckpt", "seg", "gt")}
        log("[serve-ckpt] inference.eval mean IoU: " + ", ".join(
            f"{k} {v['mean_iou']:.4f} ({v['num_referrals']} referral)"
            for k, v in scores.items())
            + " (ckpt: no seg head, no masks; seg: a random tiny seg head; "
            "gt: the ground truth as a prediction)")
        if scores["gt"]["mean_iou"] != 1.0 or not \
                0.0 <= scores["seg"]["mean_iou"] <= 1.0 or \
                scores["ckpt"]["num_referrals"] != 1:
            raise AssertionError(f"inference.eval: scores {scores}")
    finally:
        if old_env is None:
            os.environ.pop("VIDEONET_DATASETS_DIR", None)
        else:
            os.environ["VIDEONET_DATASETS_DIR"] = old_env

    # phase 8's QLoRA tree, served from memory: adapters attached to the
    # int8 base, every other leaf cast to bf16
    params = serve.prepare_params(qlora_params, None, dev, torch.bfloat16)
    attached = params["llm"]["layers"][0]["attn"]["wq"]
    if set(attached) != {"kernel_q", "kernel_scale", "lora"}:
        raise AssertionError(f"QLoRA tree: wq holds {sorted(attached)}")
    tok = SmokeTokenizer(cfg.llm.vocab_size)
    frames, _, _ = _smoke_inputs(seed, cfg.num_frames, (480, 854), 1)
    reset_launches()
    sync()
    timings = {}
    t0 = time.perf_counter()
    text, _ = serve.get_model_output_frames(
        params, cfg, tok, frames, serve.CAPTION_PROMPT, "llava_llama_3",
        max_new_tokens, eos_token_ids=[tok.convert_tokens_to_ids(
            "<|eot_id|>")], timings=timings)
    sync()
    seconds = time.perf_counter() - t0
    counts = snapshot_launches()
    if not text:
        raise AssertionError("QLoRA tree: empty caption")
    n_tower = vit.num_layers_run(cfg.vision)
    layers = cfg.llm.num_layers
    expect = {"K1": n_tower, "K2": layers, "K3": 0, "K4": 0, "K5": 0,
              "K6a": 0, "K6b": 0, "K7": 0, "K8": 0}
    why = {"K1": f"{n_tower} tower layers", "K2": f"{layers} prefill layers",
           "K3": "none: a caption query", "K4": "none: a caption query",
           "K5": "none: the QLoRA base is weight-only int8",
           "K6a": "none: serving runs no backward",
           "K6b": "none: serving runs no backward",
           "K7": "none: no seg head runs", "K8": "none: a bf16 tower"}
    check_launches("serve-qlora", counts, expect, why)
    stages = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
    log(f"[serve-qlora] phase 8's trained tree (int8 base + fp32 LoRA r=64 "
        f"attached, cast to bf16) served from memory: caption query "
        f"{seconds:.3f} s ({stages} s); caption[:40] {text[:40]!r}; {smi}")
    del params
    torch.cuda.empty_cache()
    sync()
    return counts, {"checkpoint_seconds": t_ckpt, "scores": scores,
                    "qlora_caption_seconds": seconds,
                    "qlora_stages": timings}


# ---------------------------------------------------------------------------
# the Mistral and MPT families (phases 24-25)
# ---------------------------------------------------------------------------

# the conversation template each family serves with
FAMILY_TEMPLATES = {"mistral": "mistral_instruct", "mpt": "mpt"}
# Mistral's window checked (not timed) besides its own 4096: one key, a
# short band, and past the prompt (the causal mask alone)
WINDOW_EDGES = (1, 100)
# the tiny family decoders of the card-vs-CPU agreement: head dim 128 (the
# only one K2 takes a window or a per-head bias at), 2 layers, a prompt of
# 40 tokens, Mistral's window cut to 8 slots
TINY_FAMILY_PROMPT = 40
TINY_FAMILY_WINDOW = 8
# the least top-two margin (in logits, CPU fp32) of a greedy step whose
# token the card must reproduce, in units of the largest difference of the
# two sides' prefill logits: the card runs bf16 products and K2 with bf16
# P, the CPU fp32 ones (on the same bf16-rounded weights), so a step
# whose two best logits lie closer than a few such differences is a near
# tie either side may break
TINY_FAMILY_MARGIN = 4.0
# the spread the tiny decoders' head is scaled to (the std of the prompt's
# logits), so that greedy steps are rarely near ties: at the init's own
# scale MPT's tied head gives logits ~0.3 apart at most
TINY_FAMILY_LOGIT_STD = 4.0


def family_cfg(cfg, name):
    """`cfg` with the family's full-width LLM (`LlamaConfig.mistral_7b()` /
    `mpt_7b()`), the [SEG] token the last id of its vocabulary."""
    from video_llava_seg_torch.config import LlamaConfig

    lc = (LlamaConfig.mistral_7b() if name == "mistral"
          else LlamaConfig.mpt_7b())
    return dataclasses.replace(cfg, llm=lc, seg_token_idx=lc.vocab_size - 1)


def window_keys(rows: int, window: int) -> int:
    """Keys the causal rows 0..rows-1 see under a window: sum_i min(i + 1,
    window) (every key without one: window >= rows)."""
    w = min(window, rows)
    return w * (w + 1) // 2 + (rows - w) * w


def family_prompt_lens(cfg, name, tok):
    """(the spliced caption prompt's length at batch 1; the caption +
    referral batch's padded length and its shorter row's left pad) under
    the family's template."""
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.mm_utils import tokenizer_image_token
    from video_llava_seg_torch.models import llava

    tmpl = FAMILY_TEMPLATES[name]
    ids = np.asarray(tokenizer_image_token(
        serve.build_prompt(cfg, serve.CAPTION_PROMPT, tmpl), tok))[None]
    per_image = llava.visual_tokens_per_sample(cfg)
    s = int(llava.build_splice_plan(ids, per_image).seq_lens[0])
    bids, blens = serve.batch_prompt_ids(
        cfg, tok, [serve.CAPTION_PROMPT, REFERRAL], tmpl)
    plan = llava.build_splice_plan(bids, per_image, pad_side="left",
                                   input_lens=blens)
    batch_len = plan.gather_idx.shape[1]
    return s, batch_len, int(batch_len - plan.seq_lens.min())


def _k2_agree(tag, got, want):
    """A correctness-only K2 check within BOUNDS["K2"] (relative to the
    largest output of the fp32 twin)."""
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-6)
    log(f"[check] {tag}: max_abs_err {err:.4e}, rel {rel:.3e} (bound "
        f"{BOUNDS['K2']:.0e})")
    if not math.isfinite(rel) or rel > BOUNDS["K2"]:
        raise AssertionError(f"{tag}: rel err {rel:.3e} > bound")


def phase_family_kernel_checks(name, fcfg, s, batch_len, pad, seed, dev,
                               results):
    """K2's family forms at the shapes of the family's prefill, against the
    fp32 twin: Mistral's window (4096, causal GQA 32 / 8) at batch 1 over
    the caption prompt and at the left-padded batch 2 (the per-key pad
    bias), and at windows 1, 100 and past the prompt; MPT's ALiBi (the
    per-head key bias, causal MHA) at both. Timed over 10 launches back
    to back and by device time (a CUDA graph of 10) beside the twin, K2
    with no window / bias on the same inputs, and SDPA with the equivalent
    mask (Mistral: a boolean mask; MPT: the bf16 float mask slope_h * (j -
    i) with -inf past the diagonal and on pad keys)."""
    import torch.nn.functional as F

    from video_llava_seg_torch.ops.attention import (
        alibi_slopes,
        attention,
        attention_reference,
    )

    lc = fcfg.llm
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 24)
    key = "K2_window" if lc.sliding_window else "K2_alibi"
    fam = (dict(window=lc.sliding_window) if lc.sliding_window
           else dict(alibi=True))
    what = (f"window {lc.sliding_window}" if lc.sliding_window
            else "ALiBi (per-head key bias)")
    w = lc.sliding_window or 1 << 30

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    def sdpa_mask(rows, kv_mask=None):
        i = torch.arange(rows, device=dev)
        rel = i[None, :] - i[:, None]
        ok = (rel <= 0) & (rel > -w)
        if lc.use_alibi:
            slopes = torch.from_numpy(alibi_slopes(lc.num_heads)).to(dev)
            m = torch.where(ok, slopes[:, None, None] * rel.float(),
                            -math.inf)[None]
            if kv_mask is not None:
                m = m.masked_fill(~kv_mask[:, None, None, :], -math.inf)
            return m.to(bf)
        ok = ok[None, None]
        return ok if kv_mask is None else ok & kv_mask[:, None, None, :]

    for batch, rows in ((1, s), (2, batch_len)):
        q = randn(batch, lc.num_heads, rows, lc.head_dim)
        k = randn(batch, lc.num_kv_heads, rows, lc.head_dim)
        v = randn(batch, lc.num_kv_heads, rows, lc.head_dim)
        kv_mask = None
        real = slice(None)
        keys = window_keys(rows, w)
        if batch == 2:
            kv_mask = torch.ones(2, rows, dtype=torch.bool, device=dev)
            kv_mask[1, :pad] = False
            real = slice(pad, None)
            keys += window_keys(rows - pad, w)
        kw = dict(causal=True, kv_mask=kv_mask)
        got = attention(q, k, v, **kw, **fam)
        sync()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{key}: non-finite output")
        del got
        mask = sdpa_mask(rows, kv_mask)
        bias_bytes = (4 * batch * lc.num_heads * rows if lc.use_alibi
                      else 4 * batch * rows if batch == 2 else 0)
        work = (2 * _nbytes(q, k, v, q) + bias_bytes,
                4 * lc.num_heads * lc.head_dim * keys, PEAK_BF16)
        tag = (f"q{list(q.shape)} kv{list(k.shape)} causal, {what}"
               + (f", row 1 left-padded by {pad}, real query rows compared"
                  if batch == 2 else ""))
        _check(key, tag,
               lambda: attention(q, k, v, **kw, **fam)[:, :, real],
               lambda: attention_reference(q, k, v, **kw, **fam)[:, :, real],
               lambda: attention_reference(q.float(), k.float(), v.float(),
                                           **kw, **fam)[:, :, real],
               results, work,
               run_library=lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask,
                   enable_gqa=lc.num_kv_heads != lc.num_heads),
               run_previous=lambda: attention(q, k, v, **kw),
               previous="K2 causal (no window / head bias)", train=10,
               device_time=True)
        if lc.use_alibi:
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            want = attention_reference(q.float(), k.float(), v.float(),
                                       **kw, **fam)
            sync()
            err = ((lib[:, :, real].float() - want[:, :, real]).abs().max()
                   / want[:, :, real].abs().max()).item()
            log(f"[check] {key} {tag}: SDPA with the bf16 ALiBi mask, rel "
                f"err {err:.3e} against the fp32 twin (not bounded: its "
                f"mask rounds slope_h * (j - i) to bf16)")
            del lib, want
        if lc.sliding_window and batch == 1:
            cut = rows - lc.sliding_window
            log(f"[check] {key}: the window cuts keys on {cut} of the "
                f"{rows} query rows")
            if cut < 1000:
                raise AssertionError(f"the prompt ({rows}) does not exceed "
                                     f"the window by 1000 rows")
            for edge in WINDOW_EDGES + (rows + 7,):
                _k2_agree(f"K2 window {edge} q{list(q.shape)} causal",
                          attention(q, k, v, causal=True, window=edge),
                          attention_reference(q.float(), k.float(),
                                              v.float(), causal=True,
                                              window=edge))
        del q, k, v, mask
        torch.cuda.empty_cache()


def phase_family(name, cfg, seed, max_new_tokens, dev, smi, results,
                 hw=(480, 854)):
    """Phase 24 (Mistral-7B) / 25 (MPT-7B) at full width: K2's family form
    against the twin (`phase_family_kernel_checks`), then the W4A8 +
    int8-KV + fused batched path (caption + referral in one
    `get_model_output_batched` call) and the bf16 batch-1 caption
    (`get_model_output_frames`), each under the family's template, with
    the launches counted over exactly that call: K2 = 32 a prefill, all on
    attention_sm90.cu; K5 by C entry; K1 / K3 / K4 as phases 3 / 4. Then
    the bf16 tree's decode step's device time (torch.profiler) and, for
    MPT, the tied head's product by CUDA events. Returns (the W4A8 call's
    counts, summary)."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.models import llama, llava, seg_head, vit
    from video_llava_seg_torch.ops.quantization import quantized_nbytes

    fcfg = family_cfg(cfg, name)
    lc = fcfg.llm
    tag = f"family {name}"
    tok = SmokeTokenizer(lc.vocab_size)
    tmpl = FAMILY_TEMPLATES[name]
    s, batch_len, pad = family_prompt_lens(fcfg, name, tok)
    log(f"[{tag}] {lc.num_layers} layers, {lc.num_heads} / "
        f"{lc.num_kv_heads} heads, window {lc.sliding_window}, ALiBi "
        f"{lc.use_alibi}, {lc.norm_type}, {lc.mlp_type}, tied head "
        f"{lc.tie_word_embeddings}; the {tmpl} caption prompt splices to "
        f"{s} tokens, the caption + referral batch to 2 x {batch_len} (pad "
        f"{pad})")
    t0 = time.perf_counter()
    phase_family_kernel_checks(name, fcfg, s, batch_len, pad, seed, dev,
                               results)
    t_checks = time.perf_counter() - t0

    eos = [tok.convert_tokens_to_ids("<|eot_id|>")]
    stops = serve.keyword_stop_sequences(tok, tmpl)
    frames, seg, meta = _smoke_inputs(seed, fcfg.num_frames, hw,
                                      fcfg.seg.max_seg_frames)
    n_tower = vit.num_layers_run(fcfg.vision)
    sc = seg_head.make_sam2_cfg(fcfg.seg)
    layers = lc.num_layers
    none = dict(K6a=0, K6b=0, K7=0, K8=0)
    why_none = {"K6a": "none: serving runs no backward",
                "K6b": "none: serving runs no backward",
                "K7": "none: K4 runs every Hiera block",
                "K8": "none: the tower is bf16"}

    # the W4A8 + int8-KV + fused batched path
    t0 = time.perf_counter()
    params, qcfg = build_quant_params(fcfg, seed, dev)
    sync()
    llm_gb = quantized_nbytes(params["llm"]) / 1e9
    log(f"[{tag} w4a8] init: W4A8 LLM {llm_gb:.3f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    queries = [(serve.CAPTION_PROMPT, False), (REFERRAL, True)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync()
    timings = {}
    t1 = time.perf_counter()
    outs = serve.get_model_output_batched(
        params, qcfg, tok, frames, queries, tmpl, max_new_tokens,
        seg_frames_u8=seg, seg_meta=meta, eos_token_ids=eos,
        stop_sequences=stops, timings=timings)
    sync()
    w4a8_s = time.perf_counter() - t1
    counts = snapshot_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    (cap_text, cap_logits), (ref_text, logits) = outs
    log(f"[{tag} w4a8] caption + referral in one batched call: {w4a8_s:.3f}"
        f" s (" + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        + f" s); peak allocated {peak:.1f} GiB; caption[:60] "
        f"{cap_text[:60]!r}")
    want_shape = (1, fcfg.seg.max_seg_frames, *hw)
    if not cap_text or cap_logits is not None:
        raise AssertionError(f"{tag}: caption row: empty text or a mask")
    if logits is None or logits.shape != want_shape \
            or not np.isfinite(logits).all():
        raise AssertionError(f"{tag}: referral mask logits not finite "
                             f"{want_shape}")
    # K5 a step: the fused qkv, wo, the MLP's two denses (Mistral's fused
    # gate-up; MPT's up) a layer, and the head where it is not tied
    head = 0 if lc.tie_word_embeddings else 1
    per_step = 4 * layers + head
    steps = counts["K5"] // per_step - 1
    if counts["K5"] % per_step or not 1 <= steps <= max_new_tokens:
        raise AssertionError(f"{tag}: {counts['K5']} K5 launches are no "
                             f"whole number of {per_step}-product steps")
    expect = {"K1": n_tower, "K2": layers, "K3": sc.twoway_depth,
              "K4": sc.hiera.depth, "K5": per_step * (1 + steps), **none}
    why = {"K1": f"{n_tower} tower layers, the clip encoded once",
           "K2": f"{layers} layers of one batch-2 prefill, {what_k2(lc)}",
           "K3": "image->token attention in the 2 two-way blocks, the "
                 "referral row only",
           "K4": "16 Hiera blocks, 8 seg frames batched",
           "K5": f"{per_step} = {layers} layers x 4 fused denses"
                 + (" + lm_head" if head else " (tied head: no K5)")
                 + f", in the prefill and in each of {steps} decode steps",
           **why_none}
    check_launches(f"{tag} w4a8", counts, expect, why)
    if counts["sm90 entry"] < layers or counts["attention.cu entry"]:
        raise AssertionError(f"{tag}: K2 off attention_sm90.cu")
    want = {kernels.W4A8_GEMV_ENTRY: per_step * steps + head,
            "vls_w4a8_sm90": 4 * layers, "vls_w4a8": 0}
    got = {e: counts[e] for e in want}
    log(f"[{tag} w4a8] w4a8_matmul launches by C entry: {got} (expected "
        f"{want}: {per_step} x {steps} decode steps"
        + (" + the prefill's lm_head" if head else "")
        + f", 4 x {layers} prefill denses, none on w4a8.cu)")
    if got != want:
        raise AssertionError(f"{tag}: w4a8_matmul routes {got}, expected "
                             f"{want}")
    del params, outs, logits
    torch.cuda.empty_cache()

    # the bf16 batch-1 caption
    t0 = time.perf_counter()
    params = llava.init(fcfg, torch.Generator(device=dev).manual_seed(seed),
                        dev, torch.bfloat16)
    sync()
    log(f"[{tag} bf16] init {time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    reset_launches()
    sync()
    bf16_timings = {}
    t1 = time.perf_counter()
    text, _ = serve.get_model_output_frames(
        params, fcfg, tok, frames, serve.CAPTION_PROMPT, tmpl,
        max_new_tokens, eos_token_ids=eos, stop_sequences=stops,
        timings=bf16_timings)
    sync()
    bf16_s = time.perf_counter() - t1
    bf16_counts = snapshot_launches()
    log(f"[{tag} bf16] caption: {bf16_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in bf16_timings.items())
        + f" s); caption[:60] {text[:60]!r}")
    if not text:
        raise AssertionError(f"{tag} bf16: empty caption")
    expect = {"K1": n_tower, "K2": layers, "K3": 0, "K4": 0, "K5": 0,
              **none}
    why = {"K1": f"{n_tower} tower layers", "K2": f"{layers} prefill "
           f"layers, {what_k2(lc)}", "K3": "none: a caption has no seg head",
           "K4": "none: a caption has no seg head",
           "K5": "none: a bf16 tree has no W4A8 dense", **why_none}
    check_launches(f"{tag} bf16", bf16_counts, expect, why)
    if bf16_counts["attention.cu entry"]:
        raise AssertionError(f"{tag} bf16: K2 off attention_sm90.cu")
    step_ms, _ = step_device_ms(lc, params["llm"], 1, s, max_new_tokens,
                                torch.bfloat16, dev)
    log(f"[{tag} bf16] a decode step at 1 row (cache {s} + "
        f"{max_new_tokens // 2} slots): device {step_ms} ms (torch.profiler"
        f"); {smi}")
    head_ms = None
    if lc.tie_word_embeddings:
        h = torch.randn(1, 1, lc.hidden_size, device=dev).to(torch.bfloat16)
        head_ms = cuda_ms(lambda: llama.unembed(params["llm"], lc, h),
                          train=10)
        log(f"[{tag} bf16] the tied head's product [1, {lc.hidden_size}] x "
            f"[{lc.hidden_size}, {lc.vocab_size}] bf16 (torch.matmul over "
            f"the embedding): {head_ms:.4f} ms a step (10 back to back; "
            f"the table's bytes at 3.35 TB/s: "
            f"{2 * lc.hidden_size * lc.vocab_size / HBM_BYTES_S * 1e3:.4f}"
            f" ms)")
    del params
    torch.cuda.empty_cache()
    sync()
    return counts, {
        "prompt_tokens": s, "batch_len": batch_len, "pad": pad,
        "kernel_checks_seconds": t_checks,
        "w4a8_batched": {"seconds": w4a8_s, "stages": timings,
                         "peak_gib": peak, "decode_steps": steps},
        "bf16_caption": {"seconds": bf16_s, "stages": bf16_timings},
        "bf16_decode_step_device_ms": step_ms,
        "tied_head_ms": head_ms, "bf16_launches": bf16_counts}


def what_k2(lc) -> str:
    return (f"window {lc.sliding_window}" if lc.sliding_window
            else "ALiBi" if lc.use_alibi else "causal")


def tiny_family_cfg(name):
    """The tiny decoder of family `name` for the card-vs-CPU agreement:
    head dim 128 (K2's window and per-head bias exist only there)."""
    from video_llava_seg_torch.config import LlamaConfig

    base = dataclasses.replace(LlamaConfig.tiny(), hidden_size=256,
                               intermediate_size=512, num_heads=2,
                               num_kv_heads=1, head_dim=128)
    if name == "mistral":
        return dataclasses.replace(base, sliding_window=TINY_FAMILY_WINDOW,
                                   rope_theta=10000.0)
    return dataclasses.replace(base, num_kv_heads=2, use_rope=False,
                               use_alibi=True, norm_type="layernorm",
                               mlp_type="gelu", tie_word_embeddings=True)


def phase_tiny_family_agreement(seed):
    """Each family's tiny decoder: greedy decode on the card (K2 with the
    window / the ALiBi bias, bf16) and on the CPU (the twin, fp32), same
    bf16-rounded weights, at batch 1 and at a left-padded batch 2. The
    prefill's last logits within AGREE_BOUND; the greedy tokens equal up
    to the first step whose CPU margin (top-two logits, from one fp32
    forward over the prompt and the CPU's tokens) is below
    TINY_FAMILY_MARGIN times the prefill logits' largest difference (the
    steps compared are printed)."""
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.bridge import cast_tree
    from video_llava_seg_torch.models import llama

    out = {}
    for name in FAMILY_TEMPLATES:
        lc = tiny_family_cfg(name)
        params = llama.init(lc, torch.Generator().manual_seed(seed), "cpu",
                            torch.float32)
        r = np.random.default_rng(seed)
        s = TINY_FAMILY_PROMPT
        x = r.standard_normal((2, s, lc.hidden_size)).astype(np.float32)
        x = torch.from_numpy(x).to(torch.bfloat16).float()
        head = (params["embed_tokens"]["embedding"]
                if lc.tie_word_embeddings else params["lm_head"]["kernel"])
        spread = llama.forward(params, lc, x[:1], torch.arange(s))[0].std()
        head.mul_(TINY_FAMILY_LOGIT_STD / spread)
        params = cast_tree(cast_tree(params, "cpu", torch.bfloat16), "cpu",
                           torch.float32)
        card = cast_tree(params, "cuda", torch.bfloat16)
        for batch, pad in ((1, None), (2, [0, 9])):
            xb = x[:batch].clone()
            if pad is not None:
                xb[1, :pad[1]] = 0.0
            kw = dict(pad_lens=pad)
            pos = torch.arange(s)[None]
            cache = llama.init_kv_cache(lc, batch, s, "cpu", torch.float32)
            mask = None
            if pad is not None:
                mask = pos >= torch.tensor(pad)[:, None]
            want_l = llama.prefill(params, lc, xb, pos, cache, kv_mask=mask,
                                   last_logit_only=True)[0]
            k2 = kernels.LAUNCHES.snapshot()["K2"]
            got_l = llama.prefill(
                card, lc, xb.cuda().to(torch.bfloat16), pos.cuda(),
                llama.init_kv_cache(lc, batch, s, "cuda"),
                kv_mask=None if mask is None else mask.cuda(),
                last_logit_only=True)[0]
            sync()
            if kernels.LAUNCHES.snapshot()["K2"] != k2 + lc.num_layers:
                raise AssertionError(f"tiny {name}: K2 not launched a layer")
            diff = (got_l.float().cpu() - want_l).abs().max().item()
            rel = diff / want_l.abs().max().item()
            thresh = TINY_FAMILY_MARGIN * diff
            new = 8
            wt, _, _ = llama.greedy_generate(params, lc, xb, new, (), **kw)
            gt, _, _ = llama.greedy_generate(
                card, lc, xb.cuda().to(torch.bfloat16), new, (), **kw)
            gt = gt.cpu()
            # the CPU's margins: one fp32 forward over prompt + its tokens
            seq = torch.cat([xb, llama.embed(params, wt[:, :-1]).float()], 1)
            am = None
            if pad is not None:
                am = torch.arange(seq.shape[1])[None] >= torch.tensor(
                    pad)[:, None]
            logits, _ = llama.forward(params, lc, seq,
                                      torch.arange(seq.shape[1]),
                                      attn_mask=am)
            top2 = logits[:, s - 1:].topk(2, dim=-1).values
            margin = (top2[..., 0] - top2[..., 1])
            if not torch.equal(logits[:, s - 1:].argmax(-1), wt):
                raise AssertionError(f"tiny {name}: the CPU's forward does "
                                     "not reproduce its greedy tokens")
            compared = 0
            for j in range(new):
                if (margin[:, j] < thresh).any():
                    break
                if not torch.equal(gt[:, j], wt[:, j]):
                    raise AssertionError(
                        f"tiny {name} batch {batch}: token {j} differs at a "
                        f"CPU margin of {margin[:, j].min().item():.3e}")
                compared += 1
            least = (margin[:, :compared].min().item() if compared
                     else float("nan"))
            log(f"[agree] tiny {name} batch {batch}: prefill logits card "
                f"bf16 vs CPU fp32 rel err {rel:.3e} (bound "
                f"{AGREE_BOUND:.0e}); greedy tokens equal over {compared} of "
                f"{new} steps (stopped at a CPU margin < {thresh:.3e}: "
                f"{compared < new}; least margin compared {least:.3e})")
            if not rel <= AGREE_BOUND:
                raise AssertionError(f"tiny {name} batch {batch}: the card "
                                     "disagrees with the CPU")
            out[f"{name}_b{batch}"] = {"logits_rel_err": rel,
                                       "tokens_compared": compared}
    return out


# ---------------------------------------------------------------------------
# parallelism (phases 27-29): tensor-parallel serving and FSDP training
# ---------------------------------------------------------------------------

# The two-rank phases run two processes on the one card (gloo: NCCL
# refuses two ranks on one device), whose collectives pass through host
# memory. TP serving runs each family at its full depth and width. The
# FSDP step keeps full width and is cut to FSDP_LAYERS layers for the
# time limit, not for memory: every gathered layer crosses host memory
# twice a step (forward and recompute) at gloo's rate on one card; the
# phase's line prints both arithmetics (the memory a full-depth rank
# would peak at, the seconds its gathers would add)
TP = 2
FSDP_LAYERS = 4
# greedy tokens a TP query (the all-reduces of each decode step cross
# host memory under gloo)
TP_MAX_NEW = 8
# A W4A8 TP rank sums exact integer products (K5 with unit scales, fp32
# integers below 2^24), so its prefill logits and tokens must equal the
# one process's bit for bit. A bf16 rank sums fp32 partials of its row
# blocks where the one process runs one bf16 product of the whole row:
# its prefill logits may differ by at most TP_BF16_LOGIT_ATOL (set from
# the sound runs' readings), and its tokens must equal the one process's
# up to a first difference that falls on a step whose one-process
# top-two margin is below TP_MARGIN x that limit (a near tie: each of
# the top two moves by at most the limit, taking a decode step's logits
# to drift like the prefill's). The control, a rank run with layer 0's
# two row-parallel sums left out (TP_CONTROL_CALLS), must exceed the
# limit. Readings at 32 layers on an H100 80GB HBM3 at 700 W:
# 0.0586-0.0625, the control 1.82.
TP_BF16_LOGIT_ATOL = 0.125
TP_MARGIN = 2.0
TP_CONTROL_CALLS = (0, 1)
# the serving runs: (family, W4A8 or bf16)
TP_RUNS = {"llama_bf16": ("llama", False), "llama_w4a8": ("llama", True),
           "mpt_w4a8": ("mpt", True)}
# phase 28 repeats phase 26's first steps through the FSDP code
FSDP_REF_STEPS = 2
# Phase 29: FSDP_STEPS steps (update 0 runs at the warmup's lr 0, so
# updates 1 and 2 move the parameters) against one process on the global
# batch. Each rank runs its row at batch 1 where the one process runs
# both at batch 2, so bf16 products of other shapes round differently:
# the limits below are set from the sound runs' readings. The control,
# one process on row 0 alone (a rank whose gradients are not summed over
# the group), must fail them. Readings (H100 80GB HBM3, 700 W): loss
# 6.2e-8 / 6.2e-8 / 4.4e-5, grad norm 3.1e-5 / 3.1e-5 / 5.3e-5, the
# leaves 0.024 of the update; the control 1.5e-4 / 1.5e-4 / 6.1e-3,
# 2.8e-2 / 2.8e-2 / 4.4e-2 and 0.69.
FSDP_STEPS = 3
FSDP_LOSS_RTOL = 2e-4
FSDP_GRAD_NORM_RTOL = 1e-3
# ||rank's parameters - one process's|| / ||one process's update||, over
# every trainable leaf after the last step
FSDP_UPDATE_RTOL = 0.1
# the largest learning rate of the stage-3 groups: an Adam update moves
# a parameter by at most about lr, so two runs' leaves part by at most
# 3 x lr a nonzero-lr update (`check_params` in the CPU tests)
FSDP_PEAK_LR = 2e-5
# Phase 30: tensor-parallel training against the one process on the same
# row. Unlike FSDP (each rank's per-row products bit-equal to the one
# process's), a tp = 2 rank sums fp32 partials of wo / w_down where the
# one process rounds one bf16 product, and cuBLAS cuts the column shards'
# products its own way: a few elements differ by a bf16 step in the first
# layer, over half of them by the fourth, and the random-weight stage-3
# loss (its mask loss most) moves with them. Phase 29's limits (2e-4 /
# 1e-3) do not hold: first reading (H100 80GB HBM3, 700 W) loss 3.0e-4 /
# 3.0e-4 / 2.8e-3, grad norm 2.0e-3 / 2.0e-3 / 3.9e-3 at steps 1-3, the
# leaves 0.066 of the update. The loss and grad-norm limits below keep
# ~2.5x over those; the leaves keep phase 29's limit, which the control
# (no 'model' sum of the LoRA partial gradients: 0.26) must exceed. The
# CPU tests hold the same step in fp32 to rel 1e-5.
TP_TRAIN_LOSS_RTOL = 1e-2
TP_TRAIN_GRAD_NORM_RTOL = 1e-2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tp_cfg(cfg, family):
    return cfg if family == "llama" else family_cfg(cfg, family)


def tp_params(fcfg, w4a8, seed, dev):
    """A TP run's serving tree, seeded on the card: the LLM bf16 or W4A8
    (as --load_4bit makes it; unfused, since --fuse_qkv is single-card),
    tower, projector and seg head bf16."""
    from video_llava_seg_torch.models import llama, projector, seg_head, vit

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    llm = (llama.init_quantized(fcfg.llm, g, dev, bf, bits=4,
                                act_quant=True) if w4a8
           else llama.init(fcfg.llm, g, dev, bf))
    return {"llm": llm,
            "vision_tower": perturb(vit.init(fcfg.vision, g, dev, bf), g),
            "mm_projector": projector.init(fcfg.projector, g, dev, bf),
            "seg_head": perturb(seg_head.init(fcfg.seg, fcfg.llm.hidden_size,
                                              g, dev, bf), g)}


def tp_serve(name, cfg, seed, root, out_dir, dev, mp, max_new=TP_MAX_NEW):
    """One TP run through `run_inference` (`--model_parallel mp`): the
    caption and the referral of the fixture's video. Returns for each
    query its greedy tokens, the top-two margin of each step's logits and
    the prefill's logits; the launches by kernel and C entry, seconds,
    peak memory and (on the writing rank) the JSON."""
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.models import llama, llava

    family, w4a8 = TP_RUNS[name]
    fcfg = tp_cfg(cfg, family)
    tok = SmokeTokenizer(fcfg.llm.vocab_size)
    params = tp_params(fcfg, w4a8, seed, dev)
    template = ("llava_llama_3" if family == "llama"
                else FAMILY_TEMPLATES[family])
    flags = ["-i", "unused", "-o", out_dir, "--device", str(dev),
             "--conv_template", template]
    if mp > 1:
        flags += ["--model_parallel", str(mp), "--dist_backend", "gloo"]
    flags += ["--max_new_tokens", str(max_new)]
    tokens, margins, prefill = [], [], []
    generate, select = llava.generate, llama.select_token

    def recorded(*a, **k):
        margins.append([])
        out = generate(*a, **k)
        tokens.append(out[0][0, :out[2]].tolist())
        return out

    def recorded_select(logits, *a, **k):
        top = logits.float().topk(2, dim=-1).values
        if not margins[-1]:
            prefill.append(logits[0].float().cpu())
        margins[-1].append(float((top[:, 0] - top[:, 1]).min()))
        return select(logits, *a, **k)

    llava.generate, llama.select_token = recorded, recorded_select
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync()
    t0 = time.perf_counter()
    try:
        serve.run_inference(serve.parse_args(flags),
                            model=(params, fcfg, tok),
                            fetcher=ArrayFetcher(root))
    finally:
        llava.generate, llama.select_token = generate, select
    sync()
    seconds = time.perf_counter() - t0
    counts = snapshot_launches()
    path = os.path.join(out_dir, "000007.json")
    pred = None
    if os.path.exists(path):
        with open(path) as fh:
            pred = json.load(fh)
    del params
    torch.cuda.empty_cache()
    return {"tokens": tokens, "margins": margins, "prefill": prefill,
            "counts": counts, "seconds": seconds,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "pred": pred}


def tp_tokens_agree(tag, one, rank, exact):
    """Holds a rank's serving run to the one process's on the same card.
    W4A8 (`exact`): the prefill logits and every greedy token equal. bf16:
    the prefill logits within TP_BF16_LOGIT_ATOL, and the tokens equal up
    to a first difference that may only fall on a step whose one-process
    top-two margin is below TP_MARGIN x TP_BF16_LOGIT_ATOL. Returns the
    per-query (largest prefill-logit difference, tokens equal) and the
    failures."""
    held, bad = [], []
    tie = TP_MARGIN * TP_BF16_LOGIT_ATOL
    for q, (want, got) in enumerate(zip(one["tokens"], rank["tokens"])):
        d = float((one["prefill"][q] - rank["prefill"][q]).abs().max())
        k = 0
        while k < min(len(want), len(got)) and want[k] == got[k]:
            k += 1
        held.append((d, k))
        if exact:
            if d != 0.0 or got != want:
                bad.append(f"{tag} query {q}: W4A8 must be bit-equal: "
                           f"prefill logits within {d:.3e}, tokens {got} "
                           f"vs {want}")
            continue
        if not d <= TP_BF16_LOGIT_ATOL:
            bad.append(f"{tag} query {q}: prefill logits within {d:.3e}, "
                       f"limit {TP_BF16_LOGIT_ATOL}")
        if got != want and not (k < len(one["margins"][q])
                                and one["margins"][q][k] < tie):
            bad.append(f"{tag} query {q}: tokens {got} part from the one "
                       f"process's {want} at step {k}, not at a near tie "
                       f"(margins {one['margins'][q]}, below {tie} allowed)")
    return held, bad


def tp_broken_sums(calls):
    """A control for phase 27: the group sums of the listed row-parallel
    denses left out (0: layer 0's wo at the first query's prefill, 1: its
    w_down), each rank keeping its own partial. Returns the function that
    puts the sums back."""
    from video_llava_seg_torch.parallel import collectives
    from video_llava_seg_torch.parallel import tensor_parallel as tpm

    dense, seen = tpm.row_parallel_dense, [0]

    def broken(p, x):
        skip = seen[0] in calls
        seen[0] += 1
        if not skip:
            return dense(p, x)
        reduce = collectives.all_reduce
        collectives.all_reduce = lambda t, *a, **k: t
        try:
            return dense(p, x)
        finally:
            collectives.all_reduce = reduce

    tpm.row_parallel_dense = broken

    def restore():
        tpm.row_parallel_dense = dense
    return restore


def fsdp_two_rank_cfg(cfg):
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=FSDP_LAYERS))


def fsdp_global_batch(fcfg, seed):
    from video_llava_seg_torch.train.train import synthetic_batches

    return next(synthetic_batches(fcfg, TP, seed=seed))


def fsdp_rank_run(cfg, seed, dev, workdir):
    """Phase 29 on one rank: the stage-3 QLoRA state sharded over the two
    ranks (`--fsdp`), its row of the global batch. Steps 1 to
    FSDP_STEPS - 1 through the trainer's loop (rank 0 writes the last
    one's checkpoint, gathered), the last step on the same state in
    memory; then a fresh state resumed by the loop from that checkpoint
    to the last step. Returns every step's metrics, whether the resumed
    last step (metrics and trainable leaves) equals the uninterrupted
    one bit for bit, the peak memory and, on rank 0, the full trainable
    leaves after the last step (on the host)."""
    import itertools

    from video_llava_seg_torch.config import MeshConfig, to_json
    from video_llava_seg_torch.parallel.fsdp import DataParallel
    from video_llava_seg_torch.parallel.mesh import create_mesh
    from video_llava_seg_torch.train.optimizer import leaves_with_paths
    from video_llava_seg_torch.train.train import init_params
    from video_llava_seg_torch.train.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )
    from video_llava_seg_torch.train.trainer import RowGenerators, train_loop

    fcfg = fsdp_two_rank_cfg(cfg)
    tcfg = train_tcfg(seed=seed, mesh=MeshConfig(fsdp=True),
                      per_device_batch_size=1, output_dir=workdir)
    dp = DataParallel(create_mesh(tcfg.mesh), fsdp=True)
    batch = batch_to_device(dp.rows(fsdp_global_batch(fcfg, seed), 1), dev,
                            torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runs = []
    for steps in (FSDP_STEPS - 1, FSDP_STEPS):
        local = dp.shard(init_params(fcfg, tcfg, dev))
        # one more layer's bytes at rest on this rank: its shards, its
        # LoRA with Adam's m and v, and the layer input a checkpointed
        # block keeps for the backward
        layer_bytes = sum(
            t.numel() * t.element_size()
            * (3 if p.startswith("lora/") else 1)
            for p, t in leaves_with_paths(local)
            if p.startswith(("llm/layers/0/", "lora/llm/layers/0/")))
        layer_bytes += batch["gather_idx"].shape[1] * fcfg.llm.hidden_size * 2
        # the bytes one gather of a whole layer (and its LoRA) brings in
        layer_gather = sum(
            t.numel() * t.element_size() * dp.size
            for p, t in leaves_with_paths(local)
            if p.startswith(("llm/layers/0/", "lora/llm/layers/0/"))
            and dp.dim(p) is not None)
        state, tx = create_train_state(local, tcfg)
        del local
        step_fn = make_train_step(fcfg, tcfg, tx, dp=dp)
        metrics = []

        def rec(state, b, g, step_fn=step_fn, metrics=metrics):
            state, m = step_fn(state, b, g)
            metrics.append({k: float(v) for k, v in m.items()})
            return state, m

        reset_launches()
        # the first pass ends at checkpoint-(FSDP_STEPS - 1); the second
        # resumes from it
        state = train_loop(state, rec, itertools.repeat(batch),
                           dataclasses.replace(tcfg, num_train_steps=steps),
                           to_json(fcfg), dp=dp)
        counts = snapshot_launches()
        if steps < FSDP_STEPS:      # the last step, uninterrupted
            state, _ = rec(state, batch, RowGenerators(seed, steps,
                                                       dp.rank))
        full = dp.full_params(dict(zip(tx.paths, tx.params)))
        runs.append({"metrics": metrics, "counts": counts,
                     "trainable": {p: t.to("cpu", copy=True)
                                   for p, t in full.items()}})
        del state, tx, step_fn, full
        torch.cuda.empty_cache()
    sync()
    straight, resumed = runs
    same = all(torch.equal(straight["trainable"][p], t)
               for p, t in resumed["trainable"].items())
    return {"metrics": straight["metrics"],
            "resumed_last": resumed["metrics"],
            "resume_bitwise": same and resumed["metrics"][-1]
            == straight["metrics"][-1],
            "trainable": straight["trainable"] if dp.rank == 0 else None,
            "counts": straight["counts"],
            "layer_bytes": layer_bytes, "layer_gather_bytes": layer_gather,
            "sharded_leaves": sum(dp.dim(p) is not None for p in dp.specs),
            "leaves": len(dp.specs), "seconds": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def time_collectives():
    """Wrap the port's tensor collectives (the tensor-parallel sums and
    gathers, the FSDP ones and the ring's shift) to sum their seconds and
    bytes (of the tensors sent) by op. Each is bracketed by a device
    synchronize, so its seconds hold the card's work queued before it as
    little as its own end: the rest of a rank's time is compute and
    host. Returns the dict."""
    from video_llava_seg_torch.parallel import collectives

    acc = {}

    def wrap(name):
        fn = getattr(collectives, name)

        def timed(t, *a, **k):
            ts = t if isinstance(t, list) else [t]
            cuda = any(x.is_cuda for x in ts)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, *a, **k)
            if cuda:
                torch.cuda.synchronize()
            s, b = acc.get(name, (0.0, 0))
            acc[name] = (s + time.perf_counter() - t0,
                         b + sum(x.numel() * x.element_size() for x in ts))
            return out
        setattr(collectives, name, timed)

    for name in ("all_reduce", "all_gather_dim", "reduce_scatter",
                 "ring_shift"):
        wrap(name)
    return acc


def parallel_rank(rank, world, port, spec):
    """One of the two ranks of phases 27 / 29 / 30: torchrun's environment,
    the card shared (gloo); every TP serving run, the bf16 control with
    layer 0's sums left out (one token), the FSDP steps, then the
    tensor-parallel training runs; its results to
    spec["dir"]/rank<r>.pt."""
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    collective_time = time_collectives()
    dev = torch.device(spec["device"])
    out = {"tp": {}}
    try:
        for name in TP_RUNS:
            collective_time.clear()
            # an output directory a rank: rank 0 alone writes the JSON
            out["tp"][name] = tp_serve(name, spec["cfg"], spec["seed"],
                                       spec["root"],
                                       os.path.join(spec["dir"], "tp", name,
                                                    f"rank{rank}"),
                                       dev, world)
            out["tp"][name]["collectives"] = dict(collective_time)
        restore = tp_broken_sums(TP_CONTROL_CALLS)
        try:
            out["control"] = tp_serve(
                "llama_bf16", spec["cfg"], spec["seed"], spec["root"],
                os.path.join(spec["dir"], "control", f"rank{rank}"), dev,
                world, max_new=1)
        finally:
            restore()
        collective_time.clear()
        out["fsdp"] = fsdp_rank_run(spec["cfg"], spec["seed"], dev,
                                    os.path.join(spec["dir"], "fsdp"))
        out["fsdp"]["collectives"] = dict(collective_time)
        # phase 30 in the same processes (a spawn and a group fewer)
        out["tp_train"] = tp_train_rank_run(
            spec["cfg"], spec["seed"], dev, os.path.join(spec["dir"],
                                                         "tp_train"),
            collective_time)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, os.path.join(spec["dir"], f"rank{rank}.pt"))


def shard_kernel_checks(cfg, prefill_len, seed, dev, results):
    """K2 and K5 at one rank's shard shapes at tp = 2 (phase 27): Llama-3-8B
    (16 / 4 heads; wq / wk / wv / w_gate / w_up on their column blocks,
    wo / w_down on their row blocks with unit scales and fp32 output, the
    vocab-split lm_head) and MPT-7B (16 / 16 heads, rank 1's ALiBi slopes:
    those of global heads 16-31; its MLP's up / down), each product at the
    prefill rows and at one decode row, against the plain versions as
    phase 2 holds them (K5 exact)."""
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.attention import (
        alibi_slopes,
        attention,
        attention_reference,
    )
    from video_llava_seg_torch.ops.int4 import unpack_int4, w4a8_matmul_plain

    g = torch.Generator(device=dev).manual_seed(seed + 6)
    bf = torch.bfloat16
    mpt = family_cfg(cfg, "mpt").llm
    mpt_len = family_prompt_lens(family_cfg(cfg, "mpt"), "mpt",
                                 SmokeTokenizer(mpt.vocab_size))[0]
    for lc, s, fam in ((cfg.llm, prefill_len, "llama"), (mpt, mpt_len,
                                                         "mpt")):
        hq, hkv = lc.num_heads // TP, lc.num_kv_heads // TP
        q = torch.randn(1, hq, s, lc.head_dim, generator=g, device=dev).to(bf)
        k = torch.randn(1, hkv, s, lc.head_dim, generator=g,
                        device=dev).to(bf)
        v = torch.randn(1, hkv, s, lc.head_dim, generator=g,
                        device=dev).to(bf)
        slopes = (torch.from_numpy(alibi_slopes(lc.num_heads)[hq:]).to(dev)
                  if lc.use_alibi else False)
        causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        mask = None
        if lc.use_alibi:
            rel = (torch.arange(s, device=dev)[None]
                   - torch.arange(s, device=dev)[:, None]).float()
            mask = torch.where(causal, slopes[:, None, None] * rel,
                               float("-inf"))[None].to(bf)
        work = (2 * _nbytes(q, k, v, q),
                4 * hq * lc.head_dim * s * (s + 1) // 2, PEAK_BF16)
        entry = kernels.attention_entry(lc.head_dim, False, s, hkv,
                                        bias=lc.use_alibi,
                                        head_bias=lc.use_alibi)
        if entry != SM90_ENTRY:
            raise AssertionError(f"K2 tp{TP} {fam}: routed to {entry}")
        _check("K2_tp2", f"{fam} rank shard q{list(q.shape)} "
               f"kv{list(k.shape)} causal"
               + (" ALiBi of heads 16-31" if lc.use_alibi else ""),
               lambda: attention(q, k, v, causal=True, alibi=slopes),
               lambda: attention_reference(q, k, v, causal=True,
                                           alibi=slopes),
               lambda: attention_reference(q.float(), k.float(), v.float(),
                                           causal=True, alibi=slopes),
               results, work,
               run_library=lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, is_causal=mask is None,
                   enable_gqa=True))
        del q, k, v, mask, causal
    shapes = {}
    for lc, s in ((cfg.llm, prefill_len), (mpt, mpt_len)):
        d, hd = lc.hidden_size, lc.head_dim
        col = [(d, lc.num_heads * hd // TP), (d, lc.num_kv_heads * hd // TP),
               (d, lc.intermediate_size // TP)]
        row = [(lc.num_heads * hd // TP, d), (lc.intermediate_size // TP, d)]
        for rows in (s, 1):
            for i, o in col:
                shapes[(rows, i, o, "column")] = None
            for i, o in row:
                shapes[(rows, i, o, "row")] = None
        if not lc.tie_word_embeddings:
            shapes[(1, d, lc.vocab_size // TP, "head")] = None
    for rows, in_dim, out, kind in shapes:
        packed = torch.randint(-128, 128, (in_dim // 2, out), generator=g,
                               device=dev, dtype=torch.int8)
        xq = torch.randint(-127, 128, (rows, in_dim), generator=g,
                           device=dev, dtype=torch.int8)
        if kind == "row":       # the integer products, scaled after the sum
            w_scale = torch.ones(out, device=dev)
            a_scale = torch.ones(rows, 1, device=dev)
        else:
            w_scale = torch.rand(out, generator=g, device=dev) * 1e-2 + 1e-4
            a_scale = torch.rand(rows, 1, generator=g, device=dev) + 1e-3
        dt = bf if kind == "column" else torch.float32
        w_i8 = torch.cat(unpack_int4(packed)).t().contiguous().t()
        xq_lib = (torch.cat([xq, xq.new_zeros(32, in_dim)])
                  if rows < 17 else xq)
        entry = kernels.w4a8_entry(rows, in_dim // 2, out)
        want = kernels.W4A8_GEMV_ENTRY if rows <= 8 else "vls_w4a8_sm90"
        if entry != want:
            raise AssertionError(f"K5 tp{TP} [{rows}, {in_dim}] x [{in_dim}"
                                 f", {out}]: routed to {entry}")
        work = (_nbytes(xq, a_scale, packed, w_scale)
                + rows * out * (4 if dt == torch.float32 else 2),
                2 * rows * in_dim * out, PEAK_INT8)
        _check("K5_tp2", f"{kind}-parallel [{rows}, {in_dim}] x [{in_dim}, "
               f"{out}] -> {str(dt).split('.')[-1]} ({entry})",
               lambda: kernels.w4a8_matmul(xq, a_scale, packed, w_scale, dt),
               lambda: w4a8_matmul_plain(xq, a_scale, packed, w_scale, dt),
               lambda: w4a8_matmul_plain(xq, a_scale, packed, w_scale, dt),
               results, work,
               run_library=lambda: torch._int_mm(xq_lib, w_i8))
        del packed, xq, w_i8, xq_lib
    torch.cuda.empty_cache()
    sync()


def fsdp_single_reference(cfg, seed, dev, rows=None):
    """Phase 29's reference: the same stage-3 QLoRA tree through
    FSDP_STEPS single-process steps on the global batch (2 rows) or, for
    the control, on its rows `rows` alone. Returns the metrics and the
    trainable leaves before the first step and after the last (on the
    host)."""
    from video_llava_seg_torch.train.train import init_params
    from video_llava_seg_torch.train.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )
    from video_llava_seg_torch.train.trainer import RowGenerators

    fcfg = fsdp_two_rank_cfg(cfg)
    tcfg = train_tcfg(seed=seed)
    state, tx = create_train_state(init_params(fcfg, tcfg, dev), tcfg)
    step_fn = make_train_step(fcfg, tcfg, tx)
    batch = fsdp_global_batch(fcfg, seed)
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
    batch = batch_to_device(batch, dev, torch.bfloat16)

    def trainable():
        return {p: t.detach().to("cpu", copy=True)
                for p, t in zip(tx.paths, tx.params)}

    start = trainable()
    metrics = []
    for step in range(FSDP_STEPS):
        state, m = step_fn(state, batch, RowGenerators(seed, step))
        metrics.append({k: float(v) for k, v in m.items()})
    after = trainable()
    del state, tx, step_fn, batch
    torch.cuda.empty_cache()
    sync()
    return {"metrics": metrics, "start": start, "after": after}


def update_gap(start, after, want):
    """(||after - want|| / ||want - start||, max |after - want|) over every
    trainable leaf: how far a run's parameters are from the reference's,
    against the reference's own update."""
    num = den = 0.0
    worst = 0.0
    for p, w in want.items():
        d = after[p].double() - w.double()
        num += float(d.square().sum())
        den += float((w.double() - start[p].double()).square().sum())
        worst = max(worst, float(d.abs().max()))
    return math.sqrt(num / den), worst


def tp_launch_line(tag, c):
    from video_llava_seg_torch import kernels

    return (f"{tag}: K2 {c['K2']} (attention_sm90.cu {c['sm90 entry']}, "
            f"attention.cu {c['attention.cu entry']}), K5 {c['K5']} "
            f"(w4a8_sm90.cu {c['vls_w4a8_sm90']}, w4a8_gemv_sm90.cu "
            f"{c[kernels.W4A8_GEMV_ENTRY]}, w4a8.cu {c['vls_w4a8']}), K1 "
            f"{c['K1']}, K3 {c['K3']}, K4 {c['K4']}")


def collective_split(x):
    """'X s: collectives Y s (by op), the rest Z s' of one rank's run."""
    c = x.get("collectives", {})
    total = sum(v[0] for v in c.values())
    return (f"{x['seconds']:.3f} s: collectives {total:.3f} s ("
            + ", ".join(f"{k} {v[0]:.3f} s {v[1] / 1e9:.2f} GB"
                        for k, v in sorted(c.items()))
            + f"), compute and host {x['seconds'] - total:.3f} s")


def phase_parallel(cfg, prefill_len, seed, dev, smi, results):
    """Phases 27 and 29. 27: K2 / K5 at the shard shapes
    (`shard_kernel_checks`); then each TP run (Llama-3-8B bf16 and W4A8,
    MPT-7B W4A8; 32 layers, full width; CLIP-L and the seg head whole on
    every rank) served in this process and by two ranks through
    `run_inference --model_parallel 2`: the rank's prefill logits and
    greedy tokens against the one process's (`tp_tokens_agree`), the
    bf16 control beyond the limit, the JSON written by rank 0 alone, each
    rank's launches by C entry (K2 all on attention_sm90.cu, K5 on
    w4a8_sm90.cu / w4a8_gemv_sm90.cu, none on attention.cu / w4a8.cu),
    each rank's seconds split into collectives and the rest.
    29: the stage-3 QLoRA step (FSDP_LAYERS layers, full width) on the
    global batch of 2 rows in this process (and, the control, on row 0
    alone), then by the two ranks under --fsdp (a row each) for
    FSDP_STEPS steps and the last again resumed from the checkpoint
    before it (`fsdp_rank_run`): every step's loss and grad norm, and the
    trainable leaves after the last, within their limits of the one
    process's, the control outside them, the resume bitwise, each
    rank's peak memory. The same ranks then run phase 30's training
    (`tp_train_rank_run`). Returns (rank 0's W4A8 Llama TP counts,
    summary, phase 30's inputs: the one-process run on row 0, its
    reference, and the ranks' runs)."""
    from video_llava_seg_torch import kernels

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shard_kernel_checks(cfg, prefill_len, seed, dev, results)
    t_checks = time.perf_counter() - t0
    summary = {"fsdp_layers": FSDP_LAYERS,
               "kernel_checks_seconds": t_checks, "tp": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as work:
        root = os.path.join(work, "datasets")
        write_vicas_fixture(root, seed)
        old_env = os.environ.get("VIDEONET_DATASETS_DIR")
        os.environ["VIDEONET_DATASETS_DIR"] = root
        try:
            one = {}
            for name in TP_RUNS:
                one[name] = tp_serve(name, cfg, seed, root,
                                     os.path.join(work, "one", name), dev, 1)
            t0 = time.perf_counter()
            ref = fsdp_single_reference(cfg, seed, dev)
            t_ref = time.perf_counter() - t0
            control = fsdp_single_reference(cfg, seed, dev, slice(0, 1))
            torch.cuda.empty_cache()
            sync()
            # both ranks on this process's card
            spec = {"cfg": cfg, "seed": seed, "root": root, "dir": work,
                    "device": (f"cuda:{torch.cuda.current_device()}"
                               if dev.type == "cuda" else "cpu")}
            t0 = time.perf_counter()
            torch.multiprocessing.spawn(
                parallel_rank, args=(TP, free_port(), spec), nprocs=TP,
                join=True)
            t_ranks = time.perf_counter() - t0
            ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                                weights_only=False) for r in range(TP)]
        finally:
            if old_env is None:
                os.environ.pop("VIDEONET_DATASETS_DIR", None)
            else:
                os.environ["VIDEONET_DATASETS_DIR"] = old_env
    failures = []
    log(f"[parallel] two ranks on the one card (gloo) ran the three TP "
        f"serving runs, the control, the FSDP steps and phase 30's runs in "
        f"{t_ranks:.1f} s (two processes sharing a card: no multi-GPU "
        f"speed); {smi}")
    for name in TP_RUNS:
        o, rs = one[name], [r["tp"][name] for r in ranks]
        family, w4a8 = TP_RUNS[name]
        layers = tp_cfg(cfg, family).llm.num_layers
        tag = f"[tp{TP} {name}]"
        log(f"{tag} one process: {o['seconds']:.3f} s, peak "
            f"{o['peak_gib']:.1f} GiB; " + "; ".join(
                f"rank {r}: {collective_split(x)}, peak "
                f"{x['peak_gib']:.1f} GiB" for r, x in enumerate(rs))
            + f" ({layers} layers, full width, the family's full depth; "
            "collectives timed between device synchronizes; "
            f"{smi})")
        log(tp_launch_line(f"{tag} one process launches", o["counts"]))
        for r, x in enumerate(rs):
            log(tp_launch_line(f"{tag} rank {r} launches", x["counts"]))
        held = []
        for r, x in enumerate(rs):
            h, bad = tp_tokens_agree(f"{tag} rank {r}", o, x, w4a8)
            held.append(h)
            failures += bad
        if rs[0]["pred"] is None or any(x["pred"] is not None
                                        for x in rs[1:]):
            failures.append(f"{tag}: rank 0 alone must write the JSON")
        queries = len(o["tokens"])
        for r, x in enumerate(rs):
            c = x["counts"]
            if (c["K2"] != layers * queries or c["attention.cu entry"]
                    or c["sm90 entry"] < c["K2"]):
                failures.append(f"{tag} rank {r}: K2 {c['K2']} (expected "
                                f"{layers} x {queries}), attention.cu "
                                f"{c['attention.cu entry']}")
            if w4a8 and (not c["K5"] or c["vls_w4a8"] or c["vls_w4a8_sm90"]
                         + c[kernels.W4A8_GEMV_ENTRY] != c["K5"]):
                failures.append(f"{tag} rank {r}: K5 off the sm90 entries")
            if c != rs[0]["counts"]:
                failures.append(f"{tag}: the ranks launched unlike")
        rule = ("W4A8: prefill logits and every token must be bit-equal"
                if w4a8 else
                f"bf16: prefill logits within {TP_BF16_LOGIT_ATOL}, tokens "
                f"equal up to a margin below "
                f"{TP_MARGIN * TP_BF16_LOGIT_ATOL}")
        for r, h in enumerate(held):
            log(f"{tag} rank {r}: against the one process's "
                + "; ".join(f"query {q}: {k} of {len(o['tokens'][q])} "
                            f"tokens equal, prefill logits within {d:.3e}, "
                            f"one-process margins "
                            + ", ".join(f"{m:.3f}" for m in o["margins"][q])
                            for q, (d, k) in enumerate(h))
                + f" ({rule}); rank 0 alone wrote the JSON")
        summary["tp"][name] = {
            "layers": layers, "tokens_held": held,
            "one_process_s": o["seconds"],
            "rank_s": [x["seconds"] for x in rs],
            "rank_collectives": [x["collectives"] for x in rs],
            "rank_peak_gib": [x["peak_gib"] for x in rs],
            "launches_by_rank": [x["counts"] for x in rs]}
    base = one["llama_bf16"]["prefill"][0]
    d_control = [float((base - r["control"]["prefill"][0]).abs().max())
                 for r in ranks]
    log(f"[tp{TP} control] layer 0's two row-parallel sums left out (bf16, "
        f"the caption's prefill): prefill logits within "
        + ", ".join(f"{d:.3e}" for d in d_control)
        + f" of the one process's on ranks 0 / 1; the limit "
        f"{TP_BF16_LOGIT_ATOL} must reject it")
    if not all(d > TP_BF16_LOGIT_ATOL for d in d_control):
        failures.append(f"tp control: a run without layer 0's sums stays "
                        f"within {TP_BF16_LOGIT_ATOL} ({d_control})")
    summary["tp_control_prefill_logit_diff"] = d_control
    f = [r["fsdp"] for r in ranks]
    steps = []
    for step, (want, got, ctl) in enumerate(zip(ref["metrics"],
                                                f[0]["metrics"],
                                                control["metrics"])):
        rel = {k: abs(got[k] - want[k]) / abs(want[k])
               for k in ("loss", "grad_norm")}
        crel = {k: abs(ctl[k] - want[k]) / abs(want[k])
                for k in ("loss", "grad_norm")}
        steps.append({"rank": rel, "control": crel})
        log(f"[fsdp 2 ranks] step {step + 1}: loss {got['loss']:.6f} vs "
            f"{want['loss']:.6f} one process on the same 2 rows (rel "
            f"{rel['loss']:.2e}, limit {FSDP_LOSS_RTOL:.0e}); grad_norm "
            f"{got['grad_norm']:.5f} vs {want['grad_norm']:.5f} (rel "
            f"{rel['grad_norm']:.2e}, limit {FSDP_GRAD_NORM_RTOL:.0e}); "
            f"the control (row 0 alone): loss {ctl['loss']:.6f} (rel "
            f"{crel['loss']:.2e}), grad_norm {ctl['grad_norm']:.5f} (rel "
            f"{crel['grad_norm']:.2e})")
        if not rel["loss"] <= FSDP_LOSS_RTOL:
            failures.append(f"fsdp step {step + 1}: loss rel "
                            f"{rel['loss']:.2e}")
        if not rel["grad_norm"] <= FSDP_GRAD_NORM_RTOL:
            failures.append(f"fsdp step {step + 1}: grad_norm rel "
                            f"{rel['grad_norm']:.2e}")
        if crel["loss"] <= FSDP_LOSS_RTOL and (crel["grad_norm"]
                                               <= FSDP_GRAD_NORM_RTOL):
            failures.append(f"fsdp control step {step + 1}: row 0 alone "
                            "passes the loss and grad-norm limits")
    gap, worst = update_gap(ref["start"], f[0]["trainable"], ref["after"])
    cgap, cworst = update_gap(ref["start"], control["after"], ref["after"])
    bound = 3 * FSDP_PEAK_LR * (FSDP_STEPS - 1)
    log(f"[fsdp 2 ranks] trainable leaves ({len(ref['after'])}) after "
        f"{FSDP_STEPS} steps ({FSDP_STEPS - 1} at a nonzero lr): "
        f"||rank 0's - one process's|| = {gap:.3e} of the one process's "
        f"update (limit {FSDP_UPDATE_RTOL}), largest difference "
        f"{worst:.3e} (limit {bound:.1e}); the control (row 0 alone): "
        f"{cgap:.3e} of the update, largest {cworst:.3e}")
    if not (gap <= FSDP_UPDATE_RTOL and worst <= bound):
        failures.append(f"fsdp: trainable leaves {gap:.3e} of the update, "
                        f"largest difference {worst:.3e}")
    if not cgap > FSDP_UPDATE_RTOL:
        failures.append(f"fsdp control: row 0 alone is within "
                        f"{FSDP_UPDATE_RTOL} of the update ({cgap:.3e})")
    if not all(x["resume_bitwise"] for x in f):
        failures.append("fsdp: the resumed run differs from the straight "
                        "one")
    full_layers = cfg.llm.num_layers
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    projected = [x["peak_gib"] + (full_layers - FSDP_LAYERS)
                 * x["layer_bytes"] / 2**30 for x in f]
    gathered = f[0]["collectives"].get("all_gather_dim", (0.0, 0))
    rate = gathered[1] / max(gathered[0], 1e-9)
    extra = (2 * (full_layers - FSDP_LAYERS) * f[0]["layer_gather_bytes"]
             / max(rate, 1.0))
    log(f"[fsdp 2 ranks] {FSDP_LAYERS} of {full_layers} LLM layers, full "
        f"width (two processes on one card; cut for the time of gloo's "
        f"gathers through host memory, not for memory: a layer adds "
        f"{f[0]['layer_bytes'] / 2**20:.0f} MiB at rest a rank, so "
        f"{full_layers} layers would peak near "
        + " + ".join(f"{p:.1f}" for p in projected)
        + f" GiB of the card's {card_gib:.0f}, but their gathers "
        f"({f[0]['layer_gather_bytes'] / 1e9:.2f} GB a layer, twice a "
        f"step) would add about {extra:.0f} s a step at this run's "
        f"{rate / 1e9:.2f} GB/s, {(FSDP_STEPS + 1) * extra:.0f} s over the "
        f"phase's {FSDP_STEPS + 1} steps); "
        f"{f[0]['sharded_leaves']} of {f[0]['leaves']} leaves sharded; "
        f"{FSDP_STEPS} steps, then step {FSDP_STEPS} again from rank 0's "
        f"gathered checkpoint-{FSDP_STEPS - 1} in a fresh state: trainable "
        f"leaves and step-{FSDP_STEPS} metrics bit-equal: "
        f"{all(x['resume_bitwise'] for x in f)}; peak allocated by rank: "
        + ", ".join(f"{x['peak_gib']:.1f} GiB" for x in f)
        + f"; {f[0]['seconds']:.1f} s on the ranks, the one-process "
        f"reference {t_ref:.1f} s; rank 0's collectives (s, GB): "
        + ", ".join(f"{k} {v[0]:.1f} s {v[1] / 1e9:.2f} GB"
                    for k, v in f[0]["collectives"].items()) + f"; {smi}")
    if failures:
        raise AssertionError("; ".join(failures))
    summary["fsdp"] = {"metrics": f[0]["metrics"],
                       "reference": ref["metrics"],
                       "control": control["metrics"], "steps": steps,
                       "update_gap": gap, "largest_difference": worst,
                       "control_update_gap": cgap,
                       "rank_peak_gib": [x["peak_gib"] for x in f],
                       "projected_full_depth_gib": projected,
                       "seconds": f[0]["seconds"],
                       "collectives": f[0]["collectives"],
                       "sharded_leaves": f[0]["sharded_leaves"]}
    tp_train = {"reference": control,
                "ranks": [r.pop("tp_train") for r in ranks]}
    return ranks[0]["tp"]["llama_w4a8"]["counts"], summary, tp_train


def phase_fsdp_one_rank(seed, dev, params, ref):
    """Phase 28: a one-rank NCCL group runs phase 26's first
    FSDP_REF_STEPS steps through the --fsdp code (`DataParallel`, the
    per-layer hook, the group's sums), from the same trainable leaves on
    the same device batches: losses and parameters bit-equal to phase
    26's. At dp 1 the JAX rule shards no leaf (its dp > 1 guard), so
    this pins the plumbing, not the gathers (phase 29 runs those)."""
    import torch.distributed as dist

    from video_llava_seg_torch.config import MeshConfig
    from video_llava_seg_torch.parallel.fsdp import DataParallel
    from video_llava_seg_torch.parallel.mesh import create_mesh
    from video_llava_seg_torch.train.optimizer import (
        _map_with_paths,
        leaves_with_paths,
    )
    from video_llava_seg_torch.train.train_step import (
        create_train_state,
        make_train_step,
    )
    from video_llava_seg_torch.train.trainer import RowGenerators

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        dcfg = ref["cfg"]
        tree = _map_with_paths(lambda p, t: ref["start"].get(p, t), params)
        tcfg = train_tcfg(seed=seed, mesh=MeshConfig(fsdp=True))
        dp = DataParallel(create_mesh(tcfg.mesh), fsdp=True)
        state, tx = create_train_state(dp.shard(tree), tcfg)
        step_fn = make_train_step(dcfg, tcfg, tx, dp=dp)
        expect, why, bwd = train_step_expect(dcfg)
        for step, batch in enumerate(ref["batches"]):
            reset_launches()
            state, m = step_fn(state, batch, RowGenerators(seed, step))
            sync()
            check_launches(f"fsdp one rank step {step + 1}",
                           snapshot_launches(), expect, why, bwd=bwd)
            got = {k: float(v) for k, v in m.items()}
            if got != ref["metrics"][step]:
                raise AssertionError(f"fsdp one rank step {step + 1}: "
                                     f"metrics {got} vs phase 26's "
                                     f"{ref['metrics'][step]}")
        for p, t in leaves_with_paths(state.params):
            if p in ref["after"] and not torch.equal(t, ref["after"][p]):
                raise AssertionError(f"fsdp one rank: leaf {p} differs from "
                                     "phase 26's")
        log(f"[fsdp one rank] a one-rank NCCL group ran phase 26's first "
            f"{FSDP_REF_STEPS} steps through the --fsdp code: losses, "
            f"grad norms and all {len(ref['after'])} trainable leaves "
            "bit-equal (loss "
            + ", ".join(f"{x['loss']:.6f}" for x in ref["metrics"]) + ")")
    finally:
        dist.destroy_process_group()
    del state, tx, step_fn
    torch.cuda.empty_cache()
    sync()


# ---------------------------------------------------------------------------
# tensor-parallel training (phase 30)
# ---------------------------------------------------------------------------

def tp_train_kernel_checks(cfg, seq_len, seed, dev, results):
    """K2 with the logsumexp and K6a / K6b at one tp = 2 rank's shard of
    the train step (Llama-3-8B's 16 query / 4 KV heads of a rank, causal,
    the synthetic batch's length), against their plain versions as phase
    6 holds them; SDPA's forward and backward (fwd+bwd - fwd) at the same
    shard as the library."""
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.attention import (
        flash_backward_plain,
        flash_forward_plain,
    )

    lc = cfg.llm
    hq, hkv, d = lc.num_heads // TP, lc.num_kv_heads // TP, lc.head_dim
    if kernels.attention_entry(d, False, seq_len, hkv) != SM90_ENTRY:
        raise AssertionError(f"K2 tp{TP} train: routed off {SM90_ENTRY}")
    if kernels.attention_bwd_entry(d, seq_len, hkv) != K6_SM90_PAIR:
        raise AssertionError(f"K6 tp{TP} train: routed off {K6_SM90_PAIR}")
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    q, do = randn(1, hq, seq_len, d), randn(1, hq, seq_len, d)
    k, v = randn(1, hkv, seq_len, d), randn(1, hkv, seq_len, d)
    scale = 1.0 / math.sqrt(d)
    kw = dict(scale=scale, causal=True, kv_bias=None)
    shape = (f"tp{TP} rank shard q{list(q.shape)} kv{list(k.shape)} "
             "causal")
    pairs = hq * seq_len * (seq_len + 1) // 2
    prod = 2 * pairs * d
    qb, kb, lse_b = _nbytes(q), _nbytes(k), 4 * hq * seq_len
    out, lse = kernels.attention(q, k, v, with_lse=True, **kw)
    _, want_lse = flash_forward_plain(q.float(), k.float(), v.float(), None,
                                      causal=True, scale=scale)
    sync()
    lse_err = (lse - want_lse).abs().max().item()
    log(f"[flash] K2_tp2_lse {shape}: lse max abs err {lse_err:.3e} (bound "
        f"{LSE_BOUND:.0e})")
    if not math.isfinite(lse_err) or lse_err > LSE_BOUND:
        raise AssertionError(f"K2_tp2_lse: lse off by {lse_err:.3e}")
    del want_lse
    _check("K2_tp2_lse", f"{shape}, with lse",
           lambda: kernels.attention(q, k, v, with_lse=True, **kw)[0],
           lambda: flash_forward_plain(q, k, v, None, causal=True,
                                       scale=scale),
           lambda: flash_forward_plain(q.float(), k.float(), v.float(),
                                       None, causal=True, scale=scale)[0],
           results, (2 * qb + 2 * kb + lse_b, 2 * prod, PEAK_BF16),
           run_library=lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True))
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), do)

    lib_bwd = max(cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd), 0.0)
    ref = flash_backward_plain(q.float(), k.float(), v.float(), None,
                               out.float(), lse, do.float(), causal=True,
                               scale=scale)
    pair_checks(shape, d, q, k, v, out, do, lse, kw, None, ref,
                lambda: flash_backward_plain(q, k, v, None, out, lse, do,
                                             causal=True, scale=scale),
                results, qb, kb, lse_b, prod, names=("K6a_tp2", "K6b_tp2"))
    for name in ("K6a_tp2", "K6b_tp2"):
        results[name]["library_ms"] = lib_bwd
        results[name]["shapes"][-1]["library_ms"] = lib_bwd
    log(f"[flash] K6_tp2 SDPA backward (fwd+bwd - fwd) {shape}: "
        f"{lib_bwd:.4f} ms; K6a_tp2 {results['K6a_tp2']['ms']:.4f} ms + "
        f"K6b_tp2 {results['K6b_tp2']['ms']:.4f} ms (bounds "
        f"{results['K6a_tp2']['bound_ms']:.4f} / "
        f"{results['K6b_tp2']['bound_ms']:.4f} ms); K2_tp2_lse "
        f"{results['K2_tp2_lse']['ms']:.4f} ms (bound "
        f"{results['K2_tp2_lse']['bound_ms']:.4f} ms), SDPA forward "
        f"{results['K2_tp2_lse']['library_ms']:.4f} ms")
    del q, k, v, do, out, lse, ref, qr, kr, vr
    torch.cuda.empty_cache()
    sync()


def tp_train_rank_run(cfg, seed, dev, workdir, collective_time):
    """Phase 30 on one rank: the stage-3 QLoRA state split over the two
    ranks' 'model' group (`--model_parallel 2`, dp 1: both ranks on row
    0 of the global batch). Steps 1 to FSDP_STEPS - 1 through the
    trainer's loop (rank 0 writes the last one's checkpoint, gathered),
    the last step in memory; a fresh state resumed by the loop from that
    checkpoint to the last step; then the control: FSDP_STEPS steps with
    the 'model' sum of the LoRA partial gradients left out. Returns each
    run's metrics, launches, seconds and collectives, whether the resumed
    last step equals the uninterrupted one bit for bit, the peak memory
    and, on rank 0, the full trainable leaves (on the host)."""
    import itertools

    from video_llava_seg_torch.config import MeshConfig, to_json
    from video_llava_seg_torch.parallel.fsdp import DataParallel
    from video_llava_seg_torch.parallel.mesh import create_mesh
    from video_llava_seg_torch.parallel.tensor_parallel import (
        check_divisible,
    )
    from video_llava_seg_torch.train.optimizer import leaves_with_paths
    from video_llava_seg_torch.train.train import init_params
    from video_llava_seg_torch.train.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )
    from video_llava_seg_torch.train.trainer import RowGenerators, train_loop

    fcfg = fsdp_two_rank_cfg(cfg)
    check_divisible(fcfg.llm, TP)
    tcfg = train_tcfg(seed=seed, mesh=MeshConfig(model_parallel=TP),
                      per_device_batch_size=1, output_dir=workdir)
    dp = DataParallel(create_mesh(tcfg.mesh))
    batch = batch_to_device(dp.rows(fsdp_global_batch(fcfg, seed), 1), dev,
                            torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for run in ("straight", "resumed", "control"):
        state, tx = create_train_state(dp.shard(init_params(fcfg, tcfg,
                                                            dev)), tcfg)
        # the rank's shards of the frozen LLM (int8 base, its scales, the
        # embedding and norms)
        base = {p: t.clone() for p, t in leaves_with_paths(state.params)
                if p.startswith("llm/")}
        step_fn = make_train_step(fcfg, tcfg, tx, dp=dp)
        metrics = []

        def rec(state, b, g, step_fn=step_fn, metrics=metrics):
            state, m = step_fn(state, b, g)
            metrics.append({k: float(v) for k, v in m.items()})
            return state, m

        collective_time.clear()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        if run == "control":
            dp.sum_partial = lambda paths, params: None
            try:
                for step in range(FSDP_STEPS):
                    state, _ = rec(state, batch,
                                   RowGenerators(seed, step, dp.rank))
            finally:
                del dp.sum_partial
        else:
            # the straight pass ends at checkpoint-(FSDP_STEPS - 1); the
            # resumed one starts from it
            state = train_loop(
                state, rec, itertools.repeat(batch),
                dataclasses.replace(tcfg, num_train_steps=FSDP_STEPS - 1
                                    if run == "straight" else FSDP_STEPS),
                to_json(fcfg), dp=dp)
        counts = snapshot_launches()
        if run == "straight":
            state, _ = rec(state, batch, RowGenerators(seed, FSDP_STEPS - 1,
                                                       dp.rank))
        sync()
        seconds = time.perf_counter() - t0
        local = dict(leaves_with_paths(state.params))
        full = dp.full_params(dict(zip(tx.paths, tx.params)))
        runs[run] = {"metrics": metrics, "counts": counts,
                     "seconds": seconds,
                     "collectives": dict(collective_time),
                     "base_equal": all(torch.equal(local[p], t)
                                       for p, t in base.items()),
                     "trainable": {p: t.to("cpu", copy=True)
                                   for p, t in full.items()}}
        del state, tx, step_fn, full, local, base
        torch.cuda.empty_cache()
    straight, resumed = runs["straight"], runs["resumed"]
    same = (all(torch.equal(straight["trainable"][p], t)
                for p, t in resumed["trainable"].items())
            and resumed["metrics"][-1] == straight["metrics"][-1])
    if not dp.main:
        for r in runs.values():
            r["trainable"] = None
    return {"runs": runs, "resume_bitwise": same,
            "partial_leaves": len(dp.partial),
            "model_split_leaves": sum(dp.model_dim(p) is not None
                                      for p in dp.specs),
            "leaves": len(dp.specs),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_tp_train(cfg, seq_len, seed, dev, smi, results, tp_train):
    """Phase 30: `tp_train_kernel_checks`, then the two ranks'
    `tp_train_rank_run` (run by phase 29's ranks: `tp_train["ranks"]`)
    against this process's FSDP_STEPS steps on the same row
    (`tp_train["reference"]`: phase 29's one-process run on row 0).
    Returns (rank 0's launches of the loop's steps, summary)."""
    t0 = time.perf_counter()
    tp_train_kernel_checks(cfg, seq_len, seed, dev, results)
    t_checks = time.perf_counter() - t0
    ref, ranks = tp_train["reference"], tp_train["ranks"]
    t_ranks = sum(v["seconds"] for v in ranks[0]["runs"].values())
    fcfg = fsdp_two_rank_cfg(cfg)
    failures = []
    tag = f"[tp{TP} train]"
    log(f"{tag} two ranks on the one card (gloo) split the stage-3 QLoRA "
        f"state over their 'model' group ({fcfg.llm.num_layers} of "
        f"{cfg.llm.num_layers} LLM layers, full width; "
        f"{ranks[0]['model_split_leaves']} of {ranks[0]['leaves']} leaves "
        f"split, {ranks[0]['partial_leaves']} LoRA factors with partial "
        f"gradients) and ran the straight, resumed and control runs in "
        f"{t_ranks:.1f} s (after phase 29, in its processes; two processes "
        f"sharing a card: no multi-GPU speed); {smi}")
    straight = [r["runs"]["straight"] for r in ranks]
    control = ranks[0]["runs"]["control"]
    # the limits the control leaves (it must leave one at least: at step
    # 1 LoRA b is zero, so the column-parallel a's gradient is too and
    # only the row-parallel b's partials are missing)
    control_fails = []
    steps = []
    for step, (want, got, ctl) in enumerate(zip(
            ref["metrics"], straight[0]["metrics"], control["metrics"])):
        keys = ("loss", "loss_text", "loss_mask", "grad_norm")
        rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in keys}
        crel = {k: abs(ctl[k] - want[k]) / abs(want[k]) for k in keys}
        steps.append({"rank": rel, "control": crel})
        log(f"{tag} step {step + 1}: loss {got['loss']:.6f} vs "
            f"{want['loss']:.6f} one process on the same row (rel "
            f"{rel['loss']:.2e}, limit {TP_TRAIN_LOSS_RTOL:.0e}; text "
            f"{rel['loss_text']:.2e}, mask {rel['loss_mask']:.2e}); "
            f"grad_norm {got['grad_norm']:.5f} vs {want['grad_norm']:.5f} "
            f"(rel {rel['grad_norm']:.2e}, limit "
            f"{TP_TRAIN_GRAD_NORM_RTOL:.0e}); the control (no 'model' sum "
            f"of the LoRA partial gradients): loss {ctl['loss']:.6f} (rel "
            f"{crel['loss']:.2e}), grad_norm {ctl['grad_norm']:.5f} (rel "
            f"{crel['grad_norm']:.2e})")
        limits = (("loss", TP_TRAIN_LOSS_RTOL),
                  ("grad_norm", TP_TRAIN_GRAD_NORM_RTOL))
        failures += [f"tp train step {step + 1}: {k} rel {rel[k]:.2e}"
                     for k, lim in limits if not rel[k] <= lim]
        control_fails += [f"step {step + 1} {k} rel {crel[k]:.2e}"
                          for k, lim in limits if not crel[k] <= lim]
    if any(r["runs"]["straight"]["metrics"] != straight[0]["metrics"]
           for r in ranks):
        failures.append("tp train: the model ranks report unlike metrics")
    gap, worst = update_gap(ref["start"], straight[0]["trainable"],
                            ref["after"])
    cgap, cworst = update_gap(ref["start"], control["trainable"],
                              ref["after"])
    bound = 3 * FSDP_PEAK_LR * (FSDP_STEPS - 1)
    log(f"{tag} trainable leaves ({len(ref['after'])}) after {FSDP_STEPS} "
        f"steps ({FSDP_STEPS - 1} at a nonzero lr): ||rank 0's - one "
        f"process's|| = {gap:.3e} of the one process's update (limit "
        f"{FSDP_UPDATE_RTOL}), largest difference {worst:.3e} (limit "
        f"{bound:.1e}); the control: {cgap:.3e} of the update, largest "
        f"{cworst:.3e}; int8 base bit-identical on every rank and run: "
        + str(all(x["base_equal"] for r in ranks
                  for x in r["runs"].values())))
    if not (gap <= FSDP_UPDATE_RTOL and worst <= bound):
        failures.append(f"tp train: trainable leaves {gap:.3e} of the "
                        f"update, largest difference {worst:.3e}")
    if not cgap <= FSDP_UPDATE_RTOL:
        control_fails.append(f"trainable leaves {cgap:.3e} of the update")
    log(f"{tag} the control leaves the limits at: "
        + ("; ".join(control_fails) or "none"))
    if not control_fails:
        failures.append("tp train control: within every limit without the "
                        "'model' sum of the LoRA partial gradients")
    if not all(x["base_equal"] for r in ranks for x in r["runs"].values()):
        failures.append("tp train: the int8 base changed")
    if not all(r["resume_bitwise"] for r in ranks):
        failures.append("tp train: the resumed run differs from the "
                        "straight one")
    log(f"{tag} step {FSDP_STEPS} again from rank 0's gathered "
        f"checkpoint-{FSDP_STEPS - 1} in a fresh state: trainable leaves "
        f"and metrics bit-equal: {all(r['resume_bitwise'] for r in ranks)}")
    # the loop's FSDP_STEPS - 1 steps of the straight run, counted on each
    # rank: one train step's launches each (K2 and K6a / K6b at the shard)
    loop_steps = FSDP_STEPS - 1
    expect, why, bwd = train_step_expect(fcfg)
    expect = {k: v * loop_steps for k, v in expect.items()}
    why = {k: f"{loop_steps} steps x ({v})" for k, v in why.items()}
    bwd = {k: v * loop_steps for k, v in bwd.items()}
    for r, x in enumerate(straight):
        c = x["counts"]
        log(f"{tag} rank {r} launches by C entry: K2 {c['K2']} "
            f"(attention_sm90.cu {c['sm90 entry']} with the links and "
            f"trunk blocks, attention.cu {c['attention.cu entry']}); K6a / "
            f"K6b on attention_bwd_sm90.cu {c[K6_SM90_PAIR[0]]} / "
            f"{c[K6_SM90_PAIR[1]]}, attention_bwd.cu {c[K6_CUDA_C_PAIR[0]]}"
            f" / {c[K6_CUDA_C_PAIR[1]]}, attention_short_bwd_sm90.cu "
            f"{c[K6_SHORT_ENTRY]}")
        try:
            check_launches(f"tp{TP} train rank {r}, {loop_steps} steps", c,
                           expect, why, bwd=bwd)
        except AssertionError as e:
            failures.append(f"tp train rank {r}: {e}")
        if c != straight[0]["counts"]:
            failures.append("tp train: the ranks launched unlike")
    for r, x in enumerate(ranks):
        log(f"{tag} rank {r}: peak allocated {x['peak_gib']:.1f} GiB; "
            + "; ".join(f"{name} run ({len(v['metrics'])} steps) "
                        + collective_split(v)
                        for name, v in x["runs"].items()))
    log(f"{tag} kernel checks {t_checks:.1f} s; {smi}")
    if failures:
        raise AssertionError("; ".join(failures))
    summary = {"layers": fcfg.llm.num_layers, "seconds_ranks": t_ranks,
               "kernel_checks_seconds": t_checks, "steps": steps,
               "metrics": straight[0]["metrics"],
               "reference": ref["metrics"],
               "control": control["metrics"], "update_gap": gap,
               "largest_difference": worst, "control_update_gap": cgap,
               "resume_bitwise": True,
               "rank_peak_gib": [x["peak_gib"] for x in ranks],
               "rank_seconds": [{k: v["seconds"]
                                 for k, v in x["runs"].items()}
                                for x in ranks],
               "rank_collectives": [{k: v["collectives"]
                                     for k, v in x["runs"].items()}
                                    for x in ranks],
               "launches_by_rank": [
                   {k: x["counts"][k] for k in (
                       "K1", "K2", "K3", "K4", "K6a", "K6b", "sm90 entry",
                       "attention.cu entry", *K6_SM90_PAIR,
                       *K6_CUDA_C_PAIR, K6_SHORT_ENTRY)}
                   for x in straight]}
    return straight[0]["counts"], summary


# ---------------------------------------------------------------------------
# ring-attention context parallelism (phase 31)
# ---------------------------------------------------------------------------

# Two ranks share the card (gloo), each holding one contiguous block of a
# sequence of CP x the one-clip prefill's tokens, so each rank's ring block
# is the prefill's shape. The forward runs Llama-3-8B at full depth and
# width; the backward is cut to RING_BWD_LAYERS layers for the time of
# gloo's gradient sums through host memory (as phase 30), not for memory.
CP = 2
RING_BWD_LAYERS = 4
# cp_forward against the one process's llama.forward on the same bf16
# tree and sequence: the largest |logit| difference and the largest
# |hidden| difference over the largest |hidden|. The ring rounds each
# block's output to bf16 and merges the blocks in fp32 where one process
# rounds one pass over all keys, and its denses run at half the rows
# (another cuBLAS tiling): differences that 32 random layers grow. The
# CPU tests hold the same forward in fp32 to 2e-4 / 3e-4. First reading
# (H100 80GB HBM3, 700 W): logits 0.1055, hidden 3.07e-2, the control
# (`broken_merge`) 3.97 / 0.704; the limits keep ~2.4x over the reading.
RING_LOGIT_ATOL = 0.25
RING_HIDDEN_RTOL = 0.075
# the 4-layer backward against the one process: the loss's relative
# difference and each leaf's ||g - g_one|| / ||g_one||. First reading:
# loss 3.1e-6, leaves 1.36e-2 (median 1.19e-2; bf16 gradients summed in
# another order), the controls 0.731 (nothing summed) / 1.000 (lm_head
# summed too)
RING_LOSS_RTOL = 3e-5
RING_GRAD_RTOL = 0.035


def broken_merge(o, lse, o_b, lse_b):
    """The control of phase 31: the ring's merge without the rescale of
    either side (the blocks' outputs added as they are)."""
    if o is None:
        return o_b.float(), lse_b
    return o + o_b.float(), torch.logaddexp(lse, lse_b)


def ring_kernel_checks(cfg, block, seed, dev, results):
    """The ring's new K2 / K6 call forms at a rank's block of phase 31
    (Llama-3-8B's 32 query / 8 KV heads over `block` rows: the one-clip
    prefill's), against their plain versions: K2 non-causal with the
    logsumexp (`K2_cp2`: an earlier rank's block); the merge of the
    diagonal (causal) and that block against one pass over both; then
    K6a / K6b non-causal from the merged (global) O and lse (`K6a_cp2` /
    `K6b_cp2`: the backward of that block), each timed beside SDPA."""
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.ops.attention import (
        attention_reference,
        flash_backward_plain,
        flash_forward_plain,
    )
    from video_llava_seg_torch.parallel import ring_attention as ra

    lc = cfg.llm
    hq, hkv, d = lc.num_heads, lc.num_kv_heads, lc.head_dim
    if kernels.attention_entry(d, False, block, hkv) != SM90_ENTRY:
        raise AssertionError(f"K2 cp{CP}: routed off {SM90_ENTRY}")
    if kernels.attention_bwd_entry(d, block, hkv) != K6_SM90_PAIR:
        raise AssertionError(f"K6 cp{CP}: routed off {K6_SM90_PAIR}")
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 8)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    q, do = randn(1, hq, block, d), randn(1, hq, block, d)
    k0, v0 = randn(1, hkv, block, d), randn(1, hkv, block, d)  # own block
    k, v = randn(1, hkv, block, d), randn(1, hkv, block, d)    # rank 0's
    scale = 1.0 / math.sqrt(d)
    shape = (f"cp{CP} rank block q{list(q.shape)} kv{list(k.shape)} "
             "non-causal")
    pairs = hq * block * block
    prod = 2 * pairs * d
    qb, kb, lse_b = _nbytes(q), _nbytes(k), 4 * hq * block
    out_b, lse = kernels.attention(q, k, v, scale=scale, causal=False,
                                   with_lse=True)
    _, want_lse = flash_forward_plain(q.float(), k.float(), v.float(), None,
                                      causal=False, scale=scale)
    sync()
    lse_err = (lse - want_lse).abs().max().item()
    log(f"[flash] K2_cp2 {shape}: lse max abs err {lse_err:.3e} (bound "
        f"{LSE_BOUND:.0e}; natural log, as flash_forward_plain's)")
    if not math.isfinite(lse_err) or lse_err > LSE_BOUND:
        raise AssertionError(f"K2_cp2: lse off by {lse_err:.3e}")
    del want_lse
    _check("K2_cp2", f"{shape}, with lse",
           lambda: kernels.attention(q, k, v, scale=scale, causal=False,
                                     with_lse=True)[0],
           lambda: flash_forward_plain(q, k, v, None, causal=False,
                                       scale=scale),
           lambda: flash_forward_plain(q.float(), k.float(), v.float(),
                                       None, causal=False, scale=scale)[0],
           results, (2 * qb + 2 * kb + lse_b, 2 * prod, PEAK_BF16),
           run_library=lambda: F.scaled_dot_product_attention(
               q, k, v, enable_gqa=True))
    # the rank's two blocks merged by their lse (the ring's `_merge`)
    # against one pass of the fp32 reference over both: this rank's rows
    # see all of rank 0's keys and their own causally
    out_0, lse_0 = kernels.attention(q, k0, v0, scale=scale, causal=True,
                                     with_lse=True)
    o, lse_g = ra._merge(*ra._merge(None, None, out_0, lse_0), out_b, lse)
    out = o.to(bf)
    want = attention_reference(q.float(), torch.cat([k, k0], 2).float(),
                               torch.cat([v, v0], 2).float(), causal=True)
    sync()
    merge_err = _rel_err(out, want)
    log(f"[flash] cp{CP} merge of the diagonal (causal) and rank 0's block "
        f"(non-causal) by their lse against one fp32 pass over both: rel "
        f"err {merge_err:.3e} (bound {BOUNDS['K2_cp2']:.0e})")
    if not merge_err <= BOUNDS["K2_cp2"]:
        raise AssertionError(f"cp{CP} merge: rel err {merge_err:.3e}")
    del want, o, out_0, lse_0
    torch.cuda.empty_cache()
    kw = dict(scale=scale, causal=False, kv_bias=None)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), do)

    lib_bwd = max(cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd), 0.0)
    lse_g = lse_g.contiguous()
    ref = flash_backward_plain(q.float(), k.float(), v.float(), None,
                               out.float(), lse_g, do.float(), causal=False,
                               scale=scale)
    pair_checks(f"{shape}, global O and lse", d, q, k, v, out, do, lse_g,
                kw, None, ref,
                lambda: flash_backward_plain(q, k, v, None, out, lse_g, do,
                                             causal=False, scale=scale),
                results, qb, kb, lse_b, prod, names=("K6a_cp2", "K6b_cp2"))
    for name in ("K6a_cp2", "K6b_cp2"):
        results[name]["library_ms"] = lib_bwd
        results[name]["shapes"][-1]["library_ms"] = lib_bwd
    log(f"[flash] K6_cp2 SDPA backward (fwd+bwd - fwd) {shape}: "
        f"{lib_bwd:.4f} ms; K6a_cp2 {results['K6a_cp2']['ms']:.4f} ms + "
        f"K6b_cp2 {results['K6b_cp2']['ms']:.4f} ms (bounds "
        f"{results['K6a_cp2']['bound_ms']:.4f} / "
        f"{results['K6b_cp2']['bound_ms']:.4f} ms); K2_cp2 "
        f"{results['K2_cp2']['ms']:.4f} ms (bound "
        f"{results['K2_cp2']['bound_ms']:.4f} ms), SDPA forward "
        f"{results['K2_cp2']['library_ms']:.4f} ms")
    del q, k, v, k0, v0, do, out, out_b, lse, lse_g, ref, qr, kr, vr
    torch.cuda.empty_cache()
    sync()


def ring_launches(c):
    """A run's launches by kernel and C entry, as phase 31 reads them."""
    return {k: c[k] for k in ("K2", "K6a", "K6b", "sm90 entry",
                              "attention.cu entry", *K6_SM90_PAIR,
                              *K6_CUDA_C_PAIR)}


def ring_compare(got_logits, got_hidden, logits, hidden):
    """(largest |logit| difference, largest |hidden| difference over the
    largest |hidden|) of a rank's cp_forward against the one process's."""
    d_logit = float((got_logits - logits).abs().max())
    d_hidden = float((got_hidden.float() - hidden.float()).abs().max()
                     / hidden.float().abs().max())
    return d_logit, d_hidden


def ring_rank(rank, world, port, spec):
    """One of the two ranks of phase 31: a gloo group on the shared card.
    Forward: Llama-3-8B bf16 at full depth from the seed; rank 0 first
    runs the one process's `llama.forward` on the tree and sequence; then
    `cp_forward` over the CP x block tokens (the launches and collectives
    of exactly that run) and the control with `broken_merge`, rank 0
    comparing both. Backward: a RING_BWD_LAYERS-layer tree, the token
    cross-entropy of the whole sequence through `cp_forward`, every
    leaf's gradient made whole by `reduce_grads` (the controls: lm_head
    summed too, nothing summed); rank 0 runs the one process's loss and
    gradients. Writes its results to spec["dir"]/ring<r>.pt."""
    from video_llava_seg_torch.models import llama
    from video_llava_seg_torch.parallel import collectives
    from video_llava_seg_torch.parallel import ring_attention as ra
    from video_llava_seg_torch.train.optimizer import leaves_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    collective_time = time_collectives()
    dev = collectives.initialize_distributed(
        "gloo", spec["device"], init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank)
    out = {}
    try:
        group = ra.create_seq_mesh().groups[ra.SEQ_AXIS]
        lc, s = spec["cfg"].llm, spec["seq_len"]
        bf = torch.bfloat16
        g = torch.Generator(device=dev).manual_seed(spec["seed"] + 9)
        torch.cuda.reset_peak_memory_stats()
        params = llama.init(lc, g, dev, bf)
        ids = torch.randint(0, lc.vocab_size, (1, s), generator=g,
                            device=dev)
        pos = torch.arange(s, device=dev)
        with torch.no_grad():
            embeds = llama.embed(params, ids)
            ref = None
            if rank == 0:
                sync()
                t0 = time.perf_counter()
                ref = llama.forward(params, lc, embeds, pos)
                sync()
                out["one_process_s"] = time.perf_counter() - t0
            collectives.synchronize()
            reset_launches()
            collective_time.clear()
            sync()
            t0 = time.perf_counter()
            logits, hidden = ra.cp_forward(params, lc, embeds, pos, group)
            sync()
            out["forward_s"] = time.perf_counter() - t0
            out["forward_launches"] = ring_launches(snapshot_launches())
            out["forward_collectives"] = dict(collective_time)
            if rank == 0:
                out["forward_diff"] = ring_compare(logits, hidden, *ref)
                top = ref[0][0].topk(2, dim=-1).values
                out["margins"] = (top[:, 0] - top[:, 1]).cpu()
                out["argmax_same"] = (logits[0].argmax(-1)
                                      == ref[0][0].argmax(-1)).cpu()
            del logits, hidden
            kept, ra._merge = ra._merge, broken_merge
            try:
                logits, hidden = ra.cp_forward(params, lc, embeds, pos,
                                               group)
            finally:
                ra._merge = kept
            if rank == 0:
                out["control_diff"] = ring_compare(logits, hidden, *ref)
            del logits, hidden, ref, params, embeds
        torch.cuda.empty_cache()
        out["forward_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

        # the backward at RING_BWD_LAYERS layers
        lc4 = dataclasses.replace(lc, num_layers=RING_BWD_LAYERS)
        g = torch.Generator(device=dev).manual_seed(spec["seed"] + 10)
        params = llama.init(lc4, g, dev, bf)
        tgt = torch.randint(0, lc.vocab_size, (1, s), generator=g,
                            device=dev)
        with torch.no_grad():
            embeds = llama.embed(params, ids)
        leaves = [(p, t) for p, t in leaves_with_paths(params)
                  if not p.startswith("embed_tokens/")]
        for _, t in leaves:
            t.requires_grad_(True)

        def loss_and_grads(fn):
            logits = fn()
            loss = torch.nn.functional.cross_entropy(
                logits.view(-1, logits.shape[-1]), tgt.view(-1))
            grads = torch.autograd.grad(loss, [t for _, t in leaves])
            return float(loss.detach()), dict(zip((p for p, _ in leaves),
                                                  grads))

        collectives.synchronize()
        reset_launches()
        collective_time.clear()
        sync()
        t0 = time.perf_counter()
        loss, raw = loss_and_grads(lambda: ra.cp_forward(
            params, lc4, embeds, pos, group)[0])
        sync()
        out["backward_launches"] = ring_launches(snapshot_launches())
        grads = ra.reduce_grads(raw, group)
        sync()
        out["backward_s"] = time.perf_counter() - t0
        out["backward_collectives"] = dict(collective_time)
        # the control that sums every leaf: the leaves the ring leaves
        # partial are summed already, so sum the others too
        whole = {p: t for p, t in raw.items()
                 if not p.startswith(ra.PARTIAL_PREFIXES)}
        kept, ra.PARTIAL_PREFIXES = ra.PARTIAL_PREFIXES, ("",)
        try:
            sum_all = {**grads, **ra.reduce_grads(whole, group)}
        finally:
            ra.PARTIAL_PREFIXES = kept
        if rank == 0:
            t0 = time.perf_counter()
            loss_one, one = loss_and_grads(lambda: llama.forward(
                params, lc4, embeds, pos)[0])
            sync()
            out["backward_one_process_s"] = time.perf_counter() - t0

            def rel(gs):
                return {p: float((gs[p].float() - w.float()).norm()
                                 / w.float().norm().clamp_min(1e-30))
                        for p, w in one.items()}

            out["loss"] = (loss, loss_one)
            out["grad_rel"] = rel(grads)
            out["sum_none_rel"] = rel(raw)
            out["sum_all_rel"] = rel(sum_all)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params, raw, grads, sum_all, whole
        torch.cuda.empty_cache()
    finally:
        collectives.shutdown()
    torch.save(out, os.path.join(spec["dir"], f"ring{rank}.pt"))


def phase_ring(cfg, block, seed, dev, smi, results):
    """Phase 31: `ring_kernel_checks`, then the two ranks of `ring_rank`
    over CP x block tokens: the forward's hidden state and logits against
    the one process's within RING_HIDDEN_RTOL / RING_LOGIT_ATOL (the
    broken merge beyond them), the argmax equal on every row whose
    one-process top-two margin exceeds 2 x RING_LOGIT_ATOL (each of the
    top two may move by the limit); the backward's loss and leaves within
    RING_LOSS_RTOL / RING_GRAD_RTOL (both controls beyond); each rank's
    launches by C entry. Returns the summary."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ring_kernel_checks(cfg, block, seed, dev, results)
    t_checks = time.perf_counter() - t0
    s = CP * block
    held = torch.cuda.memory_allocated() / 2**30   # no tree in this process
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ring_") as work:
        spec = {"cfg": cfg, "seed": seed, "dir": work, "seq_len": s,
                "device": f"cuda:{torch.cuda.current_device()}"}
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(ring_rank, args=(CP, free_port(), spec),
                                    nprocs=CP, join=True)
        t_ranks = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(work, f"ring{r}.pt"),
                            weights_only=False) for r in range(CP)]
    r0 = ranks[0]
    failures = []
    layers = cfg.llm.num_layers
    tag = f"[cp{CP}]"
    for r, x in enumerate(ranks):
        for what, c, n in (("forward", x["forward_launches"], layers),
                           ("backward", x["backward_launches"],
                            RING_BWD_LAYERS)):
            # each layer: the diagonal block and one a rank before it
            want = n * (r + 1)
            k6 = want if what == "backward" else 0
            log(f"{tag} rank {r} {what} ({n} layers) launches: K2 {c['K2']} "
                f"(attention_sm90.cu {c['sm90 entry']}, attention.cu "
                f"{c['attention.cu entry']}), K6a {c['K6a']} / K6b "
                f"{c['K6b']} (attention_bwd_sm90.cu "
                f"{c[K6_SM90_PAIR[0]]} + {c[K6_SM90_PAIR[1]]}, "
                f"attention_bwd.cu {c[K6_CUDA_C_PAIR[0]]} + "
                f"{c[K6_CUDA_C_PAIR[1]]}); expected K2 {want}, K6a = K6b "
                f"= {k6}")
            if (c["K2"] != want or c["sm90 entry"] != want
                    or c["attention.cu entry"] or c["K6a"] != k6
                    or c["K6b"] != k6 or c[K6_SM90_PAIR[0]] != k6
                    or c[K6_SM90_PAIR[1]] != k6 or c[K6_CUDA_C_PAIR[0]]
                    or c[K6_CUDA_C_PAIR[1]]):
                failures.append(f"cp{CP} rank {r} {what}: launches {c}")
        log(f"{tag} rank {r}: forward "
            + collective_split({"seconds": x["forward_s"],
                                "collectives": x["forward_collectives"]})
            + "; backward and gradient sums "
            + collective_split({"seconds": x["backward_s"],
                                "collectives": x["backward_collectives"]})
            + f"; peak {x['forward_peak_gib']:.1f} GiB forward, "
            f"{x['peak_gib']:.1f} GiB in all; {smi}")
    d_logit, d_hidden = r0["forward_diff"]
    c_logit, c_hidden = r0["control_diff"]
    limit = RING_LOGIT_ATOL
    wide = r0["margins"] > 2 * limit
    agree = (int(r0["argmax_same"][wide].sum()), int(wide.sum()))
    log(f"{tag} cp_forward of Llama-3-8B bf16 ({layers} layers, full width) "
        f"over {s} tokens ({CP} x {block}) against the one process's "
        f"llama.forward ({r0['one_process_s']:.3f} s): logits within "
        f"{d_logit:.4e} (limit {limit}), hidden within {d_hidden:.4e} of "
        f"its largest (limit {RING_HIDDEN_RTOL}); the control (the merge "
        f"without its rescale): logits {c_logit:.4e}, hidden "
        f"{c_hidden:.4e}; argmax equal on "
        f"{int(r0['argmax_same'].sum())} of {s} rows, on {agree[0]} of "
        f"the {agree[1]} rows whose one-process top-two margin exceeds "
        f"{2 * limit}; one-process margins: median "
        f"{float(r0['margins'].median()):.4f}, max "
        f"{float(r0['margins'].max()):.4f}")
    if not (d_logit <= limit and d_hidden <= RING_HIDDEN_RTOL):
        failures.append(f"cp{CP} forward: logits {d_logit:.3e}, hidden "
                        f"{d_hidden:.3e}")
    if c_logit <= limit and c_hidden <= RING_HIDDEN_RTOL:
        failures.append(f"cp{CP} control within the limits")
    if agree[0] != agree[1]:
        failures.append(f"cp{CP}: argmax differs on {agree[1] - agree[0]} "
                        "wide-margin rows")
    loss, loss_one = r0["loss"]
    loss_rel = abs(loss - loss_one) / abs(loss_one)
    worst = max(r0["grad_rel"].items(), key=lambda kv: kv[1])
    none_worst = max(r0["sum_none_rel"].items(), key=lambda kv: kv[1])
    all_worst = max(r0["sum_all_rel"].items(), key=lambda kv: kv[1])
    log(f"{tag} backward ({RING_BWD_LAYERS} layers, {s} tokens): loss "
        f"{loss:.6f} vs {loss_one:.6f} one process (rel {loss_rel:.3e}, "
        f"limit {RING_LOSS_RTOL}); {len(r0['grad_rel'])} leaves, worst "
        f"||g - g_one|| / ||g_one|| {worst[1]:.3e} ({worst[0]}; limit "
        f"{RING_GRAD_RTOL}), median "
        f"{statistics.median(r0['grad_rel'].values()):.3e}; controls: "
        f"nothing summed {none_worst[1]:.3e} ({none_worst[0]}), every leaf "
        f"summed {all_worst[1]:.3e} ({all_worst[0]}); the one process's "
        f"step {r0['backward_one_process_s']:.3f} s")
    if not (loss_rel <= RING_LOSS_RTOL and worst[1] <= RING_GRAD_RTOL):
        failures.append(f"cp{CP} backward: loss {loss_rel:.3e}, leaf "
                        f"{worst[0]} {worst[1]:.3e}")
    for name, w in (("nothing summed", none_worst),
                    ("every leaf summed", all_worst)):
        if w[1] <= RING_GRAD_RTOL:
            failures.append(f"cp{CP} control ({name}) within "
                            f"{RING_GRAD_RTOL}")
    log(f"{tag} phase 31: kernel checks {t_checks:.1f} s, the ranks "
        f"{t_ranks:.1f} s (two processes sharing the card: no multi-GPU "
        f"speed; this process held {held:.2f} GiB while they ran)")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"tokens": s, "block": block, "layers": layers,
            "backward_layers": RING_BWD_LAYERS,
            "logit_diff": d_logit, "hidden_rel_diff": d_hidden,
            "control_logit_diff": c_logit,
            "control_hidden_rel_diff": c_hidden,
            "argmax_wide_margin": agree, "loss": r0["loss"],
            "grad_rel_worst": worst, "sum_none_worst": none_worst,
            "sum_all_worst": all_worst,
            "launches_by_rank": [{"forward": x["forward_launches"],
                                  "backward": x["backward_launches"]}
                                 for x in ranks],
            "rank_seconds": [{"forward": x["forward_s"],
                              "backward": x["backward_s"]} for x in ranks],
            "rank_collectives": [{"forward": x["forward_collectives"],
                                  "backward": x["backward_collectives"]}
                                 for x in ranks],
            "rank_peak_gib": [x["peak_gib"] for x in ranks],
            "one_process_s": r0["one_process_s"],
            "kernel_checks_s": t_checks, "ranks_s": t_ranks}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_new_tokens", type=int, default=32)
    ap.add_argument("--parallel_only", action="store_true",
                    help="the build and phases 27 / 29 / 30 only, no "
                         "result lines (for iterating on them)")
    ap.add_argument("--ring_only", action="store_true",
                    help="the build and phase 31 only, no result lines")
    args = ap.parse_args(argv)

    smi = phase_environment()
    from video_llava_seg_torch import kernels
    from video_llava_seg_torch.config import VideoLlavaConfig
    from video_llava_seg_torch.inference import main as serve
    from video_llava_seg_torch.mm_utils import tokenizer_image_token
    from video_llava_seg_torch.models import llava

    cfg = dataclasses.replace(VideoLlavaConfig(),
                              seg_token_idx=VideoLlavaConfig().llm.vocab_size
                              - 1)
    phase_build()

    tok = SmokeTokenizer(cfg.llm.vocab_size)
    ids = np.asarray(tokenizer_image_token(
        serve.build_prompt(cfg, serve.CAPTION_PROMPT, "llava_llama_3"),
        tok))[None]
    tokens_per_image = llava.visual_tokens_per_sample(cfg)
    prefill_len = int(llava.build_splice_plan(
        ids, tokens_per_image).seq_lens[0])
    bids, blens = serve.batch_prompt_ids(
        cfg, tok, [serve.CAPTION_PROMPT, REFERRAL], "llava_llama_3")
    plan = llava.build_splice_plan(bids, tokens_per_image, pad_side="left",
                                   input_lens=blens)
    batch_len = plan.gather_idx.shape[1]
    pad = int(batch_len - plan.seq_lens.min())
    log(f"[check] caption prompt splices to {prefill_len} tokens; the "
        f"caption + referral batch to 2 x {batch_len}, the shorter row "
        f"left-padded by {pad}")
    dev = torch.device("cuda")
    if args.ring_only:
        ring = phase_ring(cfg, prefill_len, args.seed, dev, smi, {})
        log(json.dumps({"ring": ring}, default=str))
        return 0
    if args.parallel_only:
        _, parallel, tp_train_in = phase_parallel(cfg, prefill_len,
                                                  args.seed, dev, smi, {})
        _, parallel["tp_train"] = phase_tp_train(
            cfg, train_seq_len(cfg), args.seed, dev, smi, {}, tp_train_in)
        log(json.dumps({"parallel": parallel}, default=str))
        return 0
    results = phase_kernel_checks(cfg, prefill_len, batch_len, pad,
                                  args.seed, dev)
    phase_w4a8_checks(cfg, 2 * batch_len, args.seed, dev, results)
    k5_device = phase_w4a8_decode_device(cfg, args.seed, dev, results)
    k7_rows = phase_k7_checks(cfg, args.seed, dev, results)
    gemm_rows = phase_k8_checks(cfg, args.seed, dev, results)
    link_rows = phase_attention_links(cfg, args.seed, dev, results)
    dense_rows = phase_dense_checks(cfg, args.seed, dev, results)
    row_stream_rows = phase_link_checks(cfg, args.seed, dev, results)
    bf16_counts, _ = phase_slice(cfg, args.seed, args.max_new_tokens, dev)
    quant_counts, quant = phase_quant_slice(cfg, args.seed,
                                            args.max_new_tokens, dev)
    radio_counts, radio = phase_slice(radio_cfg(cfg), args.seed,
                                      args.max_new_tokens, dev, tag="radio")
    w8a8_counts, w8a8 = phase_w8a8_encode(cfg, args.seed, dev)
    hiera_counts, hiera_op = phase_hiera_per_op(cfg, args.seed, dev)
    phase_small_agreement(args.seed)
    phase_small_agreement_quant(args.seed)
    tiny_vision = phase_tiny_vision_agreement(args.seed)
    predictor, sam2_counts, sam2_image = phase_sam2_image(args.seed, dev,
                                                          smi)
    amg_counts, amg = phase_amg(predictor, args.seed, dev, smi)
    del predictor
    sam2_tiny = phase_tiny_sam2_agreement(args.seed, dev)
    video_counts, video = {}, {}
    for variant in SAM2_VIDEO_VARIANTS:
        video_counts[variant], video[variant] = phase_sam2_video(
            variant, args.seed, dev, smi)
    k7_video_rows, base_plus_counts = phase_video_kernel_checks(
        args.seed, dev, results)
    video_tiny = phase_tiny_sam2_video_agreement(args.seed, dev)

    seq_len = train_seq_len(cfg)
    log(f"[flash] the synthetic train batch splices to {seq_len} tokens")
    phase_flash_bwd_checks(cfg, seq_len, args.seed, dev, results)
    phase_grad_checks(args.seed, dev)
    train_counts, train, qlora_params = phase_train_slice(cfg, args.seed,
                                                          dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as work:
        t0 = time.perf_counter()
        data_counts, data = phase_train_data(cfg, qlora_params, args.seed,
                                             dev, smi, work)
        data["cli"] = phase_train_data_cli(args.seed, dev, smi, work,
                                           data.pop("root"))
        data.pop("tokenizer_dir")
        data["seconds"] = time.perf_counter() - t0
        train["vicas_data_path"] = data
    log(f"[train-data] phase 26: {data['seconds']:.1f} s")
    t0 = time.perf_counter()
    phase_fsdp_one_rank(args.seed, dev, qlora_params, data.pop("fsdp_ref"))
    log(f"[fsdp one rank] phase 28: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        os.makedirs(os.path.join(work, "train"))
        train["agreement"], cli_params = phase_train_agreement(
            args.seed, os.path.join(work, "train"))
        t0 = time.perf_counter()
        beam_bf16_counts, beam_w4a8_counts, beams, quant_tree = phase_beams(
            cfg, args.seed, args.max_new_tokens, dev, smi)
        t1 = time.perf_counter()
        sampling_counts, sampling = phase_sampling(
            cfg, quant_tree, args.seed, args.max_new_tokens, dev, smi)
        del quant_tree
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        qlora_counts, served = phase_train_serve_score(
            cfg, work, cli_params, qlora_params, args.seed,
            args.max_new_tokens, dev, smi)
        t3 = time.perf_counter()
    del qlora_params
    log(f"[serving] phases 21 / 22 / 23: {t1 - t0:.1f} / {t2 - t1:.1f} / "
        f"{t3 - t2:.1f} s")
    family_counts, families = {}, {}
    for phase, name in ((24, "mistral"), (25, "mpt")):
        t0 = time.perf_counter()
        family_counts[name], families[name] = phase_family(
            name, cfg, args.seed, args.max_new_tokens, dev, smi, results)
        families[name]["seconds"] = time.perf_counter() - t0
        log(f"[family {name}] phase {phase}: "
            f"{families[name]['seconds']:.1f} s")
    families["tiny_agreement"] = phase_tiny_family_agreement(args.seed)
    t0 = time.perf_counter()
    tp_counts, parallel, tp_train_in = phase_parallel(
        cfg, prefill_len, args.seed, dev, smi, results)
    parallel["seconds"] = time.perf_counter() - t0
    log(f"[parallel] phases 27 / 29 (and phase 30's rank runs): "
        f"{parallel['seconds']:.1f} s")
    t0 = time.perf_counter()
    tp_train_counts, parallel["tp_train"] = phase_tp_train(
        cfg, seq_len, args.seed, dev, smi, results, tp_train_in)
    del tp_train_in
    parallel["tp_train"]["seconds"] = time.perf_counter() - t0
    log(f"[tp{TP} train] phase 30's kernel checks and verdicts: "
        f"{parallel['tp_train']['seconds']:.1f} s")
    t0 = time.perf_counter()
    ring = phase_ring(cfg, prefill_len, args.seed, dev, smi, results)
    ring["seconds"] = time.perf_counter() - t0
    log(f"[cp{CP}] phase 31: {ring['seconds']:.1f} s")

    kernels_out = []
    main_paths = {"K5": quant_counts, "K7": hiera_counts,
                  "K8": w8a8_counts["clip"]}
    for name in kernels.LaunchCounts.NAMES:
        r = results[name]
        source, csrc = SOURCES[name]
        by = r["bound_by_ms"]
        main_path = main_paths.get(name, train_counts)
        kernels_out.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [f"video_llava_seg_torch/csrc/{c}" for c in csrc],
            "replaces": REPLACES[name], "launches": main_path[name],
            "launches_by_path": {"bf16": bf16_counts[name],
                                 "w4a8_batched": quant_counts[name],
                                 "train_step": train_counts[name],
                                 "radio_bf16": radio_counts[name],
                                 "w8a8_encode_clip":
                                     w8a8_counts["clip"][name],
                                 "w8a8_encode_radio":
                                     w8a8_counts["radio"][name],
                                 "hiera_per_op": hiera_counts[name],
                                 "sam2_set_image":
                                     sam2_counts["set_image"][name],
                                 "sam2_predict":
                                     sam2_counts["predict"][name],
                                 "amg_defaults":
                                     amg_counts["defaults"][name],
                                 **{f"sam2_video_{v}":
                                    video_counts[v]["propagate"][name]
                                    for v in SAM2_VIDEO_VARIANTS},
                                 "train_step_vicas": data_counts[name],
                                 "beams_bf16": beam_bf16_counts[name],
                                 "beams_w4a8": beam_w4a8_counts[name],
                                 "sampling_w4a8_batched":
                                     sampling_counts[name],
                                 "qlora_tree_serving": qlora_counts[name]},
            "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
            "bound": BOUNDS[name] if BOUNDS[name] is not None else "exact",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if by["bytes"] >= by["operations"]
                         else "operations"),
            "library_ms": r["library_ms"], "shapes": r["shapes"]})
        prev = [sh["previous_ms"] for sh in r["shapes"] if "previous_ms" in sh]
        if prev:
            kernels_out[-1]["previous_ms"] = sum(prev)
        if name == "K5":
            kernels_out[-1]["launches_by_entry"] = {
                e: quant_counts[e] for e in kernels.W4A8_ROUTES}
            kernels_out[-1]["launches_by_path"].update({
                f"{p}_by_entry": {e: c[e] for e in kernels.W4A8_ROUTES}
                for p, c in (("beams_w4a8", beam_w4a8_counts),
                             ("sampling_w4a8_batched", sampling_counts))})
            kernels_out[-1]["decode_device"] = k5_device
    # gemm_s8 (K8's int8 dense and int_matmul), counted by route on the
    # W8A8 encodes, the only paths with kernel_qa denses
    r = results["gemm_s8"]
    source, csrc = SOURCES["gemm_s8"]
    kernels_out.append({
        "name": "gemm_s8", "route": "cuda", "source": source,
        "csrc": [f"video_llava_seg_torch/csrc/{c}" for c in csrc],
        "replaces": REPLACES["gemm_s8"],
        "launches": w8a8_counts["clip_gemm_s8"]["vls_gemm_s8_sm90"],
        "launches_by_path": {"w8a8_encode_clip": w8a8_counts["clip_gemm_s8"],
                             "w8a8_encode_radio":
                                 w8a8_counts["radio_gemm_s8"]},
        "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
        "bound": "exact", "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": ("bytes" if r["bound_by_ms"]["bytes"]
                     >= r["bound_by_ms"]["operations"] else "operations"),
        "library_ms": r["library_ms"],
        "previous_ms": sum(sh["previous_ms"] for sh in r["shapes"]),
        "shapes": r["shapes"]})
    # K8's row quantizers, counted by C entry on the W8A8 encodes; times
    # summed over the main-path shapes (w8a8_row_cases)
    r = results["quant_rows"]
    source, csrc = SOURCES["quant_rows"]
    kernels_out.append({
        "name": "quant_rows", "route": "cuda", "source": source,
        "csrc": [f"video_llava_seg_torch/csrc/{c}" for c in csrc],
        "replaces": REPLACES["quant_rows"],
        "launches": w8a8_counts["clip_quant_rows"][QUANT_ROWS_SM90_ENTRY],
        "launches_by_path": {
            "w8a8_encode_clip": w8a8_counts["clip_quant_rows"],
            "w8a8_encode_radio": w8a8_counts["radio_quant_rows"]},
        "max_abs_err": r["max_abs_err"],
        "bound": ("quant_rows exact; ln_quant_rows within "
                  f"{QUANT_ROWS_LN_STEPS} int8 step, under "
                  f"{QUANT_ROWS_LN_FRACTION} of the elements differing, "
                  f"scales within rtol {QUANT_ROWS_LN_SCALE_RTOL}"),
        "frac_differing": r["frac_differing"],
        "scale_rel_err": r["scale_rel_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "previous_ms": r["previous_ms"], "device_ms": r["device_ms"],
        "previous_device_ms": r["previous_device_ms"],
        "instruction_bound_ms": r["instruction_bound_ms"],
        "shapes": r["shapes"]})
    # gemm_bf16 (the denses of K1 and K4), counted by C entry on every path
    r = results["gemm_bf16"]
    source, csrc = SOURCES["gemm_bf16"]
    paths = {"bf16": bf16_counts, "w4a8_batched": quant_counts,
             "train_step": train_counts, "train_step_vicas": data_counts,
             "radio_bf16": radio_counts,
             "w8a8_encode_clip": w8a8_counts["clip"],
             "w8a8_encode_radio": w8a8_counts["radio"],
             "hiera_per_op": hiera_counts,
             "sam2_set_image": sam2_counts["set_image"]}
    kernels_out.append({
        "name": "gemm_bf16", "route": "cuda", "source": source,
        "csrc": [f"video_llava_seg_torch/csrc/{c}" for c in csrc],
        "replaces": REPLACES["gemm_bf16"],
        "launches": bf16_counts[GEMM_SM90_ENTRY],
        "launches_by_path": {
            p: {e: c[e] for e in kernels.GEMM_BF16_ROUTES}
            for p, c in paths.items()},
        "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
        "bound": BOUNDS["gemm_bf16"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": ("bytes" if r["bound_by_ms"]["bytes"]
                     >= r["bound_by_ms"]["operations"] else "operations"),
        "library_ms": r["library_ms"],
        "previous_ms": sum(sh["previous_ms"] for sh in r["shapes"]),
        "shapes": r["shapes"]})
    # the row streams (K1's / K4's LayerNorms, K4's shortcut pool), counted
    # by C entry on every path; times summed over the main-path shapes
    for name, routes, entry in (
            ("layernorm", kernels.LAYERNORM_ROUTES, LAYERNORM_SM90_ENTRY),
            ("maxpool2x2", kernels.MAXPOOL_ROUTES, MAXPOOL_SM90_ENTRY)):
        r = results[name]
        source, csrc = SOURCES[name]
        kernels_out.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [f"video_llava_seg_torch/csrc/{c}" for c in csrc],
            "replaces": REPLACES[name], "launches": bf16_counts[entry],
            "launches_by_path": {
                p: {e: c[e] for e in routes} for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
            "bound": ("one bf16 step an element (ln_bound)"
                      if BOUNDS[name] is not None else "exact"),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": r["library_ms"],
            "previous_ms": sum(sh["previous_ms"] for sh in r["shapes"]),
            "device_ms": sum(sh["device_ms"] for sh in r["shapes"]),
            "shapes": r["shapes"]})
    # K2 at head dim 256 (memory attention) and K4 at Hiera-L (head dim
    # 72), counted on the video slice's propagation
    for name, base in (("K2_hd256", "K2"), ("K4_hiera_large", "K4")):
        r = results[name]
        source, csrc = SOURCES[base]
        by = r["bound_by_ms"]
        dev_ms = [sh["device_ms"] for sh in r["shapes"] if "device_ms" in sh]
        kernels_out.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [f"video_llava_seg_torch/csrc/{c}" for c in csrc],
            "replaces": REPLACES[base],
            "launches": video_counts["large"]["propagate"][base],
            "launches_by_path": {
                f"sam2_video_{v}": video_counts[v]["propagate"][base]
                for v in SAM2_VIDEO_VARIANTS},
            "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
            "bound": BOUNDS[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if by["bytes"] >= by["operations"]
                         else "operations"),
            "library_ms": r["library_ms"], "shapes": r["shapes"],
            **({"device_ms": sum(dev_ms)} if dev_ms else {})})
    # K7 at Hiera-L's head dim 72 (counted on the video slice's
    # propagation) and Hiera-B+'s 56 (on its image predictor's set_image)
    for variant, path, counts in (
            ("large", "sam2_video_large", video_counts["large"]["propagate"]),
            ("base_plus", "sam2_set_image_base_plus", base_plus_counts)):
        name = f"K7_hiera_{variant}"
        r = results[name]
        source, csrc = SOURCES["K7"]
        by = r["bound_by_ms"]
        kernels_out.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [f"video_llava_seg_torch/csrc/{c}" for c in csrc],
            "replaces": REPLACES["K7"], "launches": counts[WINDOW_SM90_ENTRY],
            "launches_by_path": {path: {e: counts[e]
                                        for e in kernels.WINDOW_ROUTES}},
            "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
            "bound": BOUNDS[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if by["bytes"] >= by["operations"]
                         else "operations"),
            "library_ms": r["library_ms"],
            "previous_ms": sum(sh["previous_ms"] for sh in r["shapes"]),
            "device_ms": sum(sh["device_ms"] for sh in r["shapes"]),
            "shapes": r["shapes"], "kinds": k7_video_rows[variant]})
    # K2's family forms, counted on each family's W4A8 batched call (one
    # batch-2 prefill: 32 launches, all on attention_sm90.cu)
    for name, fam in (("K2_window", "mistral"), ("K2_alibi", "mpt")):
        r = results[name]
        source, csrc = SOURCES["K2"]
        by = r["bound_by_ms"]
        c, bc = family_counts[fam], families[fam]["bf16_launches"]
        kernels_out.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [f"video_llava_seg_torch/csrc/{x}" for x in csrc],
            "replaces": REPLACES["K2"], "launches": c["K2"],
            "launches_by_path": {
                f"{fam}_w4a8_batched": c["K2"], f"{fam}_bf16_caption":
                    bc["K2"]},
            "launches_by_entry": {
                f"{fam}_w4a8_batched": {"attention_sm90.cu": c["sm90 entry"],
                                        "attention.cu":
                                            c["attention.cu entry"]},
                f"{fam}_bf16_caption": {"attention_sm90.cu":
                                            bc["sm90 entry"],
                                        "attention.cu":
                                            bc["attention.cu entry"]}},
            "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
            "bound": BOUNDS[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if by["bytes"] >= by["operations"]
                         else "operations"),
            "library_ms": r["library_ms"],
            "previous_ms": sum(sh["previous_ms"] for sh in r["shapes"]),
            "device_ms": sum(sh["device_ms"] for sh in r["shapes"]),
            "shapes": r["shapes"]})
    # K2 and K5 at the shard shapes of tensor-parallel serving, counted on
    # rank 0 of the W4A8 Llama run (each rank launches alike)
    for name, base in (("K2_tp2", "K2"), ("K5_tp2", "K5")):
        r = results[name]
        source, csrc = SOURCES[base]
        by = r["bound_by_ms"]
        kernels_out.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [f"video_llava_seg_torch/csrc/{x}" for x in csrc],
            "replaces": REPLACES[base], "launches": tp_counts[base],
            "launches_by_path": {
                f"tp{TP}_{run}_rank{rank}": c[base]
                for run, v in parallel["tp"].items()
                for rank, c in enumerate(v["launches_by_rank"])},
            "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
            "bound": BOUNDS[name] if BOUNDS[name] is not None else "exact",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if by["bytes"] >= by["operations"]
                         else "operations"),
            "library_ms": r["library_ms"], "shapes": r["shapes"]})
    # K2 with the logsumexp and K6a / K6b at the shard of tensor-parallel
    # training, counted on rank 0 over the trainer loop's steps of phase 30
    # (each rank launches alike)
    for name, base in (("K2_tp2_lse", "K2"), ("K6a_tp2", "K6a"),
                       ("K6b_tp2", "K6b")):
        r = results[name]
        source, csrc = SOURCES[base]
        by = r["bound_by_ms"]
        kernels_out.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [f"video_llava_seg_torch/csrc/{x}" for x in csrc],
            "replaces": REPLACES[base], "launches": tp_train_counts[base],
            "launches_by_path": {
                f"tp{TP}_train_rank{rank}": c[base] for rank, c in
                enumerate(parallel["tp_train"]["launches_by_rank"])},
            "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
            "bound": BOUNDS[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if by["bytes"] >= by["operations"]
                         else "operations"),
            "library_ms": r["library_ms"], "shapes": r["shapes"]})
    # the ring's K2 / K6 forms at a rank's block, counted on rank 1 of
    # phase 31 (the rank that runs the non-causal form: its 32-layer
    # forward, its 4-layer backward)
    for name, base, run in (("K2_cp2", "K2", "forward"),
                            ("K6a_cp2", "K6a", "backward"),
                            ("K6b_cp2", "K6b", "backward")):
        r = results[name]
        source, csrc = SOURCES[base]
        by = r["bound_by_ms"]
        kernels_out.append({
            "name": name, "route": "cuda", "source": source,
            "csrc": [f"video_llava_seg_torch/csrc/{x}" for x in csrc],
            "replaces": REPLACES[base],
            "launches": ring["launches_by_rank"][CP - 1][run][base],
            "launches_by_path": {
                f"cp{CP}_{w}_rank{rank}": c[w][base]
                for rank, c in enumerate(ring["launches_by_rank"])
                for w in ("forward", "backward")},
            "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
            "bound": BOUNDS[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if by["bytes"] >= by["operations"]
                         else "operations"),
            "library_ms": r["library_ms"], "shapes": r["shapes"]})
    for v in parallel["tp"].values():
        v["launches_by_rank"] = [{k: c[k] for k in ("K1", "K2", "K3", "K4",
                                                    "K5", "sm90 entry",
                                                    "attention.cu entry",
                                                    "vls_w4a8_sm90",
                                                    kernels.W4A8_GEMV_ENTRY,
                                                    "vls_w4a8")}
                                 for c in v["launches_by_rank"]]
    log(json.dumps({"parallel": parallel}))
    log(json.dumps({"ring": ring}))
    for fam in FAMILY_TEMPLATES:
        del families[fam]["bf16_launches"]
    log(json.dumps({"llm_families": families}))
    log(json.dumps({"w4a8_batched_slice": quant}))
    log(json.dumps({"vision_slice": {
        "radio_bf16_serving": radio, "w8a8_encode": w8a8,
        "hiera_per_op": hiera_op, "tiny_agreement": tiny_vision,
        "k7_vs_k4_attention_stage": k7_rows, "gemm_s8": gemm_rows,
        "attention_links": link_rows, "gemm_bf16": dense_rows,
        "row_streams": row_stream_rows}}))
    log(json.dumps({"sam2_image_slice": {
        "predictor": sam2_image, "amg": amg, "tiny_agreement": sam2_tiny}}))
    log(json.dumps({"sam2_video_slice": {**video,
                                         "tiny_agreement": video_tiny}}))
    log(json.dumps({"train_slice": train}))
    log(json.dumps({"serving_surface": {"beams": beams,
                                        "sampling": sampling,
                                        "train_serve_score": served}}))
    log(json.dumps({"kernels": kernels_out}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
