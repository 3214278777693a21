#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure (none is caught, so any failure exits
non-zero and prints no result):

  1. device: needs torch.cuda; prints torch/CUDA versions and the card's
     name and power limit from nvidia-smi;
  2. build: compiles internvideo_tpu_torch/csrc/*.cu with nvcc; prints
     the ptxas report and, on a line of its own for each, the registers
     and spill bytes of each instantiation of K5's wgmma forward, dq and
     dk/dv kernels, of K4a's (the same dq / dk/dv bodies at d 64, 88), of
     K1's and K2's (the forward body at d 64, 88 / 64, 72, 88, 128), of
     K4b's (the dq / dk/dv bodies at d 64, 72, 88, 128), of K7's wgmma
     s8 GEMM (f32 and bf16 output), of K3's (the forward body with the
     QK-RMSNorm in shared memory at d 64, 72, 88, 128), of K6's bf16
     tensor-core decode (at (R, P) = (896, 128), (512, 64)) and of K11's
     (the walk with only Q normed at d 64, 88, and its normed-k pre-pass);
     fails on a spill in K4b's, K7's, K3's, K6's or K11's;
  3. the flash kernel vs its plain PyTorch version on the card, at the JAX
     kernel tests' shapes (fp32, max-abs 2e-5), at the encoder's
     (2, 4097, 16, 88) bf16 with q/k/v as views of one (B, S, 3*1408)
     tensor (out rel-L2 <= 1e-2, LSE max-abs <= 1e-2), and in bf16 at the
     edges of the wgmma kernel's 128-row query tile and 64-key stages (Sq
     1, 127, 129 against Sk 65, 129, 193; d 64 and 88; the same bars);
  4. the main path: `internvideo_tpu_torch.cli.eval` on
     configs/torch/eval_classification_1b.py (InternVideo2-1B, 16 x 224 px,
     bf16, B = 16); every kernel launch count is reset just before and
     read just after, and must be 40 per forward; logits must be finite;
  5. the same seeded 1B model at B = 2 with every LayerScale gamma at 0.1,
     kernel route vs plain route (pooled and logits rel-L2 <= 1e-2), and
     the kernel vs plain on the real q/k/v of blocks 0 and 39;
  6. at the main path's (16, 4097, 16, 88) bf16: the kernel vs plain
     (rel-L2 <= 1e-2) and both times with CUDA events; the 1B forward at
     B = 16 through both routes (clips/s);
  7. the backward kernels (dq, dk/dv) vs their plain version on the card:
     fp32 at the JAX kernel tests' shapes (max-abs <= 5e-4, the JAX grad
     bar), bf16 at the finetune's (32, 2049, 16, 88) with q/k/v as views of
     one (B, S, 3*1408) tensor (rel-L2 <= 1e-2 each), and with a nonzero
     LSE cotangent;
  8. the training main path: `internvideo_tpu_torch.cli.train` on
     configs/torch/finetune_k400_1b.py (InternVideo2-1B, 8 x 224 px, B = 32,
     bf16 + fp32 params, remat, drop-path, mixup/cutmix) for 3 steps; the
     launch counts are reset just before and read just after and must be
     80 flash_fwd (forward + remat recompute), 40 dq and 40 dk/dv per step;
     every logged loss and grad_norm must be finite;
  9. kernel route vs plain route in training: fp32 at 1B widths and depth
     2 (loss and every parameter's grad max-abs <= 5e-4), and bf16 at the
     full depth with B = 2 (loss rel <= 1e-2; rel-L2 <= 2e-2 on the grads of
     blocks.{0,39}.attn.qkv.weight and .q_norm.weight);
 10. times with CUDA events: the train step at B = 32 on a device-resident
     batch (ms, clips/s), dq and dk/dv at (32, 2049, 16, 88) bf16 beside the
     plain backward, and as yardsticks only (never on the port's path)
     PyTorch's flash SDPA forward, backward and forward + backward at the
     finetune's and the eval's shapes; one more train step under
     torch.profiler gives device time by kernel group and the idle share;
 11. the pretrain kernels vs their plain versions on the card: small-S
     attention (K2 forward, K4b dq and dk/dv) and the fused qkv op (K3: its
     row-statistics pre-pass and attention kernel; backward through K2 /
     K4b) in fp32 at small shapes of every instantiated head dim (max-abs
     2e-5 forward, 5e-4 grads), and in bf16 at the path's shapes on views of
     one (B, S, 3W) tensor: (32, 833, 16, 88) for K2 / K4b / K3 and the CLIP
     teacher's (512, 257, 25, 128) for K3 (rel-L2 <= 1e-2); K2 in bf16 at
     the wgmma kernel's tile edges (phase 3's, and S = 196) at every
     instantiated head dim (out rel-L2 <= 1e-2, LSE max-abs <= 1e-2); K4b
     in bf16 at its tiles' edges (Sq and Sk each 1, 63, 65, 127, 129, 833;
     every instantiated head dim; q, k, v views of projections; dq / dk /
     dv rel-L2 <= 1e-2 each); K3 in bf16 at its tiles' edges (S 1, 63, 64,
     65, 127, 128, 129, 257, 833, 1024 at every instantiated head dim, the
     projection a padded view 16 bytes past a 128-byte boundary; rel-L2 <=
     1e-2, two calls bit-identical);
 12. the pretrain main path: `internvideo_tpu_torch.cli.train` on
     configs/torch/pretrain_1b_umt.py (1B student at 16 x 224, S = 833,
     CLIP-6B and MAE-g14 teachers, B = 32) for 3 steps; the launch counts are
     reset just before and read just after and must be, per step, 128
     fused_qkv_fwd and 128 fused_qkv_rstd (40 student forward + 40 remat
     recompute at S = 833 + 48 CLIP teacher at S = 257, counted by S
     too), 40 small_s_fwd / small_s_bwd_dq /
     small_s_bwd_dkv (K3's backward), 40 flash_fwd (MAE teacher) and no K4a;
     every logged loss, loss term and grad_norm must be finite;
 13. kernel route vs plain route in pretraining at full widths, B = 2, with
     the same keep indices on both: the CLIP teacher's z, pooled and
     attention and the MAE teacher's z (rel-L2 <= 2e-2: 48 bf16 blocks
     deep), the loss (rel <= 1e-2) and
     the grads of encoder.blocks.{0,39}.attn.{qkv,q_norm}.weight and
     clip_decoder.0.head.weight (rel-L2 <= 2e-2);
 14. times with CUDA events: the pretrain step at B = 32 on a device-resident
     batch (ms, clips/s) split into CLIP teacher, MAE teacher and the
     student's forward + backward + update; each new kernel at its path
     shape beside its plain version, its bound and the SDPA yardstick (K3
     at the student's and the teacher's shapes, split into pre-pass and
     attention), and
     K1 at the MAE teacher's (32, 4096, 16, 88); one more step under
     torch.profiler;
 15. the causal / narrow-v flash kernel (K5) vs its plain version on the
     card: fp32 at the JAX kernel tests' causal shapes (ragged S = 200, the
     72 / 200 / 128 query offset, d_v 32 < d_qk 64; max-abs 2e-5) and bf16
     at the prefill's (8, 2048, 32, 256 / 128) and the 2B preset's
     (8, 2048, 20, 192 / 128) with k / v as strided views of one tensor
     (out rel-L2 <= 1e-2); then at both pairs in bf16 the edges of the
     wgmma kernel's 128-row query tile and 64-key tiles (Sq 1, 127,
     129, 1056; Sk < Sq; query offsets 203, 299, 1000; a window edge and
     segment boundaries inside a key tile, a key tile of pads; groups of 4
     and 8), q at a base 16 bytes off a 128-byte boundary (out rel-L2 <=
     1e-2, finite LSE within 1e-2, the same rows -inf);
 16. the paged decode kernel (K6) vs its plain version: fp32 with ragged
     lengths and unused block-table columns on a page of NaN (max-abs
     1e-4), bf16 at the 8B decode shape (B 8, H 32, R 896, P 128, page 64,
     seq 2048-2112; rel-L2 <= 1e-2); the bf16 kernel at its edges: B 1 and
     8, (H, R, P) of both serving paths, lengths 0, 1, 63, 64, 65, either
     side of one and two split lengths and 32,768, NaN trash pages (rel-L2
     <= 1e-2, 0 without tokens, two calls bit-identical);
 17. the serving main path: `internvideo_tpu_torch.cli.generate --preset
     qwen3_8b_mla --paged` on a 512-token prompt for 32 tokens, then a
     ServingEngine on the same seeded 8B model (8 slots, page 64, 272
     pages, buckets 512 / 2048, max_len 2112) serving 12 requests of
     100-2048 prompt tokens and 32-64 new tokens, with decode_horizon 1 and
     8; the launch counts are reset before each run and read after and must
     be 36 K5 per prefill call, 36 K6 per decode step and nothing else;
     every token in the vocabulary, every request at its budget;
 18. kernel route vs plain route on the 8B model, 36 layers, B = 2,
     512-token prompts, prefill and 4 paged decode steps (same fed
     tokens): in bf16 the attention of layers 0, 18 and 35 on its real
     inputs (rel-L2 <= 1e-2) and the logits against the same weights run
     in fp32 (the kernel route no farther than the plain route, x 1.25; the
     two bf16 routes are ~5.6e-2 apart, as far as each is from fp32); in
     fp32 the two routes' logits (rel-L2 <= 1e-4); fp32 at the 8B widths
     and depth 2: greedy tokens identical across dense generate, paged
     generate (K6) and the ServingEngine;
 19. times with CUDA events: prefill at B = 8, prompt 2048 and steady paged
     decode at B = 8, seq 2048 (tokens/s) on qwen3_8b_mla and qwen3_2b_mla;
     K5 and K6 at their path shapes beside the plain version, the bound
     and (K5) the SDPA yardstick (K6 at the 8B and the 2B video decode's
     shapes, by CUDA graph replay: the wrapper's host work hides it under
     CUDA events); one prefill and one decode step under torch.profiler;
 20. the SFT kernels vs their plain versions on the card: K5's backward
     (dq, dk/dv), K8 (segment ids in K5's forward and backward) and K2 /
     K4b at head dim 72, in fp32 at the JAX kernel tests' shapes (segments
     in halves, packed runs, pads of -1 that meet each other, the 72 / 200
     / 128 query offset, d_v 32 < d_qk 64; max-abs 2e-5 forward, 5e-4
     grads) and in bf16 at the path's shapes (rel-L2 <= 1e-2): K5 + K8 at
     (1, 8192, 32, 256 / 128) with the SFT stream's segments and k / v as
     strided views, K5 alone there, K2 / K4b at (8, 196, 16, 72) on qkv
     views;
 21. the SFT main path: `internvideo_tpu_torch.cli.train` on
     configs/torch/sft_internvideo3_8b.py (InternVideo3-8B widths, text
     depth 32, pack 8192, B = 1, bf16, remat) for 3 steps; the launch counts
     are reset just before and read just after and must be, per step,
     2 x 32 segmented K5 forwards (forward + remat), 32 + 32 segmented K5
     dq / dk/dv and 27 each of K2 / K4b dq / K4b dk/dv, nothing else; every
     loss and grad_norm finite; the peak device memory;
 22. kernel route vs plain route in SFT at pack 2048: fp32 at full widths,
     text depth 2 (loss and every parameter's grad max-abs <= 5e-4); bf16 at
     the config's depth (loss rel <= 1e-2; the grads of
     layers.{0,31}.self_attn.{q_proj.weight,kv_b_proj_kernel} and
     vision_tower.blocks.0.qkv.weight printed as rel-L2 between the routes,
     and held as: the kernel route no farther (rel-L2) from the same weights
     run in fp32 than the plain route, x 1.25; the two bf16 routes sit
     3e-2-9e-2 apart, each as far from fp32, see PERF.md);
 23. times with CUDA events: each new kernel at its path shape beside its
     plain version, its bound (the visible pairs this row's segments give)
     and, as a yardstick only, SDPA with an explicit mask where a backend
     takes the shape; the SFT step at the config's depth on a
     device-resident batch (ms, tokens/s, peak memory), one step split into
     tower, LLM forward + backward, CE and update; one step under
     torch.profiler;
 22b. one bf16 AdamW step at configs/torch/sft_tiny.py's widths from the
     same params and grads on the card (torch's fused update) and through
     the port's CPU route (fused too): the update's rel-L2 between them and
     to the fp32 reference (the step on fp32 copies, rounded once) <= 1e-3;
 24. K5 with grouped-query heads and the sliding window vs its plain version
     on the card: fp32 at the JAX kernel tests' shapes (test_gqa 8 / 2
     heads, test_sliding_window causal and not, window 50, the rows with no
     key of test_window_fully_masked_rows_zero, a window with the query
     offset 72 and a ragged S = 200; max-abs 2e-5 on out and LSE) and bf16
     at the dense-GQA prefill's (8, 2048, 32 / 8, 128) causal, window none
     and 128, on k / v as strided views (rel-L2 <= 1e-2);
 24b. K2 and K5 at the HiCo video path's shapes vs their plain versions
     (bf16 rel-L2 <= 1e-2): the tower's (64, 196, 16, 72) on qkv views and
     the video prefill's (1, 1056, 20, 192 / 128) causal on k / v views;
     both timed there beside their plain versions, bounds and SDPA
     yardsticks;
 25. the dense-GQA main path: `internvideo_tpu_torch.cli.generate --preset
     qwen3_8b_dense` (36 layers, 32 / 8 heads of 128, bf16, seeded weights)
     on a 512-token prompt for 32 tokens, launches reset before and read
     after: 36 `flash_fwd_causal_gqa` and nothing else (decode attends on
     the plain route, as in JAX); `--paged` must raise the dense-GQA
     ValueError; then the Qwen3-VL-dense compose (internvideo3_8b with the
     qwen3_8b_dense text model): dense generate with one 16 x 224 clip and
     its 3-D mRoPE grid, 27 K2 + 36 GQA K5 and nothing else;
 26. the HiCo video serving main path on internvideo25_hico_2b at bench.py's
     shapes: 128 frames x 224 through the tower (27 K2 at (64, 196, 16, 72))
     and HiCo-R16 to 1024 visual tokens; a 1056-token paged video prefill
     (27 K2 + 24 K5 at (1, 1056, 20, 192 / 128)); paged decode at B = 8 (24
     K6 a step); a ServingEngine with 8 slots serving 4 video requests
     (`submit(..., video=)`) and 4 text requests, every request at its
     budget, every token in the vocabulary, 27 K2 per video prefill, 24 K5
     per prefill, 24 K6 per decode step and nothing else;
 27. kernel route vs plain route on both paths: bf16 at full depth, the
     attention of the first and last text layers and tower blocks on their
     real inputs (rel-L2 <= 1e-2), and the logits of a prefill + 4 decode
     steps held against the same weights run in fp32 (the kernel route no
     farther than the plain route, x 1.25; the fp32 routes within 1e-4);
     fp32 at full widths and depth 2: greedy tokens identical across the
     routes and, on the HiCo compose, between dense and paged video
     generate;
 28. times with CUDA events: bench.py's mllm_video128_vision_ms,
     mllm_video128_ttft_ms (paged, 1-D positions, B = 1) and
     mllm_video128_decode_tokens_per_sec (paged, B = 8); qwen3_8b_dense
     prefill at B = 8 x 2048 and a dense decode step at B = 8, seq 2048;
     one prefill and one decode step of each under torch.profiler; K5 GQA
     at (8, 2048, 32 / 8, 128), window none and 128, beside its plain
     version, its bound and the SDPA (enable_gqa) yardstick;
 29. K5's grouped-query / sliding-window backward (dq, dk/dv) vs its plain
     version: fp32 at the JAX kernel tests' shapes (test_sliding_window_
     unaligned_grads, test_gqa's 8 / 2 heads causal and not, a causal window
     with the query offset 72 and a ragged S = 200, GQA with segments and
     pads of -1, test_window_fully_masked_rows_zero's rows without keys,
     which must get dq = 0), each with and without an LSE cotangent (max-abs
     5e-4); bf16 at the RL update's (4, 1152, 32 / 8, 128) causal, window
     none and 128, k / v strided views of one projection (rel-L2 <= 1e-2);
     dk / dv bit-identical across two calls;
 30. the RL main path: `RLTrainer.fit` on qwen3_8b_dense at full width
     (hidden 4096, 32 / 8 heads of 128, SwiGLU 12288, vocab 151936, qk-norm,
     remat, bf16, seeded weights) and depth RL_DEPTH, the compiled rollout
     backend, 2 prompts x 8 = 16 rows of 1024 + 128 tokens at temperature
     1.0, a rule-based reward (the share of response tokens in a fixed id
     set), kl_beta 0.01 (the frozen reference runs), grad_accum 4, 2
     iterations; launches reset before and read after: per iteration 14 x
     depth `flash_fwd_causal_gqa` (prefill, logp_old, and per microbatch
     policy + reference + remat recompute), 4 x depth each of
     `flash_bwd_causal_{dq,dkv}_gqa`, nothing else (decode attends on the
     plain route, as in JAX); losses, kl and rewards finite; the first
     update's ratio_mean within 1e-2 of 1; the peak memory. Then the engine
     backend: one iteration on qwen3_8b_mla (full width, depth 4) with a
     ServingEngine (8 slots, temperature 1.0) serving 16 requests of 256 +
     32 tokens: per prefill call 4 K5, per decode step 4 K6, 4 K5 for
     logp_old, 3 x 4 K5 + 4 dq + 4 dk/dv per microbatch, nothing GQA;
 31. kernel route vs plain route on one policy update from phase 30's
     first rollout batch (4 rows x 1152, the advantages set to +-1, +-0.5:
     the seeded rewards are nearly all 0): fp32 at full width, depth 2, with
     the KL reference (loss and every parameter's grad max-abs <= 5e-4);
     bf16 at depth RL_DEPTH without the reference (the policy's token
     log-probs and the grads of the first and last layers' attention
     projections no farther, rel-L2, from the same weights run in fp32 than
     the plain route's, x 1.25; the losses printed);
 32. times with CUDA events: dq and dk/dv at (4, 1152, 32 / 8, 128), window
     none and 128, beside the plain backward, the bound (visible pairs x d x
     6 / 8 FLOPs or the bytes) and the SDPA enable_gqa backward yardstick;
     one RL iteration at depth RL_DEPTH after a warm-up, split into rollout
     prefill, decode, logp_old, the updates and the optimizer step, and
     update tokens/s; one microbatch update under torch.profiler;
 33. K7, the fused dynamic-int8 GEMM (csrc/int8_gemm.cu), vs its plain
     version on the card: at the JAX kernel tests' shapes (ragged M, K = 200,
     a row of zeros and a row of exact .5 ties), f32 and bf16 input, f32 and
     bf16 output, and at every shape the int8 paths give it (bf16 input):
     f32 outputs within a relative 1e-6 (bit for bit expected: identical
     codes, scales and int32 sums), bf16 outputs rel-L2 <= 1e-2, the
     differing elements printed; then at the wgmma GEMM's tile edges (M 1,
     63, 65, 129, 16385; N 1, 255, 257; K 4, 132, 1408, the weight pitch
     padded to 16) in all four dtype pairs, bit-identical to the plain
     version;
 34. the int8 serving main path: qwen3_8b_mla with quant="int8_mix" at full
     width and 36 layers, its seeded bf16 weights mapped by
     quantize_params_like (the dense copy freed); a paged generate on a
     2048-token prompt for 32 tokens (K7 7 per layer at the prefill: q, kv_a
     for the cache entry and again for the attention, o, gate, up, down; 36
     K5; 36 K6 per decode step; nothing else), then a ServingEngine (8 slots,
     12 requests of 100-2048 prompt tokens): 36 K5 per prefill, 252 K7 per
     prefill of a 2048 bucket (none for a 512 bucket: M < INT8_MIX_DYN_M),
     36 K6 per decode step, nothing else; every token in the vocabulary;
 35. at full depth in bf16 on a 1024-token prompt: K7 against its plain
     version on the real inputs of every int8 projection of layers 0, 18
     and 35 (rel-L2 <= 1e-2); end to end (a deep random int8 model is
     chaotic: one flipped code compounds) the int8_mix kernel route no
     farther than the plain route (K7's plain version, plain attention),
     x 1.25, from the same int8 weights run in fp32; int8_mix vs int8_wo
     and the drift from the dense bf16 model printed; JAX's int8_mix test
     on the card at its own config (every logit within 0.15 abs + 0.15
     rel of int8_wo, argmax agreement >= 0.9); fp32 at full width, depth 2:
     greedy tokens identical across the routes;
 36. times with CUDA events: llm_prefill_int8_tokens_per_sec (int8_mix,
     B = 8 x 2048) and llm_decode_int8_tokens_per_sec (int8_wo, B = 8, seq
     2048) beside phase 19's bf16 numbers; one int8_mix prefill under
     torch.profiler; K7 at every path shape: ms, TOPS, the bound (2MKN int8
     operations at 1,979 TOPS or 2MK + KN + 2MN bytes at 3.35 TB/s), the
     plain version's ms and two yardsticks (torch's quantize + torch._int_mm
     + rescale; a bf16 F.linear);
 37. InternVideo2-1B with quant="int8" at 16 x 224, B = 16: 160 K7 and 40 K1
     per forward, nothing else, finite logits, encoder_int8_clips_per_sec
     beside the bf16 model's; in fp32 at B = 2 with every LayerScale gamma at
     0.5 (as the JAX test): pooled and tokens against the dense model at
     the 1B (printed) and at the JAX test's config (rel-L2 <= 5e-3);
     the internvideo25_hico_2b tower with quant="int8" on 128 frames: 108 K7
     and 27 K2, its ms beside the bf16 tower's;
 38. K9 (fused add + RMSNorm) and K10 (fused LayerScale + add + RMSNorm)
     vs their plain versions: fp32 at the JAX tests' (2, 123, 64) and
     (4, 16, 64) (y max-abs <= 1e-6, the new residual identical); bf16 at the
     1B encoder's residual stream (16 * 4097 rows x 1408), K9 with an fp32
     residual, K10 all bf16 (y rel-L2 <= 1e-3, the new residual identical);
     K10's gradient through its Function against plain autograd (rel-L2 <=
     1e-2); K9 on a requires-grad input raises;
 39. K11 (fused qkv + QK-RMSNorm + blocked-K attention) vs its plain
     version: fp32 at (1, 1100 / 1040, 2 x 64) (max-abs 2e-5, grads 5e-4),
     bf16 on one projection at the stage-2 tower's (32, 1025, 16, 88), the
     1B eval's (16, 4097, 16, 88), S = 8192 (2, 8192, 16, 88) and head dim
     64 (4, 4097, 16, 64) (rel-L2 <= 1e-2; one pre-pass and one attention
     launch an op; the pre-pass's normed k bit-identical to the cast chain
     on its own 1/rms, within two bf16 ulps of `rms_norm` of the k slice,
     its 1/rms within 1e-6 of the plain pre-pass's); 39b: the three
     kernels' only paths, their entry points (`ops.fused_add_rms_norm`,
     `fused_ls_add_rms_norm`, `fused_qkv_attention_or_none(allow_large=
     True)` at S = 1025), each once, launches reset before and read after;
 40. the retrieval main path: `internvideo_tpu_torch.cli.eval` on
     configs/torch/eval_retrieval_stage2_1b.py (internvideo2_stage2_1b, 64
     clips x 64 texts, k 16); launches reset before and read after: 400
     flash_fwd (2 tower batches x 40 + 64 rerank batches x 5 cross-attention
     layers) and nothing else; every metric finite, the keys itm_eval's;
 41. kernel route vs plain route on the same seeded model (the tower's
     LayerScale gammas at 0.1, as in phase 5), 2 clips x 2 texts:
     vision_proj, text_proj and the ITM logits (rel-L2 <= 1e-2, or the
     kernel route no farther from the fp32 weights' output than the plain
     route, x 1.25); K1 on fusion layer 19's real cross-attention
     (rel-L2 <= 1e-2);
 42. times: tower clips/s (B 32), text texts/s (B 32 x 32), rerank pairs/s
     (32 pairs) and the whole eval's wall time; videoclip_retrieval_p50_ms
     as bench.py:241-317 times it; one query under torch.profiler; K9, K10
     and K11 beside their plain versions, bounds and yardsticks (K11 and
     its pre-pass alone beside SDPA on pre-normed q / k and the production
     route, 2 rms_norm + K1, in the same call); K1 at the
     shapes the retrieval eval gives it (the tower's (32, 1025, 16, 88) on
     qkv views, the rerank cross-attention's 32 queries on 1025 keys at
     head dim 64) beside its plain version, bound and flash SDPA;
 43. the VideoCLIP stage-2 training kernels vs their plain versions: K1 /
     K4a fp32 at B 2 with the step's Sq / Sk ((1025, 1025, 16, 88) and
     (32, 1025, 16, 64); out max-abs 2e-5, grads 5e-4) and bf16 at its
     shapes (the unmasked tower's (64, 1025, 16, 88) on qkv views, the
     fusion cross-attention's (64, 32 / 1025, 16, 64) in the MLM pass and
     (192, ...) in the VTM pass; rel-L2 1e-2); K2 / K4b at the UTA
     variant's cross-attention (8, 32 / 209, 16, 64) and K3 (+ K2 / K4b
     backward) at its masked student (8, 209, 16, 88), fp32 and bf16; then
     each kernel at each shape timed (CUDA events, median of 5; the UTA
     shapes by CUDA graph replay) beside its plain version, bound and flash
     SDPA;
 44. the stage-2 main path: `internvideo_tpu_torch.cli.train` on
     configs/torch/clip_stage2_1b.py (internvideo2_stage2_1b uncut, B 64,
     32 tokens, `uta=0`: the tower unmasked at S = 1025, remat) for 3
     steps; launches reset just before and read just after must equal
     `clip_want`'s prediction (per step 90 K1 = 80 tower incl. remat + 5
     MLM + 5 VTM cross-attention, 50 dq, 50 dk/dv, nothing else); every
     logged loss term and grad_norm finite;
 45. kernel route vs plain route on the first step's losses (loss,
     loss_vtc, loss_vtm, loss_mlm) and six gradients, B 4, the same draws,
     an fp32 copy of the weights on the plain route as the anchor (rel 1e-2
     / grads rel-L2 2e-2, or the kernel route no farther from the anchor
     than 1.25 x the plain route);
 46. the stage-2 step at B 64 on a device-resident batch: launches of one
     step against the prediction, ms (CUDA events), clips/s, peak device
     memory, one step under torch.profiler (device busy share);
 47. the UTA variant: the same config with engine.uta = 1.0,
     attention-guided masking at 0.8 and configs/torch/pretrain_1b_umt.py's
     CLIP-6B teacher, batch cut to 8, 2 steps through `cli.build_clip` +
     `Trainer.fit`; launches against the prediction (per step 128 K3 and
     128 pre-passes = 80 student at S = 209 + 48 teacher, 50 each of K2 /
     K4b dq / dk/dv), every loss term finite.

 48. K1, K2 and K5 at InternVideo2-Chat's shapes, B 8 and B 1, through
     `flash_attention` (one launch of the named kernel each), vs their plain
     versions (fp32 max-abs 2e-5, bf16 rel-L2 1e-2): K1 at the ViT's
     (B, 2049, 16, 88) on qkv views and at the QFormer cross-attention's
     32 queries on 2049 keys, 12 heads of 64; K2 at the QFormer
     self-attention's (B, 32, 12, 64); K5 at the LLM prefill's (B, 32 + 64,
     32, 256 / 128) and a ragged prompt of 61;
 49. the chat main path: `internvideo_tpu_torch.cli.eval` task videoqa on
     configs/torch/chat_videoqa_8b.py (`VideoChatConfig()` in bf16, nothing
     cut: 1B ViT at 8 x 224, QFormer of 32 queries, Qwen3-8B M2LA; 8 clips
     in batches of 4, 64-token prompt, 32 greedy tokens); launches reset
     just before and read just after: per prefill 52 K1 (40 ViT + 12
     cross-attention), 12 K2, 36 K5, nothing per decode step;
 50. kernel route vs plain route on the chat model, B 2: each attention on
     its real inputs (ViT blocks 0 / 39, QFormer layers 0 / 11 self and
     cross, LLM layers 0 / 35 prefill; rel-L2 1e-2); prefill + 2 decode
     steps' logits held to an fp32 copy at full depth (x 1.25); greedy
     tokens of both routes reported;
 51. times at B 1 and B 8: TTFT split into ViT, QFormer and LLM prefill
     (CUDA events) with each part's launches (40 / 12 + 12 / 36), decode
     tokens/s, generate's wall, peak memory, idle share (torch.profiler);
     the phase-48 shapes by CUDA graph replay beside the plain version, the
     bound and the library call (the first SDPA backend that takes the
     shape, also by graph replay);
 52. task zeroshot through `cli.eval` on
     configs/torch/eval_zeroshot_stage2_1b.py (internvideo2_stage2_1b
     uncut, 8 classes x 28 templates, 2 batches of 8 clips): 40 K1 a clip
     batch and nothing else;
 53. K3 (+ its K2 / K4b backward) and K2 / K4b alone at the distill
     student's head dim 64 vs their plain versions: fp32 at (2, 417, 16, 64)
     (max-abs 2e-5 forward, 5e-4 grads), bf16 at (32, 417, 16, 64) (rel-L2
     1e-2; K3's grads 2e-2);
 54. their times there (CUDA events, median of 5), K3 split into pre-pass
     and attention, beside the plain versions, the bounds and flash SDPA
     (forward; the aten backward for K4b at d 64);
 55. the distill main path: `internvideo_tpu_torch.cli.train` on
     configs/torch/distill_l14_1b.py (InternVideo2-L/14 student at 8 x 224,
     tube masking 0.8 so S = 417, remat; the frozen InternVideo2-1B teacher
     at S = 2049, bf16; B 32) for 3 steps; launches reset just before and
     read just after: per step 40 K1 (teacher), 48 K3 + 48 pre-pass, all at
     S 417 (student forward + remat), 24 each of K2 / K4b dq / K4b dk/dv,
     nothing else; every loss term and grad_norm finite;
 56. kernel route vs plain route of the distill loss, B 2, the same keep
     indices: fp32 at L / 1B widths and depth 2 (loss terms and every grad
     max-abs 5e-4); bf16 at full depth, held to an fp32 copy of the weights
     (within 1e-2 / 2e-2 of the plain route, or the kernel route no
     farther from fp32 than 1.25 x the plain route);
 57. the distill step at B 32 on a device-resident batch: one step's
     launches, ms (CUDA events), clips/s, peak memory, the teacher's share,
     device time by kernel group and the idle share (torch.profiler);
 58. the real SFT data path: `cli.train` on configs/torch/sft_internvideo3_8b.py
     with `data.jsonl=` (16 rows: 8 conversations on seeded 64 x 240 x 320
     uint8 `.npy` clips, 8 text only) and text depth 4 for 3 steps; per step
     8 segmented K5 forwards, 4 + 4 segmented K5 dq / dk/dv, 27 each of
     K2 / K4b at head dim 72, nothing else; the host's ms a batch for
     packing + load_media beside the step's, the step fed by
     prefetch_to_device and its idle share; K5 + K8 on a jsonl pack's
     segment ids vs their plain version (rel-L2 1e-2) and timed;
 59. prefetch_to_device on the card: each batch equal to the host bytes
     under a kernel queued on the consumer stream at once; host -> card
     GB/s.

 60. the fusion cross-attention at the audio-visual step's new shapes vs
     the plain versions: K1 / K4a over audio + video tokens (32 queries on
     252 + 1025 keys, 16 heads of 64; B 64 in the MLM pass, 192 in the VTM
     pass) and K2 / K4b over audio alone (32 on 252), fp32 at B 2 (max-abs
     2e-5 forward, 5e-4 grads) and bf16 at the path's shapes (rel-L2 1e-2);
     K2 / K4b at the simple audio tower's (64, 512, 12, 64) on qkv views;
     each timed (K1 / K4a by CUDA events, K2 / K4b by CUDA graph replay,
     median of 5) beside its plain version, bound and flash SDPA;
 61. the audio-visual main path: `internvideo_tpu_torch.cli.train` on
     configs/torch/clip_av_stage2_1b.py (the 1B tower at 4 x 224 with
     remat, BEATs on the 998 x 64 fbank -> 252 tokens, bert-large; B 64, 32
     tokens, media type audio_video) for 3 steps; launches reset just before
     and read just after must equal `clip_av_want` (per step 90 K1 = 80
     tower + 5 MLM + 5 VTM at Sk 1277, 50 dq, 50 dk/dv, nothing else;
     BEATs' attention is plain torch); every loss term and grad_norm finite;
 62. the step of each media type on one model and optimizer, B 64,
     device-resident batches: launches against `clip_av_want` (video: as
     audio_video at Sk 1025; audio: 10 each of K2 / K4b dq / dk/dv at Sk
     252), ms (CUDA events), clips/s, peak memory, the audio tower's
     forward + backward alone; audio_video and audio under torch.profiler
     (device time by kernel group, idle share);
 63. the real-audio path on that trainer: 8 wavs of 10-12 s (half at
     22.05 kHz stereo) and seeded uint8 clips written to a temp dir, an
     audio and an audio_video corpus registered and built, 3 steps of each
     through JsonlVideoTextDataset -> load_fbank -> prefetch_to_device ->
     the step; the host's ms a batch (and load_fbank's alone) beside the fed
     step's, and its idle share;
 64. kernel route vs plain route of the audio-visual loss per media type,
     B 2, the same draws: fp32 at full widths and depth 2 (loss terms and
     every grad max-abs 5e-4); bf16 at full depth (within 1e-2 / 2e-2 of the
     plain route, or the kernel route no farther from an fp32 copy than
     1.25 x the plain route);
 65. the simple audio tower at its default width (768 x 12 blocks of 12
     heads on a 1024 x 128 fbank) in place of BEATs: one audio step at B 64,
     12 + 10 each of K2 / K4b dq / dk/dv, its ms and peak memory.

The last three lines are the card, the kernel table as JSON and
{"ok": true, "device": {...}}; the line before them gives the whole run's
wall time.
"""

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

CONFIG_1B = "configs/torch/eval_classification_1b.py"
MAIN_SHAPE = (16, 4097, 16, 88)  # B, S, H, head_dim of the 1B at 16 x 224
DEPTH_1B = 40
CONFIG_TRAIN = "configs/torch/finetune_k400_1b.py"
TRAIN_SHAPE = (32, 2049, 16, 88)  # B, S, H, head_dim of the 1B finetune at 8 x 224
TRAIN_STEPS = 3
CONFIG_PRETRAIN = "configs/torch/pretrain_1b_umt.py"
PRETRAIN_SHAPE = (32, 833, 16, 88)  # B, S, H, head_dim of the masked 1B student
TEACHER_SHAPE = (512, 257, 25, 128)  # B*T, S, H, head_dim of the CLIP-6B teacher
MAE_TEACHER_SHAPE = (32, 4096, 16, 88)  # B, S, H, head_dim of the VideoMAE-g14 teacher (K1)
PRETRAIN_STEPS = 3
PRESET_8B, PRESET_2B = "qwen3_8b_mla", "qwen3_2b_mla"
LLM_DEPTH_8B, VOCAB = 36, 151936
PREFILL_SHAPE = (8, 2048)  # B, prompt: bench.py's LLM prefill shape
CAUSAL_SHAPE = (8, 2048, 32, 256, 128)  # B, S, H, d_qk, d_v of the 8B prefill
CAUSAL_SHAPE_2B = (8, 2048, 20, 192, 128)
DECODE_SHAPE = (8, 32, 896, 128, 64)  # B, H, R, P, page size of the 8B decode
DECODE_LENS = [2048, 2060, 2075, 2080, 2090, 2100, 2111, 2112]
DECODE_SHAPE_2B = (8, 20, 512, 64, 64)  # the 2B video decode (internvideo25_hico_2b's text)
SERVE_ENGINE = dict(max_batch=8, page_size=64, num_pages=272, prompt_buckets=(512, 2048),
                    max_len=2112)
CONFIG_SFT = "configs/torch/sft_internvideo3_8b.py"
SFT_PACK, SFT_STEPS, SFT_ROUTE_PACK = 8192, 3, 2048
SFT_ATTN_SHAPE = (1, 8192, 32, 256, 128)  # B, S, H, d_qk, d_v of the SFT text attention
TOWER_SHAPE = (8, 196, 16, 72)  # B * frames, S, H, head_dim of the tower at 16 x 224
TOWER_DEPTH = 27
PRESET_GQA, GQA_DEPTH = "qwen3_8b_dense", 36
GQA_SHAPE = (8, 2048, 32, 8, 128)  # B, S, Hq, Hkv, head_dim of the dense-GQA prefill
GQA_WINDOW = 128  # gpt-oss's published sliding_window
PRESET_HICO, HICO_FRAMES = "internvideo25_hico_2b", 128
HICO_VISUAL, HICO_PROMPT = 1024, 1056  # 64 merged frames x HiCo-R16; + text (bench.py:526-537)
HICO_TOWER_DEPTH, HICO_TEXT_DEPTH, HICO_DECODE_B = 27, 24, 8
HICO_TOWER_SHAPE = (64, 196, 16, 72)  # B * T', S, H, head_dim of the tower at 128 x 224
HICO_ATTN_SHAPE = (1, HICO_PROMPT, 20, 192, 128)  # B, S, H, d_qk, d_v of the 2B video prefill
# GRPO RL on qwen3_8b_dense: depth (the largest multiple of 4 under 72 GB,
# PERF.md §4), prompts x group rows of prompt + response tokens, microbatches
RL_DEPTH, RL_ITERS, RL_ACCUM = 24, 2, 4
RL_PROMPTS, RL_GROUP, RL_PROMPT_LEN, RL_NEW = 2, 8, 1024, 128
RL_SHAPE = (4, 1152, 32, 8, 128)  # B, L, Hq, Hkv, head_dim of one microbatch's attention
RL_ENGINE_DEPTH, RL_ENGINE_PROMPT, RL_ENGINE_NEW = 4, 256, 32  # the engine backend, qwen3_8b_mla
# H100 SXM dense peaks (NVIDIA data sheet, 700 W): bf16 tensor cores, HBM
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
PEAK_INT8_OPS = 1979e12  # int8 tensor cores, dense
# int8 serving (phases 33-37): the (M, K, N) each path gives K7. 8B prefill at
# B 8 x 2048: q_proj, kv_a, o_proj, gate / up, down; the 1B encoder at B 16 x
# 4097: qkv, proj, fc1, fc2 (MLP 6144 = int(1408 * 48 / 11)); the tower at
# 128 frames (64 x 196 tokens): qkv, proj, fc1, fc2 (K = 4304: a ragged k-tile)
INT8_SHAPES = {
    "serve_int8": [(16384, 4096, 8192), (16384, 4096, 1024), (16384, 4096, 4096),
                   (16384, 4096, 12288), (16384, 12288, 4096)],
    "encoder_int8": [(65552, 1408, 4224), (65552, 1408, 1408), (65552, 1408, 6144),
                     (65552, 6144, 1408)],
    "tower_int8": [(12544, 1152, 3456), (12544, 1152, 1152), (12544, 1152, 4304),
                   (12544, 4304, 1152)],
}
INT8_MAIN_SHAPE = (16384, 4096, 12288)  # the 8B gate / up projection
# tests/test_int8_gemm.py:24-32's shapes (M shape, K, N), K = 200 and its f32 case
INT8_TEST_SHAPES = [((256,), 256, 384), ((3, 170), 256, 384), ((130,), 384, 200),
                    ((64,), 128, 128), ((2, 40), 200, 96), ((192,), 256, 256)]
# K7 launches per paged prefill layer: q, kv_a twice (the cache entry, then
# the attention), o, gate, up, down (as JAX's prefill_paged, llm.py:337)
INT8_PREFILL_PROJ = 7
INT8_AGREE_SHAPE = (1, 1024)  # B, prompt of the route agreement: M = INT8_MIX_DYN_M
ENC_INT8_B = 16
# tests/test_quant_rl_paged.py:216-219's encoder (plain attention: head dim 32
# has no K1 / K2 instantiation)
INT8_ENC_TEST = dict(embed_dim=128, depth=2, num_heads=4, mlp_ratio=4.0, patch_size=14,
                     img_size=56, num_frames=4, tubelet_size=1, clip_embed_dim=64,
                     num_classes=0, attn_impl="plain",
                     mlp_act="gelu")
INT8_TOWER_VIDEO = (1, HICO_FRAMES, 224, 224, 3)
# VideoCLIP stage-2 retrieval (phases 38-42): the eval config, the tower's
# attention shape at 4 x 224 and B 32, and K9 / K10's rows x D: the 1B
# encoder's residual stream at 16 x 224, B 16
CONFIG_RETRIEVAL = "configs/torch/eval_retrieval_stage2_1b.py"
RETRIEVAL_TOWER_SHAPE = (32, 1025, 16, 88)
# the rerank fusion's cross-attention to the tower's tokens: (B, Sq, Sk, H, D)
RETRIEVAL_CROSS_SHAPE = (32, 32, 1025, 16, 64)
NORM_SHAPE = (16 * 4097, 1408)
# VideoCLIP stage-2 training (phases 43-47): the 1B recipe (uta = 0: the
# tower unmasked at S = 1 + 4 * 256), the tower's attention at B 64, the
# fusion cross-attention to its tokens (B, Sq, Sk, H, D) in the MLM pass
# and the VTM pass (3B rows); the UTA variant at B 8 (the batch cut):
# the masked student at S = 1 + 4 * 52 and its cross-attention
CONFIG_CLIP = "configs/torch/clip_stage2_1b.py"
CLIP_STEPS = 3
CLIP_TOWER_SHAPE = (64, 1025, 16, 88)
CLIP_CROSS_SHAPES = {"mlm": (64, 32, 1025, 16, 64), "vtm": (192, 32, 1025, 16, 64)}
CLIP_UTA_B = 8
CLIP_UTA_STEPS = 2
CLIP_UTA_STUDENT_SHAPE = (8, 209, 16, 88)
CLIP_UTA_CROSS_SHAPE = (8, 32, 209, 16, 64)
# InternVideo2-Chat serving (phases 48-51): the videoqa config (VideoChatConfig()
# in bf16), its attention shapes (the ViT's S, H, D at 8 x 224; the QFormer's
# cross-attention Sq, Sk, H, D; the LLM's H, d_qk, d_v), the prompt, its ragged
# variant and the new tokens; the CLI run's clips and prefills (8 in batches of 4);
# then the zero-shot eval of the stage-2 model (phase 52)
CONFIG_CHAT = "configs/torch/chat_videoqa_8b.py"
CHAT_VIT_SHAPE = (2049, 16, 88)
CHAT_CROSS_SHAPE = (32, 2049, 12, 64)
CHAT_LLM_SHAPE = (32, 256, 128)
CHAT_PROMPT, CHAT_RAGGED_PROMPT, CHAT_NEW = 64, 61, 32
CHAT_BATCHES = (8, 1)
CHAT_CLI_CLIPS, CHAT_CLI_PREFILLS = 8, 2
CONFIG_ZEROSHOT = "configs/torch/eval_zeroshot_stage2_1b.py"
# Task distill (phases 53-57): the InternVideo2-L/14 student at 8 x 224 with
# tube masking at 0.8 (S = 1 + 8 * 52) and the frozen 1B teacher unmasked
# (S = 1 + 8 * 256, the finetune's K1 shape), B 32; the route check's depth
CONFIG_DISTILL = "configs/torch/distill_l14_1b.py"
DISTILL_STEPS = 3
DISTILL_STUDENT_SHAPE = (32, 417, 16, 64)
DISTILL_TEACHER_SHAPE = (32, 2049, 16, 88)
# The real SFT data path (phase 58): a jsonl of 8 conversations on seeded
# uint8 clips of 64 x 240 x 320 (`.npy`, resized by load_media to the
# config's 16 x 224 grid) and 8 text-only ones, the SFT config's widths with
# the text depth cut to 4; then (phase 59) prefetch_to_device's batches
SFT_JSONL_DEPTH = 4
SFT_JSONL_STEPS = 3
SFT_JSONL_CLIP = (64, 240, 320, 3)
PREFETCH_BATCH = {"video": (8, 16, 224, 224, 3), "input_ids": (8, 8192)}
# Audio-visual stage 2 (phases 60-65): the full-width config (the 1B tower at
# 4 x 224, BEATs on the 998 x 64 fbank -> 63 x 4 = 252 tokens, bert-large,
# B 64); the fusion cross-attention's (B, Sq, Sk, H, D) in the MLM pass (B)
# and the VTM pass (3B rows) over audio + video tokens (252 + 1025) and over
# audio alone; the simple tower at its default width (1024 x 128 -> 512
# tokens, 12 heads of 64); the real-audio path's wavs and uint8 clips
CONFIG_AV = "configs/torch/clip_av_stage2_1b.py"
AV_STEPS = 3
AV_CROSS_SHAPES = {"av_mlm": (64, 32, 1277, 16, 64), "av_vtm": (192, 32, 1277, 16, 64),
                   "audio_mlm": (64, 32, 252, 16, 64), "audio_vtm": (192, 32, 252, 16, 64)}
AV_SIMPLE_SHAPE = (64, 512, 12, 64)
AV_REAL_WAVS = 8
AV_REAL_CLIP = (16, 240, 320, 3)
# K11's bf16 edges beside its two path shapes: the top of its S range, and
# head dim 64 at the eval's S
K11_EDGE_SHAPES = ((2, 8192, 16, 88), (4, 4097, 16, 64))


# K5's earlier forward design, which the wgmma one replaced; its times, taken
# on the same card in one run beside the wgmma kernel's, are in PERF.md
# (tools_torch/compare_k5_fwd.py), not measured here.
K5_EARLIER = {"design": "mma.sync m16n8k16 + cp.async, 4 warps of 16 rows",
              "times_beside_ms": "PERF.md section 6, tools_torch/compare_k5_fwd.py"}
K1K2_EARLIER = {"design": "mma.sync m16n8k16 + cp.async, 4 warps of 16 rows (attn_fwd.cuh's "
                          "bf16 body, deleted with K11's redesign)",
                "times_beside_ms": "PERF.md section 6, tools_torch/compare_fwd_k1k2.py"}
K4B_EARLIER = {"design": "mma.sync m16n8k16 + double-buffered cp.async, 4 warps and 64-row "
                          "tiles (attn_bwd.cuh's bf16 body, deleted with this redesign)",
               "times_beside_ms": "PERF.md section 6, tools_torch/compare_k4b_k7.py"}
K7_EARLIER = {"design": "mma.sync m16n8k32 s8, 128 x 128 CTA tiles of 8 warps, 3-stage cp.async, "
                        "ldmatrix",
              "times_beside_ms": "PERF.md section 6, tools_torch/compare_k4b_k7.py"}
K3_EARLIER = {"design": "attn_fwd.cuh's mma.sync m16n8k16 body, 64-row CTAs of 4 warps, cp.async "
                        "double buffer, q / k normed on load",
              "times_beside_ms": "PERF.md section 6, tools_torch/compare_k3_k6.py"}
K11_EARLIER = {"design": "attn_fwd.cuh's mma.sync m16n8k16 body, 64-row CTAs of 4 warps, cp.async "
                         "double buffer, q and every k tile normed on load in each CTA",
               "times_beside_ms": "PERF.md section 6, tools_torch/compare_k11.py"}
K6_EARLIER = {"design": "8 heads a CTA (the pool read H / 8 times), 16-token cp.async tiles, "
                        "fp32 CUDA-core FMAs with warp-shuffle sums (which the fp32 route keeps)",
              "times_beside_ms": "PERF.md section 6, tools_torch/compare_k3_k6.py"}
K5_BWD_EARLIER = {"design": "mma.sync m16n8k16 + cp.async, 4 warps of 16 rows; dk/dv at d_qk "
                            "256 split over two CTAs that each recompute P^T and dS^T",
                  "times_beside_ms": "PERF.md section 6, tools_torch/compare_k5_bwd.py"}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, n: int = 20) -> float:
    """Device ms of one `fn()` from replaying a CUDA graph of `n` calls (for
    kernels that the wrapper's host work would hide under _time_ms)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _time_ms(graph.replay, iters=5, warmup=1) / n


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for `flops` bf16 tensor-core
    operations and `nbytes` of device-memory traffic."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _fwd_bound(b, s, h, d) -> tuple[float, str]:
    """_bound of a non-causal attention forward at (B, S, H, D) bf16: 4 B H
    S^2 d operations; q, k, v read and out written once, the LSE written."""
    return _bound(4 * b * h * s * s * d, 4 * b * s * h * d * 2 + b * h * s * 4)


def _ptxas(log: str, pattern: str, label, count: int) -> dict:
    """Registers at entry and spill bytes of each kernel whose mangled name
    matches `pattern` in the build log, keyed by `label(match)`; raises
    unless there are `count` of them, each with its report."""
    import re

    res, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*" + pattern, line)
        if m:
            name = label(m)
            res[name] = {}
        elif "Compiling entry function" in line:
            name = None
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                res[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                res[name]["registers"] = int(m[1])
    if len(res) != count or any(len(v) != 3 for v in res.values()):
        raise AssertionError(f"the build log lacks {pattern}'s ptxas report: {res}")
    return res


def _ptxas_k5(log: str, kernel: str = "causal_fwd_bf16_kernel", count: int = 12) -> dict:
    """The ptxas report of each instantiation of one of K5's bf16 kernels
    (`<kernel><d_qk, d_v, kSeg>`: the forward, or the backward's
    `causal_bwd_dq_bf16_kernel` / `causal_bwd_dkv_bf16_kernel`, 10 each)."""
    return _ptxas(log, kernel + r"ILi(\d+)ELi(\d+)ELb(\d)E",
                  lambda m: f"({m[1]}, {m[2]}{', seg' if m[3] == '1' else ''})", count)


def _ptxas_k4a(log: str) -> dict:
    """The ptxas report of K4a's bf16 kernels (flash_bwd_{dq,dkv}_wgmma_kernel
    <D>, K5's bodies at D = 64 and 88)."""
    return _ptxas(log, r"flash_bwd_(dq|dkv)_wgmma_kernelILi(\d+)E",
                  lambda m: f"{m[1]} ({m[2]}, {m[2]})", 4)


def _ptxas_k1k2(log: str) -> dict:
    """The ptxas report of K1's and K2's bf16 kernels ({flash,small_s}_fwd_
    wgmma_kernel<D>, K5's forward body at D = 64, 88 and 64, 72, 88, 128)."""
    return _ptxas(log, r"(flash|small_s)_fwd_wgmma_kernelILi(\d+)E",
                  lambda m: f"{m[1]}_fwd ({m[2]}, {m[2]})", 6)


def _ptxas_k4b_k7(log: str) -> dict:
    """The ptxas report of K4b's bf16 kernels (small_s_bwd_{dq,dkv}_wgmma_
    kernel<D>, K4a's bodies at D = 64, 72, 88, 128) and of K7's GEMM
    (int8_gemm_wgmma_kernel<out type>); raises on a spill (the kernels they
    replace had none)."""
    rep = {**_ptxas(log, r"small_s_bwd_(dq|dkv)_wgmma_kernelILi(\d+)E",
                    lambda m: f"small_s_bwd_{m[1]} ({m[2]}, {m[2]})", 8),
           **_ptxas(log, r"int8_gemm_wgmma_kernelI(f|13__nv_bfloat16)E",
                    lambda m: f"int8_gemm ({'f32' if m[1] == 'f' else 'bf16'} out)", 2)}
    spilled = {k: v for k, v in rep.items() if v["spill_stores"] or v["spill_loads"]}
    if spilled:
        raise AssertionError(f"K4b / K7 kernels spill: {spilled}")
    return rep


def _ptxas_k3_k6(log: str) -> dict:
    """The ptxas report of K3's bf16 kernels (fused_qkv_fwd_wgmma_kernel<D>,
    K2's body with the QK-RMSNorm in shared memory at D = 64, 72, 88, 128)
    and of K6's (paged_decode_mma_kernel<R, P>); raises on a spill (the
    kernels they replace had none)."""
    rep = {**_ptxas(log, r"fused_qkv_fwd_wgmma_kernelILi(\d+)E",
                    lambda m: f"fused_qkv_fwd ({m[1]}, {m[1]})", 4),
           **_ptxas(log, r"paged_decode_mma_kernelILi(\d+)ELi(\d+)E",
                    lambda m: f"paged_decode (R {m[1]}, P {m[2]})", 2)}
    spilled = {k: v for k, v in rep.items() if v["spill_stores"] or v["spill_loads"]}
    if spilled:
        raise AssertionError(f"K3 / K6 kernels spill: {spilled}")
    return rep


def _ptxas_k11(log: str) -> dict:
    """The ptxas report of K11's bf16 kernels (fused_qkv_large_fwd_wgmma_kernel
    <D>, K3's walk without the K norm at D = 64 and 88) and of its pre-pass
    (fused_qkv_rstd_kernel<bf16, normed k>); raises on a spill (the kernel
    they replace had none)."""
    rep = {**_ptxas(log, r"fused_qkv_large_fwd_wgmma_kernelILi(\d+)E",
                    lambda m: f"fused_qkv_large_fwd ({m[1]}, {m[1]})", 2),
           **_ptxas(log, r"fused_qkv_rstd_kernelILb1ELb1E", lambda m: "pre-pass (normed k)", 1)}
    spilled = {k: v for k, v in rep.items() if v["spill_stores"] or v["spill_loads"]}
    if spilled:
        raise AssertionError(f"K11 kernels spill: {spilled}")
    return rep


# The edges of the wgmma forward's 128-row query tile (one row, one short,
# one past) against those of its 64-key stages (one key past one, two and
# three stages): (Sq, Sk).
FWD_TILE_EDGES = [(sq, sk) for sq in (1, 127, 129) for sk in (65, 129, 193)]


def _fwd_edges_bf16(fa, kernel: str, dims, edges, g) -> None:
    """`kernel` ("flash_fwd": K1, "small_s_fwd": K2) in bf16 at each (Sq, Sk)
    of `edges` and head dim of `dims`, held to the plain version: out rel-L2
    <= 1e-2, LSE max-abs <= 1e-2."""
    worst = (0.0, 0.0)
    for d in dims:
        for sq, sk in edges:
            q = torch.randn(2, sq, 4, d, device="cuda", generator=g).bfloat16()
            k, v = (torch.randn(2, sk, 4, d, device="cuda", generator=g).bfloat16()
                    for _ in range(2))
            out, lse = fa._flash_fwd_cuda(q, k, v, d ** -0.5, kernel=kernel)
            ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5)
            torch.cuda.synchronize()
            rel, e_lse = _rel(out, ref), (lse - ref_lse).abs().max().item()
            if not (rel <= 1e-2 and e_lse <= 1e-2):
                raise AssertionError(f"{kernel} bf16 disagrees with its plain version at "
                                     f"(Sq, Sk, d) {(sq, sk, d)}: rel-L2 {rel}, lse {e_lse}")
            worst = (max(worst[0], rel), max(worst[1], e_lse))
    print(f"{kernel} bf16 tile edges (Sq, Sk) {edges} x d {list(dims)}: worst out rel-L2 "
          f"{worst[0]:.3e}, lse max-abs {worst[1]:.3e} (bars 1e-2)", flush=True)


# The edges of K4b's tiles, for Sq and Sk each: one row, one short of and one
# past a 64-row / 64-key stage and a 128-row / 128-key CTA, the student's 833.
BWD_TILE_EDGES = (1, 63, 65, 127, 129, 833)


def _bwd_edges_bf16(fa, g) -> None:
    """K4b in bf16 at each (Sq, Sk) of BWD_TILE_EDGES x BWD_TILE_EDGES and
    each instantiated head dim, q from one projection and k / v from another
    (views, as the models pass them), held to the plain backward: dq, dk, dv
    rel-L2 <= 1e-2 each; with one key (Sk = 1: a constant softmax, dq and dk
    zero in exact arithmetic, both routes fp32 rounding noise) dq and dk of
    both max-abs <= 1e-4."""
    worst = 0.0
    b, h = 2, 4
    for d in fa.SMALL_S_HEAD_DIMS:
        for sq in BWD_TILE_EDGES:
            for sk in BWD_TILE_EDGES:
                qp = torch.randn(b, sq, 3 * h * d, device="cuda", generator=g).bfloat16()
                kvp = torch.randn(b, sk, 3 * h * d, device="cuda", generator=g).bfloat16()
                q = qp[..., :h * d].unflatten(-1, (h, d))
                k, v = (x.unflatten(-1, (h, d)) for x in kvp[..., h * d:].split(h * d, dim=-1))
                do = torch.randn(b, sq, h, d, device="cuda", generator=g).bfloat16()
                with torch.no_grad():
                    out, lse = fa._flash_fwd_cuda(q, k, v, d ** -0.5, kernel="small_s_fwd")
                got = fa._flash_bwd_cuda(q, k, v, out, lse, do, d ** -0.5, prefix="small_s")
                refs = fa.small_s_attention_bwd_ref(q, k, v, out, lse, do, d ** -0.5)
                torch.cuda.synchronize()
                if sk == 1:  # dq, dk: zero in exact arithmetic
                    tiny = max(x.abs().max().item() for x in (*got[:2], *refs[:2]))
                    if not tiny <= 1e-4:
                        raise AssertionError(f"K4b bf16 at one key, d {d}: dq / dk max-abs "
                                             f"{tiny} (zero in exact arithmetic)")
                    got, refs = got[2:], refs[2:]
                rels = [_rel(x, r) for x, r in zip(got, refs)]
                if not max(rels) <= 1e-2:
                    raise AssertionError(f"K4b bf16 disagrees with its plain version at (Sq, Sk,"
                                         f" d) {(sq, sk, d)}: dq / dk / dv rel-L2 {rels}")
                worst = max(worst, *rels)
    print(f"small_s_bwd bf16 tile edges Sq x Sk {BWD_TILE_EDGES}^2 x d "
          f"{list(fa.SMALL_S_HEAD_DIMS)}, projection views: worst dq / dk / dv rel-L2 "
          f"{worst:.3e} (bar 1e-2)", flush=True)


# The edges of K3's 128-row query tiles (two 64-row warpgroups) and 64-key
# stages, the teacher's S = 257 (a 1-row last tile), the student's 833, the
# small-S limit.
K3_TILE_EDGES = (1, 63, 64, 65, 127, 128, 129, 257, 833, 1024)


def _fused_edges_bf16(fa, g) -> None:
    """K3 in bf16 at each S of K3_TILE_EDGES and each instantiated head dim,
    B 2, 4 heads, the (B, S, 3W) projection a padded view whose base sits
    16 bytes past a 128-byte boundary: out rel-L2 <= 1e-2 against the plain
    version, two calls bit-identical."""
    worst, b, h = 0.0, 2, 4
    for d in fa.SMALL_S_HEAD_DIMS:
        w = h * d
        for s in K3_TILE_EDGES:
            pitch = 3 * w + 8
            flat = (torch.randn(b * s * pitch + 64, device="cuda", generator=g) * 2).bfloat16()
            off = (128 - flat.data_ptr() % 128) % 128 // 2 + 8
            qkv = flat[off:off + b * s * pitch].view(b, s, pitch)[..., :3 * w]
            qw, kw = (torch.randn(w, device="cuda", generator=g) * 0.1 + 1 for _ in range(2))
            out = fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
            again = fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
            ref = fa.fused_qkv_ref(qkv, qw, kw, h, d ** -0.5)
            torch.cuda.synchronize()
            rel = _rel(out, ref)
            if not (qkv.data_ptr() % 128 == 16 and rel <= 1e-2 and torch.equal(out, again)):
                raise AssertionError(f"K3 bf16 at (S, d) {(s, d)}: rel-L2 {rel}, bit-identical "
                                     f"across calls {torch.equal(out, again)}")
            worst = max(worst, rel)
    print(f"fused_qkv_fwd bf16 tile edges S {K3_TILE_EDGES} x d {list(fa.SMALL_S_HEAD_DIMS)}, "
          f"padded projection views 16 bytes past a 128-byte boundary: worst out rel-L2 "
          f"{worst:.3e} (bar 1e-2), two calls bit-identical", flush=True)


def _set_attn_impl(model, impl: str) -> None:
    """The route of every encoder block's and BERT layer's attention (the
    pooling head stays on the plain route, as the model pins it)."""
    from internvideo_tpu_torch.models.bert import BertAttention
    from internvideo_tpu_torch.nn.transformer import Attention

    for m in model.modules():
        if isinstance(m, (Attention, BertAttention)):
            m.attn_impl = impl


def _raise_gammas(model, value: float = 0.1) -> None:
    """Every LayerScale gamma at `value`, so that each block moves the output."""
    from internvideo_tpu_torch.nn.transformer import LayerScale

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerScale):
                m.gamma.fill_(value)


def check_kernel(fa) -> None:
    """Phase 3."""
    g = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, h, d in [(2, 256, 256, 2, 64), (1, 257, 257, 2, 88),
                            (1, 256, 263, 2, 64), (1, 263, 256, 2, 64)]:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g)
        k = torch.randn(b, sk, h, d, device="cuda", generator=g)
        v = torch.randn(b, sk, h, d, device="cuda", generator=g)
        out, lse = fa.flash_attention_with_lse(q, k, v)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5)
        e_out = (out - ref).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        print(f"kernel fp32 {(b, sq, sk, h, d)}: out max-abs {e_out:.3e}, "
              f"lse max-abs {e_lse:.3e} (bar 2e-5)", flush=True)
        if not (e_out <= 2e-5 and e_lse <= 2e-5):
            raise AssertionError("fp32 kernel disagrees with its plain version")

    b, s, h, d = 2, *MAIN_SHAPE[1:]
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g).bfloat16()
    q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
    out, lse = fa.flash_attention_with_lse(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5)
    rel, e_lse = _rel(out, ref), (lse - ref_lse).abs().max().item()
    max_abs = (out.float() - ref.float()).abs().max().item()
    print(f"kernel bf16 {(b, s, s, h, d)} strided qkv views: out rel-L2 {rel:.3e} "
          f"(bar 1e-2), out max-abs {max_abs:.3e}, lse max-abs {e_lse:.3e} (bar 1e-2)",
          flush=True)
    if not (rel <= 1e-2 and e_lse <= 1e-2):
        raise AssertionError("bf16 kernel disagrees with its plain version")
    _fwd_edges_bf16(fa, "flash_fwd", fa.KERNEL_HEAD_DIMS, FWD_TILE_EDGES, g)


def run_main_path(fa) -> int:
    """Phase 4; returns the kernel launches of the main-path run."""
    from internvideo_tpu_torch.cli import eval as cli
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2

    forwards = []

    def record(module, args, out):
        if isinstance(module, InternVideo2):
            forwards.append((tuple(out.logits.shape), bool(torch.isfinite(out.logits).all())))

    hook = torch.nn.modules.module.register_module_forward_hook(record)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        fa.reset_launch_count()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--config", CONFIG_1B, "--device", "cuda"])
        torch.cuda.synchronize()
        launches = fa.launch_count()
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"cli.eval {CONFIG_1B}: {json.dumps(result)} ({wall:.1f} s wall incl. init "
          f"and data)", flush=True)
    print(f"main path: {len(forwards)} forwards, logits {forwards[0][0] if forwards else None}, "
          f"flash_fwd launches {launches}", flush=True)
    if rc != 0 or not forwards:
        raise AssertionError("cli.eval did not run a forward")
    if not all(finite for _, finite in forwards):
        raise AssertionError("non-finite logits on the main path")
    if launches != DEPTH_1B * len(forwards):
        raise AssertionError(f"{launches} kernel launches for {len(forwards)} forwards; "
                             f"expected {DEPTH_1B} per forward")
    return launches


def check_routes(fa, model):
    """Phase 5 on `model` (gammas already 0.1)."""
    g = torch.Generator("cuda").manual_seed(1)
    video = torch.randn(2, 16, 224, 224, 3, device="cuda", generator=g)
    outs = {}
    for impl in ("kernel", "plain"):
        _set_attn_impl(model, impl)
        with torch.inference_mode():
            outs[impl] = model(video)
    for name in ("pooled", "logits"):
        k, p = getattr(outs["kernel"], name), getattr(outs["plain"], name)
        rel = _rel(k, p)
        print(f"1B B=2 gammas 0.1, kernel vs plain route: {name} rel-L2 {rel:.3e} "
              f"(bar 1e-2)", flush=True)
        if not (torch.isfinite(k).all() and rel <= 1e-2):
            raise AssertionError(f"routes disagree on {name}")

    captured = {}
    hooks = [model.blocks[i].attn.register_forward_pre_hook(
        lambda mod, args, i=i: captured.__setitem__(i, mod.project_qkv(args[0])))
        for i in (0, DEPTH_1B - 1)]
    _set_attn_impl(model, "kernel")
    with torch.inference_mode():
        model(video)
    for h in hooks:
        h.remove()
    for i, (q, k, v) in sorted(captured.items()):
        with torch.inference_mode():
            out, lse = fa.flash_attention_with_lse(q, k, v)
            ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, q.shape[-1] ** -0.5)
        rel, e_lse = _rel(out, ref), (lse - ref_lse).abs().max().item()
        print(f"block {i} real q/k/v {tuple(q.shape)}: out rel-L2 {rel:.3e}, "
              f"lse max-abs {e_lse:.3e} (bars 1e-2)", flush=True)
        if not (rel <= 1e-2 and e_lse <= 1e-2):
            raise AssertionError(f"kernel disagrees with plain on block {i}")


def time_all(fa, model, card):
    """Phase 6; returns (kernel ms, plain ms, kernel max-abs error) at
    MAIN_SHAPE, the shape the main path gives the kernel."""
    g = torch.Generator("cuda").manual_seed(2)
    q, k, v = (torch.randn(*MAIN_SHAPE, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    scale = MAIN_SHAPE[-1] ** -0.5
    with torch.inference_mode():
        out, lse = fa.flash_attention_with_lse(q, k, v)
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, scale)
        torch.cuda.synchronize()
    rel, e_lse = _rel(out, ref), (lse - ref_lse).abs().max().item()
    max_abs = (out.float() - ref.float()).abs().max().item()
    print(f"kernel bf16 {MAIN_SHAPE} (main-path shape): out rel-L2 {rel:.3e}, "
          f"max-abs {max_abs:.3e}, lse max-abs {e_lse:.3e} (bars 1e-2)", flush=True)
    if not (rel <= 1e-2 and e_lse <= 1e-2):
        raise AssertionError("bf16 kernel disagrees with its plain version at the main shape")
    del out, lse, ref, ref_lse
    with torch.inference_mode():
        kern_ms = _time_ms(lambda: fa.flash_attention_with_lse(q, k, v), iters=20, warmup=3)
        plain_ms = _time_ms(lambda: fa.flash_attention_ref_with_lse(q, k, v, scale), iters=2)
    b, s, h, d = MAIN_SHAPE
    tflop = 4 * b * h * s * s * d / 1e12
    print(f"[{card}] flash fwd {MAIN_SHAPE} bf16: kernel {kern_ms:.3f} ms "
          f"({tflop / kern_ms * 1e3:.1f} TFLOP/s), plain {plain_ms:.3f} ms "
          f"({tflop / plain_ms * 1e3:.1f} TFLOP/s)", flush=True)

    video = torch.randn(16, 16, 224, 224, 3, device="cuda", generator=g)
    with torch.inference_mode():
        _set_attn_impl(model, "kernel")
        fwd_k = _time_ms(lambda: model(video), iters=3)
        # the plain route's fp32 scores are ~4.3 GB per layer for 4 clips:
        # it runs the batch in chunks of 4
        _set_attn_impl(model, "plain")
        fwd_p = _time_ms(lambda: [model(c) for c in video.split(4)], iters=1)
    print(f"[{card}] InternVideo2-1B fwd 16x224 bf16 B=16: kernel route {fwd_k:.1f} ms "
          f"= {16e3 / fwd_k:.2f} clips/s; plain route {fwd_p:.1f} ms "
          f"= {16e3 / fwd_p:.2f} clips/s", flush=True)
    return kern_ms, plain_ms, max_abs


def check_backward(fa) -> dict:
    """Phase 7; returns the max-abs errors of dq and of dk/dv at TRAIN_SHAPE
    bf16, the shape the main path gives the kernels."""
    g = torch.Generator("cuda").manual_seed(3)

    def grads(q, k, v, do, gl=None):
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out, lse = fa.flash_attention_with_lse(q, k, v)
        loss = (out.float() * do.float()).sum()
        if gl is not None:
            loss = loss + (lse * gl).sum()
        got = torch.autograd.grad(loss, (q, k, v))
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(),
                                         lse.detach(), do, q.shape[-1] ** -0.5, lse_ct=gl)
        return got, ref

    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    cases = [(2, 256, 256, 2, 64, False), (1, 257, 257, 2, 88, False),
             (1, 256, 263, 2, 64, False), (1, 263, 256, 2, 64, False),
             (1, 257, 257, 2, 88, True)]
    for b, sq, sk, h, d, with_lse in cases:
        q, do = rnd(b, sq, h, d), rnd(b, sq, h, d)
        k, v = rnd(b, sk, h, d), rnd(b, sk, h, d)
        gl = rnd(b, h, sq) if with_lse else None
        got, ref = grads(q, k, v, do, gl)
        errs = [(x - r).abs().max().item() for x, r in zip(got, ref)]
        print(f"bwd kernels fp32 {(b, sq, sk, h, d)}{' + dLSE' if with_lse else ''}: "
              f"dq/dk/dv max-abs {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (bar 5e-4)",
              flush=True)
        if not max(errs) <= 5e-4:
            raise AssertionError("fp32 backward kernels disagree with their plain version")

    out = {}
    for b, with_lse in ((TRAIN_SHAPE[0], False), (2, True)):
        _, s, h, d = TRAIN_SHAPE
        qkv = rnd(b, s, 3 * h * d).bfloat16()
        q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
        do = rnd(b, s, h, d).bfloat16()
        gl = rnd(b, h, s) if with_lse else None
        got, ref = grads(q, k, v, do, gl)
        rels = [_rel(x, r) for x, r in zip(got, ref)]
        errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
        print(f"bwd kernels bf16 {(b, s, s, h, d)} strided qkv views"
              f"{' + dLSE' if with_lse else ''}: dq/dk/dv rel-L2 {rels[0]:.3e} / "
              f"{rels[1]:.3e} / {rels[2]:.3e} (bar 1e-2), max-abs {errs[0]:.3e} / "
              f"{errs[1]:.3e} / {errs[2]:.3e}", flush=True)
        if not max(rels) <= 1e-2:
            raise AssertionError("bf16 backward kernels disagree with their plain version")
        if not with_lse:
            out = {"flash_bwd_dq": errs[0], "flash_bwd_dkv": max(errs[1:])}
        del qkv, q, k, v, do, got, ref
    return out


def run_train_path(fa) -> dict:
    """Phase 8; returns the launches of each kernel in the main-path run."""
    from internvideo_tpu_torch.cli import train as cli

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_TRAIN, "--device", "cuda",
                       f"trainer.total_steps={TRAIN_STEPS}", "trainer.log_every=1",
                       "trainer.checkpoint_dir=None"])
    torch.cuda.synchronize()
    launches = {name: fa.launch_count(name) for name in fa.KERNELS}
    wall = time.perf_counter() - t0
    records = [dict(kv.split(": ") for kv in line.split("  "))
               for line in buf.getvalue().splitlines() if line.startswith("step: ")]
    for r in records:
        print(f"cli.train {CONFIG_TRAIN}: {r}", flush=True)
    print(f"main path (train): {TRAIN_STEPS} steps in {wall:.1f} s wall incl. model init, "
          f"host data and the first call's build; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {launches}", flush=True)
    if rc != 0 or len(records) != TRAIN_STEPS:
        raise AssertionError(f"cli.train logged {len(records)} of {TRAIN_STEPS} steps")
    if not all(math.isfinite(float(r[k])) for r in records for k in ("loss", "grad_norm")):
        raise AssertionError("non-finite loss or grad_norm on the training main path")
    want = {**dict.fromkeys(fa.KERNELS, 0), "flash_fwd": 2 * DEPTH_1B * TRAIN_STEPS,
            "flash_bwd_dq": DEPTH_1B * TRAIN_STEPS, "flash_bwd_dkv": DEPTH_1B * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"launches {launches} on the training main path; expected "
                             f"{want} (80 forward incl. remat, 40 dq, 40 dk/dv per step)")
    return launches


def _train_model(run, **overrides):
    """The finetune config's model on the card, gammas 0.1 and the head at
    std ~0.02, so that every branch moves the loss."""
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2

    cfg = dataclasses.replace(run.model, drop_path_rate=0.0, **overrides)
    model = InternVideo2(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    _raise_gammas(model)
    with torch.no_grad():
        model.head.weight.mul_(1000)
    return model


def _loss_and_grads(model, video, labels, impl):
    from internvideo_tpu_torch.data.mixup import smoothed_one_hot
    from internvideo_tpu_torch.train.engines.finetune import soft_target_ce

    _set_attn_impl(model, impl)
    model.zero_grad(set_to_none=True)
    logits = model(video).logits
    loss = soft_target_ce(logits, smoothed_one_hot(labels, logits.shape[-1], 0.1))
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def check_train_routes(run):
    """Phase 9."""
    g = torch.Generator("cuda").manual_seed(4)
    c = run.model
    video = torch.randn(2, c.num_frames, c.img_size, c.img_size, 3, device="cuda", generator=g)
    labels = torch.randint(0, c.num_classes, (2,), device="cuda", generator=g)

    model = _train_model(run, depth=2, dtype="float32", param_dtype="float32", remat=False)
    (lk, gk), (lp, gp) = (_loss_and_grads(model, video, labels, i) for i in ("kernel", "plain"))
    errs = {n: (gk[n] - gp[n]).abs().max().item() for n in gk}
    worst = max(errs, key=errs.get)
    print(f"train fp32 1B widths depth 2 B=2, kernel vs plain route: loss {lk.item():.6f} / "
          f"{lp.item():.6f} (abs diff {abs(lk - lp).item():.3e}), worst grad max-abs "
          f"{errs[worst]:.3e} at {worst} (grad max {gp[worst].abs().max().item():.3e}); "
          f"bar 5e-4 on all {len(errs)} params", flush=True)
    if not (abs(lk - lp).item() <= 5e-4 and errs[worst] <= 5e-4):
        raise AssertionError("fp32 training routes disagree")
    del model, gk, gp

    model = _train_model(run)
    (lk, gk), (lp, gp) = (_loss_and_grads(model, video, labels, i) for i in ("kernel", "plain"))
    rel_loss = abs(lk - lp).item() / abs(lp).item()
    names = [f"blocks.{i}.attn.{w}.weight" for i in (0, DEPTH_1B - 1) for w in ("qkv", "q_norm")]
    rels = {n: _rel(gk[n], gp[n]) for n in names}
    print(f"train bf16 1B B=2, kernel vs plain route: loss {lk.item():.6f} / {lp.item():.6f} "
          f"(rel {rel_loss:.3e}, bar 1e-2); grad rel-L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels.items()) + " (bar 2e-2)", flush=True)
    if not (rel_loss <= 1e-2 and max(rels.values()) <= 2e-2):
        raise AssertionError("bf16 training routes disagree")


def _sdpa_times(shape, card) -> dict:
    """PyTorch's flash SDPA at `shape` (B, S, H, D) bf16, as a yardstick:
    forward, backward alone (the aten backward op) and forward + backward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, h, d = shape
    g = torch.Generator("cuda").manual_seed(5)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
                   .transpose(1, 2) for _ in range(4))
    aten = torch.ops.aten
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10, warmup=2)
        r = aten._scaled_dot_product_flash_attention(q, k, v, 0.0, False, False)
        bwd = _time_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, r[0], r[1], r[2], r[3], r[4], r[5], 0.0, False, r[6], r[7]),
            iters=10, warmup=2)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        both = _time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves), leaves, do), iters=10, warmup=2)
    print(f"[{card}] yardstick torch flash SDPA {shape} bf16: fwd {fwd:.3f} ms, bwd "
          f"{bwd:.3f} ms, fwd+bwd {both:.3f} ms", flush=True)
    return {"fwd": fwd, "bwd": bwd, "fwd_bwd": both}


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "int8_" in n:  # K7's row quantizer and GEMM
        return "int8_gemm"
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "small_s_fwd", "small_s_bwd_dq",
                "small_s_bwd_dkv", "fused_qkv_fwd", "fused_qkv_rstd", "causal_fwd", "causal_bwd_dq",
                "causal_bwd_dkv", "paged_decode"):
        if key in n:
            return key
    if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "GEMMs (cuBLAS)"
    if "adam" in n or "multi_tensor" in n:
        return "optimizer (AdamW, norms)"
    return "elementwise / reductions / copies"


def profile_step(step, card, what: str = "train step") -> dict:
    """One step under torch.profiler: device time by kernel group and the
    device's idle share of the step's wall time. Returns {"wall_ms",
    "busy_ms", "groups"} (busy_ms None when the profiler saw no device
    time). Only device activity is traced: host-op tracing added its own
    host time to the wall and took ~29 s to trace and summarise one ~3.4 s
    audio-visual step (tools_torch/probe_clip_av.py), and the groups read
    device events alone."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups, launches = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + evt.self_device_time_total / 1e3
        launches[g] = launches.get(g, 0) + evt.count
    busy = sum(groups.values())
    if not busy:
        print(f"[{card}] {what} profile: the profiler saw no device time; breakdown "
              f"not measured (step wall {wall:.1f} ms)", flush=True)
        return {"wall_ms": wall, "busy_ms": None, "groups": {}}
    print(f"[{card}] {what} under torch.profiler: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle {max(0.0, 1 - busy / wall):.1%}", flush=True)
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {t:.1f} ms ({t / busy:.1%} of device time, {launches[g]} launches)",
              flush=True)
    return {"wall_ms": wall, "busy_ms": busy, "groups": groups}


def time_train(fa, run, card) -> dict:
    """Phase 10; returns each backward kernel's ms, the plain backward's ms
    and the SDPA yardsticks."""
    b, s, h, d = TRAIN_SHAPE
    g = torch.Generator("cuda").manual_seed(6)
    q, k, v, do = (torch.randn(*TRAIN_SHAPE, device="cuda", generator=g).bfloat16()
                   for _ in range(4))
    scale = d ** -0.5
    with torch.no_grad():
        out, lse = fa._flash_fwd_cuda(q, k, v, scale)
        delta = fa._bwd_delta(out, do)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        ms = {
            "flash_fwd": _time_ms(lambda: fa._flash_fwd_cuda(q, k, v, scale), iters=10, warmup=2),
            "flash_bwd_dq": _time_ms(lambda: fa._launch_bwd(
                "flash_bwd_dq", q, k, v, do, lse, delta, (dq,), scale), iters=10, warmup=2),
            "flash_bwd_dkv": _time_ms(lambda: fa._launch_bwd(
                "flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), scale), iters=10, warmup=2),
            "plain_bwd": _time_ms(lambda: fa.flash_attention_bwd_ref(
                q, k, v, out, lse, do, scale), iters=2),
        }
    tflop = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}
    for name, n in tflop.items():
        rate = n * b * h * s * s * d / ms[name] / 1e9
        print(f"[{card}] {name} {TRAIN_SHAPE} bf16: {ms[name]:.3f} ms ({rate:.1f} TFLOP/s)",
              flush=True)
    print(f"[{card}] plain backward {TRAIN_SHAPE} bf16 (dq, dk, dv together): "
          f"{ms['plain_bwd']:.3f} ms", flush=True)
    del q, k, v, do, out, lse, delta, dq, dk, dv
    sdpa = {"train": _sdpa_times(TRAIN_SHAPE, card), "eval": _sdpa_times(MAIN_SHAPE, card)}

    ms["train_step"] = time_finetune_step(run, card, profile=True)
    ms["sdpa"] = sdpa
    return ms


def time_finetune_step(run, card, profile: bool = False) -> float:
    """Phase 10's train step: the finetune config's trainer at B = 32 on a
    device-resident batch (CUDA events, 3 steps after 1); with `profile`
    one more step under torch.profiler. Returns the step's ms."""
    from internvideo_tpu_torch.cli import train as cli

    b = TRAIN_SHAPE[0]
    g = torch.Generator("cuda").manual_seed(6)
    trainer, _ = cli.build_finetune(dataclasses.replace(
        run, trainer=dataclasses.replace(run.trainer, checkpoint_dir=None)), torch.device("cuda"))
    c = run.model
    batch = {"video": torch.randn(b, c.num_frames, c.img_size, c.img_size, 3, device="cuda",
                                  generator=g),
             "label": torch.randint(0, c.num_classes, (b,), device="cuda", generator=g)}
    step_ms = _time_ms(lambda: trainer._step(trainer.state, batch), iters=3, warmup=1)
    print(f"[{card}] InternVideo2-1B finetune train step 8x224 bf16 B={b} (remat, drop-path, "
          f"mixup/cutmix, AdamW), device-resident batch: {step_ms:.1f} ms = "
          f"{b * 1e3 / step_ms:.2f} clips/s", flush=True)
    if profile:
        profile_step(lambda: trainer._step(trainer.state, batch), card)
    return step_ms


def _qkv_views(b, s, h, d, g, dtype=torch.bfloat16):
    """q, k, v as (B, S, H, D) views into one (B, S, 3W) tensor."""
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g).to(dtype)
    return qkv, [x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1)]


def _small_s_grads(fa, q, k, v, do):
    """(out, (dq, dk, dv)) through SmallSAttention (K2, K4b)."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fa.SmallSAttention.apply(q, k, v, q.shape[-1] ** -0.5)
    return out, torch.autograd.grad((out.float() * do.float()).sum(), (q, k, v))


def _fused_grads(fa, qkv, qw, kw, h, do):
    """(out, (dqkv, dqw, dkw)) through FusedQKVAttention (K3; K2, K4b)."""
    leaves = [x.detach().requires_grad_() for x in (qkv, qw, kw)]
    out = fa.fused_qkv_rmsnorm_attention(*leaves, num_heads=h)
    return out, torch.autograd.grad((out.float() * do.float()).sum(), leaves)


def _fused_ref_grads(fa, qkv, qw, kw, h, do):
    leaves = [x.detach().requires_grad_() for x in (qkv, qw, kw)]
    out = fa.fused_qkv_ref(*leaves, h, (qkv.shape[-1] // 3 // h) ** -0.5)
    return out, torch.autograd.grad((out.float() * do.float()).sum(), leaves)


def check_pretrain_kernels(fa) -> dict:
    """Phase 11; returns each new kernel's max-abs error at its path shape
    in bf16 (the K3 entries: the op's output)."""
    g = torch.Generator("cuda").manual_seed(7)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    for b, s, h, d in [(2, 205, 4, 88), (1, 413, 8, 88), (2, 257, 4, 128), (1, 300, 2, 64)]:
        q, k, v, do = (rnd(b, s, h, d) for _ in range(4))
        out, got = _small_s_grads(fa, q, k, v, do)
        ref, lse = fa.small_s_attention_ref(q, k, v, d ** -0.5)
        refs = fa.small_s_attention_bwd_ref(q, k, v, ref, lse, do, d ** -0.5)
        e_out = (out - ref).abs().max().item()
        errs = [(x - r).abs().max().item() for x, r in zip(got, refs)]
        qkv, qw, kw = rnd(b, s, 3 * h * d) * 2, rnd(h * d) * 0.1 + 1, rnd(h * d) * 0.1 + 1
        fout, fgot = _fused_grads(fa, qkv, qw, kw, h, do.flatten(-2))
        fref, frefs = _fused_ref_grads(fa, qkv, qw, kw, h, do.flatten(-2))
        torch.cuda.synchronize()
        e_fout = (fout - fref).abs().max().item()
        ferrs = [((x - r).abs() / (1 + r.abs())).max().item() for x, r in zip(fgot, frefs)]
        print(f"pretrain kernels fp32 {(b, s, h, d)}: K2 out max-abs {e_out:.3e} (bar 2e-5), "
              f"K4b dq/dk/dv max-abs {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (bar 5e-4); "
              f"K3 out max-abs {e_fout:.3e} (bar 2e-5), grads qkv/qw/kw max |err|/(1+|ref|) "
              f"{ferrs[0]:.3e} / {ferrs[1]:.3e} / {ferrs[2]:.3e} (bar 5e-4)", flush=True)
        if not (e_out <= 2e-5 and max(errs) <= 5e-4 and e_fout <= 2e-5 and max(ferrs) <= 5e-4):
            raise AssertionError("fp32 pretrain kernels disagree with their plain versions")

    out_err = {}
    b, s, h, d = PRETRAIN_SHAPE
    _, (q, k, v) = _qkv_views(b, s, h, d, g)
    do = rnd(b, s, h, d).bfloat16()
    out, got = _small_s_grads(fa, q, k, v, do)
    ref, lse = fa.small_s_attention_ref(q, k, v, d ** -0.5)
    refs = fa.small_s_attention_bwd_ref(q, k, v, ref, lse, do, d ** -0.5)
    torch.cuda.synchronize()
    rels = [_rel(x, r) for x, r in zip((out, *got), (ref, *refs))]
    errs = [(x.float() - r.float()).abs().max().item() for x, r in zip((out, *got), (ref, *refs))]
    print(f"K2 / K4b bf16 {PRETRAIN_SHAPE} strided qkv views: out/dq/dk/dv rel-L2 "
          + " / ".join(f"{r:.3e}" for r in rels) + " (bar 1e-2), max-abs "
          + " / ".join(f"{e:.3e}" for e in errs), flush=True)
    if not max(rels) <= 1e-2:
        raise AssertionError("bf16 small-S kernels disagree with their plain versions")
    out_err.update(small_s_fwd=errs[0], small_s_bwd_dq=errs[1], small_s_bwd_dkv=max(errs[2:]))
    del q, k, v, do, out, got, ref, lse, refs

    for b, s, h, d in (PRETRAIN_SHAPE, TEACHER_SHAPE):
        w = h * d
        qkv = (rnd(b, s, 3 * w) * 2).bfloat16()
        qw, kw = rnd(w) * 0.1 + 1, rnd(w) * 0.1 + 1
        fout = fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
        q_rstd = torch.rsqrt(qkv[..., :w].float().square().mean(-1) + 1e-6)
        fref = fa.fused_qkv_ref(qkv, qw, kw, h, d ** -0.5)
        torch.cuda.synchronize()
        rel = _rel(fout, fref)
        err = (fout.float() - fref.float()).abs().max().item()
        print(f"K3 bf16 {(b, s, h, d)} (W {w}): out rel-L2 {rel:.3e} (bar 1e-2), max-abs "
              f"{err:.3e}; q 1/rms range {q_rstd.min().item():.3f}-{q_rstd.max().item():.3f}",
              flush=True)
        if not rel <= 1e-2:
            raise AssertionError(f"bf16 fused qkv kernel disagrees with its plain version at "
                                 f"{(b, s, h, d)}")
        out_err["fused_qkv_fwd" if s == PRETRAIN_SHAPE[1] else "fused_qkv_fwd_teacher"] = err
        del qkv, fout, fref
    b, s, h, d = PRETRAIN_SHAPE
    qkv = (rnd(2, s, 3 * h * d) * 2).bfloat16()
    qw, kw = rnd(h * d) * 0.1 + 1, rnd(h * d) * 0.1 + 1
    do = rnd(2, s, h * d).bfloat16()
    _, fgot = _fused_grads(fa, qkv, qw, kw, h, do)
    _, frefs = _fused_ref_grads(fa, qkv, qw, kw, h, do)
    rels = [_rel(x, r) for x, r in zip(fgot, frefs)]
    print(f"K3 backward (unfused composition through K2 / K4b) bf16 (2, {s}, {h}, {d}): "
          f"qkv/qw/kw grads rel-L2 " + " / ".join(f"{r:.3e}" for r in rels) + " (bar 2e-2)",
          flush=True)
    if not max(rels) <= 2e-2:
        raise AssertionError("bf16 fused qkv gradients disagree with the plain composition")
    _fwd_edges_bf16(fa, "small_s_fwd", fa.SMALL_S_HEAD_DIMS, FWD_TILE_EDGES + [(196, 196)], g)
    _bwd_edges_bf16(fa, g)
    _fused_edges_bf16(fa, g)
    return out_err


def _pretrain_want(fa, steps: int) -> dict:
    """Launches of each kernel in `steps` pretrain steps at the 1B recipe."""
    per_step = {"fused_qkv_fwd": 2 * DEPTH_1B + 48, "fused_qkv_rstd": 2 * DEPTH_1B + 48,
                "small_s_fwd": DEPTH_1B, "small_s_bwd_dq": DEPTH_1B,
                "small_s_bwd_dkv": DEPTH_1B, "flash_fwd": 40}
    return {n: per_step.get(n, 0) * steps for n in fa.KERNELS}


def run_pretrain_path(fa, card) -> tuple:
    """Phase 12; returns the launches of each kernel in the main-path run
    and K3's launches by sequence length there."""
    from internvideo_tpu_torch.cli import train as cli

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_PRETRAIN, "--device", "cuda",
                       f"trainer.total_steps={PRETRAIN_STEPS}", "trainer.log_every=1",
                       "trainer.checkpoint_dir=None"])
    torch.cuda.synchronize()
    launches = {name: fa.launch_count(name) for name in fa.KERNELS}
    k3_by_len = fa.fused_launch_counts("fused_qkv_fwd")
    wall = time.perf_counter() - t0
    records = [dict(kv.split(": ") for kv in line.split("  "))
               for line in buf.getvalue().splitlines() if line.startswith("step: ")]
    for r in records:
        print(f"cli.train {CONFIG_PRETRAIN}: {r}", flush=True)
    print(f"[{card}] main path (pretrain): {PRETRAIN_STEPS} steps in {wall:.1f} s wall incl. "
          f"model and teacher init and host data; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {launches}", flush=True)
    if rc != 0 or len(records) != PRETRAIN_STEPS:
        raise AssertionError(f"cli.train logged {len(records)} of {PRETRAIN_STEPS} steps")
    keys = ("loss", "loss_clip_middle", "loss_clip_final", "loss_mae", "grad_norm")
    if not all(math.isfinite(float(r[k])) for r in records for k in keys):
        raise AssertionError("non-finite loss, loss term or grad_norm on the pretrain path")
    want = _pretrain_want(fa, PRETRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"launches {launches} on the pretrain main path; expected {want} "
                             "(per step: 128 K3 = 40 student + 40 remat + 48 CLIP teacher, "
                             "40 K2 / K4b dq / K4b dk/dv, 40 K1 for the MAE teacher)")
    want_by_len = {PRETRAIN_SHAPE[1]: 2 * DEPTH_1B * PRETRAIN_STEPS,
                   TEACHER_SHAPE[1]: 48 * PRETRAIN_STEPS}
    print(f"[{card}] main path (pretrain): K3 launches by sequence length {k3_by_len}", flush=True)
    if k3_by_len != want_by_len:
        raise AssertionError(f"K3 launches by sequence length {k3_by_len} on the pretrain main "
                             f"path; expected {want_by_len} (per step 40 student + 40 remat at "
                             f"S {PRETRAIN_SHAPE[1]}, 48 CLIP teacher at S {TEACHER_SHAPE[1]})")
    return launches, k3_by_len


def _pretrain_models(run, td_frames: int):
    """The recipe's student (drop-path off, gammas 0.1) and frozen teachers."""
    from internvideo_tpu_torch.models.pretrain import PretrainInternVideo2
    from internvideo_tpu_torch.models.teachers import CLIPTeacher, MAETeacher
    from internvideo_tpu_torch.train.state import frozen_teacher

    gen = lambda s: torch.Generator("cuda").manual_seed(s)  # noqa: E731
    cfg = dataclasses.replace(run.model, encoder=dataclasses.replace(
        run.model.encoder, drop_path_rate=0.0))
    student = PretrainInternVideo2(cfg, device="cuda", generator=gen(0))
    _raise_gammas(student)
    clip_t = frozen_teacher(CLIPTeacher(run.teacher, device="cuda", generator=gen(1)))
    mae_t = frozen_teacher(MAETeacher(run.mae_teacher, num_frames=td_frames, device="cuda",
                                      generator=gen(2)))
    return student, clip_t, mae_t


def check_pretrain_routes(run) -> None:
    """Phase 13."""
    from internvideo_tpu_torch.train.engines.pretrain import draw_keep_indices, pretrain_loss

    enc, eng = run.model.encoder, run.engine
    t_full = enc.num_frames * eng.td_ratio
    student, clip_t, mae_t = _pretrain_models(run, t_full)
    g = torch.Generator("cuda").manual_seed(8)
    video = torch.randn(2, t_full, enc.img_size, enc.img_size, 3, device="cuda", generator=g)
    teach = {}
    for impl in ("kernel", "plain"):
        for m in (student, clip_t, mae_t):
            _set_attn_impl(m, impl)
        with torch.no_grad():
            teach[impl] = (*clip_t(video[:, ::eng.td_ratio]), mae_t(video))
    rels = {n: _rel(k, p) for n, k, p in zip(("clip z", "clip pooled", "clip attn", "mae z"),
                                             teach["kernel"], teach["plain"])}
    # 2e-2, the grads' bar: the 48-block bf16 CLIP tower carries each
    # layer's rounding differences (~2e-3 per K3 call, phase 11) forward
    print("pretrain teachers B=2, kernel vs plain route: rel-L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels.items()) + " (bar 2e-2)", flush=True)
    if not max(rels.values()) <= 2e-2:
        raise AssertionError("teacher routes disagree")
    keep = draw_keep_indices(eng, g, teach["kernel"][2], 2, enc.num_frames // enc.tubelet_size)
    del teach

    names = [f"encoder.blocks.{i}.attn.{w}.weight" for i in (0, DEPTH_1B - 1)
             for w in ("qkv", "q_norm")] + ["clip_decoder.0.head.weight"]
    res = {}
    for impl in ("kernel", "plain"):
        for m in (student, clip_t, mae_t):
            _set_attn_impl(m, impl)
        student.zero_grad(set_to_none=True)
        loss, _, _ = pretrain_loss(student, clip_t, mae_t, eng, video, keep=keep,
                                   deterministic=True)
        loss.backward()
        params = dict(student.named_parameters())
        res[impl] = (loss.item(), {n: params[n].grad.detach().clone() for n in names})
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    grels = {n: _rel(gk[n], gp[n]) for n in names}
    print(f"pretrain bf16 full widths B=2 (same keep indices), kernel vs plain route: loss "
          f"{lk:.6f} / {lp:.6f} (rel {rel_loss:.3e}, bar 1e-2); grad rel-L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in grels.items()) + " (bar 2e-2)", flush=True)
    if not (math.isfinite(lk) and rel_loss <= 1e-2 and max(grels.values()) <= 2e-2):
        raise AssertionError("pretrain routes disagree")


def _sdpa_fwd_ms(q, k, v) -> float:
    """torch's flash SDPA forward on (B, S, H, D) inputs (yardstick only)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10, warmup=2)


def _sdpa_bwd_ms(q, k, v, do) -> float:
    """torch's flash SDPA backward alone (the aten op) (yardstick only)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    aten = torch.ops.aten
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        r = aten._scaled_dot_product_flash_attention(q, k, v, 0.0, False, False)
        return _time_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, r[0], r[1], r[2], r[3], r[4], r[5], 0.0, False, r[6], r[7]),
            iters=10, warmup=2)


def time_pretrain_kernels(fa, card) -> dict:
    """Phase 14, kernels: ms, plain ms, bound and SDPA yardstick of each new
    kernel at its path shape."""
    from internvideo_tpu_torch.ops import _build
    from internvideo_tpu_torch.ops.rmsnorm import rms_norm

    lib = _build.load_library()
    g = torch.Generator("cuda").manual_seed(9)
    res = {}
    b, s, h, d = PRETRAIN_SHAPE
    scale = d ** -0.5
    _, (q, k, v) = _qkv_views(b, s, h, d, g)
    do = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    with torch.no_grad():
        out, lse = fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd")
        delta = fa._bwd_delta(out, do)
        dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device="cuda") for x in (q, k, v))
        res["small_s_fwd"] = dict(
            ms=_time_ms(lambda: fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd"),
                        iters=20, warmup=2),
            plain_ms=_time_ms(lambda: fa.small_s_attention_ref(q, k, v, scale), iters=2),
            library_ms=_sdpa_fwd_ms(q, k, v))
        plain_bwd = _time_ms(lambda: fa.small_s_attention_bwd_ref(q, k, v, out, lse, do, scale),
                             iters=2)
        sdpa_bwd = _sdpa_bwd_ms(q, k, v, do)
        for name, outs in (("small_s_bwd_dq", (dq,)), ("small_s_bwd_dkv", (dk, dv))):
            res[name] = dict(
                ms=_time_ms(lambda: fa._launch_bwd(name, q, k, v, do, lse, delta, outs, scale),
                            iters=20, warmup=2),
                plain_ms=plain_bwd, library_ms=sdpa_bwd)
    io_bytes = 4 * b * s * h * d * 2 + 2 * b * h * s * 4  # q, k, v, dO; lse, delta
    res["small_s_fwd"]["bound"] = _fwd_bound(b, s, h, d)
    res["small_s_bwd_dq"]["bound"] = _bound(6 * b * h * s * s * d, io_bytes + b * s * h * d * 2)
    res["small_s_bwd_dkv"]["bound"] = _bound(8 * b * h * s * s * d,
                                             io_bytes + 2 * b * s * h * d * 2)
    del q, k, v, do, out, lse, delta, dq, dk, dv

    b, s, h, d = MAE_TEACHER_SHAPE  # K1 in the MAE teacher (qkv views, as its Block gives)
    _, (q, k, v) = _qkv_views(b, s, h, d, g)
    with torch.no_grad():
        res["flash_fwd_mae_teacher"] = dict(
            ms=_time_ms(lambda: fa._flash_fwd_cuda(q, k, v, d ** -0.5), iters=10, warmup=2),
            plain_ms=_time_ms(lambda: fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5),
                              iters=1),
            library_ms=_sdpa_fwd_ms(q, k, v),
            bound=_fwd_bound(b, s, h, d))
    del q, k, v

    for tag, (b, s, h, d) in (("student", PRETRAIN_SHAPE), ("teacher", TEACHER_SHAPE)):
        w = h * d
        qkv = (torch.randn(b, s, 3 * w, device="cuda", generator=g) * 2).bfloat16()
        qw, kw = (torch.randn(w, device="cuda", generator=g) * 0.1 + 1 for _ in range(2))
        q_rstd, k_rstd = (torch.empty(b, s, device="cuda") for _ in range(2))
        stream = torch.cuda.current_stream().cuda_stream

        def rstd():
            lib.ivt_fused_qkv_rstd(1, qkv.data_ptr(), q_rstd.data_ptr(), k_rstd.data_ptr(),
                                   b, s, w, qkv.stride(0), qkv.stride(1), 1e-6, stream)

        def rstd_plain():
            return [torch.rsqrt(qkv[..., i * w:(i + 1) * w].float().square().mean(-1) + 1e-6)
                    for i in (0, 1)]

        with torch.no_grad():
            op_ms = _time_ms(lambda: fa._fused_qkv_cuda(qkv, qw, kw, h, d ** -0.5, 1e-6),
                             iters=10, warmup=2)
            rstd_ms = _time_ms(rstd, iters=20, warmup=2)
            rstd_plain_ms = _time_ms(rstd_plain, iters=5)
            ref_q, ref_k = rstd_plain()
            rstd_err = max((q_rstd - ref_q).abs().max().item(), (k_rstd - ref_k).abs().max().item())
            plain_ms = _time_ms(lambda: fa.fused_qkv_ref(qkv, qw, kw, h, d ** -0.5), iters=1)
            qn = rms_norm(qkv[..., :w], qw).unflatten(-1, (h, d))
            kn = rms_norm(qkv[..., w:2 * w], kw).unflatten(-1, (h, d))
            lib_ms = _sdpa_fwd_ms(qn, kn, qkv[..., 2 * w:].unflatten(-1, (h, d)))
        qkv_bytes, rows = 3 * b * s * w * 2, 2 * b * s * 4
        res[f"fused_qkv_{tag}"] = dict(
            ms=op_ms, attn_ms=op_ms - rstd_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound=_bound(4 * b * h * s * s * d, qkv_bytes + b * s * w * 2 + 2 * w * 4))
        res[f"fused_qkv_rstd_{tag}"] = dict(
            ms=rstd_ms, plain_ms=rstd_plain_ms, library_ms=None, err=rstd_err,
            bound=_bound(0, 2 * b * s * w * 2 + rows))
        del qkv, qn, kn, q_rstd, k_rstd
    for name, r in res.items():
        print(f"[{card}] {name}: kernel {r['ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
              f"({r['bound'][1]}), plain {r['plain_ms']:.3f} ms, SDPA yardstick "
              + (f"{r['library_ms']:.3f} ms" if r["library_ms"] is not None else "n/a"),
              flush=True)
    return res


def time_pretrain_step(fa, run, card) -> dict:
    """Phase 14, step: the pretrain step at B = 32 on a device-resident batch,
    split into the two teachers and the student's part; then one step under
    torch.profiler."""
    from internvideo_tpu_torch.cli import train as cli

    trainer, shape, (clip_t, mae_t) = cli.build_pretrain(dataclasses.replace(
        run, trainer=dataclasses.replace(run.trainer, checkpoint_dir=None)), torch.device("cuda"))
    g = torch.Generator("cuda").manual_seed(10)
    batch = {"video": torch.randn(*shape, device="cuda", generator=g)}
    step_ms = _time_ms(lambda: trainer._step(trainer.state, batch), iters=2, warmup=1)
    sv = batch["video"][:, ::run.engine.td_ratio]
    with torch.no_grad():
        clip_ms = _time_ms(lambda: clip_t(sv), iters=2, warmup=1)
        mae_ms = _time_ms(lambda: mae_t(batch["video"]), iters=2, warmup=1)
    b = shape[0]
    print(f"[{card}] InternVideo2-1B UMT pretrain step 16x224 (S = 833) + CLIP-6B + MAE-g14 "
          f"teachers bf16 B={b}, device-resident batch: {step_ms:.1f} ms = "
          f"{b * 1e3 / step_ms:.2f} clips/s; CLIP teacher {clip_ms:.1f} ms, MAE teacher "
          f"{mae_ms:.1f} ms, student forward + backward + update (the rest) "
          f"{step_ms - clip_ms - mae_ms:.1f} ms", flush=True)
    profile_step(lambda: trainer._step(trainer.state, batch), card, "pretrain step")
    return {"step_ms": step_ms, "clip_ms": clip_ms, "mae_ms": mae_ms}


def _llm(preset: str, seed: int = 0, **overrides):
    """The preset's MLATransformer on the card with seeded weights (the
    generate CLI's init for `--seed seed`), in eval mode."""
    from internvideo_tpu_torch.models import presets
    from internvideo_tpu_torch.models.llm import MLATransformer

    cfg = getattr(presets, preset)(**overrides)
    return MLATransformer(cfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(seed)).eval()


def _set_llm_impl(model, impl: str) -> None:
    from internvideo_tpu_torch.nn.mla import MLAttention

    for m in model.modules():
        if isinstance(m, MLAttention):
            m.attn_impl = impl


def _serve_counts(fa, pd) -> dict:
    return {**{n: fa.launch_count(n) for n in fa.KERNELS}, "paged_decode": pd.launch_count()}


def _serve_reset(fa, pd) -> None:
    fa.reset_launch_count()
    pd.reset_launch_count()


def check_causal_kernel(fa) -> float:
    """Phase 15; returns K5's max-abs error at CAUSAL_SHAPE in bf16."""
    g = torch.Generator("cuda").manual_seed(15)
    for b, sq, sk, h, d, dv, causal, off in [(1, 200, 200, 2, 64, 64, True, 0),
                                            (1, 72, 200, 2, 64, 64, True, 128),
                                            (2, 200, 200, 4, 64, 32, True, 0),
                                            (2, 200, 200, 4, 64, 32, False, 0)]:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g)
        k = torch.randn(b, sk, h, d, device="cuda", generator=g)
        v = torch.randn(b, sk, h, dv, device="cuda", generator=g)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, q_position_offset=off)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, causal, off)
        e_out, e_lse = (out - ref).abs().max().item(), (lse - ref_lse).abs().max().item()
        print(f"K5 fp32 {(b, sq, sk, h, d, dv)} causal={causal} offset={off}: out max-abs "
              f"{e_out:.3e}, lse max-abs {e_lse:.3e} (bar 2e-5)", flush=True)
        if not (e_out <= 2e-5 and e_lse <= 2e-5):
            raise AssertionError("fp32 causal flash kernel disagrees with its plain version")
    err = None
    for b, s, h, d, dv in (CAUSAL_SHAPE, CAUSAL_SHAPE_2B):
        q = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
        kv = torch.randn(b, s, h, d + dv, device="cuda", generator=g).bfloat16()
        k, v = kv[..., :d], kv[..., d:]  # strided views of one tensor
        before = fa.launch_count("flash_fwd_causal")
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        torch.cuda.synchronize()
        if fa.launch_count("flash_fwd_causal") != before + 1:
            raise AssertionError("the causal call did not launch K5")
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True)
        rel, e_lse = _rel(out, ref), (lse - ref_lse).abs().max().item()
        max_abs = (out.float() - ref.float()).abs().max().item()
        print(f"K5 bf16 {(b, s, h, d, dv)} causal, k/v strided views: out rel-L2 {rel:.3e} "
              f"(bar 1e-2), max-abs {max_abs:.3e}, lse max-abs {e_lse:.3e}", flush=True)
        if not rel <= 1e-2:
            raise AssertionError(f"bf16 causal flash kernel disagrees at {(b, s, h, d, dv)}")
        err = max_abs if err is None else err
        del q, kv, k, v, out, lse, ref, ref_lse
    check_causal_tile_edges(fa, g)
    return err


# Phase 15's tile-edge cases, bf16 at both MLA pairs: (B, Sq, Sk, Hq, Hkv,
# keyword arguments) across the kernel's 128-row query tile and its 64-key
# tiles: one row, a tile less or more one row, the HiCo prompt's 1056 rows,
# fewer keys than queries, query offsets no multiple of 128, a window edge
# inside a key tile, segment boundaries inside tiles with whole tiles of
# pads (-1), groups of 4 and 8.
K5_EDGE_CASES = [
    (1, 1, 300, 2, 2, dict(causal=True, q_position_offset=299)),
    (1, 127, 127, 2, 2, dict(causal=True)),
    (1, 129, 129, 2, 2, dict(causal=True)),
    (1, 1056, 1056, 4, 4, dict(causal=True)),
    (1, 300, 200, 2, 2, dict(causal=True)),
    (1, 129, 400, 2, 2, dict(causal=True, q_position_offset=203)),
    (1, 100, 1100, 2, 2, dict(causal=True, q_position_offset=1000)),
    (1, 300, 300, 2, 2, dict(causal=True, window=100)),
    (1, 700, 700, 2, 2, dict(causal=True, segments=True)),
    (1, 257, 257, 8, 2, dict(causal=True)),
    (1, 257, 257, 8, 1, dict(causal=True)),
]


def _edge_segments(s: int) -> torch.Tensor:
    """(1, S) int32 ids: runs of 50, 80, 190 and 100 (boundaries inside 64-
    key tiles), then pads of -1 over whole key and query tiles."""
    lens = [50, 80, 190, 100]
    ids = np.repeat([0, 1, 2, 3, -1], lens + [s - sum(lens)])
    return torch.from_numpy(ids[None].astype(np.int32)).cuda()


def check_causal_tile_edges(fa, g) -> None:
    """Phase 15's tile edges: K5_EDGE_CASES at (256, 128) and (192, 128) in bf16,
    q at a base 16 bytes past a 128-byte boundary, k / v strided views of
    one tensor; out rel-L2 <= 1e-2, the finite LSE within 1e-2 and the same
    rows -inf as the plain version."""
    for d, dv in (CAUSAL_SHAPE[3:], CAUSAL_SHAPE_2B[3:]):
        worst = (0.0, 0.0)
        for b, sq, sk, hq, hkv, kw in K5_EDGE_CASES:
            kw = dict(kw)
            if kw.pop("segments", False):
                seg = _edge_segments(sq)
                kw.update(q_segment_ids=seg, kv_segment_ids=seg)
            n = b * sq * hq * d
            q = torch.randn(n + 8, device="cuda", generator=g).bfloat16()[8:].view(b, sq, hq, d)
            kv = torch.randn(b, sk, hkv, d + dv, device="cuda", generator=g).bfloat16()
            k, v = kv[..., :d], kv[..., d:]
            name = ("flash_fwd_causal_window" if kw.get("window") else "flash_fwd_causal_gqa"
                    if hkv != hq else "flash_fwd_causal_seg" if "q_segment_ids" in kw
                    else "flash_fwd_causal")
            before = fa.launch_count(name)
            out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
            torch.cuda.synchronize()
            if fa.launch_count(name) != before + 1:
                raise AssertionError(f"{(b, sq, sk, hq, hkv, d, dv)} {kw.keys()} did not "
                                     f"launch {name}")
            ref, ref_lse = fa.flash_attention_ref_with_lse(
                q, k, v, d ** -0.5, True, kw.get("q_position_offset", 0),
                kw.get("q_segment_ids"), kw.get("kv_segment_ids"), kw.get("window"))
            rel, e_lse = _rel(out, ref), _lse_err(lse, ref_lse)
            worst = (max(worst[0], rel), max(worst[1], e_lse))
            if not (rel <= 1e-2 and e_lse <= 1e-2):
                raise AssertionError(f"bf16 K5 disagrees at the tile edge {(b, sq, sk, hq, hkv)}"
                                     f" ({d}, {dv}) {kw.keys()}: rel-L2 {rel:.3e}, lse {e_lse}")
            del q, kv, k, v, out, lse, ref, ref_lse
        print(f"K5 bf16 ({d}, {dv}) tile edges, {len(K5_EDGE_CASES)} cases (Sq 1 / 127 / 129 / "
              f"1056, Sk < Sq, offsets 203 / 299 / 1000, window 100, segments mid-tile + a "
              f"pad tile, groups 4 / 8; q base +16 B, k / v strided views): worst out rel-L2 "
              f"{worst[0]:.3e} (bar 1e-2), lse max-abs {worst[1]:.3e}", flush=True)


def _paged_inputs(b, h, r, p_dim, page_size, max_pages, lens, dtype, seed):
    """A pool of b * max_pages pages plus a NaN trash page; shuffled tables
    whose unused columns point at it; slots past each length NaN too."""
    g = torch.Generator("cuda").manual_seed(seed)
    n_pages = b * max_pages
    pages = torch.randn(n_pages + 1, page_size, r + p_dim, device="cuda", generator=g)
    pages[n_pages] = float("nan")
    tables = torch.full((b, max_pages), n_pages, dtype=torch.int32)
    perm = torch.Generator().manual_seed(seed)
    for i, n_tok in enumerate(lens):
        n = -(-n_tok // page_size)
        tables[i, :n] = i * max_pages + torch.randperm(max_pages, generator=perm)[:n].int()
        pages[tables[i, n - 1], n_tok - (n - 1) * page_size:] = float("nan")
    q_lat = torch.randn(b, h, r, device="cuda", generator=g).to(dtype)
    q_pe = torch.randn(b, h, p_dim, device="cuda", generator=g).to(dtype)
    return (q_lat, q_pe, pages.to(dtype), tables.cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def check_paged_kernel(pd) -> float:
    """Phase 16; returns K6's max-abs error at DECODE_SHAPE in bf16."""
    for b, h, r, p_dim, ps, mp, lens in [(3, 4, 32, 16, 4, 5, [3, 9, 17]),
                                         (2, 32, 896, 128, 64, 4, [1, 200])]:
        q_lat, q_pe, pages, tables, sl = _paged_inputs(b, h, r, p_dim, ps, mp, lens,
                                                       torch.float32, 16)
        out = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=0.17)
        torch.cuda.synchronize()
        ref = pd.paged_mla_decode_ref(q_lat, q_pe, torch.nan_to_num(pages), tables, sl,
                                      softmax_scale=0.17)
        err = (out - ref).abs().max().item()
        print(f"K6 fp32 (B {b}, H {h}, R {r}, P {p_dim}, page {ps}) lens {lens}, NaN trash "
              f"page: max-abs {err:.3e} (bar 1e-4), finite {bool(torch.isfinite(out).all())}",
              flush=True)
        if not (torch.isfinite(out).all() and err <= 1e-4):
            raise AssertionError("fp32 paged decode kernel disagrees with its plain version")
    b, h, r, p_dim, ps = DECODE_SHAPE
    q_lat, q_pe, pages, tables, sl = _paged_inputs(b, h, r, p_dim, ps, 34, DECODE_LENS,
                                                   torch.bfloat16, 17)
    out = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=256 ** -0.5)
    ref = pd.paged_mla_decode_ref(q_lat, q_pe, torch.nan_to_num(pages), tables, sl,
                                  softmax_scale=256 ** -0.5)
    torch.cuda.synchronize()
    rel, err = _rel(out, ref), (out.float() - ref.float()).abs().max().item()
    print(f"K6 bf16 {DECODE_SHAPE} seq {DECODE_LENS[0]}-{DECODE_LENS[-1]}: rel-L2 {rel:.3e} "
          f"(bar 1e-2), max-abs {err:.3e}", flush=True)
    if not (torch.isfinite(out).all() and rel <= 1e-2):
        raise AssertionError("bf16 paged decode kernel disagrees with its plain version")
    _paged_edges_bf16(pd)
    return err


def _paged_edges_bf16(pd) -> None:
    """K6's bf16 kernel at B 1 and 8 and both serving paths' (H, R, P), page
    64, pools of 40 pages a sequence with NaN trash: lengths 0, 1, 63, 64,
    65 and either side of one and two split lengths (and 32,768 at B 1);
    rel-L2 <= 1e-2 against the plain version on the cleaned pool, 0 without
    tokens, two calls bit-identical."""
    worst, page = 0.0, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (1, 8):
        split = pd.split_len_bf16(b, 40 * page, sms)
        around = [split - 1, split, split + 1, 2 * split - 1, 2 * split + 1]
        if b == 1:
            cases = [[n] for n in [0, 1, page - 1, page, page + 1, *around, 32768]]
        else:
            cases = [[0, 1, page - 1, page, page + 1, 300, 1000, 2112],
                     around + [split - 1, split, split + 1]]
        for h, r, p_dim in ((32, 896, 128), (20, 512, 64)):
            for i, lens in enumerate(cases):
                mp = max(40, -(-max(lens) // page))
                q_lat, q_pe, pages, tables, sl = _paged_inputs(
                    b, h, r, p_dim, page, mp, [max(n, 1) for n in lens], torch.bfloat16, 160 + i)
                sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
                out = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=0.1)
                again = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=0.1)
                ref = pd.paged_mla_decode_ref(q_lat, q_pe, torch.nan_to_num(pages), tables, sl,
                                              softmax_scale=0.1)
                torch.cuda.synchronize()
                live = sl > 0
                rel = _rel(out[live], ref[live]) if live.any() else 0.0
                ok = (torch.isfinite(out).all() and (out[~live] == 0).all() and rel <= 1e-2
                      and torch.equal(out, again))
                if not ok:
                    raise AssertionError(f"K6 bf16 at B {b}, (H, R, P) {(h, r, p_dim)}, lengths "
                                         f"{lens}: rel-L2 {rel}, bit-identical across calls "
                                         f"{torch.equal(out, again)}")
                worst = max(worst, rel)
                del q_lat, q_pe, pages, tables
    print(f"K6 bf16 edges (B 1 and 8; (H, R, P) (32, 896, 128), (20, 512, 64); lengths 0, 1, "
          f"63, 64, 65, split lengths +-1, 32768; NaN trash): worst rel-L2 {worst:.3e} (bar "
          f"1e-2), 0 without tokens, two calls bit-identical", flush=True)


def _wrap_calls(model) -> dict:
    """Count the model's prefill_paged / decode_step_paged calls."""
    calls = {"prefill": 0, "decode": 0}
    for name, key in (("prefill_paged", "prefill"), ("decode_step_paged", "decode")):
        fn = getattr(model, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        setattr(model, name, counted)
    return calls


def run_serve_path(fa, pd, card):
    """Phase 17; returns (the 8B model, the launches of each kernel summed
    over the CLI run and both engine runs)."""
    import numpy as np

    from internvideo_tpu_torch.cli import generate as cli
    from internvideo_tpu_torch.serve import ServingEngine

    zero = dict.fromkeys(_serve_counts(fa, pd), 0)
    ids = torch.randint(1, VOCAB, (512,), generator=torch.Generator().manual_seed(17))
    buf = io.StringIO()
    t0 = time.perf_counter()
    _serve_reset(fa, pd)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--preset", PRESET_8B, "--paged", "--ids", ",".join(map(str, ids.tolist())),
                       "--max-new-tokens", "32", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = _serve_counts(fa, pd)
    wall = time.perf_counter() - t0
    tokens = json.loads(buf.getvalue().strip().splitlines()[-1])["tokens"]
    print(f"[{card}] cli.generate --preset {PRESET_8B} --paged, 512-token prompt, 32 new: "
          f"{tokens[:8]}... ({wall:.1f} s wall incl. the 8B init); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    want = {**zero, "flash_fwd_causal": LLM_DEPTH_8B, "paged_decode": LLM_DEPTH_8B * 31}
    if rc != 0 or len(tokens) != 32 or not all(0 <= t < VOCAB for t in tokens):
        raise AssertionError(f"cli.generate returned {len(tokens)} tokens: {tokens}")
    if launches != want:
        raise AssertionError(f"launches {launches} on the generate CLI; expected {want}")
    total = dict(launches)
    gc.collect()
    torch.cuda.empty_cache()

    model = _llm(PRESET_8B)  # the CLI's seeded weights
    calls = _wrap_calls(model)
    for horizon in (1, 8):
        eng = ServingEngine(model, **SERVE_ENGINE, decode_horizon=horizon)
        rng = np.random.default_rng(17)
        reqs = [(rng.integers(1, VOCAB, size=int(n)).astype(np.int32), int(m))
                for n, m in zip(rng.integers(100, 2049, 12), rng.integers(32, 65, 12))]
        calls.update(prefill=0, decode=0)
        _serve_reset(fa, pd)
        t0 = time.perf_counter()
        rids = [eng.submit(p, m) for p, m in reqs]
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _serve_counts(fa, pd)
        n_tok = sum(len(outs[r]) for r in rids)
        print(f"[{card}] ServingEngine {PRESET_8B} horizon {horizon}: 12 requests, prompts "
              f"{min(len(p) for p, _ in reqs)}-{max(len(p) for p, _ in reqs)}, {n_tok} tokens "
              f"in {wall:.2f} s ({n_tok / wall:.1f} tokens/s end to end incl. prefill); "
              f"{calls['prefill']} prefill calls, {calls['decode']} decode steps; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        for rid, (p, m) in zip(rids, reqs):
            out = outs[rid]
            if len(out) != m or not ((out >= 0) & (out < VOCAB)).all():
                raise AssertionError(f"request {rid}: {len(out)} of {m} tokens, {out}")
        want = {**zero, "flash_fwd_causal": LLM_DEPTH_8B * calls["prefill"],
                "paged_decode": LLM_DEPTH_8B * calls["decode"]}
        if launches != want or calls["prefill"] != 12:
            raise AssertionError(f"launches {launches} for {calls} on the engine; expected "
                                 f"{want} (36 K5 per prefill, 36 K6 per decode step)")
        total = {k: total[k] + launches[k] for k in total}
        del eng
    for name in ("prefill_paged", "decode_step_paged"):
        delattr(model, name)
    return model, total


def _route_logits(model, impl: str, ids, fed, capture=None) -> list:
    """Prefill `ids` into fresh page pools, then 4 paged decode steps fed
    `fed`, on route `impl`; returns the 5 last-position logits (fp32).
    With `capture`, the first, middle and last layers record their attention inputs of
    the prefill and of the first decode step."""
    from internvideo_tpu_torch.models.llm import init_paged_cache

    _set_llm_impl(model, impl)
    b, s = ids.shape
    pages, tables = init_paged_cache(model.cfg, b, s + 64, 64, model.embed_tokens.weight.dtype,
                                     "cuda")
    undo = []
    if capture is not None:
        n = model.cfg.num_layers
        for i in sorted({0, n // 2, n - 1}):
            attn = model.layers[i].self_attn

            def record(m, args, kwargs, i=i):
                capture.setdefault(("prefill", i), (args, kwargs))

            undo.append(attn.register_forward_pre_hook(record, with_kwargs=True).remove)
            undo.append(_hook_decode(attn, capture, i))
    with torch.no_grad():
        out = model.prefill_paged(ids, pages, tables, 64)
        logits = [out.logits[:, -1].float()]
        for step in range(4):
            lens = torch.full((b,), s + step, dtype=torch.int32, device="cuda")
            out = model.decode_step_paged(fed[:, step:step + 1], pages, tables, lens, 64)
            logits.append(out.logits[:, -1].float())
    for fn in undo:
        fn()
    _set_llm_impl(model, "kernel")
    return logits


def _hook_decode(attn, capture, i):
    """Record the first decode_paged call's arguments of `attn` (later
    steps write only past its seq_lens, so its pool view stays valid);
    returns the undo."""
    fn = attn.decode_paged

    def recorded(*a, **kw):
        capture.setdefault(("decode", i), (a, kw))
        return fn(*a, **kw)

    attn.decode_paged = recorded
    return lambda: delattr(attn, "decode_paged")


def check_serve_routes(model) -> None:
    """Phase 18 on the 8B bf16 `model`, then an fp32 8B-width depth-2 model.

    End to end in bf16, any two roundings of this 36-layer random-init model
    land ~5.6e-2 apart in the logits (both routes are that far from the same
    weights run in fp32), so the routes are held to each other layer by
    layer on the real activations (rel-L2 <= 1e-2), and end to end against
    the fp32 run: the kernel route no farther from it than the plain route
    (x 1.25), and in fp32 the two routes agree to 1e-4."""
    import numpy as np

    from internvideo_tpu_torch.models.generation import generate
    from internvideo_tpu_torch.models.llm import MLATransformer
    from internvideo_tpu_torch.serve import ServingEngine

    g = torch.Generator("cuda").manual_seed(18)
    ids = torch.randint(1, VOCAB, (2, 512), device="cuda", generator=g)
    fed = torch.randint(1, VOCAB, (2, 4), device="cuda", generator=g)
    capture = {}
    res = {impl: _route_logits(model, impl, ids, fed, capture if impl == "kernel" else None)
           for impl in ("kernel", "plain")}
    for (kind, i), (args, kw) in sorted(capture.items()):
        attn = model.layers[i].self_attn
        outs = {}
        with torch.no_grad():
            for impl in ("kernel", "plain"):
                attn.attn_impl = impl
                fn = attn.forward if kind == "prefill" else attn.decode_paged
                outs[impl] = fn(*args, **kw)
        attn.attn_impl = "kernel"
        rel = _rel(outs["kernel"], outs["plain"])
        print(f"{PRESET_8B} bf16 layer {i} {kind} attention on its real inputs, kernel vs plain "
              f"route: rel-L2 {rel:.3e} (bar 1e-2)", flush=True)
        if not rel <= 1e-2:
            raise AssertionError(f"routes disagree at layer {i} ({kind})")
    del capture

    ref = MLATransformer(dataclasses.replace(model.cfg, dtype="float32", param_dtype="float32"),
                         device="cuda", generator=torch.Generator("cuda").manual_seed(0)).eval()
    with torch.no_grad():
        for p32, p16 in zip(ref.parameters(), model.parameters()):
            p32.copy_(p16)
    f32 = {impl: _route_logits(ref, impl, ids, fed) for impl in ("kernel", "plain")}
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    for n in range(5):
        rk, rp = _rel(res["kernel"][n], f32["plain"][n]), _rel(res["plain"][n], f32["plain"][n])
        rows.append((_rel(res["kernel"][n], res["plain"][n]), rk, rp,
                     _rel(f32["kernel"][n], f32["plain"][n])))
    print(f"{PRESET_8B} 36 layers B=2 512-token prompts, prefill + 4 paged decode steps (same fed "
          "tokens), logits rel-L2 [bf16 kernel vs bf16 plain | bf16 kernel vs fp32 | bf16 plain "
          "vs fp32 | fp32 kernel vs fp32 plain]: "
          + "; ".join(" / ".join(f"{x:.3e}" for x in r) for r in rows), flush=True)
    if not all(torch.isfinite(x).all() for x in res["kernel"]):
        raise AssertionError("non-finite logits on the kernel route")
    if not all(rk <= 1.25 * rp and r32 <= 1e-4 for _, rk, rp, r32 in rows):
        raise AssertionError("the kernel route is farther from the fp32 run than the plain route, "
                             "or the fp32 routes disagree")
    del res, f32

    m32 = _llm(PRESET_8B, num_layers=2, dtype="float32", param_dtype="float32")
    rng = np.random.default_rng(18)
    prompts = [rng.integers(1, VOCAB, size=n).astype(np.int32) for n in (100, 37)]
    eng = ServingEngine(m32, max_batch=2, page_size=64, num_pages=8, max_len=136,
                        prompt_buckets=(128,))
    rids = [eng.submit(p, 8) for p in prompts]
    outs = eng.run()
    for rid, p in zip(rids, prompts):
        pt = torch.from_numpy(p).long()[None].cuda()
        dense = generate(m32, pt, max_new_tokens=8)[0].cpu().numpy()
        paged = generate(m32, pt, max_new_tokens=8, paged=True, page_size=64)[0].cpu().numpy()
        print(f"{PRESET_8B} widths fp32 depth 2, prompt {len(p)}: dense {dense.tolist()}, "
              f"paged {paged.tolist()}, engine {outs[rid].tolist()}", flush=True)
        if not ((dense == paged).all() and (dense == outs[rid]).all()):
            raise AssertionError("fp32 greedy tokens differ across dense, paged and the engine")


def _param_bytes(model, skip_embed: bool = True) -> int:
    return sum(p.numel() * p.element_size() for n, p in model.named_parameters()
               if not (skip_embed and n.startswith("embed_tokens")))


def time_llm(model, preset: str, card) -> dict:
    """Phase 19: prefill at PREFILL_SHAPE and steady paged decode at B = 8,
    seq 2048 on `model` (tokens/s and the bounds)."""
    from internvideo_tpu_torch.models.llm import init_paged_cache

    cfg = model.cfg
    b, s = PREFILL_SHAPE
    g = torch.Generator("cuda").manual_seed(19)
    ids = torch.randint(1, VOCAB, (b, s), device="cuda", generator=g)
    pages, tables = init_paged_cache(cfg, b, s + 64, 64, torch.bfloat16, "cuda")
    tok = torch.randint(1, VOCAB, (b, 1), device="cuda", generator=g)
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        prefill = lambda: model.prefill_paged(ids, pages, tables, 64)  # noqa: E731
        decode = lambda: model.decode_step_paged(tok, pages, tables, lens, 64)  # noqa: E731
        prefill_ms = _time_ms(prefill, iters=3, warmup=1)
        decode_ms = _time_ms(decode, iters=10, warmup=2)
    m = cfg.mla
    layer_params = sum(p.numel() for n, p in model.named_parameters() if n.startswith("layers."))
    head = cfg.vocab_size * cfg.hidden_size
    attn = cfg.num_layers * b * m.num_heads * s * (s + 1) // 2 * 2 * (m.q_head_dim
                                                                     + m.v_head_dim)
    # weights read once (the table only for its looked-up rows), the logits
    # of the last position (prefill) or of every sequence (decode), and for
    # decode the pool entries of the cached tokens
    prefill_bound = _bound(2 * layer_params * b * s + attn + 2 * head * b,
                           _param_bytes(model) + b * s * cfg.hidden_size * 2)
    decode_bound = _bound(2 * (layer_params + head) * b,
                          _param_bytes(model) + cfg.num_layers * b * s * m.cache_dim * 2)
    print(f"[{card}] {preset} prefill B={b} prompt {s} bf16 (prefill_paged, K5): "
          f"{prefill_ms:.1f} ms = {b * s * 1e3 / prefill_ms:.0f} tokens/s (bound "
          f"{prefill_bound[0]:.1f} ms, {prefill_bound[1]})", flush=True)
    print(f"[{card}] {preset} paged decode step B={b} seq {s} bf16 (K6): {decode_ms:.2f} ms = "
          f"{b * 1e3 / decode_ms:.1f} tokens/s (bound {decode_bound[0]:.2f} ms, "
          f"{decode_bound[1]}: the weight stream)", flush=True)
    res = {"prefill_ms": prefill_ms, "prefill_tokens_per_sec": b * s * 1e3 / prefill_ms,
           "decode_ms": decode_ms, "decode_tokens_per_sec": b * 1e3 / decode_ms,
           "prefill_bound_ms": prefill_bound[0], "decode_bound_ms": decode_bound[0]}
    if preset == PRESET_8B:
        with torch.no_grad():
            profile_step(prefill, card, f"{preset} prefill B={b} S={s}")
            profile_step(decode, card, f"{preset} paged decode step B={b} seq {s}")
    del pages
    return res


def _sdpa_causal_ms(q, k, v) -> tuple:
    """The fastest PyTorch SDPA backend that takes causal (B, S, H, D)
    attention with v at its own width, else with v zero-padded to q's
    (yardstick only, never on the port's path): (ms, note)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    vpad = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
    best = (None, "no backend ran")
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for vv, tag in ((v, "d_v as is"), (vpad, "v zero-padded to d_qk")):
            try:
                with sdpa_kernel(backend):
                    ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, vv,
                                                                         is_causal=True),
                                  iters=10, warmup=2)
            except RuntimeError as e:  # the backend refuses the shape: try the next
                print(f"  SDPA {backend.name} ({tag}) refused: {str(e).splitlines()[0][:100]}",
                      flush=True)
                continue
            if best[0] is None or ms < best[0]:
                best = (ms, f"{backend.name}, {tag}")
            break
    return best


def time_serve_kernels(fa, pd, card) -> dict:
    """Phase 19, kernels: K5 at CAUSAL_SHAPE (and the 2B shape) and K6 at
    DECODE_SHAPE beside the plain version, the bound and the yardstick."""
    g = torch.Generator("cuda").manual_seed(20)
    res = {}
    for tag, (b, s, h, d, dv) in (("8b", CAUSAL_SHAPE), ("2b", CAUSAL_SHAPE_2B)):
        q = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
        k = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
        v = torch.randn(b, s, h, dv, device="cuda", generator=g).bfloat16()
        scale = d ** -0.5
        with torch.no_grad():
            ms = _time_ms(lambda: fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0),
                          iters=20, warmup=3)
            plain_ms = _time_ms(lambda: fa.flash_attention_ref_with_lse(q, k, v, scale, True),
                                iters=1)
            lib_ms, lib_note = _sdpa_causal_ms(q, k, v)
        pairs = b * h * s * (s + 1) // 2  # visible (query, key) pairs
        bound = _bound(2 * pairs * (d + dv), (2 * b * s * h * d + 2 * b * s * h * dv) * 2
                       + b * h * s * 4)
        res[f"flash_fwd_causal_{tag}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                             library_note=lib_note, bound=bound,
                                             shape=[b, s, h, d, dv])
        print(f"[{card}] K5 flash_fwd_causal {(b, s, h, d, dv)} bf16: kernel {ms:.3f} ms "
              f"({2 * pairs * (d + dv) / ms / 1e9:.1f} TFLOP/s), bound {bound[0]:.3f} ms "
              f"({bound[1]}), plain {plain_ms:.3f} ms, SDPA yardstick "
              + (f"{lib_ms:.3f} ms ({lib_note})" if lib_ms is not None else lib_note), flush=True)
        del q, k, v

    for tag, (b, h, r, p_dim, ps), lens in (("8b", DECODE_SHAPE, DECODE_LENS),
                                           ("2b", DECODE_SHAPE_2B, [HICO_PROMPT] * 8)):
        q_lat, q_pe, pages, tables, sl = _paged_inputs(b, h, r, p_dim, ps, -(-max(lens) // ps) + 1,
                                                       lens, torch.bfloat16, 21)
        pages = torch.nan_to_num(pages)
        scale = (128 + p_dim) ** -0.5
        call = lambda: pd._paged_decode_cuda(q_lat, q_pe, pages, tables, sl, scale)  # noqa: E731
        with torch.no_grad():
            event_ms = _time_ms(call, iters=50, warmup=5)
            ms = _graph_ms(call)
            plain_ms = _time_ms(lambda: pd.paged_mla_decode_ref(q_lat, q_pe, pages, tables, sl,
                                                                softmax_scale=scale), iters=5)
        toks = sum(lens)
        pool = toks * (r + p_dim) * 2
        bound = _bound(toks * h * 2 * (r + p_dim + r),
                       pool + b * h * (2 * r + p_dim) * 2 + tables.numel() * 4)
        res[f"paged_decode_{tag}"] = dict(
            ms=ms, event_ms=event_ms, plain_ms=plain_ms, library_ms=None, bound=bound,
            pool_gb_per_s=pool / ms / 1e6, shape=[b, h, r, p_dim, ps, min(lens), max(lens)])
        print(f"[{card}] K6 paged_decode (B {b}, H {h}, R {r}, P {p_dim}, page {ps}) seq "
              f"{min(lens)}-{max(lens)} bf16: kernel {ms:.4f} ms by graph replay "
              f"({pool / ms / 1e6:.0f} GB/s of pool; the wrapper's rate under CUDA events "
              f"{event_ms:.4f} ms), bound {bound[0]:.4f} ms ({bound[1]}), plain {plain_ms:.3f} ms,"
              " no library yardstick", flush=True)
        del q_lat, q_pe, pages, tables, sl
    return res


# -- the SFT slice: phases 20-23 ---------------------------------------------------------

def _sft_run(pack: int = SFT_PACK, **text_overrides):
    """The SFT config's RunConfig with its stream at `pack` tokens and the
    text model's fields replaced."""
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.data.mllm_tokenize import SyntheticSFTConfig, synthetic_sft_stream

    run = load_config(CONFIG_SFT)
    model = dataclasses.replace(run.model, text=dataclasses.replace(run.model.text,
                                                                    **text_overrides))
    data = {**run.data, "pack_max_length": pack,
            "stream": synthetic_sft_stream(SyntheticSFTConfig(), batch_size=1,
                                           pack_max_length=pack, seed=0)}
    return dataclasses.replace(run, model=model, data=data)


def _stream_segments(pack: int = SFT_PACK):
    """The segment ids of the SFT stream's first row, on the card."""
    from internvideo_tpu_torch.data.mllm_tokenize import SyntheticSFTConfig, synthetic_sft_stream

    row = next(synthetic_sft_stream(SyntheticSFTConfig(), batch_size=1, pack_max_length=pack,
                                    seed=0))
    return torch.from_numpy(row["segment_ids"]).cuda()


def _visible_pairs(seg) -> int:
    """(query, key) pairs a causal segmented attention sees on (B, S) ids:
    n (n + 1) / 2 for each run of equal ids (the pads' -1 run included)."""
    pairs = 0
    for row in seg.cpu().tolist():
        n = 1
        for a, b in zip(row, row[1:] + [None]):
            if a == b:
                n += 1
            else:
                pairs += n * (n + 1) // 2
                n = 1
    return pairs


def _attn_grads(fn, q, k, v, do):
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return [out.detach(), *torch.autograd.grad(out, leaves, do)]


def check_sft_kernels(fa) -> dict:
    """Phase 20; returns the max-abs errors of each new kernel at its path
    shape in bf16."""
    from internvideo_tpu_torch.ops.attention_xla import attention_xla

    g = torch.Generator("cuda").manual_seed(30)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731

    def seg_ids(kind, b, s):
        if kind is None:
            return None
        if kind == "halves":
            lens = [s // 2, s - s // 2]
        elif kind == "packed":
            lens = [130, 100, 200, 82]
        else:
            lens = [s * 3 // 8, s // 4, s // 8]
            lens.append(s - sum(lens))
        ids = torch.repeat_interleave(torch.arange(len(lens)), torch.tensor(lens))
        if kind == "pads":
            ids[sum(lens[:3]):] = -1
        return ids[None].repeat(b, 1).to(torch.int32).cuda()

    # the JAX kernel tests' shapes (tests/test_flash_attention.py :80, :152,
    # :511, :569 without GQA), pads that meet each other, and K2 / K4b at 72
    cases = [(1, 256, 256, 2, 64, 64, False, 0, "halves"),
             (1, 72, 200, 2, 64, 64, True, 128, None),
             (2, 512, 512, 2, 32, 32, False, 0, "packed"),
             (2, 512, 512, 2, 32, 32, True, 0, "packed"),
             (2, 200, 200, 4, 64, 32, True, 0, None),
             (2, 200, 200, 4, 64, 32, False, 0, None),
             (1, 300, 300, 2, 64, 64, True, 0, "pads"),
             (2, 196, 196, 2, 72, 72, False, 0, None)]
    for b, sq, sk, h, d, dv, causal, off, kind in cases:
        q, k, v, do = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, dv), rnd(b, sq, h, dv)
        seg = seg_ids(kind, b, sq)
        kw = dict(causal=causal, q_position_offset=off, q_segment_ids=seg, kv_segment_ids=seg)
        got = _attn_grads(lambda q, k, v: fa.flash_attention(q, k, v, **kw), q, k, v, do)
        torch.cuda.synchronize()
        want = _attn_grads(lambda q, k, v: attention_xla(q, k, v, **kw), q, k, v, do)
        errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
        print(f"SFT kernels fp32 {(b, sq, sk, h, d, dv)} causal={causal} offset={off} "
              f"segments={kind}: out/dq/dk/dv max-abs {errs[0]:.2e} / {errs[1]:.2e} / "
              f"{errs[2]:.2e} / {errs[3]:.2e} (bars 2e-5, 5e-4)", flush=True)
        if not (errs[0] <= 2e-5 and max(errs[1:]) <= 5e-4):
            raise AssertionError("fp32 SFT kernels disagree with their plain version")

    out = {}
    b, s, h, d, dv = SFT_ATTN_SHAPE
    seg = _stream_segments()
    q = rnd(b, s, h, d).bfloat16()
    kv = rnd(b, s, h, d + dv).bfloat16()
    k, v = kv[..., :d], kv[..., d:]  # strided views, as MLAttention makes them
    do = rnd(b, s, h, dv).bfloat16()
    before = {n: fa.launch_count(n) for n in fa.KERNELS}
    got = _attn_grads(lambda q, k, v: fa.flash_attention(
        q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg), q, k, v, do)
    torch.cuda.synchronize()
    for n in ("flash_fwd_causal_seg", "flash_bwd_causal_dq_seg", "flash_bwd_causal_dkv_seg"):
        if fa.launch_count(n) != before[n] + 1:
            raise AssertionError(f"the segmented causal call did not launch {n}")
    ref_out, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True, 0, seg, seg)
    want = [ref_out, *fa.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, do, d ** -0.5,
                                                 causal=True, q_segment_ids=seg,
                                                 kv_segment_ids=seg)]
    rels = [_rel(a, w) for a, w in zip(got, want)]
    errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
    print(f"K5 + K8 bf16 {SFT_ATTN_SHAPE} causal, the stream's {int(seg.max()) + 1} segments "
          f"+ pads: out/dq/dk/dv rel-L2 {rels[0]:.2e} / {rels[1]:.2e} / {rels[2]:.2e} / "
          f"{rels[3]:.2e} (bar 1e-2), max-abs {errs[0]:.2e} / {errs[1]:.2e} / {errs[2]:.2e} / "
          f"{errs[3]:.2e}", flush=True)
    if not max(rels) <= 1e-2:
        raise AssertionError("bf16 K5 / K8 disagree with their plain version at the path shape")
    out.update(flash_fwd_causal_seg=errs[0], flash_bwd_causal_dq_seg=errs[1],
               flash_bwd_causal_dkv_seg=max(errs[2:]))
    # the same call without segments: the K5 backward alone
    got = _attn_grads(lambda q, k, v: fa.flash_attention(q, k, v, causal=True), q, k, v, do)
    ref_out, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True)
    want = [ref_out, *fa.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, do, d ** -0.5,
                                                 causal=True)]
    rels = [_rel(a, w) for a, w in zip(got, want)]
    errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
    print(f"K5 bf16 {SFT_ATTN_SHAPE} causal, no segments: out/dq/dk/dv rel-L2 "
          f"{rels[0]:.2e} / {rels[1]:.2e} / {rels[2]:.2e} / {rels[3]:.2e} (bar 1e-2)", flush=True)
    if not max(rels) <= 1e-2:
        raise AssertionError("bf16 K5 backward disagrees with its plain version")
    out.update(flash_bwd_causal_dq=errs[1], flash_bwd_causal_dkv=max(errs[2:]))
    del q, kv, k, v, do, got, want, ref_out, ref_lse

    b, s, h, d = TOWER_SHAPE
    qkv, (q, k, v) = _qkv_views(b, s, h, d, g)
    do = rnd(b, s, h, d).bfloat16()
    got = _attn_grads(lambda q, k, v: fa.flash_attention(q, k, v), q, k, v, do)
    ref_out, ref_lse = fa.small_s_attention_ref(q, k, v, d ** -0.5)
    want = [ref_out, *fa.small_s_attention_bwd_ref(q, k, v, ref_out, ref_lse, do, d ** -0.5)]
    rels = [_rel(a, w) for a, w in zip(got, want)]
    errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
    print(f"K2 / K4b bf16 {TOWER_SHAPE} (head dim 72) on qkv views: out/dq/dk/dv rel-L2 "
          f"{rels[0]:.2e} / {rels[1]:.2e} / {rels[2]:.2e} / {rels[3]:.2e} (bar 1e-2)", flush=True)
    if not max(rels) <= 1e-2:
        raise AssertionError("bf16 small-S kernels at head dim 72 disagree with their plain "
                             "version")
    out.update(small_s_fwd=errs[0], small_s_bwd_dq=errs[1], small_s_bwd_dkv=max(errs[2:]))
    return out


def _sft_depth() -> int:
    from internvideo_tpu_torch.core.config import load_config

    return load_config(CONFIG_SFT).model.text.num_layers


def sft_want(fa, steps: int, depth: int) -> dict:
    """The launches `steps` SFT steps must make: per step, 2 x depth
    segmented K5 forwards (forward + remat recompute), depth K5 dq and dk/dv,
    27 each of K2 / K4b dq / K4b dk/dv (the tower, no remat), nothing else."""
    return {**dict.fromkeys(fa.KERNELS, 0),
            "flash_fwd_causal_seg": 2 * depth * steps,
            "flash_bwd_causal_dq_seg": depth * steps, "flash_bwd_causal_dkv_seg": depth * steps,
            "small_s_fwd": TOWER_DEPTH * steps, "small_s_bwd_dq": TOWER_DEPTH * steps,
            "small_s_bwd_dkv": TOWER_DEPTH * steps}


def run_sft_path(fa, pd, card) -> dict:
    """Phase 21; returns the launches of each kernel in the main-path run."""
    from internvideo_tpu_torch.cli import train as cli

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _serve_reset(fa, pd)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_SFT, "--device", "cuda",
                       f"trainer.total_steps={SFT_STEPS}", "trainer.log_every=1"])
    torch.cuda.synchronize()
    launches = _serve_counts(fa, pd)
    wall = time.perf_counter() - t0
    records = [dict(kv.split(": ") for kv in line.split("  "))
               for line in buf.getvalue().splitlines() if line.startswith("step: ")]
    for r in records:
        print(f"cli.train {CONFIG_SFT}: {r}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{card}] main path (sft): {SFT_STEPS} steps in {wall:.1f} s wall incl. model init "
          f"and host data; peak device memory {peak:.2f} GB "
          f"(reserved {torch.cuda.max_memory_reserved() / 1e9:.2f} GB); launches {launches}",
          flush=True)
    if rc != 0 or len(records) != SFT_STEPS:
        raise AssertionError(f"cli.train logged {len(records)} of {SFT_STEPS} SFT steps")
    if not all(math.isfinite(float(r[k])) for r in records for k in ("loss", "grad_norm")):
        raise AssertionError("non-finite loss or grad_norm on the SFT main path")
    want = {**sft_want(fa, SFT_STEPS, _sft_depth()), "paged_decode": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} on the SFT main path; expected {want}")
    return launches


def _sft_model(run):
    from internvideo_tpu_torch.models.mllm import VideoMLLM

    return VideoMLLM(run.model, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(run.trainer.seed))


def _set_sft_impl(model, impl: str) -> None:
    from internvideo_tpu_torch.models.vision_tower import VisionBlock
    from internvideo_tpu_torch.nn.mla import MLAttention

    for m in model.modules():
        if isinstance(m, (MLAttention, VisionBlock)):
            m.attn_impl = impl


def _sft_batch(run):
    batch = next(run.data["stream"])
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _sft_loss_grads(model, batch, impl, names=None):
    from internvideo_tpu_torch.train.chunked_ce import chunked_cross_entropy

    _set_sft_impl(model, impl)
    model.zero_grad(set_to_none=True)
    out = model(batch["input_ids"], batch["video"], position_ids=batch["position_ids"],
                segment_ids=batch["segment_ids"], with_logits=False)
    loss = chunked_cross_entropy(out.hidden, model.language_model.lm_head.weight,
                                 batch["labels"])
    loss.backward()
    # at text depth 2 the third deepstack merger feeds no layer: no grad
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None and (names is None or n in names)}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def check_sft_routes(fa, card) -> None:
    """Phase 22, at pack SFT_ROUTE_PACK (the plain route materialises S x S)."""
    run = _sft_run(SFT_ROUTE_PACK, num_layers=2, dtype="float32", param_dtype="float32")
    run = dataclasses.replace(run, model=dataclasses.replace(
        run.model, vision=dataclasses.replace(run.model.vision, dtype="float32",
                                              param_dtype="float32")))
    model = _sft_model(run)
    batch = _sft_batch(run)
    fa.reset_launch_count()
    lk, gk = _sft_loss_grads(model, batch, "kernel")
    if fa.launch_count("flash_bwd_causal_dq_seg") == 0 or fa.launch_count("small_s_fwd") == 0:
        raise AssertionError("the kernel route of the fp32 SFT check ran no kernel")
    lp, gp = _sft_loss_grads(model, batch, "plain")
    if gk.keys() != gp.keys():
        raise AssertionError("the two routes gave gradients to different parameters")
    worst = max(((gk[n] - gp[n]).abs().max().item(), n) for n in gk)
    print(f"[{card}] SFT routes fp32, full widths, text depth 2, pack {SFT_ROUTE_PACK}: loss "
          f"kernel {lk.item():.6f} plain {lp.item():.6f} (|diff| {abs(lk - lp).item():.2e}); "
          f"worst grad max-abs {worst[0]:.2e} at {worst[1]} (bar 5e-4, {len(gk)} params)",
          flush=True)
    if not (abs(lk - lp).item() <= 5e-4 and worst[0] <= 5e-4):
        raise AssertionError("fp32 SFT kernel route disagrees with the plain route")
    del model, gk, gp, batch
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 at the config's depth. A 32-layer random-init bf16 model carries
    # each route's rounding through 32 layers twice (phase 18 sees the same in
    # serving): the weights' grads of the two bf16 routes differ by more than
    # the kernels do. So each route is also held against the same weights run
    # in fp32 (plain route): the kernel route must be no farther from it than
    # the plain route (x 1.25).
    run = _sft_run(SFT_ROUTE_PACK)
    model = _sft_model(run)
    batch = _sft_batch(run)
    depth = _sft_depth()
    last = depth - 1
    names = [f"language_model.layers.{i}.self_attn.{w}" for i in (0, last)
             for w in ("q_proj.weight", "kv_b_proj_kernel")] + ["vision_tower.blocks.0.qkv.weight"]
    lk, gk = _sft_loss_grads(model, batch, "kernel", names)
    lp, gp = _sft_loss_grads(model, batch, "plain", names)
    for m in model.modules():  # the same weights in fp32, fp32 compute
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    model.float()
    batch["video"] = batch["video"].float()
    l32, g32 = _sft_loss_grads(model, batch, "plain", names)
    rel_loss = abs(lk - lp).item() / abs(lp).item()
    rels = {n: _rel(gk[n], gp[n]) for n in names}
    far_k = {n: _rel(gk[n], g32[n]) for n in names}
    far_p = {n: _rel(gp[n], g32[n]) for n in names}
    print(f"[{card}] SFT routes bf16, text depth {depth}, pack {SFT_ROUTE_PACK}: loss "
          f"kernel {lk.item():.6f} plain {lp.item():.6f} fp32 {l32.item():.6f} (kernel vs plain "
          f"rel {rel_loss:.2e}, bar 1e-2)", flush=True)
    for n in names:
        print(f"  {n}: grad rel-L2 kernel vs plain {rels[n]:.2e}; to fp32: kernel "
              f"{far_k[n]:.2e}, plain {far_p[n]:.2e} (bar: kernel <= 1.25 x plain)", flush=True)
    if not (rel_loss <= 1e-2 and all(far_k[n] <= 1.25 * far_p[n] for n in names)):
        raise AssertionError("bf16 SFT kernel route is farther from fp32 than the plain route")


def time_sft_kernels(fa, card) -> dict:
    """Phase 23, kernels: each new kernel at its path shape beside its plain
    version, its bound (the work these inputs need) and the SDPA yardstick."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = torch.Generator("cuda").manual_seed(31)
    res = {}
    b, s, h, d, dv = SFT_ATTN_SHAPE
    seg = _stream_segments()
    q, k = (torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    v, do = (torch.randn(b, s, h, dv, device="cuda", generator=g).bfloat16() for _ in range(2))
    scale = d ** -0.5
    mask = (seg[0][:, None] == seg[0][None, :]) & torch.ones(s, s, dtype=torch.bool,
                                                            device="cuda").tril()
    for tag, (qs, ks) in (("_seg", (seg, seg)), ("", (None, None))):
        pairs = h * (_visible_pairs(seg) if qs is not None else b * s * (s + 1) // 2)
        with torch.no_grad():
            out, lse = fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0, qs, ks)
            delta = fa._bwd_delta(out, do)
            fwd_ms = _time_ms(lambda: fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0, qs, ks),
                              iters=10, warmup=2)
            plain_fwd = _time_ms(lambda: fa.flash_attention_ref_with_lse(
                q, k, v, scale, True, 0, qs, ks), iters=1)
            plain_bwd = _time_ms(lambda: fa.flash_attention_bwd_ref(
                q, k, v, out, lse, do, scale, causal=True, q_segment_ids=qs,
                kv_segment_ids=ks), iters=1)
        lib_ms, lib_note = None, "no SDPA backend took the masked shape"
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION):
            try:
                with sdpa_kernel(backend):
                    lk = [x.detach().requires_grad_() for x in (qt, kt, vt)]
                    kw = dict(attn_mask=mask) if qs is not None else dict(is_causal=True)
                    f_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                                    iters=5, warmup=1)
                    fb_ms = _time_ms(lambda: torch.autograd.grad(
                        F.scaled_dot_product_attention(*lk, **kw), lk, do.transpose(1, 2)),
                        iters=3, warmup=1)
                lib_ms, lib_note = (f_ms, fb_ms - f_ms), f"{backend.name}, " + (
                    "explicit (S, S) bool mask" if qs is not None else "is_causal")
                break
            except RuntimeError as e:
                print(f"  SDPA {backend.name} refused: {str(e).splitlines()[0][:100]}", flush=True)
        # the dq and dk/dv kernels one at a time
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        ptrs = fa._seg_ptrs(qs, ks)[1]
        dq_ms, dkv_ms = (_time_ms(lambda: fa._launch_bwd_causal(
            kind, q, k, v, do, lse, delta, ptrs, grads, scale, True, 0), iters=5, warmup=1)
            for kind in ("dq", "dkv"))
        io_fwd = (2 * b * s * h * d + 2 * b * s * h * dv) * 2 + b * h * s * 4
        io_bwd = (2 * b * s * h * d + 2 * b * s * h * dv) * 2 + 2 * b * h * s * 4
        bounds = {"fwd": _bound(2 * pairs * (d + dv), io_fwd),
                  "dq": _bound(2 * pairs * (2 * d + dv), io_bwd + b * s * h * d * 2),
                  "dkv": _bound(2 * pairs * (2 * d + 2 * dv),
                                io_bwd + b * s * h * (d + dv) * 2)}
        names = {"fwd": f"flash_fwd_causal{tag}", "dq": f"flash_bwd_causal_dq{tag}",
                 "dkv": f"flash_bwd_causal_dkv{tag}"}
        for key, ms, plain, lms in (("fwd", fwd_ms, plain_fwd, lib_ms and lib_ms[0]),
                                    ("dq", dq_ms, plain_bwd, lib_ms and lib_ms[1]),
                                    ("dkv", dkv_ms, plain_bwd, lib_ms and lib_ms[1])):
            res[names[key]] = dict(ms=ms, plain_ms=plain, library_ms=lms, library_note=lib_note,
                                   bound=bounds[key], shape=list(SFT_ATTN_SHAPE),
                                   segments=qs is not None)
            print(f"[{card}] {names[key]} {SFT_ATTN_SHAPE} bf16"
                  f"{' stream segments' if qs is not None else ''}: kernel {ms:.3f} ms, bound "
                  f"{bounds[key][0]:.3f} ms ({bounds[key][1]}, {pairs / h:.3e} visible pairs a "
                  f"head), plain {plain:.2f} ms, SDPA "
                  + (f"{lms:.3f} ms ({lib_note})" if lms is not None else lib_note), flush=True)
        del out, lse, delta
    del q, k, v, do, mask

    b, s, h, d = TOWER_SHAPE
    qkv, (q, k, v) = _qkv_views(b, s, h, d, g)
    do = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    scale = d ** -0.5
    with torch.no_grad():
        out, lse = fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd")
        delta = fa._bwd_delta(out, do)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        ms = {"small_s_fwd": _time_ms(lambda: fa._flash_fwd_cuda(q, k, v, scale,
                                                                 kernel="small_s_fwd"),
                                      iters=20, warmup=3),
              "small_s_bwd_dq": _time_ms(lambda: fa._launch_bwd(
                  "small_s_bwd_dq", q, k, v, do, lse, delta, (dq,), scale), iters=20, warmup=3),
              "small_s_bwd_dkv": _time_ms(lambda: fa._launch_bwd(
                  "small_s_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), scale), iters=20,
                  warmup=3)}
        plain_f = _time_ms(lambda: fa.small_s_attention_ref(q, k, v, scale), iters=3)
        plain_b = _time_ms(lambda: fa.small_s_attention_bwd_ref(q, k, v, out, lse, do, scale),
                           iters=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lk = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    f_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=20, warmup=3)
    fb_ms = _time_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(*lk), lk,
                                                 do.transpose(1, 2)), iters=20, warmup=3)
    flops = {"small_s_fwd": 4, "small_s_bwd_dq": 6, "small_s_bwd_dkv": 8}
    # bytes: q, k, v and the output(s) (and dO in the backward), each once;
    # the forward writes lse, the backward reads lse and delta
    t_bytes, r_bytes = b * s * h * d * 2, b * h * s * 4
    nbytes = {"small_s_fwd": 4 * t_bytes + r_bytes, "small_s_bwd_dq": 5 * t_bytes + 2 * r_bytes,
              "small_s_bwd_dkv": 6 * t_bytes + 2 * r_bytes}
    for name, n in flops.items():
        bound = _bound(n * b * h * s * s * d, nbytes[name])
        plain = plain_f if name == "small_s_fwd" else plain_b
        lms = f_ms if name == "small_s_fwd" else fb_ms - f_ms
        res[f"{name}_72"] = dict(ms=ms[name], plain_ms=plain, library_ms=lms, bound=bound,
                                 shape=list(TOWER_SHAPE))
        print(f"[{card}] {name} {TOWER_SHAPE} bf16 (head dim 72): kernel {ms[name]:.4f} ms, "
              f"bound {bound[0]:.4f} ms ({bound[1]}), plain {plain:.3f} ms, SDPA "
              f"{lms:.4f} ms", flush=True)
    return res


def time_sft_step(fa, card) -> dict:
    """Phase 23, the step: at the config's depth and pack on a device-resident
    batch, the whole step (ms, tokens/s), then one step split with CUDA
    events into tower, LLM forward + backward, CE and update; one step under
    torch.profiler."""
    from internvideo_tpu_torch.cli import train as cli
    from internvideo_tpu_torch.models.mllm import scatter_visual
    from internvideo_tpu_torch.train.chunked_ce import chunked_cross_entropy
    from internvideo_tpu_torch.train.optim import global_norm

    run = _sft_run()
    trainer, _ = cli.build_sft(run, torch.device("cuda"))
    batch = _sft_batch(run)
    tokens = int((batch["segment_ids"] >= 0).sum())
    step = lambda: trainer._step(trainer.state, batch)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_ms(step, iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{card}] InternVideo3-8B SFT step (text depth {_sft_depth()}, pack {SFT_PACK}, "
          f"B=1, {tokens} real tokens, 16 x 224 clip, bf16, remat, AdamW), device-resident "
          f"batch: {step_ms:.1f} ms = {SFT_PACK * 1e3 / step_ms:.0f} tokens/s of pack "
          f"({tokens * 1e3 / step_ms:.0f} real tokens/s); peak device memory {peak:.2f} GB",
          flush=True)

    model, state = trainer.model, trainer.state
    lm, cfg = model.language_model, model.config
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    torch.cuda.synchronize()
    state.optimizer.zero_grad()
    ev[0].record()
    visual, taps = model.encode_video(batch["video"])
    ev[1].record()
    vis = [x.detach().requires_grad_() for x in (visual, *taps)]
    ids = batch["input_ids"]
    vmask = (ids == cfg.video_token_id) | (ids == cfg.image_token_id)
    embeds = scatter_visual(lm.embed(ids), vis[0], vmask)
    zeros = torch.zeros_like(embeds)
    deep = [scatter_visual(zeros, t, vmask) for t in vis[1:]]
    hidden = model._run_llm(embeds, deep, batch["position_ids"], batch["segment_ids"],
                            False).hidden
    ev[2].record()
    hd = hidden.detach().requires_grad_()
    loss = chunked_cross_entropy(hd, lm.lm_head.weight, batch["labels"])
    loss.backward()
    ev[3].record()
    hidden.backward(hd.grad)
    ev[4].record()
    torch.autograd.backward([visual, *taps], [x.grad for x in vis])
    ev[5].record()
    global_norm([p.grad for p in model.parameters() if p.grad is not None])
    state.optimizer.step()
    ev[6].record()
    torch.cuda.synchronize()
    t = [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]
    split = {"tower_fwd": t[0], "llm_fwd": t[1], "ce_fwd_bwd": t[2], "llm_bwd": t[3],
             "tower_bwd": t[4], "update": t[5]}
    print(f"[{card}] SFT step split (CUDA events, one step): tower fwd {t[0]:.1f} + bwd "
          f"{t[4]:.1f} ms; LLM fwd {t[1]:.1f} + bwd (remat recompute incl.) {t[3]:.1f} ms; "
          f"CE fwd + bwd {t[2]:.1f} ms; grad norm + clip + AdamW {t[5]:.1f} ms; sum "
          f"{sum(t):.1f} ms", flush=True)
    del visual, taps, vis, embeds, zeros, deep, hidden, hd, loss
    profile_step(step, card, "SFT step")
    return {"step_ms": step_ms, "tokens": tokens, "peak_gb": peak, **split}


# -- multimodal serving and the dense-GQA model: phases 24-28 ---------------------------

def _set_route(model, impl: str) -> None:
    """Every attention module of `model` (tower blocks, MLA, GQA) on route `impl`."""
    for m in model.modules():
        if hasattr(m, "attn_impl"):
            m.attn_impl = impl


def _lse_err(lse, ref_lse) -> float:
    """Max-abs LSE error over the rows with keys; inf if the rows without
    keys (LSE -inf) differ."""
    empty = torch.isinf(ref_lse)
    if not torch.equal(empty, torch.isinf(lse)):
        return math.inf
    return (lse - ref_lse).masked_fill(empty, 0.0).abs().max().item()


def _gqa_name(window) -> str:
    return "flash_fwd_causal_window" if window else "flash_fwd_causal_gqa"


def check_gqa_kernel(fa) -> dict:
    """Phase 24; returns the bf16 max-abs error at GQA_SHAPE of the GQA
    (window None) and windowed launches."""
    g = torch.Generator("cuda").manual_seed(24)
    cases = [((1, 128, 128, 8, 2, 64), {}),
             ((1, 256, 256, 2, 2, 64), dict(window=50)),
             ((1, 256, 256, 2, 2, 64), dict(causal=True, window=50)),
             ((1, 256, 64, 2, 2, 64), dict(window=50)),
             ((1, 128, 200, 4, 2, 64), dict(causal=True, window=50, q_position_offset=72))]
    for (b, sq, sk, hq, hkv, d), kw in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=g)
        k, v = (torch.randn(b, sk, hkv, d, device="cuda", generator=g) for _ in range(2))
        name = _gqa_name(kw.get("window"))
        before = fa.launch_count(name)
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        if fa.launch_count(name) != before + 1:
            raise AssertionError(f"{kw} did not launch {name}")
        ref, ref_lse = fa.flash_attention_ref_with_lse(
            q, k, v, d ** -0.5, kw.get("causal", False), kw.get("q_position_offset", 0),
            None, None, kw.get("window"))
        e_out, e_lse = (out - ref).abs().max().item(), _lse_err(lse, ref_lse)
        empty = int(torch.isinf(ref_lse).any(dim=(0, 1)).sum())
        print(f"K5 GQA / window fp32 {(b, sq, sk, hq, hkv, d)} {kw}: out max-abs {e_out:.3e}, "
              f"lse max-abs {e_lse:.3e} (bar 2e-5), {empty} rows with no key", flush=True)
        if not (e_out <= 2e-5 and e_lse <= 2e-5):
            raise AssertionError("fp32 K5 GQA / window disagrees with its plain version")
    errs = {}
    b, s, hq, hkv, d = GQA_SHAPE
    for window in (None, GQA_WINDOW):
        q = torch.randn(b, s, hq, d, device="cuda", generator=g).bfloat16()
        kv = torch.randn(b, s, 2 * hkv, d, device="cuda", generator=g).bfloat16()
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]  # strided views of one tensor
        name = _gqa_name(window)
        before = fa.launch_count(name)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        if fa.launch_count(name) != before + 1:
            raise AssertionError(f"window {window} did not launch {name}")
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True, 0, None, None,
                                                       window)
        rel, e_lse = _rel(out, ref), _lse_err(lse, ref_lse)
        errs[name] = (out.float() - ref.float()).abs().max().item()
        print(f"K5 GQA bf16 {GQA_SHAPE} causal window {window}, k/v strided views: out rel-L2 "
              f"{rel:.3e} (bar 1e-2), max-abs {errs[name]:.3e}, lse max-abs {e_lse:.3e}",
              flush=True)
        if not (rel <= 1e-2 and e_lse <= 1e-2):
            raise AssertionError(f"bf16 K5 GQA disagrees at {GQA_SHAPE} window {window}")
        del q, kv, k, v, out, lse, ref, ref_lse
    return errs


def check_hico_kernels(fa) -> dict:
    """Phase 24b: K2 and K5 at the shapes the HiCo video path launches them
    at, bf16, through the wrappers: the tower's (B * T', 196, 16, 72) at 128
    frames on qkv views, and the text prefill's (1, 1056, 20, 192 / 128)
    causal, whose 1056 rows end in a ragged 32-row tile, on k / v strided
    views. Returns name -> (shape, max-abs, rel-L2)."""
    g = torch.Generator("cuda").manual_seed(241)
    res = {}
    b, s, h, d = HICO_TOWER_SHAPE
    _, (q, k, v) = _qkv_views(b, s, h, d, g)
    before = fa.launch_count("small_s_fwd")
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if fa.launch_count("small_s_fwd") != before + 1:
        raise AssertionError(f"{HICO_TOWER_SHAPE} did not launch K2")
    ref, _ = fa.small_s_attention_ref(q, k, v, d ** -0.5)
    res["small_s_fwd"] = (list(HICO_TOWER_SHAPE), (out.float() - ref.float()).abs().max().item(),
                          _rel(out, ref))
    del q, k, v, out, ref
    b, s, h, d, dv = HICO_ATTN_SHAPE
    q = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    kv = torch.randn(b, s, h, d + dv, device="cuda", generator=g).bfloat16()
    k, v = kv[..., :d], kv[..., d:]
    before = fa.launch_count("flash_fwd_causal")
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    if fa.launch_count("flash_fwd_causal") != before + 1:
        raise AssertionError(f"{HICO_ATTN_SHAPE} did not launch K5")
    ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True)
    res["flash_fwd_causal"] = (list(HICO_ATTN_SHAPE),
                               (out.float() - ref.float()).abs().max().item(), _rel(out, ref))
    e_lse = (lse - ref_lse).abs().max().item()
    for name, (shape, max_abs, rel) in res.items():
        print(f"{name} bf16 {tuple(shape)} (the HiCo path's shape): out rel-L2 {rel:.3e} "
              f"(bar 1e-2), max-abs {max_abs:.3e}"
              + (f", lse max-abs {e_lse:.3e}" if name == "flash_fwd_causal" else ""), flush=True)
        if not rel <= 1e-2:
            raise AssertionError(f"bf16 {name} disagrees with its plain version at {shape}")
    return res


def time_hico_kernels(fa, card) -> dict:
    """Phase 24b, times: K5 at HICO_ATTN_SHAPE (the video prefill's causal
    (1, 1056, 20, 192 / 128), k / v strided views) and K2 at
    HICO_TOWER_SHAPE (the tower's (64, 196, 16, 72) at 128 frames, qkv
    views), each beside its plain version, its bound and the SDPA
    yardstick. Returns kernel name -> times."""
    g = torch.Generator("cuda").manual_seed(242)
    b, s, h, d, dv = HICO_ATTN_SHAPE
    q = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    kv = torch.randn(b, s, h, d + dv, device="cuda", generator=g).bfloat16()
    k, v = kv[..., :d], kv[..., d:]
    scale = d ** -0.5
    with torch.no_grad():
        ms = _time_ms(lambda: fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0), iters=50,
                      warmup=5)
        plain_ms = _time_ms(lambda: fa.flash_attention_ref_with_lse(q, k, v, scale, True),
                            iters=3)
        lib_ms, lib_note = _sdpa_causal_ms(q, k, v)
    pairs = b * h * s * (s + 1) // 2
    bound = _bound(2 * pairs * (d + dv), (2 * b * s * h * d + 2 * b * s * h * dv) * 2
                   + b * h * s * 4)
    print(f"[{card}] K5 flash_fwd_causal {HICO_ATTN_SHAPE} (the HiCo video prefill) bf16: "
          f"kernel {ms:.4f} ms ({2 * pairs * (d + dv) / ms / 1e9:.1f} TFLOP/s), bound "
          f"{bound[0]:.4f} ms ({bound[1]}), plain {plain_ms:.3f} ms, SDPA yardstick "
          + (f"{lib_ms:.4f} ms ({lib_note})" if lib_ms is not None else lib_note), flush=True)
    res = {"flash_fwd_causal": dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                    library_note=lib_note, bound=bound,
                                    shape=list(HICO_ATTN_SHAPE))}
    del q, kv, k, v
    b, s, h, d = HICO_TOWER_SHAPE
    _, (q, k, v) = _qkv_views(b, s, h, d, g)
    scale = d ** -0.5
    with torch.no_grad():
        ms = _time_ms(lambda: fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd"),
                      iters=50, warmup=5)
        plain_ms = _time_ms(lambda: fa.small_s_attention_ref(q, k, v, scale), iters=3)
        lib_ms = _sdpa_fwd_ms(q, k, v)
    bound = _fwd_bound(b, s, h, d)
    print(f"[{card}] K2 small_s_fwd {HICO_TOWER_SHAPE} (the HiCo tower at 128 frames) bf16: "
          f"kernel {ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), plain {plain_ms:.3f} ms, "
          f"flash SDPA yardstick {lib_ms:.4f} ms", flush=True)
    res["small_s_fwd"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              library_note="flash SDPA forward", bound=bound,
                              shape=list(HICO_TOWER_SHAPE))
    return res


def _compose_prompt(cfg, frames: int, n_text: int, seed: int):
    """(ids (1, L), mRoPE positions (3, 1, L), video (1, frames, 224, 224, 3)
    bf16) for one clip on the card: text, vision_start, the clip's merged
    tokens (HiCo-compressed when the config says so), vision_end, text."""
    from internvideo_tpu_torch.data.mllm_tokenize import get_rope_index_3d

    v = cfg.vision
    gt, gh = frames // v.temporal_patch_size, 224 // v.patch_size
    per_frame = cfg.hico_tokens_per_frame or (gh // v.spatial_merge_size) ** 2
    rng = torch.Generator().manual_seed(seed)
    text = torch.randint(1, 150000, (n_text,), generator=rng)
    ids = torch.cat([text[:4], torch.tensor([cfg.vision_start_token_id]),
                     torch.full((gt * per_frame,), cfg.video_token_id),
                     torch.tensor([cfg.vision_end_token_id]), text[4:]])
    grid = None
    if not cfg.hico_tokens_per_frame:  # a HiCo run has no spatial grid left
        grid = torch.tensor([[gt, gh, gh]]).numpy()
    pos = get_rope_index_3d(ids.numpy(), grid, image_token_id=cfg.image_token_id,
                            video_token_id=cfg.video_token_id,
                            vision_start_token_id=cfg.vision_start_token_id) if grid is not None \
        else None
    g = torch.Generator("cuda").manual_seed(seed)
    video = torch.randn(1, frames, 224, 224, 3, device="cuda", generator=g).bfloat16()
    pos = None if pos is None else torch.from_numpy(pos).long()[:, None].to("cuda")
    return ids[None].to("cuda"), pos, video


def _gqa_compose(**text_overrides):
    """The Qwen3-VL-dense compose on the card: internvideo3_8b with the
    qwen3_8b_dense text model (as tests/test_gqa_llm.py composes it at tiny
    widths), seeded weights, eval mode."""
    from internvideo_tpu_torch.models import presets
    from internvideo_tpu_torch.models.mllm import VideoMLLM

    cfg = dataclasses.replace(presets.internvideo3_8b(),
                              text=presets.qwen3_8b_dense(**text_overrides))
    return VideoMLLM(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0)).eval()


def _llm_gqa(**overrides):
    """qwen3_8b_dense on the card with seeded weights (the generate CLI's
    init for `--seed 0`), in eval mode."""
    from internvideo_tpu_torch.models import presets
    from internvideo_tpu_torch.models.llm_gqa import GQATransformer

    return GQATransformer(presets.qwen3_8b_dense(**overrides), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0)).eval()


def run_gqa_path(fa, pd, card) -> dict:
    """Phase 25; returns the launches of each kernel summed over the
    generate CLI run and the compose's video generate."""
    from internvideo_tpu_torch.cli import generate as cli
    from internvideo_tpu_torch.models.generation import generate

    zero = dict.fromkeys(_serve_counts(fa, pd), 0)
    ids = torch.randint(1, VOCAB, (512,), generator=torch.Generator().manual_seed(25))
    argv = ["--preset", PRESET_GQA, "--ids", ",".join(map(str, ids.tolist())), "--device", "cuda"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    _serve_reset(fa, pd)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--max-new-tokens", "32"])
    torch.cuda.synchronize()
    launches = _serve_counts(fa, pd)
    tokens = json.loads(buf.getvalue().strip().splitlines()[-1])["tokens"]
    print(f"[{card}] cli.generate --preset {PRESET_GQA} (dense cache), 512-token prompt, 32 new: "
          f"{tokens[:8]}... ({time.perf_counter() - t0:.1f} s wall incl. the 8B init); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    want = {**zero, "flash_fwd_causal_gqa": GQA_DEPTH}  # decode: the plain route, as in JAX
    if rc != 0 or len(tokens) != 32 or not all(0 <= t < VOCAB for t in tokens):
        raise AssertionError(f"cli.generate returned {len(tokens)} tokens: {tokens}")
    if launches != want:
        raise AssertionError(f"launches {launches} on the GQA generate CLI; expected {want}")
    total = dict(launches)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv + ["--max-new-tokens", "2", "--paged"])
    except ValueError as e:
        if "dense-GQA" not in str(e):
            raise
        print(f"cli.generate --preset {PRESET_GQA} --paged refused: {e}", flush=True)
    else:
        raise AssertionError("--paged with the dense-GQA preset did not raise")
    gc.collect()
    torch.cuda.empty_cache()

    model = _gqa_compose()
    ids, pos, video = _compose_prompt(model.config, 16, 36, seed=25)
    _serve_reset(fa, pd)
    t0 = time.perf_counter()
    out = generate(model, ids, video=video, position_ids=pos, max_new_tokens=16,
                   cache_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = _serve_counts(fa, pd)
    toks = out[0].tolist()
    print(f"[{card}] Qwen3-VL-dense compose (internvideo3_8b + {PRESET_GQA}), dense generate with "
          f"one 16 x 224 clip, {ids.shape[1]}-token prompt, 3-D mRoPE positions, 16 new: "
          f"{toks[:8]}... in {time.perf_counter() - t0:.2f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    want = {**zero, "small_s_fwd": TOWER_DEPTH, "flash_fwd_causal_gqa": GQA_DEPTH}
    if len(toks) != 16 or not all(0 <= t < VOCAB for t in toks):
        raise AssertionError(f"compose generate gave {toks}")
    if launches != want:
        raise AssertionError(f"launches {launches} on the compose's video prefill; want {want}")
    return {k: total[k] + launches[k] for k in total}


def _hico_model(**over):
    from internvideo_tpu_torch.models import presets
    from internvideo_tpu_torch.models.mllm import VideoMLLM

    return VideoMLLM(presets.internvideo25_hico_2b(**over), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0)).eval()


def run_mllm_path(fa, pd, card):
    """Phase 26; returns (the HiCo 2B model, the launches of each kernel
    summed over the tower, prefill, decode and engine runs)."""
    import numpy as np

    from internvideo_tpu_torch.models.llm import init_paged_cache
    from internvideo_tpu_torch.serve import ServingEngine

    zero = dict.fromkeys(_serve_counts(fa, pd), 0)
    model = _hico_model()
    cfg, n_text = model.config, HICO_PROMPT - HICO_VISUAL - 2
    ids, _, video = _compose_prompt(cfg, HICO_FRAMES, n_text, seed=26)
    total = dict(zero)

    def counted(what, fn, want):
        _serve_reset(fa, pd)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        launches = _serve_counts(fa, pd)
        print(f"[{card}] {PRESET_HICO} {what}: {time.perf_counter() - t0:.2f} s wall; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        if launches != {**zero, **want}:
            raise AssertionError(f"launches {launches} on {what}; expected {want}")
        for k in total:
            total[k] += launches[k]
        return out

    visual, taps = counted(f"encode_video, {HICO_FRAMES} frames x 224",
                           lambda: model.encode_video(video), {"small_s_fwd": HICO_TOWER_DEPTH})
    if visual.shape != (1, HICO_VISUAL, cfg.text.hidden_size) or taps:
        raise AssertionError(f"HiCo visual tokens {tuple(visual.shape)}, {len(taps)} taps")
    pages, tables = init_paged_cache(cfg.text, 1, HICO_PROMPT + 64, 64, torch.bfloat16, "cuda")
    out = counted(f"paged video prefill, {HICO_PROMPT} tokens",
                  lambda: model.prefill_paged(ids, video, pages, tables, 64),
                  {"small_s_fwd": HICO_TOWER_DEPTH, "flash_fwd_causal": HICO_TEXT_DEPTH})
    if not torch.isfinite(out.logits).all():
        raise AssertionError("non-finite logits from the video prefill")
    del pages, out
    b = HICO_DECODE_B
    pages, tables = init_paged_cache(cfg.text, b, HICO_PROMPT + 64, 64, torch.bfloat16, "cuda")
    tok = torch.randint(1, VOCAB, (b, 1), device="cuda")
    lens = torch.full((b,), HICO_PROMPT, dtype=torch.int32, device="cuda")

    def decode4():
        for step in range(4):
            out = model.decode_step_paged(tok, pages, tables, lens + step, 64)
        return out

    counted(f"4 paged decode steps at B = {b}", decode4,
            {"paged_decode": HICO_TEXT_DEPTH * 4})
    del pages

    eng = ServingEngine(model, max_batch=8, page_size=64, num_pages=160, max_len=1152,
                        prompt_buckets=(128, 1088))
    calls = _wrap_calls(model)
    rng = np.random.default_rng(26)
    reqs = []
    for i in range(8):
        if i % 2 == 0:  # a video request: its own clip and text tail
            rids, _, rvideo = _compose_prompt(cfg, HICO_FRAMES, n_text, seed=260 + i)
            reqs.append((rids[0].cpu().numpy().astype(np.int32), rvideo[0], 32))
        else:
            reqs.append((rng.integers(1, VOCAB, size=int(rng.integers(60, 128))).astype(np.int32),
                         None, int(rng.integers(24, 49))))
    _serve_reset(fa, pd)
    t0 = time.perf_counter()
    rids = [eng.submit(p, m, video=v) for p, v, m in reqs]
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _serve_counts(fa, pd)
    n_tok = sum(len(outs[r]) for r in rids)
    print(f"[{card}] ServingEngine {PRESET_HICO}: 4 video requests ({HICO_FRAMES} frames, "
          f"{HICO_PROMPT}-token prompts) + 4 text requests, {n_tok} tokens in {wall:.2f} s "
          f"({n_tok / wall:.1f} tokens/s end to end incl. the towers and prefills); "
          f"{calls['prefill']} prefill calls, {calls['decode']} decode steps; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    for rid, (p, v, m) in zip(rids, reqs):
        out = outs[rid]
        if len(out) != m or not ((out >= 0) & (out < VOCAB)).all():
            raise AssertionError(f"request {rid}: {len(out)} of {m} tokens, {out}")
    want = {**zero, "small_s_fwd": HICO_TOWER_DEPTH * 4,
            "flash_fwd_causal": HICO_TEXT_DEPTH * calls["prefill"],
            "paged_decode": HICO_TEXT_DEPTH * calls["decode"]}
    if launches != want or calls["prefill"] != 8:
        raise AssertionError(f"launches {launches} for {calls} on the engine; expected {want}")
    for name in ("prefill_paged", "decode_step_paged"):
        delattr(model, name)
    del eng
    return model, {k: total[k] + launches[k] for k in total}


def _fp32_copy(model, build):
    """`build(dtype="float32")` on the card with `model`'s weights."""
    ref = build()
    with torch.no_grad():
        for p32, p16 in zip(ref.parameters(), model.parameters()):
            p32.copy_(p16)
    return ref.eval()


def _capture(modules: dict, run) -> dict:
    """Run `run()` with forward pre-hooks on `modules` (tag -> module);
    returns tag -> (args, kwargs) of each module's first call."""
    capture, undo = {}, []
    for tag, mod in modules.items():
        def record(m, args, kwargs, tag=tag):
            capture.setdefault(tag, (args, kwargs))

        undo.append(mod.register_forward_pre_hook(record, with_kwargs=True).remove)
    with torch.no_grad():
        run()
    for fn in undo:
        fn()
    return capture


def _layers_kernel_vs_plain(modules: dict, capture: dict, what: str) -> None:
    for tag, (args, kw) in sorted(capture.items()):
        mod, outs = modules[tag], {}
        with torch.no_grad():
            for impl in ("kernel", "plain"):
                mod.attn_impl = impl
                outs[impl] = mod(*args, **kw)
        mod.attn_impl = "kernel"
        rel = _rel(outs["kernel"], outs["plain"])
        print(f"{what} bf16 {tag} on its real inputs, kernel vs plain route: rel-L2 {rel:.3e} "
              "(bar 1e-2)", flush=True)
        if not rel <= 1e-2:
            raise AssertionError(f"routes disagree at {what} {tag}")


def _hold_to_fp32(res, f32, what: str) -> None:
    """Logits: the bf16 kernel route no farther from the fp32 run than the
    bf16 plain route (x 1.25), the fp32 routes within 1e-4 of each other."""
    rows = [(_rel(res["kernel"][n], res["plain"][n]), _rel(res["kernel"][n], f32["plain"][n]),
             _rel(res["plain"][n], f32["plain"][n]), _rel(f32["kernel"][n], f32["plain"][n]))
            for n in range(len(res["kernel"]))]
    print(f"{what}, logits rel-L2 [bf16 kernel vs bf16 plain | bf16 kernel vs fp32 | bf16 plain "
          "vs fp32 | fp32 kernel vs fp32 plain]: "
          + "; ".join(" / ".join(f"{x:.3e}" for x in r) for r in rows), flush=True)
    if not all(torch.isfinite(x).all() for x in res["kernel"]):
        raise AssertionError(f"non-finite logits on the kernel route ({what})")
    if not all(rk <= 1.25 * rp and r32 <= 1e-4 for _, rk, rp, r32 in rows):
        raise AssertionError(f"{what}: the kernel route is farther from the fp32 run than the "
                             "plain route, or the fp32 routes disagree")


def _mllm_route_logits(model, impl, ids, video, fed) -> list:
    """Paged video prefill + 4 paged decode steps fed `fed` on route `impl`:
    the 5 last-position logits (fp32)."""
    from internvideo_tpu_torch.models.llm import init_paged_cache

    _set_route(model, impl)
    b, s = ids.shape
    dt = model.language_model.embed_tokens.weight.dtype
    pages, tables = init_paged_cache(model.config.text, b, s + 64, 64, dt, "cuda")
    with torch.no_grad():
        out = model.prefill_paged(ids, video.to(dt), pages, tables, 64)
        logits = [out.logits[:, -1].float()]
        for step in range(4):
            lens = torch.full((b,), s + step, dtype=torch.int32, device="cuda")
            out = model.decode_step_paged(fed[:, step:step + 1], pages, tables, lens, 64)
            logits.append(out.logits[:, -1].float())
    _set_route(model, "kernel")
    return logits


def _gqa_route_logits(model, impl, ids, fed) -> list:
    """Dense prefill + 4 dense decode steps fed `fed` on route `impl`: the 5
    last-position logits (fp32)."""
    _set_route(model, impl)
    b, s = ids.shape
    caches = model.init_cache(b, s + 8, model.embed_tokens.weight.dtype)
    with torch.no_grad():
        out = model.prefill(model.embed_tokens(ids), caches)
        logits = [out.logits[:, -1].float()]
        for step in range(4):
            out = model.decode_step(fed[:, step:step + 1], caches, s + step)
            logits.append(out.logits[:, -1].float())
    _set_route(model, "kernel")
    return logits


def check_mllm_routes(model, fa, pd, card) -> None:
    """Phase 27 on the HiCo 2B compose `model` (bf16, full depth), then the
    8B dense-GQA model, then fp32 at full widths and depth 2. As in phase 18,
    a deep random-init bf16 model puts any two roundings ~5e-2 apart in the
    logits, so the routes are held layer by layer on the real activations
    and end to end against the same weights run in fp32."""
    from internvideo_tpu_torch.models.generation import generate

    # the HiCo compose on the main path's prompt (128 frames, 1056 tokens):
    # layers 0 and last of the tower (K2 at HICO_TOWER_SHAPE) and of the text
    # prefill (K5 at HICO_ATTN_SHAPE) on their real inputs
    cfg = model.config
    fed = torch.randint(1, VOCAB, (1, 4), device="cuda")
    ids, _, video = _compose_prompt(cfg, HICO_FRAMES, HICO_PROMPT - HICO_VISUAL - 2, seed=27)
    last_t, last_v = cfg.text.num_layers - 1, cfg.vision.num_layers - 1
    modules = {f"text layer {i} attention": model.language_model.layers[i].self_attn
               for i in (0, last_t)}
    modules.update({f"tower block {i}": model.vision_tower.blocks[i] for i in (0, last_v)})
    capture = _capture(modules, lambda: _mllm_route_logits(model, "kernel", ids, video, fed))
    shapes = {tag: tuple(args[0].shape) for tag, (args, _) in capture.items()}
    print(f"{PRESET_HICO} captured inputs at {HICO_FRAMES} frames, {ids.shape[1]} tokens: {shapes}",
          flush=True)
    _layers_kernel_vs_plain(modules, capture, PRESET_HICO)
    del capture
    # end to end against fp32: a 16-frame clip (128 visual tokens), paged
    ids, _, video = _compose_prompt(cfg, 16, 30, seed=27)
    res = {impl: _mllm_route_logits(model, impl, ids, video, fed) for impl in ("kernel", "plain")}
    ref = _fp32_copy(model, lambda: _hico_model(
        vision=dataclasses.replace(cfg.vision, dtype="float32", param_dtype="float32"),
        text=dataclasses.replace(cfg.text, dtype="float32", param_dtype="float32")))
    f32 = {impl: _mllm_route_logits(ref, impl, ids, video, fed) for impl in ("kernel", "plain")}
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    _hold_to_fp32(res, f32, f"{PRESET_HICO} {cfg.text.num_layers} text layers, one 16 x 224 "
                  f"clip, {ids.shape[1]}-token paged video prefill + 4 paged decode steps")

    # fp32 at full widths, depth 2: greedy tokens across routes, dense vs paged
    small = _hico_model(
        vision=dataclasses.replace(cfg.vision, num_layers=2, dtype="float32",
                                   param_dtype="float32", deepstack_indexes=()),
        text=dataclasses.replace(cfg.text, num_layers=2, dtype="float32",
                                 param_dtype="float32"))
    toks = {}
    for impl in ("kernel", "plain"):
        _set_route(small, impl)
        for paged in (False, True):
            toks[(impl, paged)] = generate(small, ids, video=video.float(), max_new_tokens=8,
                                           paged=paged, page_size=64, decode_impl=impl)[0].tolist()
    _set_route(small, "kernel")
    print(f"{PRESET_HICO} widths fp32 depth 2, greedy tokens [route, paged]: {toks}", flush=True)
    if len({tuple(t) for t in toks.values()}) != 1:
        raise AssertionError("fp32 greedy tokens differ across routes or dense / paged")
    del small
    gc.collect()
    torch.cuda.empty_cache()

    # the 8B dense-GQA model, text only, dense cache
    gqa = _llm_gqa()
    g = torch.Generator("cuda").manual_seed(27)
    ids = torch.randint(1, VOCAB, (2, 512), device="cuda", generator=g)
    fed = torch.randint(1, VOCAB, (2, 4), device="cuda", generator=g)
    modules = {f"layer {i} attention": gqa.layers[i].self_attn for i in (0, GQA_DEPTH - 1)}
    # the full forward calls each attention's forward (the prefill's math)
    capture = _capture(modules, lambda: gqa(ids, with_logits=False))
    _layers_kernel_vs_plain(modules, capture, PRESET_GQA)
    del capture
    res = {impl: _gqa_route_logits(gqa, impl, ids, fed) for impl in ("kernel", "plain")}
    ref = _fp32_copy(gqa, lambda: _llm_gqa(dtype="float32", param_dtype="float32"))
    f32 = {impl: _gqa_route_logits(ref, impl, ids, fed) for impl in ("kernel", "plain")}
    del ref, gqa
    gc.collect()
    torch.cuda.empty_cache()
    _hold_to_fp32(res, f32, f"{PRESET_GQA} {GQA_DEPTH} layers B=2 512-token prompts, dense "
                  "prefill + 4 dense decode steps")
    small = _llm_gqa(num_layers=2, dtype="float32", param_dtype="float32")
    toks = {}
    for impl in ("kernel", "plain"):
        _set_route(small, impl)
        toks[impl] = generate(small, ids[:, :100], max_new_tokens=8)[0].tolist()
    print(f"{PRESET_GQA} widths fp32 depth 2, greedy tokens by route: {toks}", flush=True)
    if toks["kernel"] != toks["plain"]:
        raise AssertionError("fp32 GQA greedy tokens differ across routes")


def _sdpa_gqa_ms(q, k, v, window) -> tuple:
    """PyTorch SDPA on the same (B, S, H, D) inputs with enable_gqa, causal
    (is_causal) or with a window (an explicit boolean band mask), as a
    yardstick only (never on the port's path): (ms, note)."""
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(is_causal=True)
    note = "SDPA enable_gqa, is_causal"
    if window is not None:
        rel = (torch.arange(q.shape[2], device="cuda")[:, None]
               - torch.arange(k.shape[2], device="cuda")[None])
        kw = dict(attn_mask=(rel >= 0) & (rel < window))
        note = "SDPA enable_gqa, explicit band mask"
    try:
        return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw),
                        iters=10, warmup=2), note
    except RuntimeError as e:  # no backend takes it: no yardstick
        return None, f"{note}: refused ({str(e).splitlines()[0][:100]})"


def _band_pairs(s: int, window) -> int:
    """(query, key) pairs a causal row block of S rows sees with a window."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def time_gqa_kernel(fa, card) -> dict:
    """Phase 28, kernel: K5 with GQA at GQA_SHAPE causal, window None and
    GQA_WINDOW, beside its plain version, its bound and the SDPA yardstick."""
    g = torch.Generator("cuda").manual_seed(28)
    b, s, hq, hkv, d = GQA_SHAPE
    q = torch.randn(b, s, hq, d, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    scale, res = d ** -0.5, {}
    for window in (None, GQA_WINDOW):
        with torch.no_grad():
            ms = _time_ms(lambda: fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0, None, None,
                                                            window), iters=20, warmup=3)
            plain_ms = _time_ms(lambda: fa.flash_attention_ref_with_lse(
                q, k, v, scale, True, 0, None, None, window), iters=1)
            lib_ms, lib_note = _sdpa_gqa_ms(q, k, v, window)
        pairs = b * hq * _band_pairs(s, window)
        bound = _bound(4 * pairs * d, (2 * b * s * hq * d + 2 * b * s * hkv * d) * 2
                       + b * hq * s * 4)
        name = _gqa_name(window)
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library_note=lib_note,
                         bound=bound, shape=[b, s, hq, hkv, d], window=window)
        print(f"[{card}] K5 {name} {GQA_SHAPE} causal window {window} bf16: kernel {ms:.3f} ms "
              f"({4 * pairs * d / ms / 1e9:.1f} TFLOP/s), bound {bound[0]:.3f} ms ({bound[1]}), "
              f"plain {plain_ms:.3f} ms, yardstick "
              + (f"{lib_ms:.3f} ms ({lib_note})" if lib_ms is not None else lib_note), flush=True)
    return res


def time_mllm(model, card) -> dict:
    """Phase 28, the HiCo path as bench.py:509-620 times it (B = 1 tower and
    paged video prefill with 1-D positions, paged decode at B = 8, seq
    HICO_PROMPT); one prefill and one decode step under torch.profiler."""
    from internvideo_tpu_torch.models.llm import init_paged_cache

    cfg = model.config
    ids, _, video = _compose_prompt(cfg, HICO_FRAMES, HICO_PROMPT - HICO_VISUAL - 2, seed=28)
    pages, tables = init_paged_cache(cfg.text, 1, HICO_PROMPT + 64, 64, torch.bfloat16, "cuda")
    b = HICO_DECODE_B
    dpages, dtables = init_paged_cache(cfg.text, b, HICO_PROMPT + 64, 64, torch.bfloat16, "cuda")
    tok = torch.randint(1, VOCAB, (b, 1), device="cuda")
    lens = torch.full((b,), HICO_PROMPT, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        vision = lambda: model.encode_video(video)  # noqa: E731
        prefill = lambda: model.prefill_paged(ids, video, pages, tables, 64)  # noqa: E731
        decode = lambda: model.decode_step_paged(tok, dpages, dtables, lens, 64)  # noqa: E731
        vision_ms = _time_ms(vision, iters=5)
        ttft_ms = _time_ms(prefill, iters=5)
        decode_ms = _time_ms(decode, iters=20, warmup=3)
        res = {"mllm_video128_vision_ms": vision_ms, "mllm_video128_ttft_ms": ttft_ms,
               "mllm_video128_decode_tokens_per_sec": b * 1e3 / decode_ms,
               "mllm_video128_decode_step_ms": decode_ms}
        print(f"[{card}] {PRESET_HICO}, {HICO_FRAMES} frames x 224 (bench.py's video128 shapes, "
              f"paged, 1-D positions): vision (tower + HiCo-R16) {vision_ms:.1f} ms; TTFT "
              f"(tower + {HICO_PROMPT}-token paged prefill, B=1) {ttft_ms:.1f} ms; paged decode "
              f"step B={b} seq {HICO_PROMPT} {decode_ms:.2f} ms = {b * 1e3 / decode_ms:.1f} "
              "tokens/s", flush=True)
        profile_step(prefill, card, f"{PRESET_HICO} video prefill ({HICO_FRAMES} frames, B=1)")
        profile_step(decode, card, f"{PRESET_HICO} paged decode step B={b}")
    return res


def time_gqa_llm(card) -> dict:
    """Phase 28, the dense-GQA model: prefill at PREFILL_SHAPE into the dense
    cache and a dense decode step at B = 8, seq 2048 (the plain route, as in
    JAX), tokens/s and the bounds; one of each under torch.profiler."""
    model = _llm_gqa()
    cfg = model.cfg
    b, s = PREFILL_SHAPE
    g = torch.Generator("cuda").manual_seed(28)
    ids = torch.randint(1, VOCAB, (b, s), device="cuda", generator=g)
    tok = torch.randint(1, VOCAB, (b, 1), device="cuda", generator=g)
    caches = model.init_cache(b, s + 64, torch.bfloat16)
    with torch.no_grad():
        embeds = model.embed_tokens(ids)
        prefill = lambda: model.prefill(embeds, caches)  # noqa: E731
        decode = lambda: model.decode_step(tok, caches, s)  # noqa: E731
        prefill_ms = _time_ms(prefill, iters=3)
        decode_ms = _time_ms(decode, iters=10, warmup=2)
        layer_params = sum(p.numel() for n, p in model.named_parameters()
                           if n.startswith("layers."))
        head = cfg.vocab_size * cfg.hidden_size
        kv_bytes = cfg.num_layers * b * s * cfg.num_kv_heads * cfg.hd * 2 * 2
        attn = cfg.num_layers * b * cfg.num_heads * _band_pairs(s, None) * 4 * cfg.hd
        prefill_bound = _bound(2 * layer_params * b * s + attn + 2 * head * b,
                               _param_bytes(model) + b * s * cfg.hidden_size * 2 + kv_bytes)
        decode_bound = _bound(2 * (layer_params + head) * b, _param_bytes(model) + kv_bytes)
        print(f"[{card}] {PRESET_GQA} prefill B={b} prompt {s} bf16 (dense cache, K5 GQA): "
              f"{prefill_ms:.1f} ms = {b * s * 1e3 / prefill_ms:.0f} tokens/s (bound "
              f"{prefill_bound[0]:.1f} ms, {prefill_bound[1]})", flush=True)
        print(f"[{card}] {PRESET_GQA} dense decode step B={b} seq {s} bf16 (plain route): "
              f"{decode_ms:.2f} ms = {b * 1e3 / decode_ms:.1f} tokens/s (bound "
              f"{decode_bound[0]:.2f} ms, {decode_bound[1]})", flush=True)
        profile_step(prefill, card, f"{PRESET_GQA} prefill B={b} S={s}")
        profile_step(decode, card, f"{PRESET_GQA} dense decode step B={b} seq {s}")
    return {"qwen3_8b_dense_prefill_tokens_per_sec": b * s * 1e3 / prefill_ms,
            "qwen3_8b_dense_prefill_ms": prefill_ms, "qwen3_8b_dense_decode_ms": decode_ms,
            "qwen3_8b_dense_decode_tokens_per_sec": b * 1e3 / decode_ms,
            "prefill_bound_ms": prefill_bound[0], "decode_bound_ms": decode_bound[0]}


def check_adamw_bf16(card) -> float:
    """Phase 22b: one bf16 AdamW step at configs/torch/sft_tiny.py's widths
    and optimizer from the same params and grads, on the card (torch's fused
    update) and on the CPU (the port's CPU route, fused too), each against
    the fp32 reference (the same step on fp32 copies, rounded to bf16 once).
    Returns the card-vs-CPU gap (rel-L2 of the update)."""
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.models.mllm import VideoMLLM
    from internvideo_tpu_torch.train.optim import Optimizer

    run = load_config("configs/torch/sft_tiny.py")
    model = VideoMLLM(run.model, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(22)
    start = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    grads = {k: (torch.randn(v.shape, generator=g) * 0.05).to(torch.bfloat16)
             for k, v in start.items()}

    def step(device, dtype):
        ps = {k: v.to(device, dtype).clone().requires_grad_() for k, v in start.items()}
        for k, p in ps.items():
            p.grad = grads[k].to(device, dtype)
        opt = Optimizer(run.trainer.optimizer, list(ps.items()))
        opt.step()
        return {k: p.detach().to("cpu", torch.bfloat16) for k, p in ps.items()}, opt

    def rel(got, want):
        num = sum(((got[k].float() - want[k].float()) ** 2).sum() for k in want)
        den = sum(((want[k].float() - start[k].float()) ** 2).sum() for k in want)
        return (num / den).sqrt().item()

    card_new, opt = step("cuda", torch.bfloat16)
    fused = all(gr.get("fused") for gr in opt.adamw.param_groups)
    cpu_new, _ = step("cpu", torch.bfloat16)
    ref, _ = step("cpu", torch.float32)
    gap, to_ref = rel(card_new, cpu_new), rel(card_new, ref)
    n_diff = sum(int((card_new[k] != cpu_new[k]).sum()) for k in start)
    print(f"[{card}] bf16 AdamW step, sft_tiny widths ({sum(v.numel() for v in start.values())} "
          f"params, lr {run.trainer.optimizer.lr}): card fused ({fused}) vs CPU route, update "
          f"rel-L2 {gap:.3e} ({n_diff} elements differ; bar 1e-3); card vs the fp32 reference "
          f"{to_ref:.3e}, CPU route vs it {rel(cpu_new, ref):.3e}", flush=True)
    if not (fused and gap <= 1e-3 and to_ref <= 1e-3):
        raise AssertionError("the card's fused bf16 AdamW update disagrees with the CPU route")
    return gap


def _bwd_name(kind: str, window, gqa: bool, seg: bool) -> str:
    """The counter of one K5 backward launch (window > GQA > segments)."""
    return f"flash_bwd_causal_{kind}" + ("_window" if window else "_gqa" if gqa
                                         else "_seg" if seg else "")


def _bwd_kernel_vs_plain(fa, q, k, v, do, dlse, kw):
    """The K5 backward kernels and the plain backward on the same inputs
    and the same plain forward's out / LSE: ((dq, dk, dv) kernel, plain,
    the LSE)."""
    causal, off, window = kw.get("causal", False), kw.get("q_position_offset", 0), kw.get("window")
    segs = kw.get("q_segment_ids"), kw.get("kv_segment_ids")
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        out, lse = fa.flash_attention_ref_with_lse(q, k, v, scale, causal, off, *segs, window)
        lse_ct = None if dlse is None else torch.where(torch.isinf(lse), 0.0, dlse)
        got = fa._flash_bwd_causal_cuda(q, k, v, out, lse, do, scale, causal, off, *segs,
                                        lse_ct=lse_ct, window=window)
        want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, scale, lse_ct=lse_ct,
                                          causal=causal, q_position_offset=off,
                                          q_segment_ids=segs[0], kv_segment_ids=segs[1],
                                          window=window)
    return got, want, lse


def check_rl_kernels(fa) -> dict:
    """Phase 29; returns the bf16 max-abs error at RL_SHAPE of each GQA /
    window backward kernel (dq: dq; dk/dv: the larger of dk and dv)."""
    g = torch.Generator("cuda").manual_seed(29)
    cases = [((1, 200, 200, 2, 2, 64), dict(window=64)),
             ((1, 128, 128, 8, 2, 64), {}),
             ((1, 128, 128, 8, 2, 64), dict(causal=True)),
             ((1, 128, 200, 4, 2, 64), dict(causal=True, window=50, q_position_offset=72)),
             ((2, 256, 256, 8, 2, 64), dict(causal=True, segments=True)),
             ((1, 256, 64, 2, 2, 64), dict(window=50))]
    for (b, sq, sk, hq, hkv, d), kw in cases:
        kw = dict(kw)
        if kw.pop("segments", False):  # two packed segments, then pads of -1 that meet
            seg = (torch.arange(sk, device="cuda")[None].expand(b, sk) // 100).to(torch.int32)
            seg = torch.where(torch.arange(sk, device="cuda") >= 220, -1, seg)
            kw.update(q_segment_ids=seg, kv_segment_ids=seg)
        q, do = (torch.randn(b, sq, hq, d, device="cuda", generator=g) for _ in range(2))
        k, v = (torch.randn(b, sk, hkv, d, device="cuda", generator=g) for _ in range(2))
        dlse = torch.randn(b, hq, sq, device="cuda", generator=g)
        names = [_bwd_name(n, kw.get("window"), hkv != hq, "q_segment_ids" in kw)
                 for n in ("dq", "dkv")]
        for lse_ct in (None, dlse):
            before = [fa.launch_count(n) for n in names]
            got, want, lse = _bwd_kernel_vs_plain(fa, q, k, v, do, lse_ct, kw)
            torch.cuda.synchronize()
            if [fa.launch_count(n) for n in names] != [c + 1 for c in before]:
                raise AssertionError(f"{kw} did not launch {names}")
            errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
            empty = torch.isinf(lse).any(dim=(0, 1))
            print(f"K5 GQA / window backward fp32 {(b, sq, sk, hq, hkv, d)} "
                  f"{ {n: x for n, x in kw.items() if not n.endswith('segment_ids')} }"
                  f"{' + segments' if 'q_segment_ids' in kw else ''}, LSE cotangent "
                  f"{lse_ct is not None}: dq / dk / dv max-abs "
                  + " / ".join(f"{e:.3e}" for e in errs)
                  + f" (bar 5e-4), {int(empty.sum())} rows with no key", flush=True)
            if not max(errs) <= 5e-4:
                raise AssertionError("fp32 K5 GQA / window backward disagrees with its plain "
                                     "version")
            if empty.any() and not (got[0][:, empty] == 0).all():
                raise AssertionError("a row with no key got a nonzero dq")
    res = {}
    b, s, hq, hkv, d = RL_SHAPE
    for window in (None, GQA_WINDOW):
        q, do = (torch.randn(b, s, hq, d, device="cuda", generator=g).bfloat16()
                 for _ in range(2))
        kv = torch.randn(b, s, 2 * hkv, d, device="cuda", generator=g).bfloat16()
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]  # strided views of one projection
        kw = dict(causal=True, window=window)
        got, want, _ = _bwd_kernel_vs_plain(fa, q, k, v, do, None, kw)
        again = _bwd_kernel_vs_plain(fa, q, k, v, do, None, kw)[0]
        torch.cuda.synchronize()
        rels = [_rel(a, w) for a, w in zip(got, want)]
        same = all(torch.equal(a, b2) for a, b2 in zip(got[1:], again[1:]))
        errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
        res[_bwd_name("dq", window, True, False)] = errs[0]
        res[_bwd_name("dkv", window, True, False)] = max(errs[1:])
        print(f"K5 GQA backward bf16 {RL_SHAPE} causal window {window}, k/v strided views: "
              "dq / dk / dv rel-L2 " + " / ".join(f"{r:.3e}" for r in rels)
              + " (bar 1e-2), max-abs " + " / ".join(f"{e:.3e}" for e in errs)
              + f"; dk / dv bit-identical across two calls: {same}", flush=True)
        if not (max(rels) <= 1e-2 and same):
            raise AssertionError(f"bf16 K5 GQA backward at {RL_SHAPE} window {window} disagrees "
                                 "with its plain version or is not deterministic")
        del q, do, kv, k, v, got, want, again
    return res


def _rl_model(depth: int, dtype: str = "bfloat16"):
    """qwen3_8b_dense at full width and `depth` on the card, seeded weights
    (remat, as the preset sets it)."""
    from internvideo_tpu_torch.models import presets
    from internvideo_tpu_torch.models.llm_gqa import GQATransformer

    cfg = presets.qwen3_8b_dense(num_layers=depth, dtype=dtype, param_dtype=dtype)
    return GQATransformer(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))


def _rl_cfg(**over):
    from internvideo_tpu_torch.train.rl import GRPOConfig
    from internvideo_tpu_torch.train.rl_trainer import RLTrainerConfig

    kw = dict(grpo=GRPOConfig(group_size=RL_GROUP, kl_beta=0.01), max_new_tokens=RL_NEW,
              rollout_temperature=1.0, lr=1e-5, cache_dtype="bfloat16", grad_accum=RL_ACCUM)
    return RLTrainerConfig(**{**kw, **over})


def _rl_prompts(prompt_len: int = RL_PROMPT_LEN, seed: int = 30):
    """RL_PROMPTS seeded token-id prompts (host int32)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, VOCAB, (RL_PROMPTS, prompt_len), generator=g).to(torch.int32).numpy()


def _rl_reward(p, r) -> float:
    """A rule-based reward in the manner of tests/test_rl_trainer.py:48-49:
    the share of response tokens in a fixed id set, ids below VOCAB / 8. (The
    share equal to one fixed id was 0 in every row of the seeded policy's
    2 x 2048 sampled tokens, which leaves no advantage and no gradient.)"""
    return float((r < VOCAB // 8).mean())


def rl_want(fa, depth: int, iters: int) -> dict:
    """Launches `iters` RL iterations at `depth` must make: per iteration
    the rollout prefill (depth), `logp_old` (depth) and, per microbatch,
    the policy forward, the reference forward and the remat recompute (3 x
    depth) of K5's GQA forward; depth each of the GQA dq and dk/dv per
    microbatch; nothing else (decode attends on the plain route)."""
    per = {"flash_fwd_causal_gqa": (2 + 3 * RL_ACCUM) * depth,
           "flash_bwd_causal_dq_gqa": RL_ACCUM * depth,
           "flash_bwd_causal_dkv_gqa": RL_ACCUM * depth}
    return {**dict.fromkeys(fa.KERNELS, 0), "paged_decode": 0,
            **{n: c * iters for n, c in per.items()}}


def run_rl_path(fa, pd, card, depth: int = RL_DEPTH):
    """Phase 30; returns (the launches of each kernel in the main-path run,
    the first rollout batch, the peak GB)."""
    import numpy as np

    from internvideo_tpu_torch.train.rl_trainer import RLTrainer

    model = _rl_model(depth)
    prompts = _rl_prompts()
    trainer = RLTrainer(model, _rl_cfg(), _rl_reward)
    kept, add = [], trainer.buffer.add
    trainer.buffer.add = lambda b: (kept.append(b), add(b))[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _serve_reset(fa, pd)
    t0 = time.perf_counter()
    history = trainer.fit(lambda i: prompts, iterations=RL_ITERS, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _serve_counts(fa, pd)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = rl_want(fa, depth, RL_ITERS)
    rows, length = RL_PROMPTS * RL_GROUP, RL_PROMPT_LEN + RL_NEW
    print(f"[{card}] RL main path: RLTrainer.fit on {PRESET_GQA} (full width, depth {depth}, "
          f"bf16, remat), {RL_ITERS} iterations of {RL_PROMPTS} prompts x {RL_GROUP} = {rows} "
          f"rows of {RL_PROMPT_LEN} + {RL_NEW} tokens, temperature 1.0, kl_beta 0.01, "
          f"grad_accum {RL_ACCUM}: {wall:.1f} s, peak {peak:.2f} GB; launches "
          + json.dumps({n: c for n, c in counts.items() if c}), flush=True)
    for h in history:
        print(f"  iter {h['iter']}: reward {h['reward_mean']:.5f} loss {h['loss']:.6f} "
              f"kl {h['kl']:.3e} ratio_mean {h['ratio_mean']:.6f} clip_frac "
              f"{h['clip_frac']:.4f}", flush=True)
    if counts != want:
        raise AssertionError(f"RL launches {counts} != {want}")
    if not all(np.isfinite([h[k] for k in ("loss", "kl", "reward_mean", "ratio_mean")]).all()
               for h in history):
        raise AssertionError("non-finite RL loss, kl or reward")
    if abs(history[0]["ratio_mean"] - 1.0) > 1e-2:
        raise AssertionError(f"first update's ratio_mean {history[0]['ratio_mean']} is not "
                             "within 1e-2 of 1")
    batch = {k: v for k, v in kept[0].items()}
    assert batch["full_ids"].shape == (rows, length)
    return counts, batch, peak


def run_rl_engine_path(fa, pd, card) -> dict:
    """Phase 30, the engine backend: one RL iteration on qwen3_8b_mla (full
    width, depth RL_ENGINE_DEPTH) with a ServingEngine rollout at
    temperature 1.0; returns the launches."""
    from internvideo_tpu_torch.serve import ServingEngine
    from internvideo_tpu_torch.train.rl_trainer import RLTrainer

    depth, plen, new = RL_ENGINE_DEPTH, RL_ENGINE_PROMPT, RL_ENGINE_NEW
    model = _llm(PRESET_8B, num_layers=depth)
    prompts = _rl_prompts(plen, seed=31)
    eng = ServingEngine(model, max_batch=8, page_size=64, num_pages=48, max_len=plen + new,
                        prompt_buckets=(plen,), temperature=1.0, seed=0)
    trainer = RLTrainer(model, _rl_cfg(max_new_tokens=new), _rl_reward,
                        engine=eng)
    calls = _wrap_calls(model)
    _serve_reset(fa, pd)
    t0 = time.perf_counter()
    h = trainer.fit(lambda i: prompts, iterations=1, seed=0)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _serve_counts(fa, pd)
    want = {**dict.fromkeys(counts, 0),
            "flash_fwd_causal": depth * (calls["prefill"] + 1 + 3 * RL_ACCUM),
            "flash_bwd_causal_dq": depth * RL_ACCUM, "flash_bwd_causal_dkv": depth * RL_ACCUM,
            "paged_decode": depth * calls["decode"]}
    print(f"[{card}] RL engine backend: {PRESET_8B} (full width, depth {depth}, bf16, remat), "
          f"ServingEngine 8 slots at temperature 1.0, {RL_PROMPTS} x {RL_GROUP} requests of "
          f"{plen} + {new} tokens: {calls['prefill']} prefills, {calls['decode']} decode steps, "
          f"{wall:.1f} s; loss {h['loss']:.6f} kl {h['kl']:.3e} ratio_mean "
          f"{h['ratio_mean']:.6f}; launches " + json.dumps({n: c for n, c in counts.items() if c}),
          flush=True)
    if counts != want or calls["prefill"] != RL_PROMPTS * RL_GROUP:
        raise AssertionError(f"RL engine launches {counts} != {want}")
    if not all(math.isfinite(h[k]) for k in ("loss", "kl", "reward_mean", "ratio_mean")):
        raise AssertionError("non-finite RL loss, kl or reward on the engine backend")
    return counts


def _rl_loss_grads(trainer, batch, impl: str, names=None):
    """One policy update's loss and gradients on route `impl` (policy and
    reference), and the policy's token log-probs: (loss, {name: grad},
    logp)."""
    from internvideo_tpu_torch.train.rl_trainer import sequence_logprobs

    for m in (trainer.model, trainer.ref_model):
        if m is not None:
            _set_route(m, impl)
    trainer.model.zero_grad(set_to_none=True)
    loss, _ = trainer._loss_of(batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None and (names is None or n in names)}
    trainer.model.zero_grad(set_to_none=True)
    with torch.no_grad():
        logp = sequence_logprobs(trainer.model, batch["full_ids"])
    return loss.detach(), grads, logp


def check_rl_routes(batch, card, depth: int = RL_DEPTH) -> None:
    """Phase 31: one policy update from phase 30's first rollout batch (its
    first RL_SHAPE[0] rows), kernel route vs plain route."""
    from internvideo_tpu_torch.train.rl_trainer import RLTrainer

    sub = {k: v[:RL_SHAPE[0]] for k, v in batch.items()}
    # the rollout's ids, mask and logp_old with set advantages: its rewards
    # are nearly all 0, so its own advantages would leave no gradient
    sub["advantages"] = torch.tensor([1.0, -1.0, 0.5, -0.5], device="cuda")[:RL_SHAPE[0]]
    # fp32, full width, depth 2, with the KL reference
    trainer = RLTrainer(_rl_model(2, "float32"), _rl_cfg(), None)
    res = {impl: _rl_loss_grads(trainer, sub, impl) for impl in ("kernel", "plain")}
    (lk, gk, _), (lp, gp, _) = res["kernel"], res["plain"]
    worst = max(((gk[n] - gp[n]).abs().max().item(), n) for n in gk)
    print(f"[{card}] RL route check fp32 (full width, depth 2, {RL_SHAPE[0]} x "
          f"{sub['full_ids'].shape[1]}): loss kernel {lk.item():.7f} plain {lp.item():.7f}, "
          f"max-abs grad difference {worst[0]:.3e} at {worst[1]} over {len(gk)} tensors "
          "(bar 5e-4)", flush=True)
    if not ((lk - lp).abs().item() <= 5e-4 and worst[0] <= 5e-4 and set(gk) == set(gp)):
        raise AssertionError("RL fp32 kernel and plain routes disagree")
    del trainer, res, gk, gp
    gc.collect()
    torch.cuda.empty_cache()
    # bf16 at depth D, held to the same weights in fp32 (no KL reference: one
    # bf16 and one fp32 copy of the policy fit the card, a reference beside
    # each would not); gradients kept for the attention projections of the
    # first and last layers
    names = {f"layers.{i}.self_attn.{p}.weight" for i in (0, depth - 1)
             for p in ("q_proj", "k_proj", "v_proj", "o_proj")}
    cfg = _rl_cfg(grpo=dataclasses.replace(_rl_cfg().grpo, kl_beta=0.0))
    model = _rl_model(depth)
    model.requires_grad_(False)
    for n, p in model.named_parameters():
        p.requires_grad_(n in names)
    trainer = RLTrainer(model, cfg, None)
    res = {impl: _rl_loss_grads(trainer, sub, impl, names) for impl in ("kernel", "plain")}
    model32 = _fp32_copy(model, lambda: _rl_model(depth, "float32"))
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    model32.requires_grad_(False)
    for n, p in model32.named_parameters():
        p.requires_grad_(n in names)
    f32 = _rl_loss_grads(RLTrainer(model32, cfg, None), sub, "plain", names)
    rel_logp = {impl: _rel(res[impl][2], f32[2]) for impl in res}
    rows, ok = [], rel_logp["kernel"] <= 1.25 * rel_logp["plain"]
    for n in sorted(names):
        rk, rp = _rel(res["kernel"][1][n], f32[1][n]), _rel(res["plain"][1][n], f32[1][n])
        rows.append(f"{n} {_rel(res['kernel'][1][n], res['plain'][1][n]):.3e} / {rk:.3e} / "
                    f"{rp:.3e}")
        ok &= rk <= 1.25 * rp and bool(torch.isfinite(res["kernel"][1][n]).all())
    # the loss is left out of the rule: a near-cancelling sum of ratio
    # deviations from logp_old, which the bf16 kernel route computed
    lk, lp, l32 = res["kernel"][0].item(), res["plain"][0].item(), f32[0].item()
    print(f"[{card}] RL route check bf16 (full width, depth {depth}): loss kernel {lk:.6f} "
          f"plain {lp:.6f} fp32 {l32:.6f}; token log-probs rel-L2 to fp32 kernel "
          f"{rel_logp['kernel']:.3e} plain {rel_logp['plain']:.3e}; grad rel-L2 [kernel vs "
          "plain | kernel vs fp32 | plain vs fp32]: " + "; ".join(rows), flush=True)
    if not ok:
        raise AssertionError("RL bf16: the kernel route is farther from the fp32 run than the "
                             "plain route")


def _sdpa_gqa_bwd_ms(q, k, v, do, window):
    """PyTorch SDPA's backward (forward + backward minus forward) with
    enable_gqa on the same (B, S, H, D) inputs, causal or with a band mask,
    as a yardstick only: (ms, note)."""
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    kw, note = dict(is_causal=True), "SDPA enable_gqa, is_causal"
    if window is not None:
        rel = (torch.arange(q.shape[1], device="cuda")[:, None]
               - torch.arange(k.shape[1], device="cuda")[None])
        kw, note = dict(attn_mask=(rel >= 0) & (rel < window)), "SDPA enable_gqa, band mask"
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    try:
        with torch.no_grad():
            f_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                                   **kw), iters=10, warmup=2)
        fb_ms = _time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, enable_gqa=True, **kw), leaves, dot),
            iters=10, warmup=2)
        return fb_ms - f_ms, note + " (forward + backward - forward)"
    except RuntimeError as e:  # no backend takes it: no yardstick
        return None, f"{note}: refused ({str(e).splitlines()[0][:100]})"


def time_rl_kernels(fa, card) -> dict:
    """Phase 32, kernels: K5's GQA dq and dk/dv at RL_SHAPE causal, window
    None and GQA_WINDOW, beside the plain backward, the bound and the SDPA
    yardstick."""
    g = torch.Generator("cuda").manual_seed(32)
    b, s, hq, hkv, d = RL_SHAPE
    q, do = (torch.randn(b, s, hq, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    scale, res = d ** -0.5, {}
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    io = (2 * b * s * hq * d + 2 * b * s * hkv * d) * 2 + 2 * b * hq * s * 4  # q, dO, k, v; lse, delta
    for window in (None, GQA_WINDOW):
        with torch.no_grad():
            out, lse = fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0, None, None, window)
            delta = fa._bwd_delta(out, do)
            plain_ms = _time_ms(lambda: fa.flash_attention_bwd_ref(
                q, k, v, out, lse, do, scale, causal=True, window=window), iters=1)
        lib_ms, lib_note = _sdpa_gqa_bwd_ms(q, k, v, do, window)
        pairs = b * hq * _band_pairs(s, window)
        for kind, flops, out_bytes in (("dq", 6, b * s * hq * d * 2),
                                       ("dkv", 8, 2 * b * s * hkv * d * 2)):
            ms = _time_ms(lambda: fa._launch_bwd_causal(
                kind, q, k, v, do, lse, delta, (None, None), grads, scale, True, 0, window),
                iters=20, warmup=3)
            bound = _bound(flops * pairs * d, io + out_bytes)
            name = _bwd_name(kind, window, True, False)
            res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library_note=lib_note,
                             bound=bound, shape=[b, s, hq, hkv, d], window=window)
            print(f"[{card}] K5 {name} {RL_SHAPE} causal window {window} bf16: kernel "
                  f"{ms:.3f} ms ({flops * pairs * d / ms / 1e9:.1f} TFLOP/s), bound "
                  f"{bound[0]:.4f} ms ({bound[1]}), plain backward {plain_ms:.3f} ms, yardstick "
                  + (f"{lib_ms:.3f} ms ({lib_note}, dq + dk/dv)" if lib_ms is not None
                     else lib_note), flush=True)
    return res


def _timed(obj, name: str, bucket: dict) -> None:
    """Replace obj.name with a version that synchronises the card before and
    after each call and adds its wall ms to bucket[name]."""
    fn = getattr(obj, name)
    bucket[name] = 0.0

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        bucket[name] += (time.perf_counter() - t0) * 1e3
        return r

    setattr(obj, name, timed)


def time_rl_iteration(card, depth: int = RL_DEPTH) -> dict:
    """Phase 32, the iteration: after one warm-up iteration, one RL
    iteration split into rollout prefill, decode, logp_old (and the host's
    reward / mask), the updates (reference + policy forward, remat, backward
    over RL_ACCUM microbatches) and the optimizer step; update tokens/s; one
    microbatch update under torch.profiler."""
    from internvideo_tpu_torch.train.rl_trainer import RLTrainer

    model = _rl_model(depth)
    prompts = _rl_prompts()
    trainer = RLTrainer(model, _rl_cfg(), _rl_reward)
    trainer.fit(lambda i: prompts, iterations=1, seed=0)  # warm-up
    ms = {}
    _timed(model, "prefill", ms)
    _timed(trainer, "_rollout", ms)
    _timed(trainer, "rollout_step", ms)
    _timed(trainer, "train_step", ms)
    _timed(trainer.optimizer, "step", ms)
    trainer.rollout_step(prompts, trainer._gen)
    batch = trainer.buffer.items[0]
    trainer.train_step()
    split = {"rollout_prefill": ms["prefill"], "decode": ms["_rollout"] - ms["prefill"],
             "logp_old_and_reward": ms["rollout_step"] - ms["_rollout"],
             "updates": ms["train_step"] - ms["step"], "optimizer_step": ms["step"]}
    total = ms["rollout_step"] + ms["train_step"]
    tokens = batch["full_ids"].numel()
    res = {"iteration_ms": total, **{f"{k}_ms": v for k, v in split.items()},
           "update_tokens_per_sec": tokens * 1e3 / ms["train_step"], "depth": depth}
    print(f"[{card}] RL iteration {PRESET_GQA} depth {depth}, {tuple(batch['full_ids'].shape)} "
          f"rows x tokens: {total:.1f} ms = " + ", ".join(
              f"{k} {v:.1f} ms ({v / total:.1%})" for k, v in split.items())
          + f"; update {res['update_tokens_per_sec']:.0f} tokens/s", flush=True)
    micro = RL_SHAPE[0]
    mb = {k: v[:micro] for k, v in batch.items()}

    def one_microbatch():
        loss, _ = trainer._loss_of(mb)
        (loss * mb["mask"].sum()).backward()
        model.zero_grad(set_to_none=True)

    profile_step(one_microbatch, card, f"RL microbatch update {micro} x {mb['full_ids'].shape[1]}")
    return res


# -- int8 serving: phases 33-37 -------------------------------------------------------------

def _int8_counts(fa, pd, ig) -> dict:
    return {**_serve_counts(fa, pd), "int8_gemm": ig.launch_count()}


def _int8_reset(fa, pd, ig) -> None:
    _serve_reset(fa, pd)
    ig.reset_launch_count()


def _int8_inputs(m_shape, k, n, dtype, g):
    """x (m_shape, K) with row 0 all zero and row 1 of exact .5 ties (amax
    127: the scale is 1, x / s = x), weights quantized per output channel."""
    from internvideo_tpu_torch.ops.quant import quantize_int8

    x = torch.randn(*m_shape, k, device="cuda", generator=g)
    rows = x.view(-1, k)
    rows[0] = 0.0
    rows[1] = torch.arange(k, device="cuda") % 5 - 2.5
    rows[1, 0] = 127.0
    w_q, w_s = quantize_int8(torch.randn(n, k, device="cuda", generator=g) * 0.05, 1)
    return x.to(dtype), w_q, w_s.reshape(-1)


def _int8_vs_plain(ig, x, w_q, w_s, out_dtype):
    """(max-abs, rel-L2, elements that differ) of K7 against its plain
    version; raises past the bars (f32: relative 1e-6, bf16: rel-L2 1e-2)."""
    with torch.no_grad():
        got = ig.int8_matmul_fused(x, w_q, w_s, out_dtype)
        ref = ig.int8_matmul_reference(x, w_q, w_s, out_dtype)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    max_abs, rel = diff.max().item(), _rel(got, ref)
    differ = int((got != ref).sum())
    n = got.shape[-1]
    if not bool((got.reshape(-1, n)[0] == 0).all()):
        raise AssertionError("K7: an all-zero row of x gave a nonzero output")
    if out_dtype == torch.float32:
        if not bool((diff <= 1e-6 + 1e-6 * ref.float().abs()).all()):
            raise AssertionError(f"K7 f32 output off its plain version: max-abs {max_abs:.3e}")
    elif rel > 1e-2:
        raise AssertionError(f"K7 bf16 output rel-L2 {rel:.3e} > 1e-2")
    return max_abs, rel, differ


def check_int8_kernel(ig) -> dict:
    """Phase 33; returns {(M, K, N): bf16 max-abs} at the path shapes and
    the largest f32 max-abs under "f32"."""
    g = torch.Generator("cuda").manual_seed(33)
    f32_err = 0.0
    for m_shape, k, n in INT8_TEST_SHAPES:
        for x_dtype in (torch.float32, torch.bfloat16):
            x, w_q, w_s = _int8_inputs(m_shape, k, n, x_dtype, g)
            for out_dtype in (torch.float32, torch.bfloat16):
                max_abs, rel, differ = _int8_vs_plain(ig, x, w_q, w_s, out_dtype)
                if out_dtype == torch.float32:
                    f32_err = max(f32_err, max_abs)
                print(f"K7 {str(x_dtype)[6:]} -> {str(out_dtype)[6:]} {(*m_shape, k, n)}: "
                      f"max-abs {max_abs:.3e}, rel-L2 {rel:.3e}, {differ} elements differ",
                      flush=True)
    errs = {"f32": f32_err}
    for path, shapes in INT8_SHAPES.items():
        for m, k, n in shapes:
            x, w_q, w_s = _int8_inputs((m,), k, n, torch.bfloat16, g)
            f32 = _int8_vs_plain(ig, x, w_q, w_s, torch.float32)
            bf16 = _int8_vs_plain(ig, x, w_q, w_s, torch.bfloat16)
            errs["f32"] = max(errs["f32"], f32[0])
            errs[(m, k, n)] = bf16[0]
            print(f"K7 {path} bf16 {(m, k, n)}: f32 out max-abs {f32[0]:.3e} ({f32[2]} of "
                  f"{m * n} differ); bf16 out rel-L2 {bf16[1]:.3e}, {bf16[2]} differ (bars "
                  "1e-6 relative, 1e-2)", flush=True)
            del x, w_q, w_s
    # the wgmma GEMM's tile edges: rows of a warpgroup / tile / 128 tiles,
    # columns of a 256-wide tile, 128-byte k-tiles (K 4: a padded pitch)
    edges = [(m, k, n) for m in (1, 63, 65, 129, 16385) for k in (4, 132, 1408)
             for n in (1, 255, 257)]
    for x_dtype in (torch.float32, torch.bfloat16):
        for m, k, n in edges:
            x, w_q, w_s = _int8_inputs((max(m, 2),), k, n, x_dtype, g)
            x = x[-m:]  # M = 1: the row of ties alone
            for out_dtype in (torch.float32, torch.bfloat16):
                with torch.no_grad():
                    got = ig.int8_matmul_fused(x, w_q, w_s, out_dtype)
                ref = ig.int8_matmul_reference(x, w_q, w_s, out_dtype)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"K7 {x_dtype} -> {out_dtype} at the tile edge {(m, k, n)}: "
                        f"{int((got != ref).sum())} elements differ from the plain version")
    print(f"K7 tile edges (M, K, N) in {{1, 63, 65, 129, 16385}} x {{4, 132, 1408}} x "
          f"{{1, 255, 257}}, f32 / bf16 x -> f32 / bf16 out: all {4 * len(edges)} bit-identical "
          "to the plain version", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def _int8_llm(quant: str, depth: int = LLM_DEPTH_8B, dtype: str = "bfloat16", before=None):
    """qwen3_8b_mla in `quant` on the card: the seeded dense model (the
    generate CLI's init), `before(dense)` run on it, its weights mapped by
    quantize_params_like, the dense copy freed. Returns (model, what
    `before` gave)."""
    from internvideo_tpu_torch.models.llm import MLATransformer
    from internvideo_tpu_torch.ops.quant import quantize_params_like

    dense = _llm(PRESET_8B, num_layers=depth, dtype=dtype, param_dtype=dtype)
    got = before(dense) if before is not None else None
    model = MLATransformer(dataclasses.replace(dense.cfg, quant=quant), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0)).eval()
    model.load_state_dict(quantize_params_like(model, dense.state_dict()), strict=True)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    return model, got


def _set_int8_mix(model, on: bool) -> None:
    """int8_mix (prefill-sized calls take K7) or, off, int8_wo on the same
    int8 params."""
    from internvideo_tpu_torch.ops.quant import INT8_MIX_DYN_M, Int8WoDense

    for name, m in model.named_modules():
        if isinstance(m, Int8WoDense) and name != "lm_head":
            m.dyn_m_threshold = INT8_MIX_DYN_M if on else None


@contextlib.contextmanager
def _int8_plain_route(ig, model):
    """K7's plain version in place of the kernel and the plain attention
    route on `model`, for route comparisons; launches nothing."""
    kernel = ig.int8_matmul_fused
    ig.int8_matmul_fused = ig.int8_matmul_reference
    _set_llm_impl(model, "plain")
    try:
        yield
    finally:
        ig.int8_matmul_fused = kernel
        _set_llm_impl(model, "auto")


def run_int8_serve_path(fa, pd, ig, card):
    """Phase 34; returns (the int8_mix 8B model, launches summed over the
    generate and engine runs, the dense model's logits on the agreement
    prompt, that prompt)."""
    import numpy as np

    from internvideo_tpu_torch.models.generation import generate
    from internvideo_tpu_torch.ops.quant import INT8_MIX_DYN_M
    from internvideo_tpu_torch.serve import ServingEngine

    ids_a = torch.randint(1, VOCAB, INT8_AGREE_SHAPE, generator=torch.Generator().manual_seed(35))

    def dense_logits(dense):
        with torch.no_grad():
            return dense(ids_a.cuda()).logits

    t0 = time.perf_counter()
    model, ref_logits = _int8_llm("int8_mix", before=dense_logits)
    wq = sum(p.numel() for p in model.parameters() if p.dtype == torch.int8)
    print(f"[{card}] {PRESET_8B} int8_mix (36 layers, full width, seeded bf16 weights through "
          f"quantize_params_like): {wq / 1e9:.2f} G int8 weights, "
          f"{_param_bytes(model, skip_embed=False) / 1e9:.2f} GB of parameters "
          f"({time.perf_counter() - t0:.1f} s incl. the dense init)", flush=True)
    zero = dict.fromkeys(_int8_counts(fa, pd, ig), 0)
    per_prefill = INT8_PREFILL_PROJ * LLM_DEPTH_8B
    ids = torch.randint(1, VOCAB, (1, 2048), generator=torch.Generator().manual_seed(34))
    _int8_reset(fa, pd, ig)
    t0 = time.perf_counter()
    with torch.no_grad():
        toks = generate(model, ids.cuda(), max_new_tokens=32, paged=True,
                        cache_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = _int8_counts(fa, pd, ig)
    print(f"[{card}] paged generate {PRESET_8B} int8_mix, 2048-token prompt, 32 new: "
          f"{toks[0, :8].tolist()}... ({time.perf_counter() - t0:.1f} s); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    want = {**zero, "flash_fwd_causal": LLM_DEPTH_8B, "paged_decode": LLM_DEPTH_8B * 31,
            "int8_gemm": per_prefill}
    if launches != want or toks.shape != (1, 32) or not ((toks >= 0) & (toks < VOCAB)).all():
        raise AssertionError(f"int8 generate: launches {launches} (expected {want}), tokens "
                             f"{toks.tolist()}")
    total = dict(launches)

    calls = _wrap_calls(model)
    widths = []
    prefill = model.prefill_paged

    def recorded(ids, *a, **kw):
        widths.append(ids.shape[1])
        return prefill(ids, *a, **kw)

    model.prefill_paged = recorded
    eng = ServingEngine(model, **SERVE_ENGINE, decode_horizon=1)
    rng = np.random.default_rng(34)
    reqs = [(rng.integers(1, VOCAB, size=int(n)).astype(np.int32), int(m))
            for n, m in zip(rng.integers(100, 2049, 12), rng.integers(32, 65, 12))]
    calls.update(prefill=0, decode=0)
    _int8_reset(fa, pd, ig)
    t0 = time.perf_counter()
    with torch.no_grad():
        rids = [eng.submit(p, m) for p, m in reqs]
        outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _int8_counts(fa, pd, ig)
    n_tok = sum(len(outs[r]) for r in rids)
    dyn = sum(w >= INT8_MIX_DYN_M for w in widths)
    print(f"[{card}] ServingEngine {PRESET_8B} int8_mix: 12 requests, prompts "
          f"{min(len(p) for p, _ in reqs)}-{max(len(p) for p, _ in reqs)}, {n_tok} tokens in "
          f"{wall:.2f} s ({n_tok / wall:.1f} tokens/s end to end incl. prefill); prefill widths "
          f"{sorted(widths)} ({dyn} at >= {INT8_MIX_DYN_M} rows), {calls['decode']} decode "
          f"steps; launches { {k: v for k, v in launches.items() if v} }", flush=True)
    for rid, (p, m) in zip(rids, reqs):
        out = outs[rid]
        if len(out) != m or not ((out >= 0) & (out < VOCAB)).all():
            raise AssertionError(f"request {rid}: {len(out)} of {m} tokens, {out}")
    want = {**zero, "flash_fwd_causal": LLM_DEPTH_8B * calls["prefill"],
            "paged_decode": LLM_DEPTH_8B * calls["decode"], "int8_gemm": per_prefill * dyn}
    if launches != want or calls["prefill"] != 12 or dyn == 0:
        raise AssertionError(f"int8 engine launches {launches} for {calls}; expected {want}")
    total = {k: total[k] + launches[k] for k in total}
    del eng
    for name in ("prefill_paged", "decode_step_paged"):
        delattr(model, name)
    return model, total, ref_logits, ids_a


def _int8_mix_vs_wo(model, ids) -> tuple:
    """(int8_mix logits, int8_wo logits, share within JAX's 0.15 abs + 0.15
    rel, argmax agreement) on the same int8 params."""
    with torch.no_grad():
        mix = model(ids).logits.float()
        _set_int8_mix(model, False)
        wo = model(ids).logits.float()
        _set_int8_mix(model, True)
    within = ((mix - wo).abs() <= 0.15 + 0.15 * wo.abs()).float().mean().item()
    return mix, wo, within, (mix.argmax(-1) == wo.argmax(-1)).float().mean().item()


def check_int8_routes(model, ig, ref_logits, ids_a, card) -> None:
    """Phase 35. A random-weight int8 model is chaotic: a code that flips
    one step on a 1e-6 upstream difference compounds (measured: the two
    routes 0.24 apart at depth 36 in bf16, 1.5e-2 at depth 2 in fp32). So K7
    is held against its plain version on the real inputs of every int8
    projection of layers 0, 18 and 35; end to end at depth 36 the kernel
    route must be no farther than the plain route (x 1.25) from the same
    int8 weights run in fp32, as phases 18 / 22 / 27 / 31 hold bf16; JAX's
    int8_mix-vs-int8_wo bars run at the JAX test's own config; at full
    width, depth 2, fp32 the greedy tokens of the routes must be identical.
    The rest is printed."""
    from internvideo_tpu_torch.models import presets
    from internvideo_tpu_torch.models.generation import generate
    from internvideo_tpu_torch.models.llm import MLATransformer
    from internvideo_tpu_torch.ops.quant import INT8_MIX_DYN_M, Int8WoDense, quantize_params_like

    ids = ids_a.cuda()
    seen = {}

    def record(name):
        def hook(mod, args):
            seen.setdefault(name, (mod, args[0].detach()))
        return hook

    hooks = [m.register_forward_pre_hook(record(name)) for name, m in model.named_modules()
             if isinstance(m, Int8WoDense) and name.startswith(("layers.0.", "layers.18.",
                                                                "layers.35."))]
    with torch.no_grad():
        mix = model(ids).logits.float()
    for h in hooks:
        h.remove()
    worst = 0.0
    for name, (mod, x) in seen.items():
        with torch.no_grad():
            got = ig.int8_matmul_fused(x, mod.weight_q, mod.scale, torch.bfloat16)
            want = ig.int8_matmul_reference(x, mod.weight_q, mod.scale, torch.bfloat16)
        worst = max(worst, _rel(got, want))
    print(f"[{card}] K7 vs its plain version on the real inputs of the {len(seen)} int8 "
          f"projections of layers 0, 18, 35 (M = {ids.numel()}): worst rel-L2 {worst:.3e} "
          "(bar 1e-2)", flush=True)
    if worst > 1e-2:
        raise AssertionError(f"K7 on the path's real inputs: rel-L2 {worst:.3e} > 1e-2")
    with torch.no_grad(), _int8_plain_route(ig, model):
        mix_plain = model(ids).logits.float()
    # the same int8 weights in fp32, plain route: the reference of both routes
    f32 = MLATransformer(dataclasses.replace(model.cfg, dtype="float32", param_dtype="float32"),
                         device="cuda", generator=torch.Generator("cuda").manual_seed(0)).eval()
    target = f32.state_dict()
    f32.load_state_dict({k: v.to(target[k].dtype) for k, v in model.state_dict().items()})
    with torch.no_grad(), _int8_plain_route(ig, f32):
        ref32 = f32(ids).logits.float()
    del f32, target
    d_kern, d_plain = _rel(mix, ref32), _rel(mix_plain, ref32)
    _, wo, within, agree = _int8_mix_vs_wo(model, ids)
    ref = ref_logits.float()
    print(f"[{card}] {PRESET_8B} int8_mix at depth 36, bf16, prompt {tuple(ids.shape)}: from the "
          f"fp32 run of the same int8 weights, kernel route {d_kern:.3e}, plain route "
          f"{d_plain:.3e} (bar: kernel <= 1.25 x plain); kernel vs plain {_rel(mix, mix_plain):.3e}"
          f"; int8_mix vs int8_wo rel-L2 {_rel(mix, wo):.3e}, {within:.4%} within 0.15 + 0.15 "
          f"rel, argmax agreement {agree:.4f}; drift from the dense bf16 model: int8_mix "
          f"{_rel(mix, ref):.3e}, int8_wo {_rel(wo, ref):.3e} (printed)", flush=True)
    if not (d_kern <= 1.25 * d_plain and all(bool(torch.isfinite(t).all())
                                             for t in (mix, mix_plain, wo))):
        raise AssertionError("int8_mix kernel route farther from fp32 than the plain route")
    del mix, mix_plain, wo, ref, ref32
    gc.collect()
    torch.cuda.empty_cache()

    # JAX's int8_mix test on the card: its config (tests/test_quant_rl_paged.py:
    # 361-420), b = 2, s = 512 (M = INT8_MIX_DYN_M), fp32, seeded weights
    tiny_cfg = presets.qwen3_mla_tiny(vocab_size=64, intermediate_size=48)
    dense = MLATransformer(tiny_cfg, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(35)).eval()
    tiny = MLATransformer(dataclasses.replace(tiny_cfg, quant="int8_mix"), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(35)).eval()
    tiny.load_state_dict(quantize_params_like(tiny, dense.state_dict()))
    _set_llm_impl(tiny, "plain")  # its head dims (16 / 8) have no K5 instantiation
    tiny_ids = torch.randint(0, 64, (2, INT8_MIX_DYN_M // 2), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(36))
    before = ig.launch_count()
    _, _, within, agree = _int8_mix_vs_wo(tiny, tiny_ids)
    print(f"[{card}] JAX's int8_mix test config on the card (K7 launched "
          f"{ig.launch_count() - before} times): int8_mix vs int8_wo {within:.4%} within 0.15 + "
          f"0.15 rel, argmax agreement {agree:.4f} (JAX's bars: all, 0.9)", flush=True)
    if not (within == 1.0 and agree >= 0.9):
        raise AssertionError("int8_mix vs int8_wo past JAX's bars at JAX's test config")
    del dense, tiny

    # fp32 at the 8B widths, depth 2: greedy tokens identical across the routes
    small, _ = _int8_llm("int8_mix", depth=2, dtype="float32")
    with torch.no_grad():
        mix, wo, within, agree = _int8_mix_vs_wo(small, ids)
        with _int8_plain_route(ig, small):
            plain = small(ids).logits.float()
    prompt = torch.randint(1, VOCAB, (2, INT8_MIX_DYN_M), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(35))
    with torch.no_grad():
        kern = generate(small, prompt, max_new_tokens=8, paged=True)
        with _int8_plain_route(ig, small):
            plain_toks = generate(small, prompt, max_new_tokens=8, paged=True)
    print(f"[{card}] {PRESET_8B} int8_mix fp32 depth 2, prompt {tuple(ids.shape)} (printed): kernel "
          f"vs plain route rel-L2 {_rel(mix, plain):.3e}; int8_mix vs int8_wo {within:.4%} within "
          f"0.15 + 0.15 rel, argmax agreement {agree:.4f}; greedy on 2 x {INT8_MIX_DYN_M}-token "
          f"prompts: kernel {kern.tolist()} / plain {plain_toks.tolist()}", flush=True)
    if not torch.equal(kern, plain_toks):
        raise AssertionError("fp32 int8_mix greedy tokens differ between the routes")
    del small
    gc.collect()
    torch.cuda.empty_cache()


def run_int8_encoder_tower(fa, pd, ig, card) -> dict:
    """Phase 37: the 1B encoder (B = 16, launches, clips/s beside bf16; fp32
    accuracy against dense at B = 2 with gammas 0.5) and the HiCo tower on
    128 frames (launches, ms beside bf16), both quant="int8". Returns the
    launches of each path and the times."""
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.models import presets
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.models.vision_tower import VisionTower
    from internvideo_tpu_torch.ops.quant import quantize_params_like

    def pair(build, cfg):
        dense = build(cfg)
        model = build(dataclasses.replace(cfg, quant="int8"))
        model.load_state_dict(quantize_params_like(model, dense.state_dict()), strict=True)
        return dense.eval(), model.eval()

    enc = lambda c: InternVideo2(c, device="cuda",  # noqa: E731
                                 generator=torch.Generator("cuda").manual_seed(0))
    zero = dict.fromkeys(_int8_counts(fa, pd, ig), 0)
    res = {}
    cfg = load_config(CONFIG_1B).model
    dense, model = pair(enc, cfg)
    g = torch.Generator("cuda").manual_seed(36)
    clip = (cfg.num_frames, cfg.img_size, cfg.img_size, 3)
    video = torch.randn(ENC_INT8_B, *clip, device="cuda", generator=g)
    _int8_reset(fa, pd, ig)
    with torch.no_grad():
        out = model(video)
    torch.cuda.synchronize()
    counts = _int8_counts(fa, pd, ig)
    want = {**zero, "flash_fwd": DEPTH_1B, "int8_gemm": 4 * DEPTH_1B}
    print(f"[{card}] InternVideo2-1B quant=int8 {clip[0]}x{clip[1]} bf16 B={ENC_INT8_B}: logits "
          f"{tuple(out.logits.shape)}, launches { {k: v for k, v in counts.items() if v} }",
          flush=True)
    if counts != want or not torch.isfinite(out.logits).all():
        raise AssertionError(f"int8 encoder launches {counts} (expected {want}) or non-finite")
    res["encoder_int8"] = counts
    with torch.no_grad():
        ms_int8 = _time_ms(lambda: model(video), iters=3)
        ms_bf16 = _time_ms(lambda: dense(video), iters=3)
    res["encoder_int8_clips_per_sec"] = ENC_INT8_B * 1e3 / ms_int8
    res["encoder_bf16_clips_per_sec"] = ENC_INT8_B * 1e3 / ms_bf16
    print(f"[{card}] encoder_int8_clips_per_sec (1B fwd 16x224, B={ENC_INT8_B}): int8 "
          f"{ms_int8:.1f} ms = {res['encoder_int8_clips_per_sec']:.2f} clips/s; bf16 "
          f"{ms_bf16:.1f} ms = {res['encoder_bf16_clips_per_sec']:.2f} clips/s", flush=True)
    del dense, model, out, video
    gc.collect()
    torch.cuda.empty_cache()

    # accuracy against the dense model, fp32, LayerScale gammas at 0.5, B = 2:
    # at the 1B (printed: 40 int8 blocks compound their rounding) and at the
    # JAX test's own config (tests/test_quant_rl_paged.py:203-240, its bar)
    rels = {}
    for name, c in (("1B", dataclasses.replace(cfg, dtype="float32", param_dtype="float32")),
                    ("JAX test config", dataclasses.replace(
                        cfg, **INT8_ENC_TEST, dtype="float32", param_dtype="float32"))):
        dense, model = pair(enc, c)
        for m in (dense, model):
            _raise_gammas(m, 0.5)
        video = torch.randn(2, c.num_frames, c.img_size, c.img_size, 3, device="cuda",
                            generator=g)
        with torch.no_grad():
            out, ref = model(video), dense(video)
        rels[name] = {k: _rel(getattr(out, k), getattr(ref, k)) for k in ("pooled", "tokens")}
        del dense, model, video, out, ref
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[{card}] InternVideo2 int8 vs dense, fp32, gammas 0.5, B=2: rel-L2 {rels} (bar 5e-3 "
          "at the JAX test's config)", flush=True)
    if max(rels["JAX test config"].values()) > 5e-3:
        raise AssertionError(f"int8 encoder vs dense {rels['JAX test config']} > 5e-3")
    res["encoder_int8_vs_dense"] = rels

    # the internvideo25_hico_2b tower on 128 frames
    tcfg = presets.internvideo25_hico_2b().vision
    dense, model = pair(lambda c: VisionTower(c, device="cuda",
                                              generator=torch.Generator("cuda").manual_seed(0)),
                        tcfg)
    video = torch.randn(*INT8_TOWER_VIDEO, device="cuda", generator=g)
    _int8_reset(fa, pd, ig)
    with torch.no_grad():
        toks, taps = model(video)
    torch.cuda.synchronize()
    counts = _int8_counts(fa, pd, ig)
    depth = tcfg.num_layers
    want = {**zero, "small_s_fwd": depth, "int8_gemm": 4 * depth}
    with torch.no_grad():
        ref_toks, _ = dense(video)
        rel = _rel(toks, ref_toks)
        ms_int8 = _time_ms(lambda: model(video), iters=5)
        ms_bf16 = _time_ms(lambda: dense(video), iters=5)
    print(f"[{card}] {PRESET_HICO} tower quant=int8, video {INT8_TOWER_VIDEO}: tokens "
          f"{tuple(toks.shape)}, {len(taps)} taps, rel-L2 to the bf16 tower {rel:.3e}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; tower ms int8 {ms_int8:.2f}, bf16 "
          f"{ms_bf16:.2f}", flush=True)
    if counts != want or not torch.isfinite(toks).all():
        raise AssertionError(f"int8 tower launches {counts} (expected {want}) or non-finite")
    res.update(tower_int8=counts, tower_int8_ms=ms_int8, tower_bf16_ms=ms_bf16)
    del dense, model, video, toks, taps, ref_toks
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _int_mm_ms(x, w_q, w_s):
    """The library composition: torch's quantize, torch._int_mm (cuBLASLt
    int8) and the rescale, as one PyTorch function (yardstick only)."""
    from internvideo_tpu_torch.ops.quant import quantize_int8

    def run():
        x_q, x_s = quantize_int8(x, -1)
        return (torch._int_mm(x_q, w_q.t()).float() * x_s * w_s).to(x.dtype)

    try:
        return _time_ms(run, iters=5)
    except RuntimeError as e:  # a shape _int_mm refuses: no yardstick there
        print(f"  torch._int_mm refused {tuple(x.shape)} x {tuple(w_q.shape)}: {e}", flush=True)
        return None


def time_int8(model, ig, card, bf16_serve: dict) -> dict:
    """Phase 36: the int8 LLM metrics beside the bf16 ones of phase 19, one
    int8_mix prefill under torch.profiler, K7 at every path shape."""
    from internvideo_tpu_torch.models.llm import init_paged_cache

    b, s = PREFILL_SHAPE
    g = torch.Generator("cuda").manual_seed(37)
    ids = torch.randint(1, VOCAB, (b, s), device="cuda", generator=g)
    pages, tables = init_paged_cache(model.cfg, b, s + 64, 64, torch.bfloat16, "cuda")
    tok = torch.randint(1, VOCAB, (b, 1), device="cuda", generator=g)
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        prefill = lambda: model.prefill_paged(ids, pages, tables, 64)  # noqa: E731
        decode = lambda: model.decode_step_paged(tok, pages, tables, lens, 64)  # noqa: E731
        prefill_ms = _time_ms(prefill, iters=3)
        _set_int8_mix(model, False)
        decode_ms = _time_ms(decode, iters=10, warmup=2)
        _set_int8_mix(model, True)
    res = {"llm_prefill_int8_tokens_per_sec": b * s * 1e3 / prefill_ms,
           "llm_decode_int8_tokens_per_sec": b * 1e3 / decode_ms,
           "llm_prefill_int8_ms": prefill_ms, "llm_decode_int8_ms": decode_ms}
    print(f"[{card}] {PRESET_8B} llm_prefill_int8_tokens_per_sec (int8_mix, B={b} x {s}, "
          f"prefill_paged): {prefill_ms:.1f} ms = {res['llm_prefill_int8_tokens_per_sec']:.0f} "
          f"tokens/s (bf16 in phase 19: {bf16_serve['prefill_ms']:.1f} ms = "
          f"{bf16_serve['prefill_tokens_per_sec']:.0f}); llm_decode_int8_tokens_per_sec "
          f"(int8_wo, B={b}, seq {s}): {decode_ms:.2f} ms = "
          f"{res['llm_decode_int8_tokens_per_sec']:.1f} tokens/s (bf16: "
          f"{bf16_serve['decode_ms']:.2f} ms = {bf16_serve['decode_tokens_per_sec']:.1f})",
          flush=True)
    with torch.no_grad():
        profile_step(prefill, card, f"{PRESET_8B} int8_mix prefill B={b} S={s}")
    del pages
    gc.collect()
    torch.cuda.empty_cache()

    shapes = []
    for path, path_shapes in INT8_SHAPES.items():
        for m, k, n in path_shapes:
            x, w_q, w_s = _int8_inputs((m,), k, n, torch.bfloat16, g)
            with torch.no_grad():
                ms = _time_ms(lambda: ig.int8_matmul_fused(x, w_q, w_s, torch.bfloat16), iters=5)
                plain = _time_ms(lambda: ig.int8_matmul_reference(x, w_q, w_s, torch.bfloat16),
                                 iters=1)
                w_bf16 = (w_q.float() * w_s[:, None]).bfloat16()
                linear = _time_ms(lambda: F.linear(x, w_bf16), iters=5)
                comp = _int_mm_ms(x, w_q, w_s)
            ops = 2 * m * k * n
            bound = max(ops / PEAK_INT8_OPS, (2 * m * k + k * n + 2 * m * n) / PEAK_BYTES_PER_S)
            by = "operations" if ops / PEAK_INT8_OPS >= (2 * m * k + k * n + 2 * m * n) \
                / PEAK_BYTES_PER_S else "bytes"
            row = {"path": path, "shape": [m, k, n], "ms": ms, "tops": ops / ms / 1e9,
                   "bound_ms": bound * 1e3, "bound_by": by, "plain_ms": plain,
                   "library_ms": comp, "bf16_linear_ms": linear}
            shapes.append(row)
            print(f"[{card}] K7 {path} {(m, k, n)} bf16: {ms:.3f} ms = {row['tops']:.0f} TOPS "
                  f"({bound * 1e3 / ms:.1%} of the {by} bound {bound * 1e3:.3f} ms); plain "
                  f"{plain:.2f} ms; torch quantize + _int_mm + rescale "
                  f"{'n/a' if comp is None else f'{comp:.3f} ms'}; bf16 F.linear {linear:.3f} ms",
                  flush=True)
            del x, w_q, w_s, w_bf16
    gc.collect()
    torch.cuda.empty_cache()
    res["k7"] = shapes
    return res


# ---------------------------------------------------------------------------
# Phases 38-42: K9, K10, K11 and VideoCLIP stage-2 retrieval
# ---------------------------------------------------------------------------


def _all_counts(fa, pd, ig, rms) -> dict:
    return {**_int8_counts(fa, pd, ig), **{n: rms.launch_count(n) for n in rms.KERNELS}}


def _all_reset(fa, pd, ig, rms) -> None:
    _int8_reset(fa, pd, ig)
    rms.reset_launch_count()


def _norm_inputs(rows: int, d: int, x_dtype, res_dtype, g):
    x = torch.randn(rows, d, device="cuda", generator=g).to(x_dtype)
    res = torch.randn(rows, d, device="cuda", generator=g).to(res_dtype)
    gamma = torch.randn(d, device="cuda", generator=g) * 0.1
    w = torch.randn(d, device="cuda", generator=g) * 0.1 + 1.0
    return x, res, gamma, w


def check_norm_kernels(rms) -> dict:
    """Phase 38: K9 and K10 vs their plain versions; returns max-abs errors."""
    g = torch.Generator("cuda").manual_seed(38)
    err = {"fused_add_rms_norm": 0.0, "fused_ls_add_rms_norm": 0.0}
    for shape in ((2, 123, 64), (4, 16, 64)):
        rows, d = math.prod(shape[:-1]), shape[-1]
        x, res, gamma, w = _norm_inputs(rows, d, torch.float32, torch.float32, g)
        x, res = x.reshape(shape), res.reshape(shape)
        with torch.no_grad():
            for name, got, ref in (
                    ("fused_add_rms_norm", rms.fused_add_rms_norm(x, res, w),
                     rms.fused_add_rms_norm_ref(x, res, w)),
                    ("fused_ls_add_rms_norm", rms.fused_ls_add_rms_norm(x, res, gamma, w),
                     rms.fused_ls_add_rms_norm_ref(x, res, gamma, w))):
                torch.cuda.synchronize()
                e = (got[0] - ref[0]).abs().max().item()
                same = torch.equal(got[1], ref[1])
                err[name] = max(err[name], e)
                print(f"{name} fp32 {shape}: y max-abs {e:.3e} (bar 1e-6), newres identical "
                      f"{same}", flush=True)
                if not (e <= 1e-6 and same):
                    raise AssertionError(f"{name} disagrees with its plain version at {shape}")

    rows, d = NORM_SHAPE
    for name, xdt, rdt in (("fused_add_rms_norm", torch.bfloat16, torch.float32),
                           ("fused_ls_add_rms_norm", torch.bfloat16, torch.bfloat16)):
        x, res, gamma, w = _norm_inputs(rows, d, xdt, rdt, g)
        with torch.no_grad():
            if name == "fused_add_rms_norm":
                got, ref = rms.fused_add_rms_norm(x, res, w), rms.fused_add_rms_norm_ref(x, res, w)
            else:
                got = rms.fused_ls_add_rms_norm(x, res, gamma, w)
                ref = rms.fused_ls_add_rms_norm_ref(x, res, gamma, w)
            torch.cuda.synchronize()
        rel, same = _rel(got[0], ref[0]), torch.equal(got[1], ref[1])
        e = (got[0].float() - ref[0].float()).abs().max().item()
        err[f"{name}_bf16"] = e
        print(f"{name} {NORM_SHAPE} x {str(xdt)[6:]} / residual {str(rdt)[6:]}: y rel-L2 "
              f"{rel:.3e} (bar 1e-3), max-abs {e:.3e}, newres identical {same}", flush=True)
        if not (rel <= 1e-3 and same):
            raise AssertionError(f"{name} disagrees with its plain version at {NORM_SHAPE}")
        del x, res, got, ref

    # K10's gradient through its Function (backward: the unfused composition)
    x, res, gamma, w = _norm_inputs(4096, d, torch.bfloat16, torch.bfloat16, g)
    gy = torch.randn(4096, d, device="cuda", generator=g)
    leaves = [t.requires_grad_() for t in (x, res, gamma, w)]
    grads = torch.autograd.grad((rms.fused_ls_add_rms_norm(*leaves)[0].float() * gy).sum(),
                                leaves)
    plain = [t.detach().requires_grad_() for t in leaves]
    ref_grads = torch.autograd.grad(
        (rms.fused_ls_add_rms_norm_ref(*plain)[0].float() * gy).sum(), plain)
    rels = [_rel(a, b) for a, b in zip(grads, ref_grads)]
    print(f"fused_ls_add_rms_norm bf16 (4096, {d}) grads h / residual / gamma / weight rel-L2 "
          + " / ".join(f"{r:.3e}" for r in rels) + " (bar 1e-2)", flush=True)
    if not all(r <= 1e-2 for r in rels):
        raise AssertionError("K10's gradient disagrees with plain autograd")
    try:
        rms.fused_add_rms_norm(leaves[0], leaves[1], leaves[3])
    except RuntimeError as e:
        print(f"fused_add_rms_norm on a requires-grad input raises: {e}", flush=True)
    else:
        raise AssertionError("K9 ran under autograd: it is inference-only")
    return err


def check_large_kernel(fa) -> dict:
    """Phase 39: K11 vs its plain version; returns max-abs errors."""
    g = torch.Generator("cuda").manual_seed(39)
    err = {}
    for b, s, h, d in ((1, 1100, 2, 64), (1, 1040, 2, 64)):
        w = h * d
        qkv = torch.randn(b, s, 3 * w, device="cuda", generator=g)
        qw, kw = (torch.randn(w, device="cuda", generator=g) * 0.1 + 1 for _ in range(2))
        do = torch.randn(b, s, w, device="cuda", generator=g)
        leaves = [t.requires_grad_() for t in (qkv, qw, kw)]
        out = fa.fused_qkv_rmsnorm_attention(*leaves, num_heads=h)
        grads = torch.autograd.grad((out * do).sum(), leaves)
        plain = [t.detach().requires_grad_() for t in leaves]
        ref = fa.fused_qkv_large_ref(*plain, h, d ** -0.5)
        ref_grads = torch.autograd.grad((ref * do).sum(), plain)
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        ge = [((a - r).abs() / (5e-4 + 5e-4 * r.abs())).max().item()
              for a, r in zip(grads, ref_grads)]
        err["fused_qkv_large_fwd"] = max(err.get("fused_qkv_large_fwd", 0.0), e)
        print(f"K11 fp32 {(b, s, h, d)}: out max-abs {e:.3e} (bar 2e-5); grads qkv / qw / kw "
              f"at {' / '.join(f'{x:.2f}' for x in ge)} of the 5e-4 bar", flush=True)
        if not (e <= 2e-5 and all(x <= 1 for x in ge)):
            raise AssertionError(f"K11 disagrees with its plain version at {(b, s, h, d)}")
    for shape in (RETRIEVAL_TOWER_SHAPE, MAIN_SHAPE, *K11_EDGE_SHAPES):
        b, s, h, d = shape
        w = h * d
        qkv = (torch.randn(b, s, 3 * w, device="cuda", generator=g) * 2).bfloat16()
        qw, kw = (torch.randn(w, device="cuda", generator=g) * 0.1 + 1 for _ in range(2))
        with torch.no_grad():
            # the pre-pass: the normed k rows are the cast chain on its own
            # 1/rms bit for bit, and within two bf16 ulps of `rms_norm` of the
            # k slice (whose mean sums in another order: an fp32 ulp of 1/rms
            # moves bf16(x * rstd) by one ulp at most, bf16(w * that) by two
            # through a weight below 2)
            _, k_rstd, k_normed = fa._fused_prepass_cuda(qkv, kw, 1e-6, normed_k=True)
            _, ref_rstd, ref_normed = fa.fused_qkv_large_prepass_ref(qkv, kw)
            own = (kw * (qkv[..., w:2 * w].float() * k_rstd[..., None]).bfloat16()).bfloat16()
            bits = [x.float().view(torch.int32) >> 16 for x in (k_normed, ref_normed)]
            ulps = (bits[0] - bits[1]).abs().max().item()
            differ = (k_normed != ref_normed).sum().item()
            rstd_rel = ((k_rstd - ref_rstd).abs() / ref_rstd).max().item()
            same = torch.equal(k_normed, own)
            del own, ref_normed, k_normed, bits
            fa.reset_launch_count()
            out = fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
            torch.cuda.synchronize()
            counts = {n: c for n in fa.KERNELS if (c := fa.launch_count(n))}
            ref = fa.fused_qkv_large_ref(qkv, qw, kw, h, d ** -0.5)
            torch.cuda.synchronize()
        rel, e = _rel(out, ref), (out.float() - ref.float()).abs().max().item()
        err[f"fused_qkv_large_fwd_{s}" + ("" if d == 88 else f"_d{d}")] = e
        print(f"K11 bf16 {shape} on one (B, S, 3W) projection: out rel-L2 {rel:.3e} "
              f"(bar 1e-2), max-abs {e:.3e}; launches {counts}; normed k bit-identical to "
              f"the chain on the pre-pass's 1/rms {same}, {differ} elements (at most {ulps} "
              f"bf16 ulp) off rms_norm of the k slice, 1/rms within {rstd_rel:.2e} "
              f"(relative) of the plain pre-pass's", flush=True)
        if not (rel <= 1e-2 and same and ulps <= 2 and rstd_rel <= 1e-6
                and counts == {"fused_qkv_rstd": 1, "fused_qkv_large_fwd": 1}):
            raise AssertionError(f"K11 disagrees with its plain version at {shape}")
        del qkv, out, ref
    return err


def run_norm_entry_points(fa, pd, ig, rms) -> dict:
    """Phase 39b: the three kernels' only paths are their public entry points
    (no model calls them, in JAX or here): each driven once at its path
    shape, counters reset just before and read just after."""
    from internvideo_tpu_torch import ops
    from internvideo_tpu_torch.ops.attention import fused_qkv_attention_or_none

    g = torch.Generator("cuda").manual_seed(40)
    rows, d = NORM_SHAPE
    x, res, gamma, w = _norm_inputs(rows, d, torch.bfloat16, torch.float32, g)
    h_ls, res_ls = x, res.bfloat16()
    b, s, h, hd = RETRIEVAL_TOWER_SHAPE
    qkv = torch.randn(b, s, 3 * h * hd, device="cuda", generator=g).bfloat16()
    qw, kw = torch.ones(h * hd, device="cuda"), torch.ones(h * hd, device="cuda")
    torch.cuda.synchronize()
    _all_reset(fa, pd, ig, rms)
    with torch.no_grad():
        y, newres = ops.fused_add_rms_norm(x, res, w)
        y2, newres2 = rms.fused_ls_add_rms_norm(h_ls, res_ls, gamma, w)
        declined = fused_qkv_attention_or_none(qkv, qw, kw, num_heads=h)
        out = fused_qkv_attention_or_none(qkv, qw, kw, num_heads=h, allow_large=True)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    want = {"fused_add_rms_norm": 1, "fused_ls_add_rms_norm": 1, "fused_qkv_rstd": 1,
            "fused_qkv_large_fwd": 1}
    finite = all(bool(torch.isfinite(t).all()) for t in (y, newres, y2, newres2, out))
    print(f"entry points: ops.fused_add_rms_norm {NORM_SHAPE}, fused_ls_add_rms_norm, "
          f"fused_qkv_attention_or_none at {RETRIEVAL_TOWER_SHAPE} (declines without "
          f"allow_large: {declined is None}; with it: {tuple(out.shape)}): launches {counts}, "
          f"finite {finite}", flush=True)
    if counts != want or declined is not None or not finite:
        raise AssertionError(f"entry points launched {counts}; expected {want}")
    return counts


def _retrieval_want(run) -> dict:
    """flash_fwd launches of one retrieval eval: the tower's depth per video
    batch, the fusion layers' cross-attention per rerank batch (padding
    masks keep the text tower and every fusion self-attention off the
    kernels, as in JAX)."""
    videos, texts, _, _ = run.data()
    nv, nt = videos["video"].shape[0], texts["input_ids"].shape[0]
    o = run.options
    k, kv = min(o["k_test"], nt), min(o["k_test"], nv)
    batches = -(-nv // max(1, o["rerank_batch"] // k)) + -(-nt // max(1, o["rerank_batch"] // kv))
    cross = run.model.text.num_layers - run.model.text.fusion_layer
    return {"flash_fwd": -(-nv // o["batch_size"]) * run.model.vision.depth + batches * cross}


def run_retrieval_path(fa, pd, ig, rms, card) -> tuple:
    """Phase 40: the retrieval main path through cli.eval; returns (launches,
    the metrics, the wall seconds)."""
    from internvideo_tpu_torch.cli import eval as cli
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.eval.retrieval import itm_eval

    want = _retrieval_want(load_config(CONFIG_RETRIEVAL))
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _all_reset(fa, pd, ig, rms)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_RETRIEVAL, "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    wall = time.perf_counter() - t0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"[{card}] cli.eval {CONFIG_RETRIEVAL}: {json.dumps(result)} ({wall:.1f} s wall incl. "
          f"model init and data)", flush=True)
    print(f"main path (retrieval): launches {counts}, expected {want}", flush=True)
    keys = set(itm_eval(*(np.eye(2),) * 2, np.arange(2), np.arange(2)))
    if rc != 0 or set(result) != {"task"} | keys:
        raise AssertionError(f"cli.eval retrieval printed {sorted(result)}")
    if not all(math.isfinite(result[k]) for k in keys):
        raise AssertionError("non-finite retrieval metric")
    if want != {"flash_fwd": 400} or counts != want:
        raise AssertionError(f"retrieval launched {counts}; expected {want} (400 flash_fwd)")
    return counts, result, wall


def _videoclip(dtype: str = "bfloat16"):
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.models.videoclip import VideoCLIP

    cfg = load_config(CONFIG_RETRIEVAL).model
    if dtype != cfg.vision.dtype:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype=dtype),
                                  text=dataclasses.replace(cfg.text, dtype=dtype))
    return VideoCLIP(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0)).eval()


def _retrieval_outputs(model, video, ids, mask) -> dict:
    """vision_proj, text_proj and the ITM logits of every (clip, text) pair."""
    with torch.inference_mode():
        tokens, pooled, _, _ = model.encode_vision(video)
        t_tokens, t_pooled = model.encode_text(ids, mask)
        nv, nt = tokens.shape[0], t_tokens.shape[0]
        vi, ti = torch.arange(nv).repeat_interleave(nt), torch.arange(nt).repeat(nv)
        fused = model.fusion(t_tokens[ti], mask[ti], tokens[vi])
        return {"vision_proj": model.vision_proj(pooled).float(),
                "text_proj": model.text_proj(t_pooled).float(),
                "itm_logits": model.itm_logits(fused.pooled).float()}


def check_retrieval_routes(fa) -> None:
    """Phase 41: kernel route vs plain route on the seeded full-width model
    (the tower's LayerScale gammas at 0.1), 2 clips x 2 texts; K1 on fusion
    layer 19's real cross-attention. Returns the bf16 model."""
    from internvideo_tpu_torch.core.config import load_config

    videos, texts, _, _ = load_config(CONFIG_RETRIEVAL).data()
    video = torch.as_tensor(videos["video"][:2], device="cuda")
    ids, mask = (torch.as_tensor(texts[k][:2], device="cuda")
                 for k in ("input_ids", "attention_mask"))
    model = _videoclip()
    # at their 1e-5 init the LayerScale gammas keep every block's attention
    # below the bf16 resolution of the residual: raised, as in phase 5
    _raise_gammas(model.vision_encoder)
    res = {}
    for impl in ("kernel", "plain"):
        _set_attn_impl(model, impl)
        res[impl] = _retrieval_outputs(model, video, ids, mask)
    _set_attn_impl(model, "auto")
    f32 = _videoclip("float32")
    f32.load_state_dict(model.state_dict())
    _set_attn_impl(f32, "plain")
    anchor = _retrieval_outputs(f32, video, ids, mask)
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    for name, ref in anchor.items():
        k, p = res["kernel"][name], res["plain"][name]
        rel, dk, dp = _rel(k, p), _rel(k, ref), _rel(p, ref)
        print(f"stage-2 bf16 B=2 x 2, {name}: kernel vs plain route rel-L2 {rel:.3e} (bar 1e-2); "
              f"from the fp32 weights' output: kernel {dk:.3e}, plain {dp:.3e}", flush=True)
        if not torch.isfinite(k).all() or (rel > 1e-2 and dk > 1.25 * dp):
            raise AssertionError(f"retrieval routes disagree on {name}")

    layer = model.text_encoder.layer[model.config.text.fusion_layer].crossattention
    captured = {}
    hook = layer.register_forward_pre_hook(
        lambda mod, args: captured.setdefault("qkv", (args[0], args[1])) and None)
    _retrieval_outputs(model, video, ids, mask)
    hook.remove()
    x, kv = captured["qkv"]
    heads = (model.config.text.num_heads, -1)
    with torch.inference_mode():
        q, k, v = (lin(t).unflatten(-1, heads) for lin, t in
                   ((layer.query, x), (layer.key, kv), (layer.value, kv)))
        before = fa.launch_count("flash_fwd")
        out, lse = fa.flash_attention_with_lse(q, k, v)
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, q.shape[-1] ** -0.5)
        torch.cuda.synchronize()
    rel, e_lse = _rel(out, ref), (lse - ref_lse).abs().max().item()
    print(f"fusion layer {model.config.text.fusion_layer} real cross-attention q "
          f"{tuple(q.shape)} x k/v {tuple(k.shape)}: K1 out rel-L2 {rel:.3e}, lse max-abs "
          f"{e_lse:.3e} (bars 1e-2)", flush=True)
    if fa.launch_count("flash_fwd") != before + 1 or not (rel <= 1e-2 and e_lse <= 1e-2):
        raise AssertionError("K1 disagrees with plain on fusion layer 19's cross-attention")
    return model


def _host_ms(fn, n: int) -> float:
    """bench.py's protocol (:296-315): n back-to-back calls ending in one host
    sync, minus a one-call baseline, per call; best of 3."""
    fn().item()
    fn().item()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn().item()
        base = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn()
        out.item()
        best = min(best, max(time.perf_counter() - t0 - base, 1e-9) / (n - 1))
    return best * 1e3


def time_retrieval(model, fa, rms, card) -> dict:
    """Phase 42: stage-2 throughput, videoclip_retrieval_p50_ms, one query
    under torch.profiler, and K9 / K10 / K11 beside their plain versions,
    bounds and yardsticks."""
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.eval.retrieval import itm_eval, retrieval_evaluation
    from internvideo_tpu_torch.ops.rmsnorm import rms_norm

    run = load_config(CONFIG_RETRIEVAL)
    videos, texts, gt_v, gt_t = run.data()
    g = torch.Generator("cuda").manual_seed(42)
    bt = run.options["batch_size"]
    video = torch.as_tensor(videos["video"][:bt], device="cuda")
    ids, mask = (torch.as_tensor(texts[k][:bt], device="cuda")
                 for k in ("input_ids", "attention_mask"))
    r = {}
    with torch.inference_mode():
        tokens, pooled, _, _ = model.encode_vision(video)
        t_tokens, _ = model.encode_text(ids, mask)
        tower_ms = _time_ms(lambda: model.vision_proj(model.encode_vision(video)[1]), iters=3)
        text_ms = _time_ms(lambda: model.text_proj(model.encode_text(ids, mask)[1]), iters=10)
        pairs = run.options["rerank_batch"]
        vi = torch.arange(pairs, device="cuda") % bt
        fuse = (t_tokens[vi], mask[vi], tokens[vi])
        rerank_ms = _time_ms(lambda: model.itm_logits(model.fusion(*fuse).pooled), iters=10)
    r.update(tower_clips_per_sec=bt * 1e3 / tower_ms, tower_ms=tower_ms,
             text_texts_per_sec=bt * 1e3 / text_ms, text_ms=text_ms,
             rerank_pairs_per_sec=pairs * 1e3 / rerank_ms, rerank_ms=rerank_ms)

    def tensor(x):
        return torch.as_tensor(np.asarray(x), device="cuda")

    @torch.inference_mode()
    def enc_v(batch):
        tok, pool, _, _ = model.encode_vision(tensor(batch["video"]))
        return tok, model.vision_proj(pool)

    @torch.inference_mode()
    def enc_t(batch):
        tok, pool = model.encode_text(tensor(batch["input_ids"]), tensor(batch["attention_mask"]))
        return tok, model.text_proj(pool)

    @torch.inference_mode()
    def rerank(v, t, m):
        lg = model.itm_logits(model.fusion(t, tensor(m), v).pooled)
        return lg[:, 1] - lg[:, 0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = itm_eval(*retrieval_evaluation(encode_video=enc_v, encode_text=enc_t,
                                             rerank_score=rerank, videos=videos, texts=texts,
                                             **run.options), gt_v, gt_t)
    torch.cuda.synchronize()
    r["eval_wall_s"] = time.perf_counter() - t0

    # bench.py:241-317: one (1, 32) text -> text tower -> text_proj -> normalize
    # -> ITC against a 1000 x 512 bf16 bank -> argmax
    q_ids = torch.zeros(1, 32, dtype=torch.int32, device="cuda")
    q_mask = torch.ones(1, 32, dtype=torch.int32, device="cuda")
    bank = torch.zeros(1000, model.config.embed_dim, dtype=torch.bfloat16, device="cuda")

    @torch.inference_mode()
    def query():
        proj = model.text_proj(model.encode_text(q_ids, q_mask)[1])
        proj = proj / proj.float().norm(dim=-1, keepdim=True)
        return torch.argmax(proj.to(torch.bfloat16) @ bank.T, dim=-1)[0]

    r["videoclip_retrieval_p50_ms"] = _host_ms(query, 100)
    r["query_device_ms"] = _time_ms(query, iters=100, warmup=2)
    print(f"[{card}] stage-2 1B at 4 x 224 bf16: tower {r['tower_clips_per_sec']:.1f} clips/s "
          f"(B {bt}: {tower_ms:.1f} ms), text tower {r['text_texts_per_sec']:.0f} texts/s "
          f"(B {bt} x 32: {text_ms:.2f} ms), rerank {r['rerank_pairs_per_sec']:.0f} pairs/s "
          f"(batch {pairs}: {rerank_ms:.2f} ms), the whole eval ({videos['video'].shape[0]} "
          f"clips x {texts['input_ids'].shape[0]} texts, k {run.options['k_test']}) "
          f"{r['eval_wall_s']:.2f} s wall (metrics {json.dumps(metrics)})", flush=True)
    print(f"[{card}] videoclip_retrieval_p50_ms {r['videoclip_retrieval_p50_ms']:.4f} "
          f"(bench.py's protocol: host clock, N = 100, one-call baseline subtracted, best of "
          f"3); device time a query (CUDA events) {r['query_device_ms']:.4f} ms", flush=True)
    profile_step(query, card, "retrieval query")

    # K9 / K10 at the 1B encoder's residual stream, K11 at the stage-2 tower
    # and the 1B eval: kernel, plain, bound, yardstick
    rows, d = NORM_SHAPE
    k = {}
    x, res, gamma, w = _norm_inputs(rows, d, torch.bfloat16, torch.float32, g)
    with torch.no_grad():
        k["fused_add_rms_norm"] = dict(
            ms=_time_ms(lambda: rms.fused_add_rms_norm(x, res, w), iters=20, warmup=2),
            plain_ms=_time_ms(lambda: rms.fused_add_rms_norm_ref(x, res, w), iters=5),
            library_ms=None, bound=_bound(0, rows * d * (2 + 4 + 2 + 4) + d * 4),
            shape=[rows, d], dtypes="x bf16, residual fp32")
        res = res.bfloat16()
        k["fused_ls_add_rms_norm"] = dict(
            ms=_time_ms(lambda: rms.fused_ls_add_rms_norm(x, res, gamma, w), iters=20, warmup=2),
            plain_ms=_time_ms(lambda: rms.fused_ls_add_rms_norm_ref(x, res, gamma, w), iters=5),
            library_ms=None, bound=_bound(0, rows * d * 2 * 4 + 2 * d * 4),
            shape=[rows, d], dtypes="h, residual bf16")
    del x, res
    for shape in (MAIN_SHAPE, RETRIEVAL_TOWER_SHAPE):
        b, s, h, hd = shape
        wd = h * hd
        qkv = (torch.randn(b, s, 3 * wd, device="cuda", generator=g) * 2).bfloat16()
        qw, kw = (torch.randn(wd, device="cuda", generator=g) * 0.1 + 1 for _ in range(2))
        scale = hd ** -0.5
        with torch.no_grad():
            op_ms = _time_ms(lambda: fa._fused_qkv_cuda(qkv, qw, kw, h, scale, 1e-6,
                                                        kernel="fused_qkv_large_fwd"),
                             iters=10, warmup=2)
            prepass_ms = _time_ms(lambda: fa._fused_prepass_cuda(qkv, kw, 1e-6, normed_k=True),
                                  iters=10, warmup=2)
            prod_ms = _time_ms(lambda: fa._fused_large_unfused(qkv, qw, kw, h, scale, 1e-6),
                               iters=10, warmup=2)
            plain_ms = _time_ms(lambda: fa.fused_qkv_large_ref(qkv, qw, kw, h, scale), iters=1)
            qn = rms_norm(qkv[..., :wd], qw).unflatten(-1, (h, hd))
            kn = rms_norm(qkv[..., wd:2 * wd], kw).unflatten(-1, (h, hd))
            lib_ms = _sdpa_fwd_ms(qn, kn, qkv[..., 2 * wd:].unflatten(-1, (h, hd)))
        k[f"fused_qkv_large_fwd_{s}"] = dict(
            ms=op_ms, prepass_ms=prepass_ms, plain_ms=plain_ms, library_ms=lib_ms,
            production_route_ms=prod_ms,
            bound=_bound(4 * b * h * s * s * hd, 4 * b * s * wd * 2 + 2 * wd * 4),
            shape=list(shape))
        del qkv, qn, kn
    # K1 at the retrieval eval's shapes: (B, Sq, Sk, H, D)
    b, s, h, hd = RETRIEVAL_TOWER_SHAPE
    for tag, (b, sq, sk, h, hd) in (("tower", (b, s, s, h, hd)),
                                    ("rerank_cross_attention", RETRIEVAL_CROSS_SHAPE)):
        if sq == sk:
            _, (q, kk, vv) = _qkv_views(b, sq, h, hd, g)
        else:
            q = torch.randn(b, sq, h, hd, device="cuda", generator=g).bfloat16()
            kk, vv = (torch.randn(b, sk, h, hd, device="cuda", generator=g).bfloat16()
                      for _ in range(2))
        scale = hd ** -0.5
        with torch.no_grad():
            k[f"flash_fwd_{tag}"] = dict(
                ms=_time_ms(lambda: fa._flash_fwd_cuda(q, kk, vv, scale), iters=20, warmup=3),
                plain_ms=_time_ms(lambda: fa.flash_attention_ref_with_lse(q, kk, vv, scale),
                                  iters=2),
                library_ms=_sdpa_fwd_ms(q, kk, vv),
                bound=_bound(4 * b * h * sq * sk * hd,
                             (2 * b * sq + 2 * b * sk) * h * hd * 2 + b * h * sq * 4),
                shape=[b, sq, sk, h, hd])
        del q, kk, vv
    for name, v in k.items():
        if name.startswith("flash_fwd_"):
            print(f"[{card}] K1 {name} (B, Sq, Sk, H, D) {v['shape']}: kernel {v['ms']:.4f} ms, "
                  f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}), plain {v['plain_ms']:.3f} "
                  f"ms, flash SDPA yardstick {v['library_ms']:.4f} ms", flush=True)
            continue
        print(f"[{card}] {name} {v['shape']}: kernel {v['ms']:.3f} ms, bound "
              f"{v['bound'][0]:.3f} ms ({v['bound'][1]}), plain {v['plain_ms']:.3f} ms, "
              + (f"of it the normed-k pre-pass {v['prepass_ms']:.3f} ms; SDPA on pre-normed q "
                 f"/ k {v['library_ms']:.3f} ms, the production route (2 rms_norm + K1) "
                 f"{v['production_route_ms']:.3f} ms"
                 if v["library_ms"] is not None
                 else "no single PyTorch call computes it (plain = the composition)"),
              flush=True)
    r["kernels"] = k
    return r


# ---------------------------------------------------------------------------
# Phases 43-47: VideoCLIP stage-2 training
# ---------------------------------------------------------------------------

def _median_ms(fn, runs: int = 5, iters: int = 10) -> float:
    """Median over `runs` CUDA-event timings of `iters` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(_time_ms(fn, iters=iters, warmup=0) for _ in range(runs))


def _median_graph_ms(fn, runs: int = 5) -> float:
    """Median over `runs` CUDA graph replays (_graph_ms): the device time of
    kernels that the wrapper's host work would hide under CUDA events."""
    return statistics.median(_graph_ms(fn) for _ in range(runs))


def _attn_bounds(b, sq, sk, h, d) -> dict:
    """_bound of the non-causal forward, dq and dk/dv at (B, Sq, Sk, H, D)
    bf16: 4 / 6 / 8 B H Sq Sk d operations; each input read once, each
    output written once (LSE and delta fp32)."""
    q_bytes, kv_bytes, rows = b * sq * h * d * 2, b * sk * h * d * 2, b * h * sq * 4
    pairs = b * h * sq * sk * d
    bwd_in = 2 * q_bytes + 2 * kv_bytes + 2 * rows  # q, dO, k, v; lse, delta
    return {"fwd": _bound(4 * pairs, 2 * q_bytes + 2 * kv_bytes + rows),
            "dq": _bound(6 * pairs, bwd_in + q_bytes),
            "dkv": _bound(8 * pairs, bwd_in + 2 * kv_bytes)}


def _flash_vs_plain(fa, q, k, v, do, small_s: bool = False):
    """(kernel (out, lse, dq, dk, dv), plain (out, lse, dq, dk, dv)) through
    K1 / K4a (or K2 / K4b with `small_s`), the plain backward on the
    kernel's own out and LSE, as phase 7 holds it."""
    scale = q.shape[-1] ** -0.5
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    if small_s:
        out = fa.SmallSAttention.apply(q, k, v, scale)
        ref_out, ref_lse = fa.small_s_attention_ref(q.detach(), k.detach(), v.detach(), scale)
        lse = ref_lse  # K2's LSE stays inside the Function; its out is held
    else:
        out, lse = fa.flash_attention_with_lse(q, k, v)
        ref_out, ref_lse = fa.flash_attention_ref_with_lse(q.detach(), k.detach(), v.detach(),
                                                           scale)
    grads = torch.autograd.grad((out.float() * do.float()).sum(), (q, k, v))
    ref_bwd = (fa.small_s_attention_bwd_ref if small_s else fa.flash_attention_bwd_ref)
    ref = ref_bwd(q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), do, scale)
    torch.cuda.synchronize()
    return (out.detach(), lse.detach(), *grads), (ref_out, ref_lse, *ref)


def check_clip_kernels(fa) -> dict:
    """Phase 43: K1 / K4a at the stage-2 step's shapes (the unmasked tower's
    (64, 1025, 16, 88) on qkv views; the fusion cross-attention's 32 queries
    on 1025 keys at head dim 64, B 64 in the MLM pass and 192 in the VTM
    pass), fp32 at B 2 with the same Sq / Sk (out max-abs 2e-5, grads 5e-4),
    bf16 at the path's shapes (rel-L2 1e-2, LSE max-abs 1e-2); K2 / K4b at
    the UTA variant's cross-attention (8, 32, 209, 16, 64) and K3 / K4b at
    its masked student (8, 209, 16, 88), fp32 and bf16. Returns max-abs
    errors by tag and kernel."""
    g = torch.Generator("cuda").manual_seed(43)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    b_t, s_t, h_t, d_t = CLIP_TOWER_SHAPE
    cases = {"tower": (s_t, s_t, h_t, d_t), **{
        f"cross_{tag}": shape[1:] for tag, shape in CLIP_CROSS_SHAPES.items()}}
    for tag, (sq, sk, h, d) in cases.items():
        if tag == "cross_vtm":
            continue  # the same Sq / Sk / H / D as the MLM pass's in fp32
        q, do, k, v = rnd(2, sq, h, d), rnd(2, sq, h, d), rnd(2, sk, h, d), rnd(2, sk, h, d)
        got, ref = _flash_vs_plain(fa, q, k, v, do)
        errs = [(x - r).abs().max().item() for x, r in zip(got, ref)]
        print(f"clip K1 / K4a fp32 (2, {sq}, {sk}, {h}, {d}): out / lse max-abs {errs[0]:.3e} / "
              f"{errs[1]:.3e} (bar 2e-5), dq / dk / dv {errs[2]:.3e} / {errs[3]:.3e} / "
              f"{errs[4]:.3e} (bar 5e-4)", flush=True)
        if not (max(errs[:2]) <= 2e-5 and max(errs[2:]) <= 5e-4):
            raise AssertionError(f"fp32 K1 / K4a disagree with their plain versions at {tag}")
    errs_by = {}
    for tag in cases:
        if tag == "tower":
            _, (q, k, v) = _qkv_views(b_t, s_t, h_t, d_t, g)
            shape = (b_t, s_t, s_t, h_t, d_t)
        else:
            shape = CLIP_CROSS_SHAPES[tag.split("_")[1]]
            b, sq, sk, h, d = shape
            q, k, v = rnd(b, sq, h, d).bfloat16(), rnd(b, sk, h, d).bfloat16(), rnd(
                b, sk, h, d).bfloat16()
        do = rnd(*q.shape).bfloat16()
        got, ref = _flash_vs_plain(fa, q, k, v, do)
        rels = [_rel(x, r) for x, r in zip(got, ref)]
        errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
        print(f"clip K1 / K4a bf16 {shape} ({tag}): out / dq / dk / dv rel-L2 {rels[0]:.3e} / "
              f"{rels[2]:.3e} / {rels[3]:.3e} / {rels[4]:.3e} (bar 1e-2), lse max-abs "
              f"{errs[1]:.3e} (bar 1e-2)", flush=True)
        if not (max(rels[:1] + rels[2:]) <= 1e-2 and errs[1] <= 1e-2):
            raise AssertionError(f"bf16 K1 / K4a disagree with their plain versions at {tag}")
        errs_by[tag] = {"flash_fwd": errs[0], "flash_bwd_dq": errs[2],
                        "flash_bwd_dkv": max(errs[3:])}
        del q, k, v, do, got, ref

    b, sq, sk, h, d = CLIP_UTA_CROSS_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        q, do = rnd(b, sq, h, d).to(dtype), rnd(b, sq, h, d).to(dtype)
        k, v = rnd(b, sk, h, d).to(dtype), rnd(b, sk, h, d).to(dtype)
        got, ref = _flash_vs_plain(fa, q, k, v, do, small_s=True)
        errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
        rels = [_rel(x, r) for x, r in zip(got, ref)]
        print(f"clip UTA K2 / K4b {dtype} {CLIP_UTA_CROSS_SHAPE}: out / dq / dk / dv max-abs "
              + " / ".join(f"{e:.3e}" for e in errs[:1] + errs[2:]) + ", rel-L2 "
              + " / ".join(f"{r:.3e}" for r in rels[:1] + rels[2:]), flush=True)
        ok = (errs[0] <= 2e-5 and max(errs[2:]) <= 5e-4 if dtype == torch.float32
              else max(rels[:1] + rels[2:]) <= 1e-2)
        if not ok:
            raise AssertionError(f"{dtype} K2 / K4b disagree with their plain versions at the "
                                 "UTA cross-attention")
    errs_by["uta_cross"] = {"small_s_fwd": errs[0], "small_s_bwd_dq": errs[2],
                            "small_s_bwd_dkv": max(errs[3:])}

    b, s, h, d = CLIP_UTA_STUDENT_SHAPE
    w = h * d
    for dtype in (torch.float32, torch.bfloat16):
        qkv = (rnd(b, s, 3 * w) * 2).to(dtype)
        qw, kw = rnd(w) * 0.1 + 1, rnd(w) * 0.1 + 1
        do = rnd(b, s, w).to(dtype)
        fout, fgot = _fused_grads(fa, qkv, qw, kw, h, do)
        fref, frefs = _fused_ref_grads(fa, qkv, qw, kw, h, do)
        torch.cuda.synchronize()
        e_out = (fout.float() - fref.float()).abs().max().item()
        ferrs = [((x.float() - r.float()).abs() / (1 + r.float().abs())).max().item()
                 for x, r in zip(fgot, frefs)]
        rels = [_rel(fout, fref)] + [_rel(x, r) for x, r in zip(fgot, frefs)]
        print(f"clip UTA K3 (+ K2 / K4b backward) {dtype} {CLIP_UTA_STUDENT_SHAPE}: out max-abs "
              f"{e_out:.3e}, grads qkv / qw / kw max |err|/(1+|ref|) "
              + " / ".join(f"{e:.3e}" for e in ferrs) + "; rel-L2 out / grads "
              + " / ".join(f"{r:.3e}" for r in rels), flush=True)
        ok = (e_out <= 2e-5 and max(ferrs) <= 5e-4 if dtype == torch.float32
              else rels[0] <= 1e-2 and max(rels[1:]) <= 2e-2)
        if not ok:
            raise AssertionError(f"{dtype} K3 disagrees with its plain version at the UTA "
                                 "student")
    errs_by["uta_student"] = {"fused_qkv_fwd": e_out}
    _, (q, k, v) = _qkv_views(b, s, h, d, g)
    do = rnd(b, s, h, d).bfloat16()
    got, ref = _flash_vs_plain(fa, q, k, v, do, small_s=True)
    rels = [_rel(x, r) for x, r in zip(got, ref)]
    errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
    print(f"clip UTA K2 / K4b bf16 {CLIP_UTA_STUDENT_SHAPE} qkv views (K3's backward): out / dq / "
          f"dk / dv rel-L2 " + " / ".join(f"{r:.3e}" for r in rels[:1] + rels[2:])
          + " (bar 1e-2)", flush=True)
    if not max(rels[:1] + rels[2:]) <= 1e-2:
        raise AssertionError("bf16 K2 / K4b disagree with their plain versions at the UTA "
                             "student")
    errs_by["uta_student"].update(small_s_fwd=errs[0], small_s_bwd_dq=errs[2],
                                  small_s_bwd_dkv=max(errs[3:]))
    return errs_by


def _attn_times(fa, shape, small: bool, g, timer) -> dict:
    """Times of the forward, dq and dk/dv kernels of K1 / K4a (K2 / K4b with
    `small`) at shape (B, Sq, Sk, H, D) bf16 (q / k / v views of one
    projection when Sq == Sk) by `timer`, beside the plain versions (CUDA
    events, median of 5), the bounds and flash SDPA. Returns kernel name ->
    {"ms", "plain_ms", "library_ms", "bound", "shape"}."""
    b, sq, sk, h, d = shape
    rnd = lambda *sh: torch.randn(*sh, device="cuda", generator=g)  # noqa: E731
    if sq == sk:
        _, (q, k, v) = _qkv_views(b, sq, h, d, g)
    else:
        q, k, v = (rnd(b, s, h, d).bfloat16() for s in (sq, sk, sk))
    do = rnd(b, sq, h, d).bfloat16()
    scale = d ** -0.5
    fwd = "small_s_fwd" if small else "flash_fwd"
    names = (("small_s_bwd_dq", "small_s_bwd_dkv") if small
             else ("flash_bwd_dq", "flash_bwd_dkv"))
    plain_fwd = fa.small_s_attention_ref if small else fa.flash_attention_ref_with_lse
    plain_bwd = fa.small_s_attention_bwd_ref if small else fa.flash_attention_bwd_ref
    bounds = _attn_bounds(b, sq, sk, h, d)
    with torch.no_grad():
        out, lse = fa._flash_fwd_cuda(q, k, v, scale, kernel=fwd)
        delta = fa._bwd_delta(out, do)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        plain_b = _median_ms(lambda: plain_bwd(q, k, v, out, lse, do, scale), iters=1)
        sdpa_b = statistics.median(_sdpa_bwd_ms(q, k, v, do) for _ in range(5))
        r = {fwd: dict(ms=timer(lambda: fa._flash_fwd_cuda(q, k, v, scale, kernel=fwd)),
                       plain_ms=_median_ms(lambda: plain_fwd(q, k, v, scale), iters=1),
                       library_ms=statistics.median(_sdpa_fwd_ms(q, k, v) for _ in range(5)),
                       bound=bounds["fwd"])}
        for name, outs, kind in ((names[0], (dq,), "dq"), (names[1], (dk, dv), "dkv")):
            r[name] = dict(ms=timer(lambda: fa._launch_bwd(name, q, k, v, do, lse, delta,
                                                           outs, scale)),
                           plain_ms=plain_b, library_ms=sdpa_b, bound=bounds[kind])
    for t in r.values():
        t["shape"] = [b, sq, sk, h, d]
    return r


def _print_attn_times(card, what: str, tag: str, r: dict) -> None:
    for name, t in r.items():
        print(f"[{card}] {what} {tag} {name} (B, Sq, Sk, H, D) = {tuple(t['shape'])} bf16: "
              f"kernel {t['ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ({t['bound'][1]}), "
              f"plain {t['plain_ms']:.3f} ms, flash SDPA {t['library_ms']:.4f} ms",
              flush=True)


def time_clip_kernels(fa, card) -> dict:
    """Phase 43, times (CUDA events, median of 5 runs; the UTA shapes by CUDA
    graph replay, median of 5): K1, K4a dq and dk/dv at the tower's and both
    cross-attention shapes, K2 / K4b at the UTA cross-attention and the
    masked student, K3 at the student; each beside its plain version, its
    bound and flash SDPA. Returns tag -> kernel -> times."""
    from internvideo_tpu_torch.ops.rmsnorm import rms_norm

    g = torch.Generator("cuda").manual_seed(44)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    self_attn = lambda b, s, h, d: (b, s, s, h, d)  # noqa: E731
    shapes = {"tower": self_attn(*CLIP_TOWER_SHAPE),
              **{f"cross_{t}": sh for t, sh in CLIP_CROSS_SHAPES.items()},
              "uta_cross": CLIP_UTA_CROSS_SHAPE,
              "uta_student": self_attn(*CLIP_UTA_STUDENT_SHAPE)}
    res = {}
    for tag, (b, sq, sk, h, d) in shapes.items():
        small = tag.startswith("uta")
        timer = _median_graph_ms if small else _median_ms
        r = _attn_times(fa, (b, sq, sk, h, d), small, g, timer)
        if tag == "uta_student":
            w, scale = h * d, d ** -0.5
            qkv = (rnd(b, sq, 3 * w) * 2).bfloat16()
            qw, kw = (rnd(w) * 0.1 + 1 for _ in range(2))
            with torch.no_grad():
                qn = rms_norm(qkv[..., :w], qw).unflatten(-1, (h, d))
                kn = rms_norm(qkv[..., w:2 * w], kw).unflatten(-1, (h, d))
                r["fused_qkv_fwd"] = dict(
                    ms=timer(lambda: fa._fused_qkv_cuda(qkv, qw, kw, h, scale, 1e-6)),
                    plain_ms=_median_ms(lambda: fa.fused_qkv_ref(qkv, qw, kw, h, scale),
                                        iters=1),
                    library_ms=statistics.median(
                        _sdpa_fwd_ms(qn, kn, qkv[..., 2 * w:].unflatten(-1, (h, d)))
                        for _ in range(5)),
                    bound=_bound(4 * b * h * sq * sq * d, 4 * b * sq * w * 2 + 2 * w * 4),
                    shape=[b, sq, sk, h, d])
            del qkv, qn, kn
        _print_attn_times(card, "clip", tag, r)
        res[tag] = r
    return res


def clip_want(run, steps: int) -> dict:
    """Kernel launches of `steps` stage-2 steps of `run` with `uta` = 0: per
    tower block one K1 (two with remat) and one K4a dq and dk/dv; per fusion
    layer one cross-attention (K1 / K4a at Sk = 1025) in the MLM pass and
    one in the VTM pass. BERT self-attention is masked (the plain einsum)
    and the pooling head plain: nothing else launches."""
    v, t = run.model.vision, run.model.text
    fusion = t.num_layers - t.fusion_layer
    per_step = {"flash_fwd": (2 if v.remat else 1) * v.depth + 2 * fusion,
                "flash_bwd_dq": v.depth + 2 * fusion, "flash_bwd_dkv": v.depth + 2 * fusion}
    return {n: c * steps for n, c in per_step.items()}


def clip_uta_want(run, teacher_depth: int, steps: int) -> dict:
    """Kernel launches of `steps` UTA steps: K3 (and its pre-pass) per
    student block twice (remat) and per teacher block once; K3's backward
    (K2 recompute + K4b) per student block; K2 / K4b per fusion layer's
    cross-attention (Sk = 1 + T * n_vis <= 1024) in the MLM and VTM
    passes."""
    v, t = run.model.vision, run.model.text
    fusion = t.num_layers - t.fusion_layer
    k3 = 2 * v.depth + teacher_depth
    small = v.depth + 2 * fusion
    return {n: c * steps for n, c in (("fused_qkv_fwd", k3), ("fused_qkv_rstd", k3),
                                      ("small_s_fwd", small), ("small_s_bwd_dq", small),
                                      ("small_s_bwd_dkv", small))}


def _step_records(text: str) -> list:
    return [dict(kv.split(": ") for kv in line.split("  "))
            for line in text.splitlines() if line.startswith("step: ")]


def run_clip_path(fa, pd, ig, rms, card) -> dict:
    """Phase 44: the stage-2 main path, `cli.train` on CONFIG_CLIP for
    CLIP_STEPS steps; launches reset just before and read just after.
    Returns the launches."""
    from internvideo_tpu_torch.cli import train as cli
    from internvideo_tpu_torch.core.config import load_config

    want = clip_want(load_config(CONFIG_CLIP), CLIP_STEPS)
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _all_reset(fa, pd, ig, rms)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_CLIP, "--device", "cuda",
                       f"trainer.total_steps={CLIP_STEPS}", "trainer.log_every=1",
                       "trainer.checkpoint_dir=None"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    wall = time.perf_counter() - t0
    records = _step_records(buf.getvalue())
    for r in records:
        print(f"cli.train {CONFIG_CLIP}: {r}", flush=True)
    print(f"[{card}] main path (stage-2 clip): {CLIP_STEPS} steps in {wall:.1f} s wall incl. "
          f"model init and host data; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {counts}, predicted "
          f"{want}", flush=True)
    if rc != 0 or len(records) != CLIP_STEPS:
        raise AssertionError(f"cli.train logged {len(records)} of {CLIP_STEPS} stage-2 steps")
    keys = ("loss", "loss_vtc", "loss_vtm", "loss_mlm", "grad_norm")
    if not all(math.isfinite(float(r[k])) for r in records for k in keys):
        raise AssertionError("non-finite loss, loss term or grad_norm on the stage-2 path")
    if counts != want:
        raise AssertionError(f"launches {counts} on the stage-2 path; predicted {want}")
    return counts


def _clip_model(run, dtype: str = "bfloat16"):
    """The stage-2 model of `run` in `dtype` (fp32 params either way), its
    tower's LayerScale gammas at 0.1."""
    from internvideo_tpu_torch.models.videoclip import VideoCLIP

    cfg = run.model
    vis = dataclasses.replace(cfg.vision, dtype=dtype)
    cfg = dataclasses.replace(cfg, vision=vis, text=dataclasses.replace(cfg.text, dtype=dtype),
                              pretrain=dataclasses.replace(cfg.pretrain, encoder=vis))
    model = VideoCLIP(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    _raise_gammas(model.vision_encoder)
    return model


def _clip_batch(run, b: int, seed: int) -> dict:
    v = run.model.vision
    g = torch.Generator("cuda").manual_seed(seed)
    ids = torch.randint(1, 1000, (b, run.data["text_len"]), device="cuda", generator=g)
    return {"video": torch.randn(b, v.num_frames, v.img_size, v.img_size, 3, device="cuda",
                                 generator=g),
            "input_ids": ids, "attention_mask": torch.ones_like(ids),
            "idx": torch.arange(b, device="cuda")}


CLIP_ROUTE_GRADS = ("vision_encoder.encoder.blocks.0.attn.qkv.weight",
                    "vision_encoder.encoder.blocks.39.attn.qkv.weight",
                    "text_encoder.layer.19.crossattention.key.weight",
                    "text_encoder.layer.23.crossattention.query.weight",
                    "itm_head.weight", "temp")


def _clip_route(model, run, batch, draws, impl):
    from internvideo_tpu_torch.train.engines.clip import clip_loss

    _set_attn_impl(model, impl)
    model.zero_grad(set_to_none=True)
    loss, aux = clip_loss(model, run.engine, batch, deterministic=True, **draws)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
             if n in CLIP_ROUTE_GRADS}
    return {k: v.item() for k, v in {"loss": loss, **aux}.items()}, grads


def check_clip_routes(run) -> None:
    """Phase 45: the first step's losses and some gradients, kernel route vs
    plain route, on the seeded full-width model (tower gammas 0.1), B 4, the
    same draws (negatives by rotation, one MLM corruption), dropout off;
    an fp32 copy of the weights on the plain route is the anchor: each
    number within 1e-2 (grads: rel-L2 2e-2) of the plain route's, or the
    kernel route no farther from the anchor than 1.25 x the plain route."""
    from internvideo_tpu_torch.train.engines.clip import mlm_corrupt

    b = 4
    batch = _clip_batch(run, b, 45)
    rows = torch.arange(b, device="cuda")
    corrupted, labels = mlm_corrupt(torch.Generator("cuda").manual_seed(46),
                                    batch["input_ids"], run.engine)
    draws = dict(vis_neg=(rows + 1) % b, txt_neg=(rows + 2) % b, corrupted=corrupted,
                 mlm_labels=labels)
    model = _clip_model(run)
    res = {impl: _clip_route(model, run, batch, draws, impl) for impl in ("kernel", "plain")}
    f32 = _clip_model(run, "float32")
    f32.load_state_dict(model.state_dict())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    anchor = _clip_route(f32, run, batch, draws, "plain")
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    (lk, gk), (lp, gp), (la, ga) = res["kernel"], res["plain"], anchor
    for key in lk:
        rel = abs(lk[key] - lp[key]) / max(abs(lp[key]), 1e-12)
        dk, dp = abs(lk[key] - la[key]), abs(lp[key] - la[key])
        print(f"stage-2 step bf16 B={b}, {key}: kernel {lk[key]:.6f}, plain {lp[key]:.6f} (rel "
              f"{rel:.3e}, bar 1e-2), fp32 anchor {la[key]:.6f} (kernel off by {dk:.3e}, plain "
              f"{dp:.3e})", flush=True)
        if not math.isfinite(lk[key]) or (rel > 1e-2 and dk > 1.25 * dp):
            raise AssertionError(f"stage-2 routes disagree on {key}")
    for name in CLIP_ROUTE_GRADS:
        rel, dk, dp = _rel(gk[name], gp[name]), _rel(gk[name], ga[name]), _rel(gp[name], ga[name])
        print(f"stage-2 step bf16 grad {name}: kernel vs plain rel-L2 {rel:.3e} (bar 2e-2); "
              f"from the fp32 anchor: kernel {dk:.3e}, plain {dp:.3e}", flush=True)
        if not torch.isfinite(gk[name]).all() or (rel > 2e-2 and dk > 1.25 * dp):
            raise AssertionError(f"stage-2 routes disagree on the gradient of {name}")


def time_clip_step(fa, pd, ig, rms, run, card) -> dict:
    """Phase 46: the stage-2 trainer (CONFIG_CLIP, B 64) on a device-resident
    batch: launches of one step against the prediction, then the step's ms
    (CUDA events, 3 steps after 1), the peak device memory and one step
    under torch.profiler (device busy share)."""
    from internvideo_tpu_torch.cli import train as cli

    trainer, shape, _ = cli.build_clip(dataclasses.replace(
        run, trainer=dataclasses.replace(run.trainer, checkpoint_dir=None)), torch.device("cuda"))
    b = shape["video"][0]
    batch = _clip_batch(run, b, 47)
    step = lambda: trainer._step(trainer.state, batch)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _all_reset(fa, pd, ig, rms)
    m = step()
    torch.cuda.synchronize()
    per_step = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    want = clip_want(run, 1)
    step_ms = _time_ms(step, iters=3, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = {k: float(v) for k, v in m.items()}
    print(f"[{card}] VideoCLIP stage-2 1B step (tower 4x224 S = 1025 unmasked, remat; bert-large "
          f"fusion; VTC + VTM (3B = {3 * b} fusion rows) + MLM; AdamW) bf16 B={b}, "
          f"device-resident batch: {step_ms:.1f} ms = {b * 1e3 / step_ms:.2f} clips/s; peak "
          f"device memory {peak:.2f} GB; first step's metrics {losses}", flush=True)
    print(f"[{card}] stage-2 launches per step {per_step}, predicted {want}", flush=True)
    if per_step != want:
        raise AssertionError(f"stage-2 step launched {per_step}; predicted {want}")
    prof = profile_step(step, card, "stage-2 clip step")
    busy = None if prof["busy_ms"] is None else prof["busy_ms"] / prof["wall_ms"]
    return {"step_ms": step_ms, "clips_per_s": b * 1e3 / step_ms, "peak_gb": peak,
            "device_busy_share": busy, "launches_per_step": per_step, "predicted": want,
            "first_step": losses}


def run_clip_uta_path(fa, pd, ig, rms, run, card) -> dict:
    """Phase 47: the UTA variant through `cli.build_clip` + `Trainer.fit`:
    CONFIG_CLIP with engine.uta = 1.0, attention-guided masking at 0.8 and
    the CLIP-6B TeacherConfig of CONFIG_PRETRAIN, batch cut to CLIP_UTA_B,
    CLIP_UTA_STEPS steps; launches reset just before fit and read just
    after, against the prediction; every logged loss finite."""
    from internvideo_tpu_torch.cli import train as cli
    from internvideo_tpu_torch.core.config import load_config

    teacher = load_config(CONFIG_PRETRAIN).teacher
    uta = dataclasses.replace(
        run, teacher=teacher,
        engine=dataclasses.replace(run.engine, uta=1.0, mask_type="attention", mask_ratio=0.8),
        data={**run.data, "batch_size": CLIP_UTA_B},
        trainer=dataclasses.replace(run.trainer, checkpoint_dir=None, log_every=1))
    trainer, shape, clip_teacher = cli.build_clip(uta, torch.device("cuda"))
    lines = []
    trainer.metrics.print_fn = lines.append
    data = cli._synthetic_clip_stream(shape, uta.model.text.vocab_size)
    want = clip_uta_want(uta, teacher.depth, CLIP_UTA_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _all_reset(fa, pd, ig, rms)
    trainer.fit(data, steps=CLIP_UTA_STEPS)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    wall = time.perf_counter() - t0
    records = _step_records("\n".join(lines))
    for r in records:
        print(f"stage-2 UTA (B={CLIP_UTA_B}): {r}", flush=True)
    print(f"[{card}] stage-2 UTA variant: {CLIP_UTA_STEPS} steps in {wall:.1f} s wall incl. host "
          f"data; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{counts}, predicted {want}", flush=True)
    keys = ("loss", "loss_uta", "loss_vtc", "loss_vtm", "loss_mlm", "grad_norm")
    if len(records) != CLIP_UTA_STEPS or not all(
            math.isfinite(float(r[k])) for r in records for k in keys):
        raise AssertionError("the stage-2 UTA variant logged a missing or non-finite loss")
    if counts != want:
        raise AssertionError(f"launches {counts} on the stage-2 UTA variant; predicted {want}")
    del trainer, clip_teacher
    return counts


# -- InternVideo2-Chat serving and the eval CLI's new tasks: phases 48-52 ----------------

def _chat_cases(b: int) -> dict:
    """tag -> (kernel, (B, Sq, Sk, H, d_qk, d_v), causal) of the chat path at
    batch `b`: the ViT's K1, the QFormer's cross-attention (K1) and
    self-attention (K2), the LLM prefill over [queries | prompt] (K5) and a
    ragged prompt."""
    s, h, d = CHAT_VIT_SHAPE
    sq, sk, hq, dq = CHAT_CROSS_SHAPE
    hl, dk, dv = CHAT_LLM_SHAPE
    nq = CHAT_CROSS_SHAPE[0]
    return {"vit": ("flash_fwd", (b, s, s, h, d, d), False),
            "qformer_cross": ("flash_fwd", (b, sq, sk, hq, dq, dq), False),
            "qformer_self": ("small_s_fwd", (b, nq, nq, hq, dq, dq), False),
            "llm_prefill": ("flash_fwd_causal",
                            (b, nq + CHAT_PROMPT, nq + CHAT_PROMPT, hl, dk, dv), True),
            "llm_prefill_ragged": ("flash_fwd_causal", (b, nq + CHAT_RAGGED_PROMPT,
                                                        nq + CHAT_RAGGED_PROMPT, hl, dk, dv), True)}


def _chat_inputs(shape, dtype, g):
    b, sq, sk, h, d, dv = shape
    if sq == sk and d == dv and sq > 1024:  # the ViT's q / k / v: views of one projection
        _, (q, k, v) = _qkv_views(b, sq, h, d, g, dtype)
        return q, k, v
    return (torch.randn(b, sq, h, d, device="cuda", generator=g).to(dtype),
            torch.randn(b, sk, h, d, device="cuda", generator=g).to(dtype),
            torch.randn(b, sk, h, dv, device="cuda", generator=g).to(dtype))


def check_chat_kernels(fa) -> dict:
    """Phase 48: K1, K2 and K5 at the chat path's shapes (_chat_cases) at
    B 8 and B 1, through `flash_attention` as the models call it (one launch
    of the named kernel, nothing else), vs their plain versions: fp32
    max-abs 2e-5, bf16 rel-L2 1e-2. Returns (tag, B) -> bf16 max-abs."""
    g = torch.Generator("cuda").manual_seed(48)
    errs = {}
    for b in CHAT_BATCHES:
        for tag, (kernel, shape, causal) in _chat_cases(b).items():
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = _chat_inputs(shape, dtype, g)
                before = {n: fa.launch_count(n) for n in fa.KERNELS}
                with torch.no_grad():
                    out = fa.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                after = {n: fa.launch_count(n) - before[n] for n in fa.KERNELS}
                if after != {**dict.fromkeys(fa.KERNELS, 0), kernel: 1}:
                    raise AssertionError(f"chat {tag} {shape} launched {after}; expected one "
                                         f"{kernel}")
                ref, _ = fa.flash_attention_ref_with_lse(q, k, v, shape[4] ** -0.5, causal)
                max_abs = (out.float() - ref.float()).abs().max().item()
                rel = _rel(out, ref)
                print(f"chat {kernel} {tag} (B, Sq, Sk, H, d_qk, d_v) = {shape} {dtype}: "
                      f"max-abs {max_abs:.3e}, rel-L2 {rel:.3e} (bars: fp32 max-abs 2e-5, bf16 "
                      "rel-L2 1e-2)", flush=True)
                ok = max_abs <= 2e-5 if dtype == torch.float32 else rel <= 1e-2
                if not ok:
                    raise AssertionError(f"{kernel} disagrees with its plain version at the "
                                         f"chat's {tag} {shape} {dtype}")
                if dtype == torch.bfloat16:
                    errs[(tag, b)] = max_abs
                del q, k, v, out, ref
    return errs


def _chat_want(prefills: int) -> dict:
    """Launches of `prefills` VideoChat prefills: per prefill the ViT's
    depth in K1, one K1 (cross-attention) and one K2 (self-attention) a
    QFormer layer, the LLM's depth in K5; decode steps launch nothing
    (the plain absorbed decode over the dense cache, as in JAX)."""
    from internvideo_tpu_torch.core.config import load_config

    cfg = load_config(CONFIG_CHAT).model
    n = cfg.qformer.bert.num_layers
    return {"flash_fwd": prefills * (cfg.vision.depth + n), "small_s_fwd": prefills * n,
            "flash_fwd_causal": prefills * cfg.llm.num_layers}


@contextlib.contextmanager
def _counting_chat_calls():
    """Count VideoChat.prefill / decode_step calls on every instance."""
    from internvideo_tpu_torch.models.chat import VideoChat

    calls = {"prefill": 0, "decode_step": 0}
    saved = {name: getattr(VideoChat, name) for name in calls}

    def counted(name):
        @functools.wraps(saved[name])  # generate reads prefill's signature
        def call(self, *a, **kw):
            calls[name] += 1
            return saved[name](self, *a, **kw)
        return call

    for name in calls:
        setattr(VideoChat, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(VideoChat, name, fn)


def run_chat_path(fa, pd, ig, rms, card) -> dict:
    """Phase 49: task videoqa through cli.eval on CONFIG_CHAT (the VideoChat
    built and answering on the card); launches reset just before and read
    just after, against _chat_want of the prefills it ran; the metrics'
    keys and count."""
    from internvideo_tpu_torch.cli import eval as cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _all_reset(fa, pd, ig, rms)
    with _counting_chat_calls() as calls, contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_CHAT, "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    wall = time.perf_counter() - t0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    want = _chat_want(calls["prefill"])
    print(f"[{card}] cli.eval {CONFIG_CHAT}: {json.dumps(result)} ({wall:.1f} s wall incl. the "
          f"~19 GB init and data; {calls['prefill']} prefills, {calls['decode_step']} decode "
          f"steps)", flush=True)
    print(f"main path (chat videoqa): launches {counts}, expected {want}", flush=True)
    if rc != 0 or set(result) != {"task", "accuracy", "num"} or result["num"] != CHAT_CLI_CLIPS:
        raise AssertionError(f"cli.eval videoqa printed {result}")
    if not (0 <= result["accuracy"] <= 100) or calls["prefill"] != CHAT_CLI_PREFILLS:
        raise AssertionError(f"videoqa: accuracy {result['accuracy']}, {calls} calls")
    if calls["decode_step"] != CHAT_CLI_PREFILLS * (CHAT_NEW - 1) or counts != want:
        raise AssertionError(f"the chat path launched {counts} in {calls}; expected {want}")
    return counts


def _chat_model(dtype: str = "bfloat16"):
    """CONFIG_CHAT's VideoChat with the CLI's seeded weights, on the card."""
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.models.chat import VideoChat

    cfg = load_config(CONFIG_CHAT).model
    if dtype != cfg.llm.dtype:
        f32 = lambda c: dataclasses.replace(c, dtype=dtype, param_dtype=dtype)  # noqa: E731
        cfg = dataclasses.replace(
            cfg, vision=f32(cfg.vision), llm=f32(cfg.llm),
            qformer=dataclasses.replace(cfg.qformer, bert=f32(cfg.qformer.bert)))
    return VideoChat(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0)).eval()


def _set_chat_route(model, impl: str) -> None:
    _set_attn_impl(model, impl)
    _set_llm_impl(model, impl)


def _chat_inputs_e2e(model, b: int, prompt: int, seed: int):
    v = model.config.vision
    g = torch.Generator("cuda").manual_seed(seed)
    video = torch.randn(b, v.num_frames, v.img_size, v.img_size, 3, device="cuda", generator=g)
    ids = torch.randint(1, model.config.llm.vocab_size, (b, prompt), device="cuda", generator=g)
    return video, ids


def _chat_route_logits(model, impl, video, ids, fed) -> list:
    """Prefill + len(fed) dense decode steps fed `fed` on route `impl`: the
    last-position logits (fp32)."""
    _set_chat_route(model, impl)
    b, s = ids.shape
    nq = model.cache_prefix_len
    with torch.no_grad():
        caches = model.init_cache(b, nq + s + fed.shape[1], torch.float32)
        out = model.prefill(ids, video, caches)
        logits = [out.logits[:, -1].float()]
        for step in range(fed.shape[1]):
            out = model.decode_step(fed[:, step:step + 1], caches, nq + s + step)
            logits.append(out.logits[:, -1].float())
    _set_chat_route(model, "kernel")
    return logits


def check_chat_routes(model, card) -> None:
    """Phase 50 on the bf16 VideoChat at full width and depth, B 2, a
    64-token prompt: each kernel-route attention against the plain route on
    its real inputs (a ViT block, a QFormer layer's self- and
    cross-attention, an LLM layer's prefill attention; rel-L2 1e-2); the
    prefill + 2 decode steps' logits held to an fp32 copy of the weights at
    full depth (the kernel route within 1.25 x the plain route's distance,
    the fp32 routes within 1e-4); greedy tokens from `generate` on both
    routes, reported (a bf16 argmax over random weights can flip on a near
    tie)."""
    from internvideo_tpu_torch.models.generation import generate

    video, ids = _chat_inputs_e2e(model, 2, CHAT_PROMPT, 50)
    fed = torch.randint(1, model.config.llm.vocab_size, (2, 2), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(51))
    n_vit, n_bert = model.config.vision.depth, model.config.qformer.bert.num_layers
    modules = {f"vit block {i}": model.vision_encoder.blocks[i].attn for i in (0, n_vit - 1)}
    for i in (0, n_bert - 1):
        modules[f"qformer layer {i} self"] = model.qformer.bert.layer[i].attention
        modules[f"qformer layer {i} cross"] = model.qformer.bert.layer[i].crossattention
    llm_layers = (0, model.config.llm.num_layers - 1)
    prefill_in = {}
    for i in llm_layers:
        attn = model.language_model.layers[i].self_attn

        def recorded(x, cos, sin, cache, cache_len, *, _fn=attn.prefill, _i=i, **kw):
            prefill_in.setdefault(_i, (x, cos, sin))
            return _fn(x, cos, sin, cache, cache_len, **kw)

        attn.prefill = recorded
    capture = _capture(modules, lambda: _chat_route_logits(model, "kernel", video, ids, fed[:, :0]))
    for i in llm_layers:
        del model.language_model.layers[i].self_attn.prefill
    _layers_kernel_vs_plain(modules, capture, "chat")
    for i, (x, cos, sin) in sorted(prefill_in.items()):
        attn = model.language_model.layers[i].self_attn
        outs = {}
        with torch.no_grad():
            for impl in ("kernel", "plain"):
                attn.attn_impl = impl
                outs[impl] = attn(x, cos, sin, causal=True)
        attn.attn_impl = "kernel"
        rel = _rel(outs["kernel"], outs["plain"])
        print(f"chat bf16 LLM layer {i} prefill attention on its real inputs, kernel vs plain "
              f"route: rel-L2 {rel:.3e} (bar 1e-2)", flush=True)
        if not rel <= 1e-2:
            raise AssertionError(f"routes disagree at the chat LLM layer {i}")
    del capture, prefill_in

    res = {impl: _chat_route_logits(model, impl, video, ids, fed) for impl in ("kernel", "plain")}
    ref = _fp32_copy(model, lambda: _chat_model("float32"))
    f32 = {impl: _chat_route_logits(ref, impl, video, ids, fed) for impl in ("kernel", "plain")}
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    _hold_to_fp32(res, f32, "chat (VideoChatConfig() at full width and depth, B 2, 64-token "
                            "prompt) prefill + 2 dense decode steps")
    tokens = {}
    for impl in ("kernel", "plain"):
        _set_chat_route(model, impl)
        tokens[impl] = generate(model, ids, video=video, max_new_tokens=16)
    _set_chat_route(model, "kernel")
    agree = (tokens["kernel"] == tokens["plain"]).sum().item()
    print(f"[{card}] chat greedy tokens (B 2, 16 new) on the kernel route vs the plain route: "
          f"{agree} of {tokens['kernel'].numel()} agree (a report, not a bar); kernel "
          f"{tokens['kernel'].tolist()}, plain {tokens['plain'].tolist()}", flush=True)


def time_chat(model, fa, card) -> dict:
    """Phase 51 at B 1 and B 8, a 64-token prompt and 32 new tokens: TTFT
    (the prefill + the first token's argmax) and its split into the ViT, the
    QFormer (+ llm_proj) and the LLM prefill by CUDA events, with each
    part's launches; the dense decode step's ms and tokens/s; the whole
    generate's wall; the peak device memory; the prefill and a decode step
    under torch.profiler (device idle share)."""
    from internvideo_tpu_torch.models.generation import generate

    res = {}
    nq = model.cache_prefix_len
    lm = model.language_model
    for b in CHAT_BATCHES:
        video, ids = _chat_inputs_e2e(model, b, CHAT_PROMPT, 51)
        caches = model.init_cache(b, nq + CHAT_PROMPT + CHAT_NEW, torch.float32)
        with torch.no_grad():
            tokens = model.vision_encoder(video).tokens
            queries = model.llm_proj(model.qformer(tokens))
            txt = lm.embed_tokens(ids)
            embeds = torch.cat([queries.to(txt.dtype), txt], dim=1)
            parts = {"vit": lambda: model.vision_encoder(video),
                     "qformer": lambda: model.llm_proj(model.qformer(tokens)),
                     "llm_prefill": lambda: lm.prefill(embeds, caches)}
            launches, ms = {}, {}
            for name, fn in parts.items():
                fa.reset_launch_count()
                fn()
                torch.cuda.synchronize()
                launches[name] = {n: fa.launch_count(n) for n in fa.KERNELS
                                  if fa.launch_count(n)}
                ms[name] = _time_ms(fn, iters=3)
            ttft = _time_ms(lambda: model.prefill(ids, video, caches).logits.argmax(-1), iters=3)
            tok = torch.randint(1, model.config.llm.vocab_size, (b, 1), device="cuda")
            step_len = nq + CHAT_PROMPT
            decode_ms = _time_ms(lambda: model.decode_step(tok, caches, step_len), iters=10,
                                 warmup=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen_ms = _time_ms(lambda: generate(model, ids, video=video, max_new_tokens=CHAT_NEW),
                          iters=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.no_grad():
            prof_p = profile_step(lambda: model.prefill(ids, video, caches), card,
                                  f"chat prefill B={b}")
            prof_d = profile_step(lambda: model.decode_step(tok, caches, step_len), card,
                                  f"chat dense decode step B={b}")
        idle = {k: (None if p["busy_ms"] is None else max(0.0, 1 - p["busy_ms"] / p["wall_ms"]))
                for k, p in (("prefill", prof_p), ("decode_step", prof_d))}
        res[b] = {"ttft_ms": ttft, "vit_ms": ms["vit"], "qformer_ms": ms["qformer"],
                  "llm_prefill_ms": ms["llm_prefill"], "launches": launches,
                  "decode_step_ms": decode_ms, "decode_tokens_per_sec": b * 1e3 / decode_ms,
                  "generate_ms": gen_ms, "peak_gb": peak, "idle_share": idle}
        print(f"[{card}] chat B={b}, {CHAT_PROMPT}-token prompt: TTFT {ttft:.2f} ms = ViT "
              f"{ms['vit']:.2f} + QFormer {ms['qformer']:.2f} + LLM prefill "
              f"{ms['llm_prefill']:.2f} ms (parts timed alone); launches {launches}; dense "
              f"decode step {decode_ms:.2f} ms = {b * 1e3 / decode_ms:.1f} tokens/s; generate "
              f"({CHAT_NEW} new) {gen_ms:.1f} ms; peak {peak:.2f} GB; idle share {idle}",
              flush=True)
        want = {"vit": {"flash_fwd": model.config.vision.depth},
                "qformer": {"flash_fwd": model.config.qformer.bert.num_layers,
                            "small_s_fwd": model.config.qformer.bert.num_layers},
                "llm_prefill": {"flash_fwd_causal": model.config.llm.num_layers}}
        if launches != want:
            raise AssertionError(f"chat launches per part {launches}; expected {want}")
        del caches, video, ids, tokens, queries, txt, embeds
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _sdpa_graph_ms(q, k, v, causal: bool) -> tuple:
    """The first PyTorch SDPA backend (flash, cuDNN, memory-efficient) that
    takes (B, S, H, D) q / k / v as they are, timed by CUDA graph replay as
    the kernels are (yardstick only, never on the port's path): (ms, note)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        try:
            call()
        except RuntimeError:  # the backend refuses the shape: try the next
            continue
        return _median_graph_ms(call), f"{backend.name} SDPA, CUDA graph replay"
    return None, "no SDPA backend takes the shape"


def time_chat_kernels(fa, card) -> dict:
    """Phase 51, kernels: each _chat_cases shape at B 8 and B 1, bf16, by
    CUDA graph replay (median of 5; the B 1 shapes are wrapper-bound under
    CUDA events), beside its plain version, its bound and the library call
    (`_sdpa_graph_ms`: the first SDPA backend that takes the shape, timed
    the same way)."""
    g = torch.Generator("cuda").manual_seed(52)
    res = {}
    for b in CHAT_BATCHES:
        for tag, (kernel, shape, causal) in _chat_cases(b).items():
            _, sq, sk, h, d, dv = shape
            q, k, v = _chat_inputs(shape, torch.bfloat16, g)
            scale = d ** -0.5
            with torch.no_grad():
                if causal:
                    call = lambda: fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0)  # noqa: E731
                    pairs = b * h * sq * (sq + 1) // 2
                    bound = _bound(2 * pairs * (d + dv), (2 * b * sq * h * d + 2 * b * sk * h * dv)
                                   * 2 + b * h * sq * 4)
                else:
                    call = lambda: fa._flash_fwd_cuda(q, k, v, scale, kernel=kernel)  # noqa: E731
                    bound = _attn_bounds(b, sq, sk, h, d)["fwd"]
                lib_ms, lib_note = _sdpa_graph_ms(q, k, v, causal)
                ms = _median_graph_ms(call)
                plain_ms = _median_ms(lambda: fa.flash_attention_ref_with_lse(q, k, v, scale,
                                                                              causal),
                                      runs=3, iters=1)
            res[(tag, b)] = dict(kernel=kernel, shape=list(shape), ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, library_note=lib_note, bound=bound)
            print(f"[{card}] chat {kernel} {tag} (B, Sq, Sk, H, d_qk, d_v) = {shape} bf16: kernel "
                  f"{ms:.4f} ms (graph replay), bound {bound[0]:.4f} ms ({bound[1]}), plain "
                  f"{plain_ms:.3f} ms, library "
                  + (f"{lib_ms:.4f} ms ({lib_note})" if lib_ms is not None else lib_note),
                  flush=True)
            del q, k, v
    return res


def run_zeroshot_path(fa, pd, ig, rms, card) -> dict:
    """Phase 52: task zeroshot through cli.eval on CONFIG_ZEROSHOT
    (internvideo2_stage2_1b uncut, synthetic data); launches reset just
    before and read just after: the tower's depth in K1 a clip batch and
    nothing else (the masked text runs the plain einsum, as in JAX)."""
    from internvideo_tpu_torch.cli import eval as cli
    from internvideo_tpu_torch.core.config import load_config

    run = load_config(CONFIG_ZEROSHOT)
    _, _, batches = run.data()
    batches = list(batches)
    want = {"flash_fwd": len(batches) * run.model.vision.depth}
    n = sum(len(x["label"]) for x in batches)
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _all_reset(fa, pd, ig, rms)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_ZEROSHOT, "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    wall = time.perf_counter() - t0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"[{card}] cli.eval {CONFIG_ZEROSHOT}: {json.dumps(result)} ({wall:.1f} s wall incl. "
          f"init and data)", flush=True)
    print(f"main path (zeroshot): launches {counts}, expected {want}", flush=True)
    if rc != 0 or set(result) != {"task", "top1", "top5", "n"} or result["n"] != n:
        raise AssertionError(f"cli.eval zeroshot printed {result}")
    if not all(0 <= result[k] <= 100 for k in ("top1", "top5")) or counts != want:
        raise AssertionError(f"zeroshot launched {counts}; expected {want}")
    return counts


# -- task distill, the real SFT data path, device prefetch: phases 53-59 --------------------

def check_distill_kernels(fa) -> dict:
    """Phase 53: K3 (fused qkv + QK-RMSNorm; backward K2 recompute + K4b) and
    K2 / K4b alone at the L/14 student's head dim 64, fp32 at B 2 with the
    path's S (out max-abs 2e-5, grads 5e-4) and bf16 at the path's
    (32, 417, 16, 64) (out rel-L2 1e-2, grads 2e-2; K2 / K4b on q, k, v
    views of one projection, rel-L2 1e-2). The teacher's K1 at
    (32, 2049, 16, 88) is phase 7's finetune shape. Returns max-abs errors."""
    g = torch.Generator("cuda").manual_seed(53)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    b, s, h, d = DISTILL_STUDENT_SHAPE
    w = h * d
    errs_by = {}
    for dtype, bb in ((torch.float32, 2), (torch.bfloat16, b)):
        qkv = (rnd(bb, s, 3 * w) * 2).to(dtype)
        qw, kw = rnd(w) * 0.1 + 1, rnd(w) * 0.1 + 1
        do = rnd(bb, s, w).to(dtype)
        fout, fgot = _fused_grads(fa, qkv, qw, kw, h, do)
        fref, frefs = _fused_ref_grads(fa, qkv, qw, kw, h, do)
        torch.cuda.synchronize()
        e_out = (fout.float() - fref.float()).abs().max().item()
        ferrs = [((x.float() - r.float()).abs() / (1 + r.float().abs())).max().item()
                 for x, r in zip(fgot, frefs)]
        rels = [_rel(fout, fref)] + [_rel(x, r) for x, r in zip(fgot, frefs)]
        print(f"distill K3 (+ K2 / K4b backward) {dtype} ({bb}, {s}, {h}, {d}): out max-abs "
              f"{e_out:.3e}, grads qkv / qw / kw max |err|/(1+|ref|) "
              + " / ".join(f"{e:.3e}" for e in ferrs) + "; rel-L2 out / grads "
              + " / ".join(f"{r:.3e}" for r in rels), flush=True)
        ok = (e_out <= 2e-5 and max(ferrs) <= 5e-4 if dtype == torch.float32
              else rels[0] <= 1e-2 and max(rels[1:]) <= 2e-2)
        if not ok:
            raise AssertionError(f"{dtype} K3 disagrees with its plain version at the student")
        errs_by["fused_qkv_fwd"] = e_out
        del qkv, do, fout, fgot, fref, frefs
    for dtype, bb in ((torch.float32, 2), (torch.bfloat16, b)):
        _, (q, k, v) = _qkv_views(bb, s, h, d, g, dtype)
        do = rnd(bb, s, h, d).to(dtype)
        got, ref = _flash_vs_plain(fa, q, k, v, do, small_s=True)
        errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
        rels = [_rel(x, r) for x, r in zip(got, ref)]
        print(f"distill K2 / K4b {dtype} ({bb}, {s}, {h}, {d}) qkv views: out / dq / dk / dv "
              "max-abs " + " / ".join(f"{e:.3e}" for e in errs[:1] + errs[2:]) + ", rel-L2 "
              + " / ".join(f"{r:.3e}" for r in rels[:1] + rels[2:]), flush=True)
        ok = (errs[0] <= 2e-5 and max(errs[2:]) <= 5e-4 if dtype == torch.float32
              else max(rels[:1] + rels[2:]) <= 1e-2)
        if not ok:
            raise AssertionError(f"{dtype} K2 / K4b disagree with their plain versions at the "
                                 "student's head dim 64")
        errs_by.update(small_s_fwd=errs[0], small_s_bwd_dq=errs[2],
                       small_s_bwd_dkv=max(errs[3:]))
        del q, k, v, do, got, ref
    return errs_by


def time_distill_kernels(fa, card) -> dict:
    """Phase 54: at the student's (32, 417, 16, 64), bf16, CUDA events (median
    of 5 runs of 10 calls): K3's op (its pre-pass timed alone too), K2 and
    K4b's dq and dk/dv on q, k, v views of one projection, each beside its
    plain version, its bound and flash SDPA (forward; the aten backward)."""
    from internvideo_tpu_torch.ops import _build
    from internvideo_tpu_torch.ops.rmsnorm import rms_norm

    lib = _build.load_library()
    g = torch.Generator("cuda").manual_seed(54)
    b, s, h, d = DISTILL_STUDENT_SHAPE
    w, scale = h * d, d ** -0.5
    bounds = _attn_bounds(b, s, s, h, d)
    res = {}
    _, (q, k, v) = _qkv_views(b, s, h, d, g)
    do = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    with torch.no_grad():
        out, lse = fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd")
        delta = fa._bwd_delta(out, do)
        dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device="cuda") for x in (q, k, v))
        plain_b = _median_ms(lambda: fa.small_s_attention_bwd_ref(q, k, v, out, lse, do, scale),
                             iters=1)
        sdpa_b = statistics.median(_sdpa_bwd_ms(q, k, v, do) for _ in range(5))
        res["small_s_fwd"] = dict(
            ms=_median_ms(lambda: fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd")),
            plain_ms=_median_ms(lambda: fa.small_s_attention_ref(q, k, v, scale), iters=1),
            library_ms=statistics.median(_sdpa_fwd_ms(q, k, v) for _ in range(5)),
            bound=bounds["fwd"])
        for name, outs, kind in (("small_s_bwd_dq", (dq,), "dq"),
                                 ("small_s_bwd_dkv", (dk, dv), "dkv")):
            res[name] = dict(
                ms=_median_ms(lambda: fa._launch_bwd(name, q, k, v, do, lse, delta, outs, scale)),
                plain_ms=plain_b, library_ms=sdpa_b, bound=bounds[kind])
    del q, k, v, do, out, lse, delta, dq, dk, dv
    qkv = (torch.randn(b, s, 3 * w, device="cuda", generator=g) * 2).bfloat16()
    qw, kw = (torch.randn(w, device="cuda", generator=g) * 0.1 + 1 for _ in range(2))
    q_rstd, k_rstd = (torch.empty(b, s, device="cuda") for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream
    with torch.no_grad():
        qn = rms_norm(qkv[..., :w], qw).unflatten(-1, (h, d))
        kn = rms_norm(qkv[..., w:2 * w], kw).unflatten(-1, (h, d))
        op_ms = _median_ms(lambda: fa._fused_qkv_cuda(qkv, qw, kw, h, scale, 1e-6))
        rstd_ms = _median_ms(lambda: lib.ivt_fused_qkv_rstd(
            1, qkv.data_ptr(), q_rstd.data_ptr(), k_rstd.data_ptr(), b, s, w, qkv.stride(0),
            qkv.stride(1), 1e-6, stream))
        res["fused_qkv_fwd"] = dict(
            ms=op_ms, prepass_ms=rstd_ms,
            plain_ms=_median_ms(lambda: fa.fused_qkv_ref(qkv, qw, kw, h, scale), iters=1),
            library_ms=statistics.median(
                _sdpa_fwd_ms(qn, kn, qkv[..., 2 * w:].unflatten(-1, (h, d))) for _ in range(5)),
            bound=_bound(4 * b * h * s * s * d, 4 * b * s * w * 2 + 2 * w * 4))
    del qkv, qn, kn, q_rstd, k_rstd
    for name, r in res.items():
        r["shape"] = list(DISTILL_STUDENT_SHAPE)
        print(f"[{card}] distill student {name} {DISTILL_STUDENT_SHAPE} bf16: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), plain "
              f"{r['plain_ms']:.3f} ms, flash SDPA {r['library_ms']:.4f} ms"
              + (f" (pre-pass {r['prepass_ms']:.4f} ms, on pre-normed q / k)"
                 if "prepass_ms" in r else ""), flush=True)
    k4b = res["small_s_bwd_dq"]["ms"] + res["small_s_bwd_dkv"]["ms"]
    print(f"[{card}] distill student K4b d 64: dq + dk/dv {k4b:.4f} ms = "
          f"{k4b / res['small_s_bwd_dq']['library_ms']:.2f} x flash SDPA's backward", flush=True)
    return res


def distill_want(run, steps: int) -> dict:
    """Kernel launches of `steps` distill steps of `run`: per teacher block one
    K1 (S = 1 + T * 256 > 1024, no remat: it runs under no_grad); per
    student block K3 and its pre-pass twice (forward + remat recompute) and
    K3's backward once (K2 recompute, K4b dq, dk/dv); nothing else."""
    student, teacher = run.model.encoder, run.teacher
    k3 = (2 if student.remat else 1) * student.depth
    per_step = {"flash_fwd": teacher.depth, "fused_qkv_fwd": k3, "fused_qkv_rstd": k3,
                "small_s_fwd": student.depth, "small_s_bwd_dq": student.depth,
                "small_s_bwd_dkv": student.depth}
    return {n: c * steps for n, c in per_step.items()}


def run_distill_path(fa, pd, ig, rms, card) -> dict:
    """Phase 55: the distill main path, `cli.train` on CONFIG_DISTILL for
    DISTILL_STEPS steps; launches reset just before and read just after,
    against `distill_want`; K3's launches by S; every logged loss finite."""
    from internvideo_tpu_torch.cli import train as cli
    from internvideo_tpu_torch.core.config import load_config

    want = distill_want(load_config(CONFIG_DISTILL), DISTILL_STEPS)
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _all_reset(fa, pd, ig, rms)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_DISTILL, "--device", "cuda",
                       f"trainer.total_steps={DISTILL_STEPS}", "trainer.log_every=1",
                       "trainer.checkpoint_dir=None"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    k3_by_len = fa.fused_launch_counts("fused_qkv_fwd")
    wall = time.perf_counter() - t0
    records = _step_records(buf.getvalue())
    for r in records:
        print(f"cli.train {CONFIG_DISTILL}: {r}", flush=True)
    print(f"[{card}] main path (distill): {DISTILL_STEPS} steps in {wall:.1f} s wall incl. "
          f"student and teacher init and host data; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {counts}, predicted "
          f"{want}; K3 by S {k3_by_len}", flush=True)
    if rc != 0 or len(records) != DISTILL_STEPS:
        raise AssertionError(f"cli.train logged {len(records)} of {DISTILL_STEPS} distill steps")
    keys = ("loss", "loss_middle", "loss_final", "grad_norm")
    if not all(math.isfinite(float(r[k])) for r in records for k in keys):
        raise AssertionError("non-finite loss, loss term or grad_norm on the distill path")
    if counts != want or k3_by_len != {DISTILL_STUDENT_SHAPE[1]: want["fused_qkv_fwd"]}:
        raise AssertionError(f"launches {counts} (K3 by S {k3_by_len}) on the distill path; "
                             f"predicted {want}, all K3 at S {DISTILL_STUDENT_SHAPE[1]}")
    return counts


def _distill_models(run, dtype=None):
    """The recipe's student (gammas 0.1) and frozen teacher (gammas 0.1), in
    `dtype` if given (fp32 weights and compute for an anchor)."""
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.models.pretrain import PretrainInternVideo2
    from internvideo_tpu_torch.train.state import frozen_teacher

    enc, tcfg = run.model.encoder, run.teacher
    if dtype is not None:
        enc = dataclasses.replace(enc, dtype=dtype, param_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype, param_dtype=dtype)
    student = PretrainInternVideo2(dataclasses.replace(run.model, encoder=enc), device="cuda",
                                   generator=torch.Generator("cuda").manual_seed(0))
    teacher = InternVideo2(tcfg, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    _raise_gammas(student)
    _raise_gammas(teacher)
    return student, frozen_teacher(teacher)


DISTILL_ROUTE_GRADS = ("encoder.blocks.0.attn.qkv.weight", "encoder.blocks.0.attn.q_norm.weight",
                       "encoder.blocks.23.attn.qkv.weight", "clip_decoder.0.head.weight",
                       "clip_decoder.5.head.weight", "final_clip_decoder.head.weight")


def _distill_route(student, teacher, cfg, video, keep, impl, names=None):
    from internvideo_tpu_torch.train.engines.distill import distill_loss

    for m in (student, teacher):
        _set_attn_impl(m, impl)
    student.zero_grad(set_to_none=True)
    loss, aux, _ = distill_loss(student, teacher, cfg, video, keep=keep, deterministic=True)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in student.named_parameters()
             if p.grad is not None and (names is None or n in names)}
    student.zero_grad(set_to_none=True)
    return {k: v.item() for k, v in {"loss": loss, **aux}.items()}, grads


def check_distill_routes(run) -> None:
    """Phase 56: kernel route vs plain route of the distill loss, B 2, the
    same tube keep indices: fp32 at the L / 1B widths and depth 2 (teacher
    layers (1, 0); loss and every student grad max-abs 5e-4); bf16 at full
    depth, an fp32 copy of the weights on the plain route as the anchor:
    each loss within 1e-2 of the plain route's (the grads of
    DISTILL_ROUTE_GRADS rel-L2 2e-2), or the kernel route no farther from
    the anchor than 1.25 x the plain route."""
    from internvideo_tpu_torch.ops import flash_attention as fa
    from internvideo_tpu_torch.train.engines.distill import draw_keep_indices

    enc = run.model.encoder
    g = torch.Generator("cuda").manual_seed(56)
    video = torch.randn(2, enc.num_frames, enc.img_size, enc.img_size, 3, device="cuda",
                        generator=g)
    keep = draw_keep_indices(run.engine, enc, g, 2, enc.num_frames)
    small = dataclasses.replace(
        run, model=dataclasses.replace(run.model, encoder=dataclasses.replace(enc, depth=2),
                                       clip_return_layers=2),
        teacher=dataclasses.replace(run.teacher, depth=2),
        engine=dataclasses.replace(run.engine, teacher_layer_indices=(1, 0)))
    student, teacher = _distill_models(small, "float32")
    fa.reset_launch_count()
    lk, gk = _distill_route(student, teacher, small.engine, video, keep, "kernel")
    ran = {n: fa.launch_count(n) for n in ("flash_fwd", "fused_qkv_fwd", "small_s_bwd_dkv")}
    if not all(ran.values()):
        raise AssertionError(f"the fp32 kernel route of the distill check ran {ran}")
    lp, gp = _distill_route(student, teacher, small.engine, video, keep, "plain")
    errs = {k: abs(lk[k] - lp[k]) for k in lk}
    gerr = max((gk[n] - gp[n]).abs().max().item() for n in gp)
    print(f"distill routes fp32 L / 1B widths, depth 2, B 2: loss kernel {lk['loss']:.6f} plain "
          f"{lp['loss']:.6f}; max-abs loss terms " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f"; every grad max-abs {gerr:.2e} (bar 5e-4, {len(gp)} tensors)", flush=True)
    if gk.keys() != gp.keys() or max(errs.values()) > 5e-4 or gerr > 5e-4:
        raise AssertionError("fp32 distill kernel route disagrees with the plain route")
    del student, teacher, gk, gp
    gc.collect()
    torch.cuda.empty_cache()

    student, teacher = _distill_models(run)
    res = {impl: _distill_route(student, teacher, run.engine, video, keep, impl,
                                DISTILL_ROUTE_GRADS) for impl in ("kernel", "plain")}
    s32, t32 = _distill_models(run, "float32")
    s32.load_state_dict(student.state_dict())
    t32.load_state_dict(teacher.state_dict())
    del student, teacher
    gc.collect()
    torch.cuda.empty_cache()
    anchor = _distill_route(s32, t32, run.engine, video, keep, "plain", DISTILL_ROUTE_GRADS)
    del s32, t32
    gc.collect()
    torch.cuda.empty_cache()
    (lk, gk), (lp, gp), (la, ga) = res["kernel"], res["plain"], anchor
    for key in lk:
        rel = abs(lk[key] - lp[key]) / max(abs(lp[key]), 1e-12)
        dk, dp = abs(lk[key] - la[key]), abs(lp[key] - la[key])
        print(f"distill bf16 full depth B 2, {key}: kernel {lk[key]:.6f}, plain {lp[key]:.6f} "
              f"(rel {rel:.3e}, bar 1e-2), fp32 anchor {la[key]:.6f} (kernel off by {dk:.3e}, "
              f"plain {dp:.3e})", flush=True)
        if not math.isfinite(lk[key]) or (rel > 1e-2 and dk > 1.25 * dp):
            raise AssertionError(f"distill routes disagree on {key}")
    for name in DISTILL_ROUTE_GRADS:
        rel, dk, dp = _rel(gk[name], gp[name]), _rel(gk[name], ga[name]), _rel(gp[name], ga[name])
        print(f"distill bf16 grad {name}: kernel vs plain rel-L2 {rel:.3e} (bar 2e-2); from the "
              f"fp32 anchor: kernel {dk:.3e}, plain {dp:.3e}", flush=True)
        if not torch.isfinite(gk[name]).all() or (rel > 2e-2 and dk > 1.25 * dp):
            raise AssertionError(f"distill routes disagree on the gradient of {name}")


def time_distill_step(fa, pd, ig, rms, run, card) -> dict:
    """Phase 57: the distill trainer (CONFIG_DISTILL, B 32) on a
    device-resident batch: one step's launches against `distill_want`, the
    step's ms (CUDA events, 3 steps after 1), clips/s, peak memory, the
    frozen teacher's share (its targets alone, CUDA events), then one step
    under torch.profiler: device time by kernel group, the idle share of
    the step's wall there and of its CUDA-event span."""
    from internvideo_tpu_torch.cli import train as cli
    from internvideo_tpu_torch.train.engines.distill import draw_keep_indices, teacher_targets

    trainer, shape, teacher = cli.build_distill(dataclasses.replace(
        run, trainer=dataclasses.replace(run.trainer, checkpoint_dir=None)), torch.device("cuda"))
    g = torch.Generator("cuda").manual_seed(57)
    batch = {"video": torch.randn(*shape, device="cuda", generator=g)}
    step = lambda: trainer._step(trainer.state, batch)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _all_reset(fa, pd, ig, rms)
    m = step()
    torch.cuda.synchronize()
    per_step = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    want = distill_want(run, 1)
    if per_step != want:
        raise AssertionError(f"the distill step launched {per_step}; predicted {want}")
    step_ms = _time_ms(step, iters=3, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    enc = run.model.encoder
    keep = draw_keep_indices(run.engine, enc, g, shape[0], enc.num_frames)
    teacher_ms = _time_ms(lambda: teacher_targets(teacher, run.engine, batch["video"], keep),
                          iters=3, warmup=1)
    b = shape[0]
    first = {k: float(v) for k, v in m.items()}
    print(f"[{card}] distill step (L/14 student 8x224 S = {DISTILL_STUDENT_SHAPE[1]}, remat; "
          f"frozen 1B teacher S = {DISTILL_TEACHER_SHAPE[1]}, bf16; AdamW) B={b}, "
          f"device-resident batch: {step_ms:.1f} ms = {b * 1e3 / step_ms:.2f} clips/s; teacher "
          f"targets {teacher_ms:.1f} ms ({teacher_ms / step_ms:.1%}), student forward + "
          f"backward + update {step_ms - teacher_ms:.1f} ms; peak device memory {peak:.2f} GB; "
          f"launches per step {per_step}; first step's metrics {first}", flush=True)
    prof = profile_step(step, card, "distill step")
    busy = prof["busy_ms"]
    idle_events = None if busy is None else max(0.0, 1 - busy / step_ms)
    if busy is not None:
        print(f"[{card}] distill step: device busy {busy:.1f} ms of the {step_ms:.1f} ms "
              f"CUDA-event span (idle {idle_events:.1%}; the profiler's own wall "
              f"{prof['wall_ms']:.1f} ms)", flush=True)
    del trainer, teacher, batch
    return {"step_ms": step_ms, "clips_per_s": b * 1e3 / step_ms, "teacher_ms": teacher_ms,
            "peak_gb": peak, "launches_per_step": per_step, "first_step": first,
            "profile_wall_ms": prof["wall_ms"], "busy_ms": busy,
            "idle_share_of_event_span": idle_events,
            "idle_share_of_profiler_wall": None if busy is None else
            max(0.0, 1 - busy / prof["wall_ms"]),
            "groups_ms": prof["groups"]}


def _write_sft_jsonl(root: str) -> str:
    """The jsonl of phase 58 under `root`: 8 conversations in the format of
    tests/test_mllm_tokenize.py `_sample`, each on its own seeded uint8 clip
    of SFT_JSONL_CLIP (`.npy`), and 8 text-only conversations of 300-2500
    characters; returns its path."""
    rng = np.random.default_rng(58)
    words = ["the", "cat", "jumps", "over", "a", "wall", "while", "two", "dogs", "watch",
             "from", "garden", "and", "then", "runs", "away", "quickly"]
    rows = []
    for i in range(8):
        clip = os.path.join(root, f"clip{i}.npy")
        np.save(clip, rng.integers(0, 256, SFT_JSONL_CLIP, dtype=np.uint8))
        t, h, w, _ = SFT_JSONL_CLIP
        rows.append({"messages": [{"role": "user", "content": "what happens <VIDEO_CONTEXT> here?"},
                                  {"role": "assistant", "content": "a cat jumps"}],
                     "videos": [{"path": clip, "width": w, "height": h, "origin_fps": 30.0,
                                 "origin_video_length": t}]})
    for _ in range(8):
        n = int(rng.integers(300, 2500))
        text = " ".join(rng.choice(words, size=n // 5))
        rows.append({"messages": [{"role": "user", "content": text[: n // 2]},
                                  {"role": "assistant", "content": text[n // 2:]}]})
    path = os.path.join(root, "data.jsonl")
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def run_sft_jsonl_path(fa, pd, ig, rms, card) -> dict:
    """Phase 58: the real SFT data path. `cli.train` on CONFIG_SFT with
    `data.jsonl=` (the data of `_write_sft_jsonl`) and the text depth cut to
    SFT_JSONL_DEPTH, SFT_JSONL_STEPS steps; launches reset before and read
    after against `sft_want`; every loss finite. Then on the same data: the
    host's ms a batch for packing + `load_media` (the stream alone, one
    packing round), the step on a device-resident batch, the step fed by
    `prefetch_to_device` (its ms and, under torch.profiler, the device's idle
    share); K5 + K8 on a batch's real segment ids vs their plain version
    (bf16 rel-L2 1e-2) and timed beside their bound."""
    import tempfile

    from internvideo_tpu_torch.cli import train as cli
    from internvideo_tpu_torch.core.config import apply_overrides, load_config
    from internvideo_tpu_torch.data.loader import prefetch_to_device

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sft_jsonl_") as root:
        path = _write_sft_jsonl(root)
        overrides = [f"data.jsonl={path}", f"model.text.num_layers={SFT_JSONL_DEPTH}"]
        want = {k: v for k, v in sft_want(fa, SFT_JSONL_STEPS, SFT_JSONL_DEPTH).items() if v}
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _all_reset(fa, pd, ig, rms)
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--config", CONFIG_SFT, "--device", "cuda",
                           f"trainer.total_steps={SFT_JSONL_STEPS}", "trainer.log_every=1",
                           *overrides])
        torch.cuda.synchronize()
        counts = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
        wall = time.perf_counter() - t0
        records = _step_records(buf.getvalue())
        for r in records:
            print(f"cli.train {CONFIG_SFT} data.jsonl: {r}", flush=True)
        print(f"[{card}] main path (SFT on a jsonl, text depth {SFT_JSONL_DEPTH}): "
              f"{SFT_JSONL_STEPS} steps in {wall:.1f} s wall incl. init and host data; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
              f"{counts}, predicted {want}", flush=True)
        if rc != 0 or len(records) != SFT_JSONL_STEPS:
            raise AssertionError(f"cli.train logged {len(records)} of {SFT_JSONL_STEPS} jsonl "
                                 "SFT steps")
        if not all(math.isfinite(float(r[k])) for r in records for k in ("loss", "grad_norm")):
            raise AssertionError("non-finite loss or grad_norm on the jsonl SFT path")
        if counts != want:
            raise AssertionError(f"launches {counts} on the jsonl SFT path; predicted {want}")
        out["launches"] = counts

        run = apply_overrides(load_config(CONFIG_SFT), overrides)
        stream = cli._mllm_jsonl_stream(run)
        t0 = time.perf_counter()
        first = next(stream)  # tokenizes every row, packs, loads the first round's clips
        t1 = time.perf_counter()
        batches = [next(stream) for _ in range(8)]  # one packing round: 8 clips
        host_ms = (time.perf_counter() - t1) * 1e3 / 8
        segs = [int(b["segment_ids"].max()) + 1 for b in [first] + batches]
        real = [int((b["segment_ids"] >= 0).sum()) for b in [first] + batches]
        print(f"[{card}] jsonl stream (host): tokenize 16 rows + the first batch "
              f"{(t1 - t0) * 1e3:.1f} ms; then {host_ms:.1f} ms a batch (pack + load_media of a "
              f"{SFT_JSONL_CLIP} clip to 16 x 224 x 224); segments a row {segs}, real tokens "
              f"{real} of {first['input_ids'].shape[1]}", flush=True)
        trainer, _ = cli.build_sft(run, torch.device("cuda"))
        dev = trainer.put_batch(first)
        step_ms = _time_ms(lambda: trainer._step(trainer.state, dev), iters=3, warmup=1)
        data = prefetch_to_device(stream, torch.device("cuda"))
        fed = lambda: trainer._step(trainer.state, trainer.put_batch(next(data)))  # noqa: E731
        fed_ms = _time_ms(fed, iters=4, warmup=1)
        prof = profile_step(fed, card, "jsonl SFT step fed by prefetch_to_device")
        busy = prof["busy_ms"]
        idle = None if busy is None else max(0.0, 1 - busy / prof["wall_ms"])
        idle_events = None if busy is None else max(0.0, 1 - busy / fed_ms)
        print(f"[{card}] jsonl SFT step (text depth {SFT_JSONL_DEPTH}, pack {SFT_PACK}, B 1): "
              f"{step_ms:.1f} ms on a device-resident batch, {fed_ms:.1f} ms fed by "
              f"prefetch_to_device (host {host_ms:.1f} ms a batch, {host_ms / step_ms:.1%} of "
              f"the step); device idle "
              + ("not measured" if busy is None else
                 f"{idle_events:.1%} of the fed step's CUDA-event span, {idle:.1%} of the "
                 "profiler's wall"), flush=True)
        seg = torch.from_numpy(first["segment_ids"]).cuda()
        data.close()
        del trainer, dev, data, stream, batches
        gc.collect()
        torch.cuda.empty_cache()
    out.update(host_ms_per_batch=host_ms, first_batch_ms=(t1 - t0) * 1e3, step_ms=step_ms,
               fed_step_ms=fed_ms, idle_share_of_profiler_wall=idle,
               idle_share_of_event_span=idle_events, segments=segs, real_tokens=real,
               device_busy_ms=prof["busy_ms"], profile_wall_ms=prof["wall_ms"])

    g = torch.Generator("cuda").manual_seed(58)
    b, s, h, d, dv = SFT_ATTN_SHAPE
    q = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    kv = torch.randn(b, s, h, d + dv, device="cuda", generator=g).bfloat16()
    k, v = kv[..., :d], kv[..., d:]
    do = torch.randn(b, s, h, dv, device="cuda", generator=g).bfloat16()
    got = _attn_grads(lambda q, k, v: fa.flash_attention(
        q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg), q, k, v, do)
    ref_out, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True, 0, seg, seg)
    ref = [ref_out, *fa.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, do, d ** -0.5,
                                                causal=True, q_segment_ids=seg,
                                                kv_segment_ids=seg)]
    rels = [_rel(a, w) for a, w in zip(got, ref)]
    errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, ref)]
    print(f"K5 + K8 bf16 {SFT_ATTN_SHAPE} causal on a jsonl batch's {int(seg.max()) + 1} "
          f"segments + pads: out / dq / dk / dv rel-L2 " + " / ".join(f"{r:.2e}" for r in rels)
          + " (bar 1e-2)", flush=True)
    if not max(rels) <= 1e-2:
        raise AssertionError("bf16 K5 / K8 disagree with their plain version on a jsonl pack")
    del got, ref, ref_out, ref_lse
    scale = d ** -0.5
    pairs = h * _visible_pairs(seg)
    io_fwd = (2 * b * s * h * d + 2 * b * s * h * dv) * 2 + b * h * s * 4
    io_bwd = (2 * b * s * h * d + 2 * b * s * h * dv) * 2 + 2 * b * h * s * 4
    with torch.no_grad():
        o, lse = fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0, seg, seg)
        delta = fa._bwd_delta(o, do)
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        ptrs = fa._seg_ptrs(seg, seg)[1]
        ms = {"flash_fwd_causal_seg": _median_ms(lambda: fa._flash_fwd_causal_cuda(
            q, k, v, scale, True, 0, seg, seg), iters=5)}
        for kind in ("dq", "dkv"):
            ms[f"flash_bwd_causal_{kind}_seg"] = _median_ms(lambda: fa._launch_bwd_causal(
                kind, q, k, v, do, lse, delta, ptrs, grads, scale, True, 0), iters=5)
    bounds = {"flash_fwd_causal_seg": _bound(2 * pairs * (d + dv), io_fwd),
              "flash_bwd_causal_dq_seg": _bound(2 * pairs * (2 * d + dv),
                                                io_bwd + b * s * h * d * 2),
              "flash_bwd_causal_dkv_seg": _bound(2 * pairs * (2 * d + 2 * dv),
                                                 io_bwd + b * s * h * (d + dv) * 2)}
    out["k8"] = {}
    for i, name in enumerate(bounds):
        out["k8"][name] = {"shape": list(SFT_ATTN_SHAPE), "segments": int(seg.max()) + 1,
                           "ms": ms[name], "bound_ms": bounds[name][0],
                           "bound_by": bounds[name][1],
                           "max_abs_err": (errs[0], errs[1], max(errs[2:]))[i],
                           "launches_per_step": out["launches"].get(name, 0) // SFT_JSONL_STEPS}
        print(f"[{card}] {name} {SFT_ATTN_SHAPE} bf16 on the jsonl pack "
              f"({pairs / h:.3e} visible pairs a head): kernel {ms[name]:.3f} ms, bound "
              f"{bounds[name][0]:.3f} ms ({bounds[name][1]})", flush=True)
    del q, kv, k, v, do, o, lse, delta, grads
    return out


def check_prefetch(card) -> dict:
    """Phase 59: `prefetch_to_device` on the card. Six host batches of
    PREFETCH_BATCH's shapes (fp32 clips, int32 ids) go through it; a kernel
    is queued on the consumer's stream on each batch the moment it arrives,
    and its result must equal the host bytes (the side-stream copy waited
    for); then a second pass without checks gives the host -> card GB/s,
    pinning included (host wall from the first batch asked to the last one
    on the card)."""
    from internvideo_tpu_torch.data.loader import prefetch_to_device

    rng = np.random.default_rng(59)
    host = [{"video": rng.standard_normal(PREFETCH_BATCH["video"], dtype=np.float32),
             "input_ids": rng.integers(0, VOCAB, PREFETCH_BATCH["input_ids"]).astype(np.int32)}
            for _ in range(6)]
    nbytes = sum(x.nbytes for b in host for x in b.values())
    torch.cuda.synchronize()
    for want, got in zip(host, prefetch_to_device(iter(host), torch.device("cuda"), size=2)):
        video = got["video"] * 1.0  # queued at once on the consumer stream
        ids = got["input_ids"] + 0
        if not (torch.equal(video.cpu(), torch.from_numpy(want["video"]))
                and torch.equal(ids.cpu(), torch.from_numpy(want["input_ids"]))):
            raise AssertionError("prefetch_to_device handed the consumer bytes that differ "
                                 "from the host batch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = [b["video"].sum() for b in prefetch_to_device(iter(host), torch.device("cuda"),
                                                         size=2)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = nbytes / wall / 1e9
    if not all(math.isfinite(x.item()) for x in sums):
        raise AssertionError("prefetch_to_device's batches are not finite")
    print(f"[{card}] prefetch_to_device: {len(host)} batches of {nbytes / len(host) / 1e6:.1f} MB "
          f"(fp32 {PREFETCH_BATCH['video']} + int32 {PREFETCH_BATCH['input_ids']}) equal to the "
          f"host bytes after the side-stream copy; {rate:.1f} GB/s host -> card, pinning "
          f"included ({wall * 1e3:.1f} ms)", flush=True)
    return {"batches": len(host), "bytes": nbytes, "gb_per_s": rate, "wall_ms": wall * 1e3}


# -- Audio-visual stage 2 (task clip_av): phases 60-65 -----------------------------------


def _av_tokens(model_cfg) -> int:
    """Audio tokens of the AV model's audio tower on its batch's fbank
    (BEATs pads each axis to a multiple of its patch, XLA's SAME rule; the
    simple tower tiles exactly)."""
    from internvideo_tpu_torch.models.beats import BEATsConfig

    a = model_cfg.audio
    if model_cfg.audio_tower == "beats":
        p = (model_cfg.beats or BEATsConfig()).input_patch_size
        return -(-a.max_frames // p) * -(-a.n_mels // p)
    return (a.max_frames // a.patch_size) * (a.n_mels // a.patch_size)


def clip_av_want(run, media: str, steps: int) -> dict:
    """Kernel launches of `steps` audio-visual steps of `media`: per tower
    block one K1 (two with remat) and one K4a dq and dk/dv when the media
    has video; per simple-tower block one K2 / K4b when it has audio
    (BEATs' attention is plain torch); per fusion layer one
    cross-attention over the media's tokens in the MLM pass and one in the
    VTM pass, K2 / K4b at Sk <= 1024 and K1 / K4a above. BERT
    self-attention is masked (the plain einsum): nothing else launches."""
    from internvideo_tpu_torch.ops.flash_attention import SMALL_S_MAX

    m = run.model
    v, t = m.vision, m.text
    per = {}

    def add(route, n):
        names = (("small_s_fwd", "small_s_bwd_dq", "small_s_bwd_dkv") if route == "small"
                 else ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        for name, k in zip(names, n):
            per[name] = per.get(name, 0) + k

    n_video = 1 + v.num_patches if media != "audio" else 0
    n_audio = _av_tokens(m) if media != "video" else 0
    if n_video:
        add("flash", ((2 if v.remat else 1) * v.depth, v.depth, v.depth))
    if n_audio and m.audio_tower == "simple":
        add("small" if n_audio <= SMALL_S_MAX else "flash", (m.audio.depth,) * 3)
    fusion = 2 * (t.num_layers - t.fusion_layer)
    add("small" if n_video + n_audio <= SMALL_S_MAX else "flash", (fusion,) * 3)
    return {n: c * steps for n, c in per.items()}


def check_av_kernels(fa) -> dict:
    """Phase 60: the fusion cross-attention at the audio-visual step's new
    shapes, K1 / K4a at Sk 1277 (audio + video tokens) and K2 / K4b at Sk
    252 (audio alone), 32 queries, 16 heads of 64, B 64 (MLM pass) and 192
    (VTM pass); and K2 / K4b at the simple tower's (64, 512, 12, 64) on qkv
    views. fp32 at B 2 with each Sq / Sk (out max-abs 2e-5, grads 5e-4),
    bf16 at the path's shapes (rel-L2 1e-2; K1's LSE max-abs 1e-2).
    Returns max-abs errors by tag and kernel."""
    g = torch.Generator("cuda").manual_seed(60)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    b_s, s_s, h_s, d_s = AV_SIMPLE_SHAPE
    cases = {**AV_CROSS_SHAPES, "simple_tower": (b_s, s_s, s_s, h_s, d_s)}
    errs_by = {}
    for tag, (b, sq, sk, h, d) in cases.items():
        small = sq <= fa.SMALL_S_MAX and sk <= fa.SMALL_S_MAX
        names = (("small_s_fwd", "small_s_bwd_dq", "small_s_bwd_dkv") if small
                 else ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        if not tag.endswith("_vtm"):  # the VTM pass has the MLM pass's Sq / Sk
            q, do, k, v = rnd(2, sq, h, d), rnd(2, sq, h, d), rnd(2, sk, h, d), rnd(2, sk, h, d)
            got, ref = _flash_vs_plain(fa, q, k, v, do, small_s=small)
            errs = [(x - r).abs().max().item() for x, r in zip(got, ref)]
            print(f"AV {names[0]} / bwd fp32 (2, {sq}, {sk}, {h}, {d}) ({tag}): out max-abs "
                  f"{errs[0]:.3e} (bar 2e-5), dq / dk / dv {errs[2]:.3e} / {errs[3]:.3e} / "
                  f"{errs[4]:.3e} (bar 5e-4)", flush=True)
            if not (errs[0] <= 2e-5 and (small or errs[1] <= 2e-5) and max(errs[2:]) <= 5e-4):
                raise AssertionError(f"fp32 {names} disagree with their plain versions at {tag}")
        if sq == sk:
            _, (q, k, v) = _qkv_views(b, sq, h, d, g)
        else:
            q, k, v = (rnd(b, s, h, d).bfloat16() for s in (sq, sk, sk))
        do = rnd(*q.shape).bfloat16()
        got, ref = _flash_vs_plain(fa, q, k, v, do, small_s=small)
        rels = [_rel(x, r) for x, r in zip(got, ref)]
        errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
        print(f"AV {names[0]} / bwd bf16 {(b, sq, sk, h, d)} ({tag}): out / dq / dk / dv rel-L2 "
              + " / ".join(f"{r:.3e}" for r in rels[:1] + rels[2:]) + " (bar 1e-2)"
              + ("" if small else f", lse max-abs {errs[1]:.3e} (bar 1e-2)"), flush=True)
        if not (max(rels[:1] + rels[2:]) <= 1e-2 and (small or errs[1] <= 1e-2)):
            raise AssertionError(f"bf16 {names} disagree with their plain versions at {tag}")
        errs_by[tag] = {names[0]: errs[0], names[1]: errs[2], names[2]: max(errs[3:])}
        del q, k, v, do, got, ref
    return errs_by


def time_av_kernels(fa, card) -> dict:
    """Phase 60, times: each phase-60 shape's forward, dq and dk/dv kernels
    (K1 / K4a by CUDA events, K2 / K4b by CUDA graph replay; median of 5)
    beside the plain versions, bounds and flash SDPA. Returns tag -> kernel
    -> times."""
    g = torch.Generator("cuda").manual_seed(61)
    b_s, s_s, h_s, d_s = AV_SIMPLE_SHAPE
    res = {}
    for tag, shape in {**AV_CROSS_SHAPES, "simple_tower": (b_s, s_s, s_s, h_s, d_s)}.items():
        small = max(shape[1:3]) <= fa.SMALL_S_MAX
        res[tag] = _attn_times(fa, shape, small, g, _median_graph_ms if small else _median_ms)
        _print_attn_times(card, "clip_av", tag, res[tag])
    return res


def run_clip_av_path(fa, pd, ig, rms, card) -> dict:
    """Phase 61: the audio-visual main path, `cli.train` on CONFIG_AV
    (media type audio_video) for AV_STEPS steps; launches reset just before
    and read just after must equal `clip_av_want`; every logged loss term
    and grad_norm finite. Returns the launches."""
    from internvideo_tpu_torch.cli import train as cli
    from internvideo_tpu_torch.core.config import load_config

    want = clip_av_want(load_config(CONFIG_AV), "audio_video", AV_STEPS)
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _all_reset(fa, pd, ig, rms)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_AV, "--device", "cuda",
                       f"trainer.total_steps={AV_STEPS}", "trainer.log_every=1",
                       "trainer.checkpoint_dir=None"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    wall = time.perf_counter() - t0
    records = _step_records(buf.getvalue())
    for r in records:
        print(f"cli.train {CONFIG_AV}: {r}", flush=True)
    print(f"[{card}] main path (audio-visual stage 2, audio_video): {AV_STEPS} steps in "
          f"{wall:.1f} s wall incl. model init and host data; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {counts}, predicted "
          f"{want}", flush=True)
    if rc != 0 or len(records) != AV_STEPS:
        raise AssertionError(f"cli.train logged {len(records)} of {AV_STEPS} audio-visual steps")
    keys = ("loss", "loss_vtc", "loss_vtm", "loss_mlm", "grad_norm")
    if not all(math.isfinite(float(r[k])) for r in records for k in keys):
        raise AssertionError("non-finite loss, loss term or grad_norm on the audio-visual path")
    if counts != want:
        raise AssertionError(f"launches {counts} on the audio-visual path; predicted {want}")
    return counts


def _av_batch(run, b: int, seed: int) -> dict:
    """A device batch of the AV config's shapes: normal clips and fbanks,
    token ids in [1, 1000), all-ones masks, idx 0..B-1."""
    v, a = run.model.vision, run.model.audio
    g = torch.Generator("cuda").manual_seed(seed)
    ids = torch.randint(1, 1000, (b, run.data["text_len"]), device="cuda", generator=g)
    return {"video": torch.randn(b, v.num_frames, v.img_size, v.img_size, 3, device="cuda",
                                 generator=g),
            "audio": torch.randn(b, a.max_frames, a.n_mels, device="cuda", generator=g),
            "input_ids": ids, "attention_mask": torch.ones_like(ids),
            "idx": torch.arange(b, device="cuda")}


def _use_media(trainer, run, media: str) -> None:
    """Point the trainer's step at `media` (one step per media type, as
    `make_av_clip_train_step` builds them; the model and optimizer stay)."""
    from internvideo_tpu_torch.train.engines.clip import make_av_clip_train_step

    trainer._step = make_av_clip_train_step(run.engine, media,
                                            grad_accum=run.trainer.grad_accum)


def _audio_tower_ms(model, audio) -> float:
    """The audio tower's forward + backward alone on `audio` (CUDA events)."""
    def fwd_bwd():
        tokens, pooled = model.audio_encoder(audio)
        (tokens.float().mean() + pooled.float().mean()).backward()

    ms = _time_ms(fwd_bwd, iters=2, warmup=1)
    model.zero_grad(set_to_none=True)
    return ms


def time_clip_av_steps(fa, pd, ig, rms, run, card):
    """Phase 62: the audio-visual trainer (CONFIG_AV, B 64) on
    device-resident batches, one step function per media type on one model
    and optimizer: each step's launches against `clip_av_want`, its ms (CUDA
    events: audio_video 1 step after 2, video 1 after 1, audio 2 after 2:
    the allocator still grows over the first steps), clips/s, peak device
    memory, first metrics; the audio tower's forward + backward alone (its
    share of the audio_video step); audio_video and audio under
    torch.profiler (device time by kernel group, idle share). Returns
    (results by media, the trainer)."""
    from internvideo_tpu_torch.cli import train as cli

    trainer, shape = cli.build_clip_av(dataclasses.replace(
        run, trainer=dataclasses.replace(run.trainer, checkpoint_dir=None)), torch.device("cuda"))
    b = shape["video"][0]
    batch = _av_batch(run, b, 62)
    res = {}
    for media, warmup, iters in (("audio_video", 1, 1), ("video", 0, 1), ("audio", 1, 2)):
        _use_media(trainer, run, media)
        step = lambda: trainer._step(trainer.state, batch)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _all_reset(fa, pd, ig, rms)
        m = step()
        torch.cuda.synchronize()
        per_step = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
        want = clip_av_want(run, media, 1)
        if per_step != want:
            raise AssertionError(f"the {media} step launched {per_step}; predicted {want}")
        first = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(x) for x in first.values()):
            raise AssertionError(f"non-finite metrics in the {media} step: {first}")
        step_ms = _time_ms(step, iters=iters, warmup=warmup)
        peak = torch.cuda.max_memory_allocated() / 1e9
        r = {"step_ms": step_ms, "clips_per_s": b * 1e3 / step_ms, "peak_gb": peak,
             "launches_per_step": per_step, "first_step": first,
             "timed_steps": iters, "after_steps": 1 + warmup}
        if media == "audio_video":
            r["audio_tower_ms"] = _audio_tower_ms(trainer.model, batch["audio"])
            r["audio_tower_share"] = r["audio_tower_ms"] / step_ms
        print(f"[{card}] audio-visual step ({media}; BEATs on 998 x 64 -> "
              f"{_av_tokens(run.model)} tokens, 1B tower 4x224 remat, bert-large; AdamW) bf16 "
              f"B={b}, device-resident batch: {step_ms:.1f} ms = {b * 1e3 / step_ms:.2f} "
              f"clips/s; peak device memory {peak:.2f} GB; launches per step {per_step}; "
              f"first step's metrics {first}"
              + (f"; the audio tower's forward + backward alone {r['audio_tower_ms']:.1f} ms "
                 f"({r['audio_tower_share']:.1%} of the step)" if "audio_tower_ms" in r else ""),
              flush=True)
        if media != "video":
            prof = profile_step(step, card, f"audio-visual {media} step")
            busy = prof["busy_ms"]
            r.update(profile_wall_ms=prof["wall_ms"], busy_ms=busy, groups_ms=prof["groups"],
                     idle_share_of_event_span=None if busy is None
                     else max(0.0, 1 - busy / step_ms),
                     idle_share_of_profiler_wall=None if busy is None
                     else max(0.0, 1 - busy / prof["wall_ms"]))
        res[media] = r
    del batch
    return res, trainer


def _write_av_files(root: str):
    """AV_REAL_WAVS wavs of 10-12 s (every other one at 22.05 kHz stereo, so
    the downmix and the resampling run) and as many seeded uint8 `.npy`
    clips of AV_REAL_CLIP; then an audio jsonl and an audio_video jsonl over
    them. Returns the two jsonl paths."""
    from scipy.io import wavfile

    rng = np.random.default_rng(63)
    rows = []
    for i in range(AV_REAL_WAVS):
        sr, stereo = (22_050, True) if i % 2 else (16_000, False)
        seconds = 10.0 + 2.0 * i / (AV_REAL_WAVS - 1)
        t = np.arange(int(seconds * sr)) / sr
        wav = 0.4 * np.sin(2 * np.pi * (220 + 55 * i) * t) + 0.05 * rng.standard_normal(t.shape)
        if stereo:
            wav = np.stack([wav, 0.3 * np.sin(2 * np.pi * 440 * t)], 1)
        wav_path = os.path.join(root, f"a{i}.wav")
        wavfile.write(wav_path, sr, (wav * 32767).astype(np.int16))
        clip_path = os.path.join(root, f"c{i}.npy")
        np.save(clip_path, rng.integers(0, 256, AV_REAL_CLIP, dtype=np.uint8))
        rows.append({"audio": wav_path, "video": clip_path,
                     "caption": f"a tone of {220 + 55 * i} hertz over a clip {i}"})
    paths = []
    for name, keys in (("audio", ("audio", "caption")),
                       ("audio_video", ("audio", "video", "caption"))):
        path = os.path.join(root, f"{name}.jsonl")
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps({k: r[k] for k in keys}) + "\n")
        paths.append(path)
    return paths


def run_av_real_audio_path(trainer, run, card) -> dict:
    """Phase 63: the real-audio path on the phase-62 trainer. Wavs and clips
    written by `_write_av_files`, an `audio` and an `audio_video` corpus
    registered and built (`register_corpus`, `build_datasets`, the toy
    tokenizer, 4 x 224 clips, 32 tokens); per media type AV_STEPS steps of
    JsonlVideoTextDataset (load_fbank: 998 x 64) -> prefetch_to_device ->
    the step at B 64, every loss finite; the host's ms a batch (the whole
    batch; load_fbank alone as B x its mean over the corpus's rows, each
    read once) beside the fed step's ms; one fed step under torch.profiler
    (idle share)."""
    import tempfile

    from internvideo_tpu_torch.data.corpus import CorpusSpec, build_datasets, register_corpus
    from internvideo_tpu_torch.data.loader import prefetch_to_device
    from internvideo_tpu_torch.data.tokenizer import ToyTokenizer

    v, b = run.model.vision, run.data["batch_size"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_av_") as root:
        for media, anno in zip(("audio", "audio_video"), _write_av_files(root)):
            name = f"chip_smoke_{media}"
            register_corpus(CorpusSpec(name=name, anno_path=anno, media_type=media),
                            overwrite=True)
            ds = build_datasets(name, ToyTokenizer(), num_frames=v.num_frames,
                                img_size=v.img_size, max_length=run.data["text_len"])[name]
            rng = np.random.default_rng(0)
            ds.load_audio(1, rng)  # warm: scipy's first resample
            t0 = time.perf_counter()
            for i in range(len(ds)):
                ds.load_audio(i, rng)
            fbank_ms = (time.perf_counter() - t0) * 1e3 / len(ds) * b  # B rows at the mean
            host = ds.batches(b)
            t0 = time.perf_counter()
            first = next(host)
            batch_ms = (time.perf_counter() - t0) * 1e3
            if first["audio"].shape != (b, 998, 64) or ("video" in first) != (media != "audio"):
                raise AssertionError(f"{media} batch shapes "
                                     f"{ {k: x.shape for k, x in first.items()} }")
            _use_media(trainer, run, media)
            data = prefetch_to_device(host, torch.device("cuda"))
            fed = lambda: trainer._step(trainer.state, trainer.put_batch(next(data)))  # noqa: E731
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = [fed() for _ in range(AV_STEPS)]
            torch.cuda.synchronize()
            fed_ms = (time.perf_counter() - t0) * 1e3 / AV_STEPS
            losses = [{k: float(x) for k, x in m.items()} for m in metrics]
            if not all(math.isfinite(x) for m in losses for x in m.values()):
                raise AssertionError(f"non-finite metrics on the real-audio {media} path: "
                                     f"{losses}")
            prof = profile_step(fed, card, f"real-audio {media} step fed by prefetch_to_device")
            data.close()
            busy = prof["busy_ms"]
            idle = None if busy is None else max(0.0, 1 - busy / prof["wall_ms"])
            print(f"[{card}] real-audio {media} path ({AV_REAL_WAVS} wavs of 10-12 s, half at "
                  f"22.05 kHz stereo; {AV_REAL_CLIP} uint8 clips): host {batch_ms:.1f} ms a "
                  f"batch of {b} (load_fbank {fbank_ms:.1f} ms: B x its mean over the rows), "
                  f"the fed step {fed_ms:.1f} ms over {AV_STEPS} steps; idle "
                  + ("not measured" if idle is None else f"{idle:.1%}")
                  + f" of the profiled fed step; losses {losses}", flush=True)
            out[media] = {"host_batch_ms": batch_ms, "load_fbank_ms_per_batch": fbank_ms,
                          "fed_step_ms": fed_ms, "idle_share_of_profiler_wall": idle,
                          "busy_ms": busy, "profile_wall_ms": prof["wall_ms"],
                          "losses": losses}
            del data, host, first
    return out


def _av_model(run, dtype: str = "bfloat16", **text_overrides):
    """The AV model of `run` with every tower in `dtype` (fp32 params either
    way), the vision tower's LayerScale gammas at 0.1."""
    from internvideo_tpu_torch.models.videoclip_av import VideoCLIPAV

    cfg = run.model
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, dtype=dtype),
        beats=dataclasses.replace(cfg.beats, dtype=dtype),
        text=dataclasses.replace(cfg.text, dtype=dtype, **text_overrides))
    model = VideoCLIPAV(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    _raise_gammas(model.vision_encoder)
    return model


AV_ROUTE_GRADS = ("vision_encoder.blocks.0.attn.qkv.weight",
                  "vision_encoder.blocks.39.attn.qkv.weight",
                  "audio_encoder.layers.0.self_attn.q_proj.weight",
                  "audio_encoder.layers.11.fc2.weight", "audio_to_fusion.weight",
                  "text_encoder.layer.19.crossattention.key.weight",
                  "text_encoder.layer.23.crossattention.query.weight",
                  "itm_head.weight", "temp")


def _av_route(model, run, media, batch, draws, impl, names=None):
    from internvideo_tpu_torch.train.engines.clip import av_clip_loss

    _set_attn_impl(model, impl)
    model.zero_grad(set_to_none=True)
    loss, aux = av_clip_loss(model, run.engine, media, batch, deterministic=True, **draws)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
             if p.grad is not None and (names is None or n in names)}
    return {k: v.item() for k, v in {"loss": loss, **aux}.items()}, grads


def check_clip_av_routes(run) -> None:
    """Phase 64: kernel route vs plain route of the audio-visual loss per
    media type, B 2, the same draws (negatives by rotation, one MLM
    corruption), dropout off. fp32 at full widths and depth 2 (vision
    blocks, BEATs layers, text layers with one fusion layer): the loss
    terms and every gradient max-abs 5e-4. bf16 at full depth: each loss
    term within 1e-2 of the plain route's (grads: rel-L2 2e-2), or the
    kernel route no farther from an fp32 copy of the weights (plain route)
    than 1.25 x the plain route."""
    from internvideo_tpu_torch.train.engines.clip import mlm_corrupt

    b = 2
    batch = _av_batch(run, b, 64)
    rows = torch.arange(b, device="cuda")
    corrupted, labels = mlm_corrupt(torch.Generator("cuda").manual_seed(65),
                                    batch["input_ids"], run.engine)
    draws = dict(vis_neg=(rows + 1) % b, txt_neg=(rows + 1) % b, corrupted=corrupted,
                 mlm_labels=labels)
    m = run.model
    shallow = dataclasses.replace(run, model=dataclasses.replace(
        m, vision=dataclasses.replace(m.vision, depth=2),
        beats=dataclasses.replace(m.beats, encoder_layers=2)))
    model = _av_model(shallow, "float32", num_layers=2, fusion_layer=1)
    for media in ("audio_video", "video", "audio"):
        (lk, gk), (lp, gp) = (_av_route(model, shallow, media, batch, draws, impl)
                              for impl in ("kernel", "plain"))
        loss_err = max(abs(lk[k] - lp[k]) for k in lp)
        grad_err = max((gk[n] - gp[n]).abs().max().item() for n in gp)
        print(f"audio-visual {media} fp32 depth 2, B={b}: loss terms max-abs {loss_err:.3e}, "
              f"{len(gp)} grads max-abs {grad_err:.3e} (bar 5e-4)", flush=True)
        if set(gk) != set(gp) or loss_err > 5e-4 or grad_err > 5e-4:
            raise AssertionError(f"fp32 audio-visual routes disagree ({media})")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = _av_model(run)
    res = {media: {impl: _av_route(model, run, media, batch, draws, impl, AV_ROUTE_GRADS)
                   for impl in ("kernel", "plain")} for media in ("audio_video", "video", "audio")}
    f32 = _av_model(run, "float32")
    f32.load_state_dict(model.state_dict())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for media, r in res.items():
        (lk, gk), (lp, gp) = r["kernel"], r["plain"]
        la, ga = _av_route(f32, run, media, batch, draws, "plain", AV_ROUTE_GRADS)
        for key in lk:
            rel = abs(lk[key] - lp[key]) / max(abs(lp[key]), 1e-12)
            dk, dp = abs(lk[key] - la[key]), abs(lp[key] - la[key])
            print(f"audio-visual {media} bf16 B={b}, {key}: kernel {lk[key]:.6f}, plain "
                  f"{lp[key]:.6f} (rel {rel:.3e}, bar 1e-2), fp32 anchor {la[key]:.6f} (kernel "
                  f"off by {dk:.3e}, plain {dp:.3e})", flush=True)
            if not math.isfinite(lk[key]) or (rel > 1e-2 and dk > 1.25 * dp):
                raise AssertionError(f"audio-visual routes disagree on {media} {key}")
        if set(gk) != set(gp):
            raise AssertionError(f"the routes reached different parameters ({media})")
        for name in gp:
            rel, dk, dp = (_rel(gk[name], gp[name]), _rel(gk[name], ga[name]),
                           _rel(gp[name], ga[name]))
            print(f"audio-visual {media} bf16 grad {name}: kernel vs plain rel-L2 {rel:.3e} "
                  f"(bar 2e-2); from the fp32 anchor: kernel {dk:.3e}, plain {dp:.3e}",
                  flush=True)
            if not torch.isfinite(gk[name]).all() or (rel > 2e-2 and dk > 1.25 * dp):
                raise AssertionError(f"audio-visual routes disagree on {media} grad {name}")
    del f32
    gc.collect()
    torch.cuda.empty_cache()


def run_simple_tower_step(fa, pd, ig, rms, run, card) -> dict:
    """Phase 65: the simple audio tower at its default width
    (AudioEncoderConfig(): 768 wide, 12 blocks of 12 heads, on a 1024 x 128
    fbank -> 512 tokens) in bf16 in place of BEATs, an audio step at B 64 on
    a device-resident batch, counted (12 + 10 each of K2 / K4b dq / K4b
    dk/dv against `clip_av_want`), then 2 timed (CUDA events); peak memory."""
    from internvideo_tpu_torch.cli import train as cli
    from internvideo_tpu_torch.models.audio import AudioEncoderConfig

    simple = dataclasses.replace(
        run, model=dataclasses.replace(run.model, audio_tower="simple", beats=None,
                                       audio=AudioEncoderConfig(dtype="bfloat16")),
        data={**run.data, "media_type": "audio"},
        trainer=dataclasses.replace(run.trainer, checkpoint_dir=None))
    trainer, shape = cli.build_clip_av(simple, torch.device("cuda"))
    b = shape["audio"][0]
    batch = _av_batch(simple, b, 65)
    step = lambda: trainer._step(trainer.state, batch)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _all_reset(fa, pd, ig, rms)
    m = step()
    torch.cuda.synchronize()
    per_step = {k: v for k, v in _all_counts(fa, pd, ig, rms).items() if v}
    want = clip_av_want(simple, "audio", 1)
    if per_step != want:
        raise AssertionError(f"the simple tower's audio step launched {per_step}; predicted "
                             f"{want}")
    first = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(x) for x in first.values()):
        raise AssertionError(f"non-finite metrics in the simple tower's audio step: {first}")
    step_ms = _time_ms(step, iters=2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{card}] audio-visual audio step, simple tower (768 x 12 on 1024 x 128 -> "
          f"{_av_tokens(simple.model)} tokens) bf16 B={b}: {step_ms:.1f} ms = "
          f"{b * 1e3 / step_ms:.2f} clips/s; peak device memory {peak:.2f} GB; launches per "
          f"step {per_step}; first step's metrics {first}", flush=True)
    del trainer, batch
    return {"step_ms": step_ms, "clips_per_s": b * 1e3 / step_ms, "peak_gb": peak,
            "launches_per_step": per_step, "first_step": first}


def main() -> int:
    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.ops import _build
    from internvideo_tpu_torch.ops import flash_attention as fa
    from internvideo_tpu_torch.ops import int8_gemm as ig
    from internvideo_tpu_torch.ops import paged_decode as pd
    from internvideo_tpu_torch.ops import rmsnorm as rms

    card = _card()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"card: {card}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    build_log = lib_path.with_suffix(".log").read_text()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    k5_ptxas = {what: _ptxas_k5(build_log, kernel, count) for what, kernel, count in (
        ("forward", "causal_fwd_bf16_kernel", 12), ("dq", "causal_bwd_dq_bf16_kernel", 10),
        ("dk/dv", "causal_bwd_dkv_bf16_kernel", 10))}
    k4a_ptxas = _ptxas_k4a(build_log)
    k1k2_ptxas = _ptxas_k1k2(build_log)
    k4b_k7_ptxas = _ptxas_k4b_k7(build_log)
    k3_k6_ptxas = _ptxas_k3_k6(build_log)
    k11_ptxas = _ptxas_k11(build_log)
    for what, rep in (*k5_ptxas.items(), ("K4a dq and dk/dv", k4a_ptxas),
                      ("K1 and K2", k1k2_ptxas), ("K4b and K7", k4b_k7_ptxas),
                      ("K3 (wgmma + TMA) and K6 (mma.sync + bulk copies)", k3_k6_ptxas),
                      ("K11 (wgmma + TMA) and its pre-pass", k11_ptxas)):
        design = "" if what.startswith(("K3", "K11")) else " (wgmma + TMA)"
        print(f"ptxas, {'K5 ' * (what in k5_ptxas)}{what}{design}: " + "; ".join(
            f"{k} {v['registers']} registers, {v['spill_stores']} / {v['spill_loads']} bytes "
            f"spilled (stores / loads)" for k, v in rep.items()), flush=True)

    # 3. kernel vs plain
    check_kernel(fa)

    # 4. the main path, counting launches
    launches = run_main_path(fa)

    # 5. kernel route vs plain route end to end
    cfg = load_config(CONFIG_1B).model
    model = InternVideo2(cfg, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0)).eval()
    _raise_gammas(model)
    check_routes(fa, model)

    # 6. times
    kern_ms, plain_ms, max_abs = time_all(fa, model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 7. backward kernels vs plain
    bwd_err = check_backward(fa)

    # 8. the training main path, counting launches
    train_launches = run_train_path(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 9. kernel route vs plain route in training
    run = load_config(CONFIG_TRAIN)
    check_train_routes(run)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. times
    t = time_train(fa, run, card)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # 11. the pretrain kernels vs their plain versions
    pre_err = check_pretrain_kernels(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 12. the pretrain main path, counting launches
    pre_launches, k3_by_len = run_pretrain_path(fa, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 13. kernel route vs plain route in pretraining
    prun = load_config(CONFIG_PRETRAIN)
    check_pretrain_routes(prun)
    gc.collect()
    torch.cuda.empty_cache()

    # 14. times
    pk = time_pretrain_kernels(fa, card)
    gc.collect()
    torch.cuda.empty_cache()
    time_pretrain_step(fa, prun, card)

    # 15. the causal flash kernel (K5) vs its plain version
    k5_err = check_causal_kernel(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 16. the paged decode kernel (K6) vs its plain version
    k6_err = check_paged_kernel(pd)
    gc.collect()
    torch.cuda.empty_cache()

    # 17. the serving main path, counting launches
    llm, serve_launches = run_serve_path(fa, pd, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 18. kernel route vs plain route in serving
    check_serve_routes(llm)
    gc.collect()
    torch.cuda.empty_cache()

    # 19. times
    serve_times = {PRESET_8B: time_llm(llm, PRESET_8B, card)}
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    llm = _llm(PRESET_2B)
    serve_times[PRESET_2B] = time_llm(llm, PRESET_2B, card)
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    sk = time_serve_kernels(fa, pd, card)
    print(f"[{card}] serving: " + json.dumps(serve_times), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 20. the SFT kernels (K5 backward, K8, K2 / K4b at 72) vs their plain versions
    sft_err = check_sft_kernels(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 21. the SFT main path, counting launches
    sft_launches = run_sft_path(fa, pd, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 22. kernel route vs plain route in SFT
    check_sft_routes(fa, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 22b. one bf16 AdamW step: the card's fused update vs the CPU route
    check_adamw_bf16(card)
    gc.collect()
    torch.cuda.empty_cache()

    # 23. times
    st = time_sft_kernels(fa, card)
    gc.collect()
    torch.cuda.empty_cache()
    sft_step = time_sft_step(fa, card)
    print(f"[{card}] sft: " + json.dumps(sft_step), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 24. K5 with GQA and the window vs its plain version
    gqa_err = check_gqa_kernel(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 24b. K2 and K5 at the HiCo video path's shapes vs their plain versions,
    # and timed there
    hico_err = check_hico_kernels(fa)
    hico_t = time_hico_kernels(fa, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 25. the dense-GQA main path (generate CLI, the Qwen3-VL-dense compose)
    gqa_launches = run_gqa_path(fa, pd, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 26. the HiCo video serving main path, counting launches
    hico, mllm_launches = run_mllm_path(fa, pd, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 27. kernel route vs plain route on both paths
    check_mllm_routes(hico, fa, pd, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 28. times
    serve_mm = time_mllm(hico, card)
    del hico
    gc.collect()
    torch.cuda.empty_cache()
    serve_mm.update(time_gqa_llm(card))
    gc.collect()
    torch.cuda.empty_cache()
    gk = time_gqa_kernel(fa, card)
    print(f"[{card}] multimodal and dense-GQA serving: " + json.dumps(serve_mm), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 29. K5's GQA / window backward vs its plain version
    rl_err = check_rl_kernels(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 30. the RL main path (compiled rollout on qwen3_8b_dense), then the
    # engine backend on qwen3_8b_mla, counting launches
    rl_launches, rl_batch, rl_peak = run_rl_path(fa, pd, card)
    gc.collect()
    torch.cuda.empty_cache()
    rl_engine_launches = run_rl_engine_path(fa, pd, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 31. kernel route vs plain route on one policy update
    check_rl_routes(rl_batch, card)
    del rl_batch
    gc.collect()
    torch.cuda.empty_cache()

    # 32. times
    rk = time_rl_kernels(fa, card)
    gc.collect()
    torch.cuda.empty_cache()
    rl_iter = time_rl_iteration(card)
    print(f"[{card}] rl: " + json.dumps({**rl_iter, "peak_gb": rl_peak}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 33. K7 (the fused dynamic-int8 GEMM) vs its plain version
    i8_err = check_int8_kernel(ig)

    # 34. the int8 serving main path: int8_mix on qwen3_8b_mla, counting launches
    i8_model, i8_launches, i8_ref, i8_ids = run_int8_serve_path(fa, pd, ig, card)

    # 35. routes, int8_mix vs int8_wo, drift from dense; fp32 depth 2 tokens
    check_int8_routes(i8_model, ig, i8_ref, i8_ids, card)
    del i8_ref
    gc.collect()
    torch.cuda.empty_cache()

    # 36. times, while the int8 8B model is on the card
    i8t = time_int8(i8_model, ig, card, serve_times[PRESET_8B])
    del i8_model
    gc.collect()
    torch.cuda.empty_cache()

    # 37. the 1B encoder and the tower with quant="int8"
    i8_enc = run_int8_encoder_tower(fa, pd, ig, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 38. K9 and K10 vs their plain versions
    norm_err = check_norm_kernels(rms)
    gc.collect()
    torch.cuda.empty_cache()

    # 39. K11 vs its plain version; 39b. the three kernels' entry points
    large_err = check_large_kernel(fa)
    gc.collect()
    torch.cuda.empty_cache()
    entry_launches = run_norm_entry_points(fa, pd, ig, rms)
    gc.collect()
    torch.cuda.empty_cache()

    # 40. the VideoCLIP stage-2 retrieval main path, counting launches
    ret_launches, _, ret_wall = run_retrieval_path(fa, pd, ig, rms, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 41. kernel route vs plain route on the stage-2 model
    vclip = check_retrieval_routes(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 42. times
    ret = time_retrieval(vclip, fa, rms, card)
    del vclip
    gc.collect()
    torch.cuda.empty_cache()

    # 43. K1 / K4a at the stage-2 step's shapes, K2 / K3 / K4b at the UTA
    # variant's, vs their plain versions; their times
    clip_err = check_clip_kernels(fa)
    gc.collect()
    torch.cuda.empty_cache()
    clip_k = time_clip_kernels(fa, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 44. the stage-2 training main path (the 1B recipe), counting launches
    clip_launches = run_clip_path(fa, pd, ig, rms, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 45. kernel route vs plain route on the first step's losses
    crun = load_config(CONFIG_CLIP)
    check_clip_routes(crun)
    gc.collect()
    torch.cuda.empty_cache()

    # 46. times: the step, its peak memory and device busy share
    clip_step = time_clip_step(fa, pd, ig, rms, crun, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 47. the UTA variant (CLIP-6B teacher, masked student), counting launches
    clip_uta_launches = run_clip_uta_path(fa, pd, ig, rms, crun, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 48. K1 / K2 / K5 at the chat path's shapes vs their plain versions
    chat_err = check_chat_kernels(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 49. the chat main path: task videoqa on the full-width VideoChat, counting launches
    chat_launches = run_chat_path(fa, pd, ig, rms, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 50. kernel route vs plain route on the chat model
    chat = _chat_model()
    check_chat_routes(chat, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 51. times: TTFT split, decode, idle share, peak memory; the kernels at its shapes
    chat_t = time_chat(chat, fa, card)
    del chat
    gc.collect()
    torch.cuda.empty_cache()
    chat_k = time_chat_kernels(fa, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 52. task zeroshot on the stage-2 model, counting launches
    zs_launches = run_zeroshot_path(fa, pd, ig, rms, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 53. K3 and K2 / K4b at the distill student's head dim 64 vs their plain versions
    distill_err = check_distill_kernels(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 54. their times at the student's shape
    distill_k = time_distill_kernels(fa, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 55. the distill main path (L/14 from a frozen 1B), counting launches
    distill_launches = run_distill_path(fa, pd, ig, rms, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 56. kernel route vs plain route of the distill loss
    drun = load_config(CONFIG_DISTILL)
    check_distill_routes(drun)
    gc.collect()
    torch.cuda.empty_cache()

    # 57. times: the step, the teacher's share, peak memory, device time by group
    distill_step = time_distill_step(fa, pd, ig, rms, drun, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 58. the real SFT data path: jsonl + clips -> packs -> SFT steps, counting launches
    sft_jsonl = run_sft_jsonl_path(fa, pd, ig, rms, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 59. prefetch_to_device on the card
    prefetch = check_prefetch(card)
    gc.collect()
    torch.cuda.empty_cache()

    # 60. the fusion cross-attention at the audio-visual shapes and the simple
    # tower's attention vs their plain versions; their times
    av_err = check_av_kernels(fa)
    gc.collect()
    torch.cuda.empty_cache()
    av_k = time_av_kernels(fa, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 61. the audio-visual main path (audio_video on the full-width config), counting launches
    av_launches = run_clip_av_path(fa, pd, ig, rms, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 62. the step of each media type: launches, ms, peak memory, device time by group
    arun = load_config(CONFIG_AV)
    av_steps, av_trainer = time_clip_av_steps(fa, pd, ig, rms, arun, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 63. the real-audio path: wavs + clips -> corpora -> load_fbank -> prefetch -> steps
    av_real = run_av_real_audio_path(av_trainer, arun, card)
    del av_trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 64. kernel route vs plain route of the audio-visual loss per media type
    check_clip_av_routes(arun)
    gc.collect()
    torch.cuda.empty_cache()

    # 65. the simple audio tower at its default width, one audio step
    av_simple = run_simple_tower_step(fa, pd, ig, rms, arun, card)
    gc.collect()
    torch.cuda.empty_cache()

    fwd_bound = _fwd_bound(*MAIN_SHAPE)
    b, s, h, d = TRAIN_SHAPE
    io_bytes = 4 * b * s * h * d * 2 + 2 * b * h * s * 4  # q, k, v, dO; lse, delta
    bounds = {"flash_bwd_dq": _bound(6 * b * h * s * s * d, io_bytes + b * s * h * d * 2),
              "flash_bwd_dkv": _bound(8 * b * h * s * s * d, io_bytes + 2 * b * s * h * d * 2)}
    src = "internvideo_tpu_torch/csrc/"
    jax_fa = "internvideo_tpu/ops/flash_attention.py:"

    def by_path(name, eval_n=0):
        paths = {"train": train_launches, "pretrain": pre_launches, "serve": serve_launches,
                 "sft": sft_launches, "serve_mllm": mllm_launches, "serve_gqa": gqa_launches,
                 "rl": rl_launches, "rl_engine": rl_engine_launches, "serve_int8": i8_launches,
                 "encoder_int8": i8_enc["encoder_int8"], "tower_int8": i8_enc["tower_int8"],
                 "retrieval": ret_launches, "entry_points": entry_launches,
                 "clip": clip_launches, "clip_uta": clip_uta_launches, "chat": chat_launches,
                 "zeroshot": zs_launches, "distill": distill_launches,
                 "sft_jsonl": sft_jsonl["launches"], "clip_av": av_launches}
        return {"eval": eval_n, **{p: counts.get(name, 0) for p, counts in paths.items()}}

    def clip_times(name, tags):
        """The stage-2 shapes' errors and times of kernel `name` (phase 43)."""
        return {tag: {"shape_b_sq_sk_h_d": clip_k[tag][name]["shape"],
                      "max_abs_err": clip_err[tag][name], "ms": clip_k[tag][name]["ms"],
                      "plain_ms": clip_k[tag][name]["plain_ms"],
                      "bound_ms": clip_k[tag][name]["bound"][0],
                      "bound_by": clip_k[tag][name]["bound"][1],
                      "library_ms": clip_k[tag][name]["library_ms"]}
                for tag in tags if name in clip_k[tag]}

    def entry(name, source, line, r, err, shape):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": jax_fa + str(line), "launches": pre_launches[name],
                "launches_by_path": by_path(name), "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"], "shape": list(shape)}

    kernels = [{
        "name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd_causal.cu",
        "c_entry": src + "flash_fwd.cu", "replaces": jax_fa + "153",
        "launches": (launches + train_launches["flash_fwd"] + pre_launches["flash_fwd"]
                     + ret_launches["flash_fwd"] + clip_launches["flash_fwd"]
                     + chat_launches["flash_fwd"] + zs_launches["flash_fwd"]
                     + av_launches["flash_fwd"]),
        "launches_by_path": by_path("flash_fwd", launches),
        "max_abs_err": max_abs, "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        "library_ms": t["sdpa"]["eval"]["fwd"], "shape": list(MAIN_SHAPE),
        "retrieval_shapes": {"tower": list(RETRIEVAL_TOWER_SHAPE),
                             "fusion_cross_attention": "(32, 32, 16, 64) x (32, 1025, 16, 64)"},
        "finetune": {"shape": list(TRAIN_SHAPE), "ms": t["flash_fwd"],
                     "library_ms": t["sdpa"]["train"]["fwd"],
                     "bound_ms": _fwd_bound(*TRAIN_SHAPE)[0]},
        "mae_teacher": {"shape": list(MAE_TEACHER_SHAPE),
                        **{k: pk["flash_fwd_mae_teacher"][k]
                           for k in ("ms", "plain_ms", "library_ms")},
                        "bound_ms": pk["flash_fwd_mae_teacher"]["bound"][0],
                        "bound_by": pk["flash_fwd_mae_teacher"]["bound"][1]},
        "design": "K5's wgmma + TMA forward body at (D, D), non-causal",
        "earlier_design": K1K2_EARLIER,
        "ptxas": {k: v for k, v in k1k2_ptxas.items() if k.startswith("flash_fwd ")},
    }] + [{
        "name": name, "route": "cuda", "source": src + body,
        "c_entry": src + "flash_bwd.cu", "replaces": jax_fa + str(line),
        "launches": train_launches[name] + clip_launches[name] + av_launches[name],
        "launches_by_path": by_path(name),
        "max_abs_err": bwd_err[name], "ms": t[name], "plain_ms": t["plain_bwd"],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": t["sdpa"]["train"]["bwd"], "shape": list(TRAIN_SHAPE),
        "design": "K5's wgmma + TMA body at (D, D), non-causal",
        "ptxas": {k: v for k, v in k4a_ptxas.items() if k.startswith(kind + " ")},
    } for name, line, body, kind in (
        ("flash_bwd_dq", 468, "flash_bwd_causal_dq.cu", "dq"),
        ("flash_bwd_dkv", 613, "flash_bwd_causal_dkv.cu", "dkv"))] + [
        {**entry("small_s_fwd", "flash_fwd_causal.cu", 1505, pk["small_s_fwd"],
                 pre_err["small_s_fwd"], PRETRAIN_SHAPE),
         "c_entry": src + "small_s_fwd.cu", "design": "K5's wgmma + TMA forward body at (D, D), non-causal",
         "earlier_design": K1K2_EARLIER,
         "ptxas": {k: v for k, v in k1k2_ptxas.items() if k.startswith("small_s_fwd ")}},
        *({**entry(name, body, line, pk[name], pre_err[name], PRETRAIN_SHAPE),
           "c_entry": src + "small_s_bwd.cu",
           "design": "K4a's wgmma + TMA body at (D, D), non-causal", "earlier_design": K4B_EARLIER,
           "ptxas": {k: v for k, v in k4b_k7_ptxas.items() if k.startswith(name + " ")}}
          for name, line, body in (("small_s_bwd_dq", 1524, "flash_bwd_causal_dq.cu"),
                                   ("small_s_bwd_dkv", 1553, "flash_bwd_causal_dkv.cu"))),
        {**entry("fused_qkv_fwd", "flash_fwd_causal.cu", 1703, pk["fused_qkv_student"],
                 pre_err["fused_qkv_fwd"], PRETRAIN_SHAPE),
         "c_entry": src + "fused_qkv.cu",
         "design": "K2's warp-specialised wgmma + TMA forward walk, built from its steps; the "
                   "two consumer warpgroups apply the QK-RMSNorm in shared memory between TMA "
                   "and wgmma, each to its 64 Q rows and to half of each K tile (the next "
                   "tile's under this tile's products); producer warp 1 stages the head's k "
                   "weights and the sequence's k 1/rms; a tile whose second warpgroup has no "
                   "row (S 257's 1-row last tile) runs one warpgroup",
         "earlier_design": K3_EARLIER,
         "ptxas": {k: v for k, v in k3_k6_ptxas.items() if k.startswith("fused_qkv_fwd ")},
         # of "launches", counted by sequence length in the same run
         "launches_student": k3_by_len.get(PRETRAIN_SHAPE[1], 0),
         "launches_clip_teacher": k3_by_len.get(TEACHER_SHAPE[1], 0),
         "attn_kernel_ms": pk["fused_qkv_student"]["attn_ms"],
         "teacher": {"shape": list(TEACHER_SHAPE), "ms": pk["fused_qkv_teacher"]["ms"],
                     "attn_kernel_ms": pk["fused_qkv_teacher"]["attn_ms"],
                     "plain_ms": pk["fused_qkv_teacher"]["plain_ms"],
                     "bound_ms": pk["fused_qkv_teacher"]["bound"][0],
                     "bound_by": pk["fused_qkv_teacher"]["bound"][1],
                     "library_ms": pk["fused_qkv_teacher"]["library_ms"],
                     "max_abs_err": pre_err["fused_qkv_fwd_teacher"]}},
        {**entry("fused_qkv_rstd", "fused_qkv.cu", 1703, pk["fused_qkv_rstd_student"],
                 pk["fused_qkv_rstd_student"]["err"], PRETRAIN_SHAPE),
         "teacher": {"shape": list(TEACHER_SHAPE), "ms": pk["fused_qkv_rstd_teacher"]["ms"],
                     "plain_ms": pk["fused_qkv_rstd_teacher"]["plain_ms"],
                     "max_abs_err": pk["fused_qkv_rstd_teacher"]["err"],
                     "bound_ms": pk["fused_qkv_rstd_teacher"]["bound"][0],
                     "bound_by": pk["fused_qkv_rstd_teacher"]["bound"][1]}},
    ]
    k5, k5_2b = sk["flash_fwd_causal_8b"], sk["flash_fwd_causal_2b"]
    k6, k6_2b = sk["paged_decode_8b"], sk["paged_decode_2b"]
    kernels += [{
        "name": "flash_fwd_causal", "route": "cuda", "source": src + "flash_fwd_causal.cu",
        "replaces": jax_fa + "153", "launches": serve_launches["flash_fwd_causal"],
        "launches_by_path": by_path("flash_fwd_causal"), "max_abs_err": k5_err,
        "ms": k5["ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound"][0],
        "bound_by": k5["bound"][1], "library_ms": k5["library_ms"],
        "library_note": k5["library_note"], "shape": k5["shape"], "design": "wgmma + TMA, warp-specialised", "earlier_design": K5_EARLIER,
        "ptxas": k5_ptxas["forward"],
        "preset_2b": {"shape": k5_2b["shape"], "ms": k5_2b["ms"],
                      "plain_ms": k5_2b["plain_ms"], "bound_ms": k5_2b["bound"][0],
                      "bound_by": k5_2b["bound"][1], "library_ms": k5_2b["library_ms"],
                      "library_note": k5_2b["library_note"]},
    }, {
        "name": "paged_decode", "route": "cuda", "source": src + "paged_decode.cu",
        "replaces": "internvideo_tpu/ops/paged_decode.py:47",
        "launches": serve_launches["paged_decode"],
        "launches_by_path": by_path("paged_decode"),
        "max_abs_err": k6_err, "ms": k6["ms"], "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound"][0], "bound_by": k6["bound"][1], "library_ms": None,
        "shape": k6["shape"], "ms_by": "CUDA graph replay (the device alone)",
        "event_ms": k6["event_ms"], "pool_gb_per_s": k6["pool_gb_per_s"],
        "design": "bf16: all heads of a sequence in one CTA over one split, one wave; tokens by "
                  "cp.async.bulk rows into a 4-stage mbarrier ring; scores and P . C on "
                  "mma.sync m16n8k16; the merge kernel as before",
        "earlier_design": K6_EARLIER,
        "ptxas": {k: v for k, v in k3_k6_ptxas.items() if k.startswith("paged_decode ")},
        "video_decode_2b": {"shape": k6_2b["shape"], "ms": k6_2b["ms"],
                            "event_ms": k6_2b["event_ms"], "plain_ms": k6_2b["plain_ms"],
                            "bound_ms": k6_2b["bound"][0], "bound_by": k6_2b["bound"][1],
                            "pool_gb_per_s": k6_2b["pool_gb_per_s"]},
    }]
    def sft_entry(name, source, line, r, err):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": jax_fa + str(line), "launches": sft_launches[name],
                "launches_by_path": by_path(name), "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"], "library_note": r["library_note"],
                "shape": r["shape"], "segments": r["segments"]}

    kernels += [
        sft_entry("flash_bwd_causal_dq", "flash_bwd_causal_dq.cu", 468,
                  st["flash_bwd_causal_dq"], sft_err["flash_bwd_causal_dq"]),
        sft_entry("flash_bwd_causal_dkv", "flash_bwd_causal_dkv.cu", 613,
                  st["flash_bwd_causal_dkv"], sft_err["flash_bwd_causal_dkv"]),
        sft_entry("flash_fwd_causal_seg", "flash_fwd_causal.cu", 153,
                  st["flash_fwd_causal_seg"], sft_err["flash_fwd_causal_seg"]),
        sft_entry("flash_bwd_causal_dq_seg", "flash_bwd_causal_dq.cu", 468,
                  st["flash_bwd_causal_dq_seg"], sft_err["flash_bwd_causal_dq_seg"]),
        sft_entry("flash_bwd_causal_dkv_seg", "flash_bwd_causal_dkv.cu", 613,
                  st["flash_bwd_causal_dkv_seg"], sft_err["flash_bwd_causal_dkv_seg"]),
    ]
    for entry in kernels:  # K2 / K4b at the tower's head dim 72
        r = st.get(f"{entry['name']}_72")
        if r is not None:
            entry["head_dim_72"] = {
                "shape": r["shape"], "launches_sft": sft_launches[entry["name"]],
                "max_abs_err": sft_err[entry["name"]], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"]}
    for entry in kernels:  # K2 / K5 at the HiCo video path's shapes (phase 24b)
        if entry["name"] in hico_err:
            shape, max_abs, rel = hico_err[entry["name"]]
            entry["hico_2b"] = {"shape": shape, "launches_serve_mllm": mllm_launches[entry["name"]],
                                "max_abs_err": max_abs, "rel_l2": rel}
            t_h = hico_t[entry["name"]]
            entry["hico_2b"].update(
                ms=t_h["ms"], plain_ms=t_h["plain_ms"], bound_ms=t_h["bound"][0],
                bound_by=t_h["bound"][1], library_ms=t_h["library_ms"],
                library_note=t_h["library_note"])
        if entry["name"] == "flash_fwd_causal_seg":
            entry.update(design="wgmma + TMA, warp-specialised", earlier_design=K5_EARLIER)
    gq, gw = gk["flash_fwd_causal_gqa"], gk["flash_fwd_causal_window"]
    kernels.append({
        "name": "flash_fwd_causal_gqa", "route": "cuda", "source": src + "flash_fwd_causal.cu",
        "replaces": jax_fa + "153", "launches": gqa_launches["flash_fwd_causal_gqa"],
        "launches_by_path": by_path("flash_fwd_causal_gqa"),
        "max_abs_err": gqa_err["flash_fwd_causal_gqa"], "ms": gq["ms"],
        "plain_ms": gq["plain_ms"], "bound_ms": gq["bound"][0], "bound_by": gq["bound"][1],
        "library_ms": gq["library_ms"], "library_note": gq["library_note"], "shape": gq["shape"],
        "design": "wgmma + TMA, warp-specialised", "earlier_design": K5_EARLIER,
        "window": {"window": GQA_WINDOW, "counter": "flash_fwd_causal_window",
                   "launches_by_path": by_path("flash_fwd_causal_window"),
                   "note": "no ported preset sets a window; phase 24 holds it, phase 28 times it",
                   "max_abs_err": gqa_err["flash_fwd_causal_window"], "ms": gw["ms"],
                   "plain_ms": gw["plain_ms"], "bound_ms": gw["bound"][0],
                   "bound_by": gw["bound"][1], "library_ms": gw["library_ms"],
                   "library_note": gw["library_note"]},
    })
    for kind, line in (("dq", 468), ("dkv", 613)):
        name, win = f"flash_bwd_causal_{kind}_gqa", f"flash_bwd_causal_{kind}_window"
        r, w = rk[name], rk[win]
        kernels.append({
            "name": name, "route": "cuda", "source": src + f"flash_bwd_causal_{kind}.cu",
            "replaces": jax_fa + str(line), "launches": rl_launches[name],
            "launches_by_path": by_path(name), "max_abs_err": rl_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "library_note": r["library_note"],
            "shape": r["shape"],
            "window": {"window": GQA_WINDOW, "counter": win, "launches_by_path": by_path(win),
                       "note": "no ported preset sets a window; phase 29 holds it, phase 32 "
                               "times it",
                       "max_abs_err": rl_err[win], "ms": w["ms"], "plain_ms": w["plain_ms"],
                       "bound_ms": w["bound"][0], "bound_by": w["bound"][1],
                       "library_ms": w["library_ms"], "library_note": w["library_note"]},
        })
    src_i8 = src + "int8_gemm.cu"
    k7_main = next(r for r in i8t["k7"] if tuple(r["shape"]) == INT8_MAIN_SHAPE)
    kernels.append({
        "name": "int8_gemm", "route": "cuda", "source": src_i8,
        "replaces": "internvideo_tpu/ops/int8_gemm.py:68", "launches": i8_launches["int8_gemm"],
        "launches_by_path": by_path("int8_gemm"), "max_abs_err": i8_err["f32"],
        "ms": k7_main["ms"], "plain_ms": k7_main["plain_ms"], "bound_ms": k7_main["bound_ms"],
        "bound_by": k7_main["bound_by"], "library_ms": k7_main["library_ms"],
        "library_note": "torch quantize + torch._int_mm (cuBLASLt int8) + rescale; "
                        "bf16_linear_ms: F.linear on the dequantized bf16 weight",
        "bf16_linear_ms": k7_main["bf16_linear_ms"], "shape": list(INT8_MAIN_SHAPE),
        "max_abs_err_bf16_out": max(v for k, v in i8_err.items() if k != "f32"),
        "shapes": i8t["k7"],
        "design": "persistent warp-specialised wgmma m64n256k32 s8 + TMA, 128 x 256 tiles",
        "earlier_design": K7_EARLIER,
        "ptxas": {k: v for k, v in k4b_k7_ptxas.items() if k.startswith("int8_gemm ")},
    })
    print(f"[{card}] int8 serving: " + json.dumps({
        **{k: v for k, v in i8t.items() if k != "k7"},
        **{k: v for k, v in i8_enc.items() if not k.endswith("_int8")},
        "llm_prefill_bf16_tokens_per_sec": serve_times[PRESET_8B]["prefill_tokens_per_sec"],
        "llm_decode_bf16_tokens_per_sec": serve_times[PRESET_8B]["decode_tokens_per_sec"]}),
        flush=True)
    k = ret.pop("kernels")
    k1 = next(e for e in kernels if e["name"] == "flash_fwd")
    k1["retrieval_times"] = {
        tag: {"shape_b_sq_sk_h_d": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
              "library_ms": r["library_ms"]}
        for tag, r in (("tower", k["flash_fwd_tower"]),
                       ("rerank_cross_attention", k["flash_fwd_rerank_cross_attention"]))}
    for name, line, src_file, counter, r, err in (
            ("fused_add_rms_norm", "internvideo_tpu/ops/rmsnorm.py:52", "rmsnorm.cu",
             "fused_add_rms_norm", k["fused_add_rms_norm"], norm_err["fused_add_rms_norm"]),
            ("fused_ls_add_rms_norm", "internvideo_tpu/ops/rmsnorm.py:127", "rmsnorm.cu",
             "fused_ls_add_rms_norm", k["fused_ls_add_rms_norm"],
             norm_err["fused_ls_add_rms_norm"]),
            ("fused_qkv_large_fwd", jax_fa + "1897", "fused_qkv_large.cu",
             "fused_qkv_large_fwd", k[f"fused_qkv_large_fwd_{MAIN_SHAPE[1]}"],
             large_err["fused_qkv_large_fwd"])):
        entry_k = {
            "name": name, "route": "cuda", "source": src + src_file, "replaces": line,
            "launches": entry_launches[counter], "launches_by_path": by_path(counter),
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "note": "no model calls it (JAX or port): its path is the public entry point"}
        if r["library_ms"] is None:
            entry_k.update(library_note="no single PyTorch call computes it; plain_ms is the "
                                        "composition", dtypes=r["dtypes"],
                           max_abs_err_bf16=norm_err[f"{name}_bf16"])
        else:
            s2 = k[f"fused_qkv_large_fwd_{RETRIEVAL_TOWER_SHAPE[1]}"]
            entry_k.update(
                library_note="flash SDPA on q / k normed beforehand",
                production_route_ms=r["production_route_ms"], prepass_ms=r["prepass_ms"],
                design="a pre-pass writes q's 1/rms and the normed k rows once; then K3's "
                       "wgmma + TMA walk with only Q normed in shared memory",
                earlier_design=K11_EARLIER, ptxas=k11_ptxas,
                max_abs_err_bf16_by_s={n.rsplit("fwd_", 1)[1]: e for n, e in large_err.items()
                                       if n.startswith("fused_qkv_large_fwd_")},
                max_abs_err_bf16=large_err[f"fused_qkv_large_fwd_{MAIN_SHAPE[1]}"],
                stage2_tower={"shape": s2["shape"], "ms": s2["ms"], "plain_ms": s2["plain_ms"],
                              "bound_ms": s2["bound"][0], "bound_by": s2["bound"][1],
                              "library_ms": s2["library_ms"],
                              "production_route_ms": s2["production_route_ms"],
                              "prepass_ms": s2["prepass_ms"],
                              "max_abs_err": large_err[
                                  f"fused_qkv_large_fwd_{RETRIEVAL_TOWER_SHAPE[1]}"]})
        kernels.append(entry_k)
    print(f"[{card}] retrieval: " + json.dumps({**ret, "cli_wall_s": ret_wall}), flush=True)
    for entry in kernels:  # the stage-2 training shapes (phase 43)
        tags = {"flash_fwd": ("tower", "cross_mlm", "cross_vtm"),
                "flash_bwd_dq": ("tower", "cross_mlm", "cross_vtm"),
                "flash_bwd_dkv": ("tower", "cross_mlm", "cross_vtm"),
                "small_s_fwd": ("uta_cross", "uta_student"),
                "small_s_bwd_dq": ("uta_cross", "uta_student"),
                "small_s_bwd_dkv": ("uta_cross", "uta_student"),
                "fused_qkv_fwd": ("uta_student",)}.get(entry["name"])
        if tags:
            entry["clip_stage2"] = clip_times(entry["name"], tags)
    print(f"[{card}] stage-2 clip: " + json.dumps(clip_step), flush=True)
    for entry in kernels:  # the chat path's shapes (phases 48, 51)
        tags = [key for key, r in chat_k.items() if r["kernel"] == entry["name"]]
        if tags:
            per = chat_launches[entry["name"]] // CHAT_CLI_PREFILLS
            entry["chat"] = {
                "launches_per_prefill": per, "launches_chat_cli": chat_launches[entry["name"]],
                "shapes": {f"{tag} B{b}": {
                    "shape_b_sq_sk_h_dqk_dv": chat_k[(tag, b)]["shape"],
                    "max_abs_err": chat_err[(tag, b)], "ms": chat_k[(tag, b)]["ms"],
                    "ms_by": "CUDA graph replay (the device alone)",
                    "plain_ms": chat_k[(tag, b)]["plain_ms"],
                    "bound_ms": chat_k[(tag, b)]["bound"][0],
                    "bound_by": chat_k[(tag, b)]["bound"][1],
                    "library_ms": chat_k[(tag, b)]["library_ms"],
                    "library_note": chat_k[(tag, b)]["library_note"]} for tag, b in tags}}
    print(f"[{card}] chat: " + json.dumps({f"B{b}": r for b, r in chat_t.items()}), flush=True)
    for entry in kernels:  # the distill path's shapes (phases 53-57)
        name = entry["name"]
        if name == "flash_fwd":  # the teacher at the finetune's shape: phase 10's times
            entry["distill_teacher"] = {
                "shape": list(DISTILL_TEACHER_SHAPE), "ms": t["flash_fwd"],
                "library_ms": t["sdpa"]["train"]["fwd"],
                "bound_ms": _fwd_bound(*DISTILL_TEACHER_SHAPE)[0],
                "launches_per_step": distill_step["launches_per_step"]["flash_fwd"],
                "launches_distill_cli": distill_launches["flash_fwd"]}
        elif name in distill_k:
            r = distill_k[name]
            entry["distill_student"] = {
                "shape": r["shape"], "max_abs_err": distill_err[name], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"],
                "launches_per_step": distill_step["launches_per_step"][name],
                "launches_distill_cli": distill_launches[name],
                **({"prepass_ms": r["prepass_ms"]} if "prepass_ms" in r else {})}
        elif name == "fused_qkv_rstd":
            entry["distill_student"] = {
                "launches_per_step": distill_step["launches_per_step"][name],
                "ms": distill_k["fused_qkv_fwd"]["prepass_ms"],
                "launches_distill_cli": distill_launches[name]}
        if name in sft_jsonl["k8"]:
            entry["sft_jsonl"] = sft_jsonl["k8"][name]
        elif name in sft_jsonl["launches"]:
            entry["sft_jsonl"] = {"launches_per_step": sft_jsonl["launches"][name]
                                  // SFT_JSONL_STEPS}
    print(f"[{card}] distill: " + json.dumps(distill_step), flush=True)
    print(f"[{card}] sft jsonl: " + json.dumps({k: v for k, v in sft_jsonl.items() if k != "k8"}),
          flush=True)
    print(f"[{card}] prefetch_to_device: " + json.dumps(prefetch), flush=True)
    for entry in kernels:  # the audio-visual path's shapes (phases 60-65)
        name = entry["name"]
        shapes = {tag: {"shape_b_sq_sk_h_d": r[name]["shape"], "max_abs_err": av_err[tag][name],
                        "ms": r[name]["ms"], "plain_ms": r[name]["plain_ms"],
                        "bound_ms": r[name]["bound"][0], "bound_by": r[name]["bound"][1],
                        "library_ms": r[name]["library_ms"]}
                  for tag, r in av_k.items() if name in r}
        if shapes:
            entry["clip_av"] = {
                "shapes": shapes, "launches_clip_av_cli": av_launches.get(name, 0),
                "launches_per_step": {media: r["launches_per_step"].get(name, 0)
                                      for media, r in av_steps.items()},
                "launches_per_simple_tower_audio_step":
                    av_simple["launches_per_step"].get(name, 0)}
    print(f"[{card}] audio-visual steps: " + json.dumps(av_steps), flush=True)
    print(f"[{card}] audio-visual real audio: " + json.dumps(av_real), flush=True)
    print(f"[{card}] audio-visual simple tower: " + json.dumps(av_simple), flush=True)
    print(f"chip_smoke: phases 1-65 in {time.perf_counter() - t_start:.1f} s wall", flush=True)
    print(card)
    for entry in kernels:  # K5's backward, redesigned: its design and ptxas report
        if entry["name"].startswith("flash_bwd_causal_"):
            entry.update(design="wgmma + TMA, warp-specialised", earlier_design=K5_BWD_EARLIER,
                         ptxas=k5_ptxas["dq" if "_dq" in entry["name"] else "dk/dv"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
