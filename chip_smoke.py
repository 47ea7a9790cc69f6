#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`videocof_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which fails the run (non-zero exit) on any fault:
  1. device: the card's name and power limit; the modules, ffmpeg, libav
     headers and free disk the entry's I/O could use; TF32 off; build the CUDA
     kernels from `videocof_torch/csrc/` with nvcc (sm_90a), one process per
     source, all at once; ptxas registers, spills and warnings of every
     kernel; the count of wgmma (HGMMA) and TMA load (UTMALDG) instructions
     in each instantiation of the forward `flash_fwd_kernel` and of the
     backward `flash_bwd_kernel`, and of int8 wgmma (IGMMA), HGMMA and
     UTMALDG in each of B4's `int8_attn_kernel` (cuobjdump -sass), which
     fails the run if any is 0.
  2. kernels vs plain, on the card, at the main paths' shapes and at the
     edge cases (ragged length, key mask with a fully masked batch row,
     D = 64 (flash) or 256 (int8), fp16, and for B1, B2 and B4 the lengths
     on and beside their 128-row q tiles and K/V tiles, Lq in {1, 127, 129}
     by Lk in {1, 127, 129, 512}): the forward B1 and the forward with
     LSE B2 on the output
     (max abs error <= 3e-2 and relative L2 error <= 1e-2: at the main
     path's lengths the outputs are small, so the absolute bound alone would
     pass a wrong kernel) and on the LSE (relative error <= 1e-4: both sides
     sum the same fp32 probabilities); the backward kernel B3 (dq, dk, dv)
     against the plain backward in its own arithmetic (P and dS rounded to
     the input type for the tensor cores, ``rounded=True``: relative L2 <=
     1e-3) and against the fp32 plain backward, JAX's arithmetic (at most
     1.5x the rounding's own size on the same inputs, about 2.6e-3 in bf16
     and 3.2e-4 in fp16), also at 32 lengths on and beside its 64-row q
     tiles and 128-key tiles (Lq 1/63/65/129 x Lk 1/127/129/512); the int8
     kernel B4 in its two kernels, K's pre-pass (its K mean within 256 x
     2^-24 x mean |k| of `k_mean`, the order of the fp32 sums; the int8 K
     at most one level off its plain version on `k_mean`, in at most 1e-4
     of the values; two launches bit for bit; also at 15 key lengths
     around its stages and 780, and past what its resident CTAs' stages
     hold) and the
     attention on the same quantized K (B1's gates), and the whole of
     B4 against its plain version (B1's gates) and against unquantized
     attention (cosine similarity > 0.999, JAX's test). Then a 2-block
     full-width DiT on a small latent through the kernels against the naive
     attention backend: the forward, and the gradient of its LoRA adapters
     (relative L2 error <= 2e-2 each), and the forward through B4 (<= 1e-2;
     1.8e-3 measured on the CPU with B4's plain version), named as an
     argument and again, naming no backend, routed by
     `VIDEOCOF_ATTENTION_TYPE=int8` (the same launches of B4 and nothing
     else); B4 under autograd raises.
  3. kernel timing at the two main-path shapes (12 heads; batch 2 for B4,
     as batched CFG runs it): each kernel, its plain version, the least time
     the card could take (bound), and one PyTorch call that computes the
     same function (SDPA's forward, with and without a gradient to carry,
     and SDPA's whole backward for B3: yardsticks the port never calls; for
     B4 SDPA's
     unquantized bf16 forward, not the same function); CUDA events, median
     of the runs after a warm-up; the achieved TFLOP/s of each flash
     kernel and B4's achieved TOP/s (int8 and bf16 operations together),
     and B4 beside B1 at B4's batch-2 shapes (whether int8 QK^T pays);
     B4's pre-pass held by phase 2's gates on the K it times (every head:
     24 slabs at the self shape); `k_mean` alone (the torch reduction over K that preceded the pre-pass
     until it took the mean) and one B4 call under torch.profiler, after a
     warm-up fill (a trace may miss its first kernel), which must show
     `k_prepass_kernel` and `int8_attn_kernel` once each and no other
     kernel but that fill (their device times recorded; a profile without
     device events is taken again, up to three times, then fails the run). Then the DiT block's five fused elementwise
     passes (`csrc/dit_fused.cu`) at the 14B's and the 1.3B's widths over
     the edit's 29,640 tokens (`dit_fused_phase`): each against its plain
     steps (the fp32 stream bit for bit; bf16 outputs within one bf16 ulp,
     after RoPE three of the pair's norm, in at most 0.1% of the elements
     differing), its time against the bound of its bytes once and the
     plain steps' time, one block's chain summed, and that chain under
     torch.profiler, which must show the five kernels (the q/k pass twice)
     and no other but its warm-up's (a profile without device events is
     taken again, up to three times, then fails the run).
  4. the edit: `WanPipeline` at full width (Wan2.1 1.3B DiT, Wan2.1 VAE,
     umT5-XXL, random bf16 weights from a seed) edits a 33-frame 480x832
     uint8 video with 4 reasoning frames in 4 Flow-UniPC steps; checks the
     output, that B1 ran exactly 2 x layers x steps times and no other
     attention kernel ran, and that every block call took the fused
     passes, each pass launched once a call; the pipeline is built under `VIDEOCOF_TIMING=1`, and the
     edit's stderr must hold one `[pipeline] <label>: <s>s` line a stage
     (the labels of `timings=`) and nothing else; the ported helpers:
     `default_backend()` is "flash" on the card, `save_videos_grid` of the
     edit's frames with the colour pin reads back through cv2 with their
     frame count and size,
     `get_video_to_video_latent` of a cv2 clip of the geometry's size (40
     frames at 16 fps, taken at fps 8) gives [1, 3, 20, 480, 832] in [0,
     1], an all-255 mask and the ref image, and `merge_video_audio`
     raises RuntimeError without ffmpeg; then one DiT step of the edit's
     geometry under torch.profiler (device time by kernel, idle share).
  5. the standard edit: the same models (the DiT's first 5 of its 30
     layers: the script's time limit) and video through
     `WanPipeline(attn_backend="int8")` in 50 Flow-UniPC steps at shift 3,
     guidance 5 against the default negative prompt, TeaCache with Wan2.1
     T2V 1.3B's coefficients on a plan pinned at a 40% skip rate (18 of 50
     steps; random weights would skip most steps, and the plan they give
     is printed); checks the output and that B4 ran exactly 2 x layers x
     computed steps times and no other kernel ran; then one batched-CFG
     DiT step (batch 2) under torch.profiler, in which each of B4's two
     kernels runs 2 x layers times (no device events fails the run).
  6. training: `CoFTrainer` on the same models with rank-16 LoRA adapters and
     the default `TrainerConfig` (480x832, 33 source + 4 reasoning + 33
     target frames, block remat) takes 3 steps on synthetic triplets, the
     first a warm-up; checks finite losses, adapters that moved in step 1,
     base weights bitwise unchanged, and the launches the design implies
     (per step: B2 in every attention's forward and again in its remat
     recompute, B3 once per attention, no B1); then one step under
     torch.profiler.
  7. the entry at 1.3B: the phase-4 DiT written to the published layout
     (two safetensors shards, their index and a config.json) by the port's
     own writer and read back by its own reader (no safetensors package),
     every tensor equal bit for bit, the config equal to Wan2.1 T2V 1.3B's,
     the read's GB/s; then `videocof_torch.cli.fast_infer.main()` in this
     process (--random_init --repeat_rope, 480x832, 33 + 4 frames) on a
     synthetic clip written with cv2, merging two rank-32 bf16 LoRA files
     written by the port's writer (a kohya "FusionX" file as the
     acceleration LoRA, a PEFT "VideoCoF" file as --videocof_path); its
     output and files are checked, B1 must run exactly 240 times, the CLI
     must hand the factory both files and exactly the weights they name
     must differ from an unmerged draw. The phase fails where cv2, which
     the port's video I/O reads with, is not importable.
  8. the 14B edit: `factory.load_pipeline("", random_init=True,
     dit_cfg=WAN21_T2V_14B, lora_paths=[the two LoRA files at 14B
     shapes])` at full width and depth (40 blocks of 5120, 40 heads of
     128); the merged weights differ from a second draw of the unmerged
     ones in exactly the modules the LoRA files name; the 4-step 480x832
     33 + 4-frame edit (output, exactly 320 B1 launches and no other
     kernel, every one of the 160 block calls through the fused passes
     and each pass launched once a call, stage walls, peak memory); one
     DiT step under torch.profiler.
  9. the 4x length-extrapolation edit at 1.3B (random weights drawn by
     `factory.load_pipeline("", random_init=True)`, full width, its first
     5 of 30 layers in phases 9-12: the script's time limit):
     a uint8 clip of 133 frames (4x the 33-frame clip, 34 latent frames)
     with 4 reasoning frames, 4 Flow-UniPC steps, repeat RoPE and RIFLEx
     (k 6, the default L_test), the VAE streamed: 34 + 1 + 34 latent
     frames, 107,640 DiT tokens; the output [1, 3, 134, 480, 832], exactly
     2 B1 launches a layer and step (self at 107,640 keys, cross) and no
     other kernel, stage walls, peak memory; one DiT step under torch.profiler.
     The whole-sequence VAE is not run at this length.
  10. the ragged batch: `batch_edit` over the 33-frame clip and the 4x
     clip's first 65 frames (29,640 and 54,600 tokens) as one batch of 2:
     exactly 240 B1 launches at batch 2, the 120 self-attention ones with
     the batch's key mask (valid keys 29,640 and 54,600), nothing else;
     each item's final latents against its own `pipe()` run with the same
     seed (relative L2 <= 2e-2, the DiT gate's: cuBLAS picks kernels by M,
     so bit equality is not expected).
  11. the paired edit (`cot=False`) of the 33-frame clip, 4 steps (18
     latent frames, 28,080 tokens): the output and 240 B1 launches.
  12. the streaming VAE against the whole-sequence VAE at 33 frames (the
     encode of the clip, the decode of item 0's 9-frame edit segment to
     uint8) in bf16: seconds, peak memory, mu's relative L2 and the uint8
     frames' difference. Against the whole-sequence VAE in fp32: the
     streamed VAE in fp32 within 1e-4 relative L2 (mu and decoded frames),
     and the streamed one in bf16 no further from it than 1.5x the whole
     one in bf16.
  13. the standard CLI (on the DiT's first 5 of 30 layers, as phase 5):
     `videocof_torch.cli.infer.main()` in this process
     (--random_init --repeat_rope, its defaults: 50 steps, CFG 5 against
     the default negative prompt, TeaCache with Wan2.1 T2V 14B's
     coefficients) on a 40-frame clip written with cv2 (it fails without
     cv2); the TeaCache plan
     these random weights give, the files, and B1 launches equal to 2 x
     layers x the computed steps, each at batch 2.
  14. fp8 weights and runtime LoRA on the Wan2.1 14B: the unmerged draw of
     phase 8's factory call quantized on the card (`quantize_dit_fp8`;
     the DiT's bytes before and after; a block's fp8 weights and scale
     equal bit for bit to the CPU's quantization, its dequantized weights
     to (q.float() * scale).to(bf16)); one DiT forward in fp8 against bf16
     within JAX's bound (mean |err| < 0.05 mean |bf16| + 0.05); phase 8's
     two LoRA files attached as runtime adapters (`load_runtime_lora`,
     rank concatenation); the 4-step edit (output, 320 B1 launches and
     nothing else, stage walls, peak), its final latents against phase
     8's merged bf16 edit (relative L2, printed); the dequantization's and
     the adapters' fusion's milliseconds beside a step's.
  15. the Wan2.2 A14B dual-expert edit: umT5-XXL, the Wan2.1 VAE and two
     WAN22_T2V_A14B experts from two seeds, each quantized to fp8 as it is
     drawn (at most one bf16 expert resident); the 480x832 33 + 4-frame
     edit in 4 Flow-UniPC steps at shift 5, guidance 1: split_idx (0 <
     split < 4), each expert's forwards (hooks), exactly 160 self and 160
     cross B1 calls at 40 heads and nothing else, stage walls, a peak
     below the card's memory, and one fp8 expert step under
     torch.profiler.
  16. A14B text-to-video (`Wan22Pipeline.text_to_video`) at 480x832 with
     81 frames (32,760 tokens), 4 steps, guidance 4 and 3 on the
     high-noise steps, batched CFG: output, 320 B1 calls at batch 2,
     seconds, peak.
  17. the TI2V-5B with the Wan2.2 VAE (`factory.load_pipeline(
     random_init=True, dit_cfg=WAN22_TI2V_5B, vae_cfg=Wan22VAEConfig())`,
     bf16): the 33 + 4-frame edit at 704x1280 (16,720 tokens) in 4 steps:
     output, 120 + 120 B1 calls at 24 heads and nothing else, stage walls,
     peak, one DiT step under torch.profiler; the streaming Wan2.2 VAE
     against the whole-sequence one in bf16 on the source clip and the
     edit's last 9 latent frames (seconds, peaks, mu's relative L2, uint8
     levels), and on the first 9 frames against the whole-sequence VAE in
     fp32 with phase 12's gates.
  18. the entries on Wan2.2: a published-layout A14B directory (two
     experts at full width and 2 layers each, the Wan2.1 VAE, umT5-XXL)
     written by `save_wan_checkpoint_dir`, then `fast_infer.main([...,
     "--quantize", "fp8"])` (the 4-step edit of a cv2 clip) and
     `infer.main([..., "--t2v", "--quantize", "fp8", "--guidance_scale_2",
     "3.0"])` (its 50 steps, CFG 5, 65 frames) on it: a `Wan22Pipeline`
     with fp8 experts, the files, the launches, the seconds (the
     directory has no tokenizer: the factory gets
     ``require_real_tokenizer=False``).
  19. serving, at full width: (a) the Wan2.1 14B in fp8 on its first 5
     of 40 layers (the script's time limit) with umT5
     offloaded (`factory.load_pipeline(random_init=True, quantize="fp8",
     offload_t5=True)`) behind `VideoCoFController` and `serving.api`'s
     handler on a thread, four POSTs of the cv2 clip as a base64 mp4 (4
     steps, guidance 1, one seed) with two rank-32 LoRA files for those
     layers as runtime adapters per request: FusionX, VideoCoF, none,
     FusionX; every reply "Success" with an mp4 cv2 reads at 34 frames of
     480x832; 40 self and 40 cross B1 calls at 40 heads a request and
     nothing else; the
     adapters detached after "none"; the edits of requests 1-3 pairwise
     different and request 4 equal to request 1 bit for bit; the allocated
     memory between requests below the fp8 DiT, the VAE, the adapters and
     1 GB (umT5 not resident); per request the client's and the
     controller's seconds, the text stage, the LoRA switch and the peak;
     /metrics, /healthz, the page, and the refusals with the JAX API's
     codes and counts (404, 400 missing video, 400 embeddings-in, 403 a
     source path outside the allowlist, 403 an update outside
     VIDEOCOF_MODEL_DIRS, 413 an oversized body; and the port's own 403
     for a LoRA file outside VIDEOCOF_MODEL_DIRS). (b) At 1.3B:
     `VideoCoFModelLoader` twice (one build) and `VideoCoFEdit` on a torch
     IMAGE wire (240 B1 calls); that pipeline behind the API, a second DiT
     draw written to the published layout and swapped in by the update
     endpoint in place (the DiT equal to the draw bit for bit, allocated
     memory flat within 64 MB, the peak within the largest tensor + 256 MB),
     an edit after it within 1e-3 relative L2 of a `WanPipeline` on the
     second draw; LoRA files merged and unmerged (the largest ulp distance,
     printed); two concurrent requests answered one after the other with
     ``busy`` >= 1; the DiT quantized to fp8 with adapters attached and
     the swap again (bit for bit `quantize_dit_fp8` of the draw, adapters
     detached). (c) `python -m videocof_torch.serving.api --random_init
     --offload_t5` as a subprocess: /healthz within 300 s, `WorkerPool`
     healthy and two mapped requests, `VideoCoFClient.post_to_host` writing
     an mp4, exit within 30 s of SIGTERM. (d) `init_distributed` on NCCL,
     a world of 1: an all_reduce, then `destroy_process_group`.
  20. training from files, at full width (the 1.3B runs on its first 5
     of 30 layers: the script's time limit): (a) a triplet JSON of four
     triplets of 40-frame cv2 clips (source, grounded with a gray
     rectangle, edited), three at 480x832 and one at 512x512, which
     `resize_center_crop` scales and crops; (b)
     `videocof_torch.cli.train.main()` in this process (--random_init,
     Wan2.1 T2V 1.3B, --lora_rank 16 --steps 4 --save_every 2
     --checkpoint_dir --export_lora, 480x832, 33 + 4 + 33 frames): finite
     losses, checkpoints at steps 2 and 4, base weights bitwise those of
     an unmerged draw, 4 B2 and 2 B3 launches a layer a step; seconds per
     step
     (the median after the warm-up), stage walls, the saves' seconds, peak
     memory; (c) each checkpoint restored into a fresh trainer, bit for bit
     the state as it was saved (adapters, both AdamW moments, step counts)
     and the latest the state in memory, then one more step from the
     restored state and from the state in memory on one sample with one
     seeded generator: the same loss bit for bit, the same step counts, the
     adapters and moments within 1e-3 relative L2 (B3 adds dq's key tiles
     in no fixed order, so two steps from one state differ in the last
     bits: the spread of two steps from the restored state is printed
     beside it); (d) the
     exported LoRA file merged by `merge_lora` into the pipeline (10
     modules a layer) and a 4-step edit: output and 8 B1 launches a layer;
     (e)
     `PrefetchLoader(num_threads=4) -> device_prefetch -> CoFTrainer.train`
     for 3 steps over the four triplets, item 1 with gradual grounding and
     item 2 with the gray overlay (whose grounding stream, the overlaid
     source as in JAX's dataset, is cut to its first 4 frames): seconds
     per step, the loader's seconds per triplet, and a fourth step under
     torch.profiler, its idle share beside phase 6's on in-memory samples;
     (f) one LoRA step each under the remat policies True,
     "dots_with_no_batch_dims_saveable" and
     "save_names:attn_out,xattn_out" (umT5 moved off the card): the loss
     equal to full remat's bit for bit, the adapter gradients within 1e-3
     relative L2 of full remat's, 4 B2 and 2 B3 a layer each, seconds and
     peak;
     (g) two steps of `CoFTrainer` on the Wan2.1 T2V 14B drawn on the card
     by `factory.load_pipeline("", random_init=True, dit_cfg=
     WAN21_T2V_14B)` at full width and depth, rank-32 LoRA, full remat, on
     the triplets: finite losses, base weights unchanged, 160 B2 and 80 B3
     launches a step, seconds per step, stage walls, peak. B2 and B3 are
     also held against their plain versions (phase 2) and timed (phase 3)
     at the 14B's 40 heads.
  21. parallelism on `torch.distributed` at the 1.3B's full width, two
     ranks sharing the one card, the edits and training runs on its first
     2 of 30 layers (the script's time limit; the ring edit on 5, as
     phase 9's):
     (a) the probe of the collectives on CUDA tensors of two ranks on
     cuda:0 (NCCL's one all_reduce; gloo's all_reduce, all_to_all_single,
     all_gather_into_tensor, reduce_scatter_tensor and batch_isend_irecv),
     each pair of processes killed if it outlives 120 s; (b) the 4-step
     480x832 33 + 4-frame edit with Ulysses over seq 2 (gloo) and (d) the
     same edit at guidance 5 with one guidance branch per data rank (data
     2), each rank's final latents against the world-1 edit of the same
     factory weights and seed within 2e-2 relative L2, the uint8
     difference, each rank's B1 calls by shape (Ulysses: one self over 6
     of 12 heads and one cross over 14,820 tokens a layer and step),
     stage walls and peak beside world 1's; (c) ring attention on the 4x
     edit at world 1 under NCCL (gloo carries no point-to-point on CUDA
     tensors): one B2 and one cross B1 a layer and step, against phase 9's 4x edit within 2e-2; (e)
     `videocof_torch.cli.train` under one `torch.distributed.run
     --nproc_per_node=2` (this script's ``--train-rank`` mode runs its
     `main` twice) with --mesh_seq 2 and with --mesh_data 2 (the frozen
     base FSDP-sharded, batch 2), rank 16, two steps: each rank's first loss
     within 2e-2 of a world-1 CLI run on the same triplets, seed and
     timesteps (batch 2 and a sampler of 2 bands for the data run; the clip
     off and umT5 off the card, --offload_t5, in both), its gradient (AdamW's first moment after step 1) within
     5e-2 relative L2 of world 1's, the adapters' move printed, 4 B2 and 2
     B3 launches a layer a step per rank, the peaks. Two ranks share one
     card's SMs: the phase's seconds are no multi-GPU speed. B1, B2 and B3
     are also held against their plain versions (phase 2) and timed
     (phase 3) at these shapes (6 heads over 29,640 tokens, 12 heads over
     14,820 tokens by 512 keys, and B2 over the 4x sequence).
  22-25. the other Wan variants at full width, random weights from the
     seed, 480x832, 33 frames (9 latent frames, 14,040 tokens), 4
     Flow-UniPC steps at shift 5, guidance 5 (batched CFG), each with its
     stage walls, peak memory, B1 calls by shape (exactly those the path
     implies, nothing else) and its final latents against the same call
     through the naive attention backend (relative L2 <= 2e-2, the DiT
     gate): (22) image-to-video at WAN21_I2V_14B's width on its first 5
     of 40 layers (the script's time limit, since phase 29) with the
     CLIP ViT-H/14 tower on the card (`factory.load_pipeline("",
     random_init=True, dit_cfg=...)`, `image_to_video` of a uint8 start
     image:
     self, text cross and 257-key image cross B1 calls), then
     `fast_infer.main(["--start_image", png, ...])` on a published-layout
     i2v directory (2 layers, full width, the CLIP file); (23) VACE at
     Wan2.1 1.3B's first 10 of 30 layers with 5 hint blocks (stride 2,
     live projections),
     `control_to_video` of a uint8 control clip under a region mask, then
     `fast_infer.main(["--control_video", clip, "--control_mask", clip,
     ...])` on a published-layout VACE directory (2 layers and their hint
     block); two rank-32 LoRA files for its layers, attached as runtime
     adapters, in one `vace_forward` of the phase's geometry (batch 1)
     against the same files merged into a copy of the DiT (relative L2
     <= 2e-2, the DiT gate), each at least ten times that distance from
     the un-adapted forward, B1 exactly (layers + hint blocks) x 2 calls;
     then the VACE pipeline with its DiT quantized to fp8 and the adapters
     attached (`set_runtime_lora`): its final latents more than 1e-3 from
     the un-adapted fp8 run's, its B1 calls those of (23); (24) camera
     control at 1.3B on 10 layers (the adapter 24 ->
     1536 on
     `pose_params_to_embedding` of 33 pose rows); (25) speech-to-video at
     the 14B's width on 5 of its 40 layers with seeded audio features
     (audio_dim 1024,
     4 tokens a latent frame, injected at layer 0: B1 at batch 18 over 4
     keys), with the runtime LoRA checks of (23) on `wan_s2v_forward`
     and the fp8 S2V pipeline. B1 is also held against its plain version (phase 2) and timed
     (phase 3) at the i2v shapes (self, text cross and image cross at 40
     heads, batch 2, 14,040 tokens) and the audio injection's.
  26-28. the other model families at full width and depth, random bf16
     weights from the seed, each with its B1 calls by shape (exactly those
     the path implies, nothing else), its DiT forwards' and decode's walls,
     its peak memory, the output's shape, finiteness and spread, and one
     DiT forward of its geometry on its first FAMILY_NAIVE_LAYERS blocks at
     full width against the naive backend (relative L2 <= 2e-2, the DiT
     gate): (26) CogVideoX-5B (42 blocks of 48 heads of 64) with its causal
     3D VAE, `CogVideoXPipeline` at 480x720, 49 frames, 226 text tokens,
     CFG 6 (batch 2, 17,776 joint tokens), 4 DDIM steps: 168 B1 calls, the
     whole-clip decode's peak; (27) Flux-dev (19 double- and 38
     single-stream blocks) with its KL VAE, `FluxPipeline` at 1024x1024
     with 512 text tokens (4,608 joint tokens) and guidance 3.5, 4 steps,
     in bf16 and again after `quantize_dit_fp8` with `FLUX_FP8_EXCLUDE`:
     228 B1 calls each, one fp8 forward against bf16 within JAX's bound
     (phase 14's); (28) QwenImage (60 blocks) with its Wan2.1-layout VAE,
     `QwenImagePipeline` at 1024x1024 with a 256-token prompt (4,352 joint
     tokens), true CFG 4, 4 steps: 480 B1 calls. Then the families'
     serving path: a 1.3B Wan controller (the load arguments of
     `serving.api --random_init`) behind the API's handler, each family's
     published-layout directory (full width, 2 layers of each kind, its
     VAE; `save_family_checkpoint_dir`) switched in by the update endpoint,
     one embeddings-in request each with an `embeddings_path` .npz inside
     the allowlist (an mp4 of 9 frames at 480x720 for CogVideoX, a
     1024x1024 png for the image families, decoded and checked, B1's
     launches counted), the switch back to Wan and one edit; and Flux at
     full width on its first 2 blocks of each kind under Ulysses at two
     gloo ranks sharing the card (2 steps), each rank's latents against
     world 1's within 2e-2 and B1's calls over 12 of the 24 heads. B1 is
     also held against its plain version (phase 2) and timed (phase 3) at
     the three families' joint shapes and at QwenImage's with a text mask
     (batch 2, row 0's text padded past 192 of its 256 tokens: the
     key-masked path, which a text mask takes).
  29. tensor, pipeline and expert parallelism on `torch.distributed`, in
     gloo worlds of 2 and 4 ranks sharing the card (the probe of phase 21
     also holds `all_to_all_single` with uneven splits and `all_reduce`
     on uint8 bytes, which this phase needs), each rank against world 1
     in this process on the same layers and inputs: (a) the 4-step
     480x832 33 + 4-frame CoF edit at WAN21_T2V_14B's width on its first
     layer of 40 (the script's time limit), fp8 with two runtime rank-32 LoRA files,
     at tp 2 (`enable_sequence_parallel(model=2)`): latents within 2e-2
     relative L2, B1 at 20 of 40 heads (4 self and 4 cross calls a rank),
     each
     rank's share of the blocks' bytes at most 0.51, the all-reduces'
     count, bytes and seconds; (b) Flux-dev (2 double and 2 single
     blocks at 1024x1024, 512 text tokens), QwenImage (2 blocks, 256) and
     CogVideoX-5B (2 blocks, 17,776 joint tokens at batch 2) forwards at
     tp 2 within 2e-2, B1 at half the heads; (c) the TP x FSDP full
     fine-tuning step at data 2 x model 2 (4 ranks) at the 1.3B's width on
     2 layers, a 29,640-token row a data rank: the loss within 2e-2, the
     gradients (FSDP-gathered) within 5e-2 relative L2 of world 1's cut
     to the rank's TP shard, AdamW's moves within 0.3, the q weight's
     shard [768, 768]; then its train state saved (`save_train_state`,
     every rank returning once the directory exists; the file at the
     model's global shapes), a fresh TP x FSDP state restored from it
     (each rank's shards bit for bit the saved state's), whose second
     step takes the loss of the second step in memory bit for bit and its
     parameters within 4e-3 relative L2 (B3 adds dq's key tiles in no
     fixed order), and the same file restored at world 1, whose second
     step is held to the world-1 gates against the ranks'; the save's and
     the restores' seconds; (d) GPipe (`pp_scan_blocks`) over the 1.3B's 30
     blocks at full depth, 29,640 tokens, batch 2, 2 stages and 2
     microbatches, within 2e-2 of the sequential blocks, and its backward
     through the first 4 blocks (the blocks' and the stream's gradients
     within 5e-2); (e) two WAN22_T2V_A14B-width fp8 experts of 2 layers,
     one a rank (`ep_param_shardings`): `select_expert(k)` for k in {0,
     1} run through `torch.func.functional_call` on a shell on the meta
     device equal bit for bit to the owner's own forward; (f)
     xlm-roberta-large with its CLIP head at full size, fp32: shapes,
     finiteness, the padded row against the row alone within 1e-4. B1,
     B2 and B3 are also held against their plain versions (phase 2) and
     timed (phase 3) at the head-local shapes: the 14B's 20 heads (self
     and cross), the 1.3B's 6 (self and cross, B2 and B3) and 3 (tp 4),
     Flux's and QwenImage's 12, CogVideoX-5B's 24 of 64.
  30. a `kernels` JSON line and, last, the device JSON line.

B1 is also held against its plain version (phase 2) and timed (phase 3) at
the 14B's 40 heads, at the self and cross shapes, and at the shapes of
phases 9 and 10: 4x self (107,640 tokens), 4x cross, and the ragged self
shape (batch 2 of 54,600 tokens, row 0's keys masked past 29,640), with
the bound of the work its rows need and of the padded work it does; and at
the Wan2.2 shapes of phases 16 and 17: the TI2V-5B's self (16,720 tokens,
24 heads) and cross, and text-to-video's self (batch 2 of 32,760 tokens,
40 heads) and cross. The VAE streams every clip longer than 2 frames (the
JAX package's threshold), in the edits of phases 4, 5, 7 and 8 too.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# files the entry phases write (checkpoints, LoRA files, clips, outputs);
# removed when each phase ends
SCRATCH = ROOT / "chiprun_out" / "chip_smoke"
# the 14B's two LoRA files, kept from the 14B edit to the fp8 phase
LORA_DIR = ROOT / "chiprun_out" / "chip_smoke_lora"
# the published umT5 and VAE files of phase 18's directory, kept for the
# variants' entry directories (phases 22-23)
SHARED_DIR = ROOT / "chiprun_out" / "chip_smoke_shared"

# the port's kernel functions, as their names appear in ptxas and the profiler
OUR_KERNELS = ("flash_fwd_kernel", "flash_bwd_kernel", "int8_attn_kernel",
               "k_prepass_kernel")
TOL = 3e-2                     # bf16 tolerance of a kernel vs its plain version
REL_TOL = 1e-2                 # ... and of ||kernel - plain|| / ||plain||
B3_ROUNDED_TOL = 1e-3          # B3 vs the plain backward in its arithmetic
# B3 vs the fp32 plain backward (JAX's arithmetic): at most 1.5x the size of
# the rounding of P and dS on the same inputs, the rounded plain backward's
# relative L2 against the fp32 one (about 2.6e-3 bf16, 3.2e-4 fp16 at the
# self and cross shapes, as the earlier B3a/B3b measured)
B3_FP32_FACTOR = 1.5
LSE_TOL = 1e-4                 # max |lse kernel - plain| / max(1, |lse plain|)
DIT_REL_TOL = 2e-2             # DiT through the kernels vs the naive backend
DIT_INT8_REL_TOL = 1e-2        # ... through B4 (1.8e-3 measured on the CPU)
QUANT_FLIP_TOL = 1e-4          # share of int8 values one level off the plain
# the pre-pass's K mean against `k_mean`: the two fp32 sums differ only in
# their order; each is within (its longest chain of additions) * 2^-24 *
# sum |k| of the exact sum, and the chains over random K stay far below 256
# roundings, so |mean - k_mean| <= 256 * 2^-24 * mean |k| per column
MEAN_ULPS = 256
# the pre-pass's key lengths held in phase 2: on and beside its stages (128
# rows at D = 128, 64 at D = 256), around 384, 512 and 780, a long ragged
# one, and 110,000 (more rows than the resident CTAs' stages keep: a chunk
# a CTA, the rows past its stage read twice)
PREPASS_LENGTHS = (1, 64, 65, 128, 129, 384, 385, 511, 512, 768, 769, 780,
                   781, 3001, 110000)
COS_TOL = 0.999                # B4 vs unquantized attention (JAX's test)
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 (data sheet)
PEAK_INT8_OPS = 1979e12        # H100 SXM dense int8 (data sheet)
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
# SASS of the Hopper designs: bf16 wgmma and TMA loads, and B4's int8 wgmma
SASS_OPCODES = ("HGMMA", "UTMALDG")
SASS_OPCODES_INT8 = ("IGMMA", "HGMMA", "UTMALDG")
SEED = 0
TRAIN_STEPS = 3
STD_STEPS = 50                 # the standard edit (the reference's inference.py)
STD_LAYERS = 5                 # ... and the standard CLI (phase 13) on the
                               # first of the 1.3B's 30 layers (the
                               # script's time limit: 10 in PR 13-14)
TEACACHE_PIN = 0.4             # pinned TeaCache skip rate (bench.py's)
LORA_RANK = 32                 # the entry phases' synthetic LoRA files
LORA_ALPHA = 16.0              # ... the kohya file's alpha (scale 0.5)
# the least relative L2 by which the runtime adapters move an fp8
# pipeline's final latents (phases 23 and 25; without them the run is
# the same arithmetic, so any adapter that is dropped shows as 0)
LORA_MOVED_MIN = 1e-3
CLIP_FRAMES = 40               # frames of the entry phase's synthetic clip
EXTRAP_FRAMES = 133            # the 4x edit: 1 + 4 x 33 frames, 34 latent
RAGGED_FRAMES = 65             # the ragged batch's long item (item 0: 33)
RIFLEX_K = 6                   # the 4x edit's RIFLEx frequency
RAGGED_REL_TOL = 2e-2          # a ragged item vs its own run (the DiT gate's)
TEXT_TOKENS = 512              # umT5 tokens of a prompt (max_sequence_length)
# the DiT's fused passes against their plain steps: the largest share of
# bf16 outputs that may differ (tests/test_torch_cuda.py's DIT_SHARE)
DIT_SHARE = 1e-3
# against the whole-sequence VAE in fp32: the streamed VAE in fp32 (mu and
# decoded frames, relative L2; cuDNN picks algorithms per chunk shape), and
# the streamed one in bf16, at most this many times the whole one's distance
VAE_FP32_REL_TOL = 1e-4
VAE_STREAM_FACTOR = 1.5
# the Wan2.2 phases: Flow-UniPC steps and Wan2.2's sample shift (at 4 steps
# the timesteps are 999, 937, 833, 624: two high-noise steps of four)
A14B_STEPS = 4
A14B_SHIFT = 5.0
T2V_FRAMES = 81                # text-to-video frames (JAX's default)
T2V_GUIDANCE = 4.0             # ... its guidance, and the high-noise one's
T2V_GUIDANCE_2 = 3.0
TI2V_HW = (704, 1280)          # the TI2V-5B's published size
ENTRY22_LAYERS = 2             # layers per expert of the entries' checkpoint
# the serving phase: the 14B server's LoRA file per request (runtime
# adapters over fp8 weights; request 4 repeats request 1)
SERVE_LORAS = ("fusionx", "videocof", "none", "fusionx")
# ... its DiT at the 14B's width on its first 5 of 40 layers, with LoRA
# files written for those (the script's time limit)
SERVE_14B_LAYERS = 5
SERVE_MEM_SLACK = 1e9          # allocated between requests over DiT + VAE +
                               # adapters (umT5's 11.4 GB are not resident)
SWAP_MEM_SLACK = 64e6          # allocated after a weight swap vs before
SWAP_PEAK_SLACK = 256e6        # a swap's peak over before + largest tensor
SWAP_REL_TOL = 1e-3            # an edit after a swap vs its draw's pipeline
SERVER_START_S = 300           # the subprocess server's /healthz deadline
SERVER_STOP_S = 30             # ... and its exit after SIGTERM
# fp8 weights against bf16, one DiT forward (JAX's tests/test_fp8.py bound):
# mean |err| < FP8_ERR_REL * mean |bf16| + FP8_ERR_ABS
FP8_ERR_REL = 0.05
FP8_ERR_ABS = 0.05
# training from files (phase 20): one instruction per triplet, the last
# triplet's clips at another aspect ratio, each item's grounding mode in
# the loader-fed steps
TRAIN_INSTRUCTIONS = ("remove the red car", "replace the dog with a cat",
                      "add a hat to the man", "make the sky purple")
TRAIN_OTHER_HW = (512, 512)
TRAIN_MODES = ("plain", "gradual", "overlay", "plain")
# phase 20's 1.3B runs on the first of its 30 layers (the script's time
# limit, 10 in PR 13-14; phase 6 trains all 30, and the 14B steps keep
# their 40)
TRAIN_LAYERS = 5
TRAIN_CLI_RANK = 16            # the CLI's LoRA rank, steps and saves
TRAIN_CLI_STEPS = 4
TRAIN_SAVE_EVERY = 2
LOADER_THREADS = 4             # the loader-fed steps (one more, profiled)
LOADER_STEPS = 3
TRAIN_REMAT_POLICIES = (True, "dots_with_no_batch_dims_saveable",
                        "save_names:attn_out,xattn_out")
REMAT_GRAD_REL_TOL = 1e-3      # adapter gradients vs full remat's (B3 may
                               # reduce in another order)
RESUME_REL_TOL = 1e-3          # a step from the restored state vs from the
                               # state in memory (the same reason)
TRAIN_14B_RANK = 32            # the 14B LoRA steps
TRAIN_14B_STEPS = 2
SP_DEGREE = 2                  # phase 21: two ranks share the one card
# phase 21's edits and training runs: the 1.3B cut to these of its 30
# layers at full width (the script's time limit); its ring edit runs on LONG_LAYERS, held against phase
# 9's 4x edit
SP_LAYERS = 2
SP_TRAIN_STEPS = 2             # ... its training runs' steps
SP_TIMEOUT_S = 600             # ... the deadline of its spawned ranks
# an SP edit's final latents vs world 1's (the DiT gate: the ranks' linears
# see other row counts, and cuBLAS picks kernels by them)
SP_REL_TOL = 2e-2
# an SP training step's first loss vs world 1's, and its gradient's
# relative L2 (bf16, other reduction orders; B3 adds dq's key tiles in no
# fixed order)
SP_LOSS_TOL = 2e-2
SP_GRAD_TOL = 5e-2
# phases 22-25, the other Wan variants: frames (9 latent frames, 14,040
# tokens at 480x832), Flow-UniPC steps, guidance (batched CFG) and JAX's
# shift of their pipelines; S2V's audio features and tokens a latent frame;
# the layers of the entries' published-layout directories
VARIANT_FRAMES = 33
VARIANT_STEPS = 4
VARIANT_GUIDANCE = 5.0
VARIANT_SHIFT = 5.0
AUDIO_DIM = 1024
AUDIO_TOKENS = 4
CLI_LAYERS = 2
# ... and the i2v and S2V paths at the 14B's width run on its first 5 of
# 40 layers, their naive-backend runs too (the script's time limit: 10
# since phases 26-28, 5 since phase 29); VACE and camera control on the
# 1.3B's first 10 of 30
VARIANT_14B_LAYERS = 5
VARIANT_1_3B_LAYERS = 10
# phases 9-12 (the 4x, ragged and paired edits) and phase 21's ring edit,
# held against phase 9's 4x edit, on the 1.3B's first 5 of 30 layers (the
# script's time limit)
LONG_LAYERS = 5
# phases 26-28, the other model families at full width and depth, random
# bf16 weights from the seed: CogVideoX-5B's clip and text (the
# reference's 480x720, 49 frames, 226 T5 tokens, CFG 6, DDIM), the image
# families' 1024x1024 with Flux-dev's 512 text tokens and guidance 3.5 and
# QwenImage's 256-token prompt under true CFG 4; the steps of each; the
# naive-backend gate on each DiT's first blocks at full width; the serving
# path's published directories (full width, this many layers of each kind)
# and its requests; the Flux Ulysses run's blocks of each kind
COG_HW = (480, 720)
COG_FRAMES = 49
COG_TEXT = 226
COG_GUIDANCE = 6.0
COG_STEPS = 4
FAMILY_HW = (1024, 1024)
FAMILY_STEPS = 4
FLUX_TEXT = 512
FLUX_GUIDANCE = 3.5
QWEN_TEXT = 256
QWEN_CFG = 4.0
FAMILY_NAIVE_LAYERS = 4
FAMILY_DIR_LAYERS = 2
SERVE_COG_FRAMES = 9
SERVE_FAMILY_STEPS = 2
FAMILY_SP_LAYERS = 2
# phase 29, tensor, pipeline and expert parallelism at gloo worlds of 2 and
# 4 ranks on the one card: the TP edit at the Wan2.1 14B's width on its
# first layer of 40 (the script's time limit); the families' TP forwards on 2 blocks of each kind;
# the pipeline over the 1.3B's 30 blocks at batch 2 in 2 microbatches, its
# backward through the first 4; the two fp8 A14B-width experts of 2
# layers; the TP x FSDP step at the 1.3B's width on 2 layers, at AdamW's
# lr 1e-2 (bf16 weights: smaller moves round away); the TP ranks' share of
# the blocks' bytes at most 0.51 (the norms, modulations and row biases
# stay whole); AdamW's moves within 0.3 relative L2 of world 1's (each
# about lr in size: a gradient within the ranks' rounding of 0 may turn
# its move's sign)
TP_EDIT_LAYERS = 1
TP_FAMILY_LAYERS = 2
PP_BATCH = 2
PP_MICRO = 2
PP_GRAD_BLOCKS = 4
EP_LAYERS = 2
TP_TRAIN_LAYERS = 2
TP_TRAIN_LR = 1e-2
TP_FSDP_MIN = 2 ** 16          # FSDP's smallest sharded tensor (JAX's)
TP_BYTES_SHARE = 0.51
TP_UPDATE_TOL = 0.3
# the TP x FSDP step's parameters after a restore vs the step in memory:
# B3 adds dq's key tiles in no fixed order, and AdamW's normalised step
# turns that into bf16 roundings of whole ulps (under 1e-3 relative L2 on
# an H100; the restored state and the step's loss are bit for bit)
TP_RESUME_TOL = 4e-3


def log(*args):
    print(*args, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, runs, warmup=2):
    """Median milliseconds of ``fn()`` over ``runs`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound(flops, nbytes, int8_ops=0):
    """(ms, "operations" | "bytes"): the larger of the operations' time (bf16
    FLOP over the bf16 peak plus int8 OP over the int8 peak) and bytes over
    the memory rate."""
    ops_ms = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def kernel_work(B, Lq, Lk, N, D, eb=2):
    """(FLOP, bytes) of the flash kernels: FLOP of their products, and bytes
    of their inputs read once and outputs written once (q, k, v, o, dO, dq,
    dk, dv in bf16; lse and delta [B, N, Lq] fp32)."""
    mm = B * N * Lq * Lk * D
    q_b, kv_b, vec_b = eb * B * Lq * N * D, eb * B * Lk * N * D, 4 * B * N * Lq
    return {
        "flash_attention_fwd": (4 * mm, 2 * q_b + 2 * kv_b),
        "flash_attention_fwd_lse": (4 * mm, 2 * q_b + 2 * kv_b + vec_b),
        # S, dP, dV, dK, dQ; reads q, k, v, dO, lse, delta, writes dq, dk,
        # dv (the fp32 dQ accumulator's zeroing, reduce-adds and cast are
        # not counted: they are the kernel's way, not the function's work)
        "flash_attention_bwd": (10 * mm, 3 * q_b + 4 * kv_b + 2 * vec_b),
    }


def int8_bounds(B, Lq, Lk, N, D, eb=2):
    """Bounds of B4 and its two kernels: the int8 product qi ki^T at the
    int8 peak and the bf16 product PV at the bf16 peak; bytes of the inputs
    read once and outputs written once (q, k, v, o in bf16; the pre-pass
    writes int8 K and fp32 row scales that the attention kernel reads, and
    writes the fp32 K mean)."""
    mm = B * N * Lq * Lk * D
    q_b, kv_b = eb * B * Lq * N * D, eb * B * Lk * N * D
    ki_b, sk_b, mean_b = B * Lk * N * D, 4 * B * N * Lk, 4 * B * N * D
    return {
        "int8_flash_attention": bound(2 * mm, 2 * q_b + 2 * kv_b, 2 * mm),
        "int8_quantize_k": bound(0, kv_b + mean_b + ki_b + sk_b),
        # the parent's pre-pass: a torch reduction for the mean, then the
        # quantization, each reading K (the mean written and read back)
        "k_mean + quantize": bound(0, 2 * kv_b + 2 * mean_b + ki_b + sk_b),
        "int8_attention_fwd": bound(2 * mm, 2 * q_b + kv_b + ki_b + sk_b,
                                    2 * mm),
    }


def pinned_teacache_plan(steps, rate, warmup=5):
    """A TeaCache plan at a fixed skip rate, spread evenly after the warm-up
    steps (bench.py's BENCH_TEACACHE_PIN plan): True = skipped."""
    plan, acc = [], 0.0
    for i in range(steps):
        acc += rate if i >= warmup else 0.0
        plan.append(acc >= 1.0)
        acc -= int(acc)
    return plan


def kernel_label(name):
    """A short label for a mangled kernel name: kernel<type, D[, lse]>."""
    kernel = next((k for k in OUR_KERNELS if k in name), name)
    dim = re.search(r"Li(\d+)E", name)
    return (f"{kernel}<{'bf16' if 'bfloat16' in name else 'fp16'}, "
            f"D={dim.group(1) if dim else '?'}"
            + (", lse" if "Lb1E" in name else "") + ">")


def ptxas_report(log_text):
    """[(kernel, registers, spill stores, spill loads, static shared memory
    bytes)] from nvcc -Xptxas -v."""
    rows, name, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((kernel_label(name), int(m.group(1)), *spills,
                         int(smem.group(1)) if smem else 0))
            name, spills = None, (0, 0)
    return rows


def sass_counts(lib_path, kernel, opcodes):
    """({label: {opcode: count}} of ``opcodes`` over the functions named like
    ``kernel`` in ``cuobjdump -sass`` of a built library, {every *GMMA*
    opcode seen there: count})."""
    from videocof_torch.ops import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {lib_path}: {res.stderr.strip()}")
    counts, gmma, func = {}, {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = kernel_label(m.group(1)) if kernel in m.group(1) else None
            if func:
                counts[func] = dict.fromkeys(opcodes, 0)
        elif func:
            for op in opcodes:
                counts[func][op] += len(re.findall(rf"\b{op}\b", line))
            for op in re.findall(r"\b\w*GMMA[\w.]*", line):
                gmma[op] = gmma.get(op, 0) + 1
    return counts, gmma


def profile_kernels(fn, tries=1):
    """Run ``fn()`` once under torch.profiler: (wall ms, device busy ms,
    [(device ms, launches, kernel name)] sorted by device time). Kernels are
    the trace's "kernel" events; busy is the union of their intervals and
    those of the device's copies and memsets. The profiler now and then
    returns no device events for a call of a millisecond or so: with
    ``tries`` > 1 (for an ``fn`` that can run again) such a profile is
    taken again, up to ``tries`` times in all, each empty one logged."""
    for attempt in range(1, tries + 1):
        wall_ms, busy_ms, rows = _profile_once(fn)
        if busy_ms > 0.0 or attempt == tries:
            return wall_ms, busy_ms, rows
        log(f"[profile] no device events in profile {attempt} of {tries}; "
            "profiling the call again")


def _profile_once(fn):
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans, by_name = [], {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ev["ts"], ev["ts"] + ev["dur"]))
        if ev.get("cat") == "kernel":
            ms, n = by_name.get(ev["name"], (0.0, 0))
            by_name[ev["name"]] = (ms + ev["dur"] / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                  reverse=True)
    return wall_ms, busy_us / 1e3, rows


def report_profile(label, wall_ms, busy_ms, kernels):
    """Print a profile: idle share, our kernels, cuBLAS, the rest, the top.
    Returns the idle share (None when the profiler saw no device events)."""
    if busy_ms <= 0.0:
        log(f"[profile] {label}: wall {wall_ms:.1f} ms; device time by "
            "kernel not measured (torch.profiler saw no device events)")
        return None
    ours = {}
    for ms, n, name in kernels:
        for key in OUR_KERNELS:
            if key in name:
                lse = "Lb1E" in name or re.search(r"fwd_kernel<[^>]*true>",
                                                  name)
                tag = key + ("<lse>" if lse else "")
                a, c = ours.get(tag, (0.0, 0))
                ours[tag] = (a + ms, c + n)
    conv_ms = sum(ms for ms, _, name in kernels if "implicit_gemm" in name)
    gemm_ms = sum(ms for ms, _, name in kernels
                  if "implicit_gemm" not in name and any(
                      s in name.lower() for s in ("gemm", "nvjet", "cutlass")))
    kernel_ms = sum(ms for ms, _, _ in kernels)
    ours_ms = sum(ms for ms, _ in ours.values())
    log(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (idle {1 - busy_ms / wall_ms:.1%}); kernel time "
        f"{kernel_ms:.1f} ms: attention kernels {ours_ms:.1f} ms ("
        + ", ".join(f"{k} {ms:.1f} ms x{n}" for k, (ms, n) in ours.items())
        + f"), cuBLAS GEMMs {gemm_ms:.1f} ms, cuDNN convolutions "
        f"{conv_ms:.1f} ms, everything else "
        f"{kernel_ms - ours_ms - gemm_ms - conv_ms:.1f} ms")
    for ms, count, name in kernels[:15]:
        log(f"[profile]   {ms:9.3f} ms  {count:5d} x  {name[:110]}")
    return 1 - busy_ms / wall_ms


def dit_pass_bytes(L, D, hd):
    """Bytes each fused DiT pass reads once and writes once over a batch-1
    [L, D] stream (fp32 4 B, bf16 2 B an element), its modulation rows,
    norm parameters (bf16) and RoPE tables [L, hd / 2] (fp32) included."""
    n, row = L * D, 4 * D
    return {"ln_modulate": 6 * n + 2 * row,
            "qk_norm_rope": 8 * n + 4 * D + 2 * 4 * L * (hd // 2),
            "qk_norm_rope_q": 4 * n + 2 * D,
            "gate_residual_ln": 12 * n + row + 4 * D,
            "residual_ln_modulate": 12 * n + 2 * row,
            "gate_residual": 10 * n + row}


def bf16_gate(got, want, mag=None, ulps=1, atol=1e-5):
    """(the worst excess over ``ulps`` bf16 ulps of ``mag`` (default: the
    larger magnitude of the two) plus ``atol``, the share of elements that
    differ at all): tests/test_torch_cuda.py's gate of the fused passes."""
    import torch
    g, w = got.float(), want.float()
    if mag is None:
        mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    diff = (g - w).abs()
    return ((diff - ulps * ulp - atol).max().item(),
            (diff > 0).float().mean().item())


def dit_fused_phase(widths, L, eps=1e-6):
    """The DiT block's five fused passes (`ops/dit_fused.py`) at each
    (width, heads) of ``widths`` over L tokens: each held against its plain
    steps on the card (the stream bit for bit; bf16 outputs within one bf16
    ulp, after RoPE three of the pair's norm, and differing in at most
    DIT_SHARE of the elements), then timed (CUDA events, median of 10)
    against the bound of its bytes once, beside the plain steps; and one
    block's chain under torch.profiler, after a warm-up kernel (a trace may
    miss its first kernel), which must show the five kernels under their
    own names (the q/k pass twice) and no other but the warm-up's. Returns
    {width: {pass: timing row}}."""
    import torch
    from videocof_torch.ops import dit_fused as df
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rec = {}
    for D, N in widths:
        hd = D // N
        g = torch.Generator(device=dev).manual_seed(SEED + D)

        def randn(*shape, dtype=torch.float32, scale=1.0):
            return (scale * torch.randn(*shape, generator=g, device=dev)
                    ).to(dtype)

        x, y = randn(1, L, D, scale=2.0), randn(1, L, D, dtype=bf16)
        e = randn(1, 6, D, scale=0.1)
        e_ = [e[:, i][:, None, :] for i in range(6)]
        q, k = randn(1, L, D, dtype=bf16), randn(1, L, D, dtype=bf16)
        w = 1.0 + randn(D, dtype=bf16, scale=0.1)
        b = randn(D, dtype=bf16, scale=0.1)
        ang = randn(L, hd // 2, scale=3.0)
        cos, sin = torch.cos(ang), torch.sin(ang)
        pair_norm = None
        runs = {
            "ln_modulate": (
                lambda: df.ln_modulate(x, e_[0], e_[1], eps),
                lambda: df.ln_modulate_reference(x, e_[0], e_[1], eps)),
            "qk_norm_rope": (
                lambda: df.qk_norm_rope(q, k, w, w, eps, cos, sin),
                lambda: df.qk_norm_rope_reference(q, k, w, w, eps, cos,
                                                  sin)),
            "qk_norm_rope_q": (
                lambda: df.qk_norm_rope(q, None, w, None, eps),
                lambda: df.qk_norm_rope_reference(q, None, w, None, eps)),
            "gate_residual_ln": (
                lambda: df.gate_residual_ln(x, y, e_[2], eps, w, b),
                lambda: df.gate_residual_ln_reference(x, y, e_[2], eps, w,
                                                      b)),
            "residual_ln_modulate": (
                lambda: df.residual_ln_modulate(x, y, e_[3], e_[4], eps),
                lambda: df.residual_ln_modulate_reference(x, y, e_[3],
                                                          e_[4], eps)),
            "gate_residual": (
                lambda: df.gate_residual(x, y, e_[5]),
                lambda: df.gate_residual_reference(x, y, e_[5])),
        }
        nbytes = dit_pass_bytes(L, D, hd)
        shape = f"B=1 L={L} D={D} ({N} heads of {hd})"
        rec[D] = {}
        for name, (kernel_fn, plain_fn) in runs.items():
            got, want = kernel_fn(), plain_fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            worst, share = -1.0, 0.0
            for a, r in zip(got, want):
                if r is None:
                    continue
                if r.dtype == torch.float32:          # the stream
                    if not torch.equal(a, r):
                        fail(f"dit {name} at {shape}: the stream differs "
                             "from the plain steps'")
                    continue
                if name == "qk_norm_rope":
                    p = r.float().view(1, L, D // 2, 2)
                    pair_norm = p.norm(dim=-1, keepdim=True).expand_as(
                        p).reshape(1, L, D)
                    a_w, a_s = bf16_gate(a, r, mag=pair_norm, ulps=3)
                else:
                    a_w, a_s = bf16_gate(a, r)
                worst, share = max(worst, a_w), max(share, a_s)
            if worst > 0 or share > DIT_SHARE:
                fail(f"dit {name} at {shape}: {worst:.3e} beyond its ulps, "
                     f"{share:.3e} of the elements differ")
            del got, want
            ms = cuda_ms(kernel_fn, runs=10)
            plain_ms = cuda_ms(plain_fn, runs=10)
            bound_ms = nbytes[name] / PEAK_BYTES * 1e3
            rec[D][name] = dict(shape=shape, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by="bytes",
                                bytes=nbytes[name], differ_share=share)
            log(f"[timing] dit {name} {shape}: kernel_ms {ms:.4f} bound_ms "
                f"{bound_ms:.4f} (bytes, {nbytes[name] / 1e6:.1f} MB) "
                f"plain_ms {plain_ms:.4f} (share of bound "
                f"{bound_ms / ms:.1%}, {nbytes[name] / ms / 1e6:.0f} GB/s; "
                f"{share:.2e} of the bf16 outputs differ from the plain)")
        chain = ("ln_modulate", "qk_norm_rope", "gate_residual_ln",
                 "qk_norm_rope_q", "residual_ln_modulate",
                 "gate_residual")
        block = {key: sum(rec[D][n][key] for n in chain)
                 for key in ("ms", "plain_ms", "bound_ms")}
        rec[D]["block"] = block
        log(f"[timing] dit one block's chain {shape}: kernels "
            f"{block['ms']:.4f} ms, bound {block['bound_ms']:.4f} ms "
            f"({block['bound_ms'] / block['ms']:.1%}), plain steps "
            f"{block['plain_ms']:.4f} ms")

        def one_chain():
            # a first kernel of its own: the trace may miss the first one
            torch.zeros(1, device=dev)
            for n in chain:
                runs[n][0]()

        _, busy_ms, prof = profile_kernels(one_chain, tries=3)
        seen = {}
        for ms, n, kname in prof:
            key = next((k for k in df.KERNEL_NAMES if k in kname), kname)
            seen[key] = (seen.get(key, (0.0, 0))[0] + ms,
                         seen.get(key, (0.0, 0))[1] + n)
        want_n = dict.fromkeys(df.KERNEL_NAMES, 1)
        want_n["dit_qk_norm_rope_kernel"] = 2
        ours = {k: v[1] for k, v in seen.items() if k in want_n}
        others = sum(v[1] for k, v in seen.items() if k not in want_n)
        if busy_ms <= 0.0:
            fail(f"one block's fused chain at {shape} under torch.profiler "
                 "recorded no device events: its kernels cannot be shown")
        if ours != want_n or others > 1:
            fail(f"one block's fused chain at {shape} launched {seen}, "
                 f"expected {want_n} and at most the warm-up's kernel")
        seen = {k: v for k, v in seen.items() if k in want_n}
        log(f"[timing] dit one block's chain under torch.profiler {shape}: "
            + ", ".join(f"{k} {ms:.4f} ms x{n}"
                        for k, (ms, n) in seen.items()))
        rec[D]["profile"] = {k: v[0] for k, v in seen.items()}
        del x, y, e, e_, q, k, w, b, cos, sin, pair_norm, runs
        torch.cuda.empty_cache()
    return rec


def check_dit_fused(tag, calls):
    """Fail unless each of the ``calls`` block calls since the last
    `dit_fused.reset_counts` took the fused passes and each pass launched
    once a call (the q/k pass once with k, for the self-attention, and once
    with q alone, for the cross-attention's q). Returns the launches by
    pass."""
    from videocof_torch.ops import dit_fused as df
    blocks, launches = df.block_counts(), df.launch_counts()
    if blocks != {"fused": calls, "plain": 0}:
        fail(f"{tag}: block calls by path {blocks}, expected {calls} fused")
    if launches != dict.fromkeys(launches, calls):
        fail(f"{tag}: the fused passes launched {launches}, expected {calls} "
             "each")
    log(f"[{tag}] block calls by path {blocks}; the fused passes' launches "
        f"{launches}")
    return launches


def dit_step_flops(cfg, L, Lt):
    """FLOP of one DiT forward at L tokens and Lt text tokens: the matmuls
    and attention of the blocks, patch embed and head (the text MLP, norms
    and elementwise work are left out)."""
    d, f = cfg.dim, cfg.ffn_dim
    per_block = (2 * L * d * d * 4            # self q, k, v, o
                 + 2 * L * d * d * 2          # cross q, o
                 + 2 * Lt * d * d * 2         # cross k, v
                 + 2 * L * d * f * 2          # FFN
                 + 4 * L * L * d              # self attention
                 + 4 * L * Lt * d)            # cross attention
    pt, ph, pw = cfg.patch_size
    io = 2 * L * d * pt * ph * pw * (cfg.in_dim + cfg.out_dim)  # embed, head
    return cfg.num_layers * per_block + io


@contextlib.contextmanager
def shallow_1_3b(layers):
    """The factory's default DiT (Wan2.1 T2V 1.3B) cut to its first
    ``layers`` layers, at full width, while the block runs."""
    from videocof_torch import factory
    real = factory.WAN21_T2V_1_3B
    factory.WAN21_T2V_1_3B = real.replace(num_layers=layers)
    try:
        yield factory.WAN21_T2V_1_3B
    finally:
        factory.WAN21_T2V_1_3B = real


def first_layers(dit, n):
    """A DiT holding ``dit``'s first ``n`` blocks (the same tensors: nothing
    is copied)."""
    from torch import nn
    cut = nn.Module.__new__(type(dit))
    cut.__dict__ = dict(dit.__dict__, _modules=dict(dit._modules))
    cut.blocks = nn.ModuleList(dit.blocks[:n])
    cut.cfg = dit.cfg.replace(num_layers=n)
    return cut


def fingerprint(t):
    """Two int64 sums over a tensor's bits (plain and position-weighted):
    any change of its values changes them but by a vanishing chance."""
    import torch
    bits = t.detach().reshape(-1).view(
        {2: torch.int16, 4: torch.int32}[t.element_size()]).long()
    pos = torch.arange(bits.numel(), device=t.device) % 65521 + 1
    return bits.sum().item(), (bits * pos).sum().item()


def draw_unmerged(cfg, dev):
    """The DiT that `factory.load_pipeline(random_init=True, seed=SEED)`
    draws before it merges any LoRA file (the DiT first, in bf16, from a
    generator seeded with the seed)."""
    import torch
    from videocof_torch.models.wan_dit import init_wan_dit
    return init_wan_dit(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        torch.bfloat16, dev)


def changed_weights(dit, prints):
    """Names of ``dit``'s tensors whose fingerprints differ from
    ``prints``."""
    return {k for k, v in dit.state_dict().items()
            if fingerprint(v) != prints[k]}


def environment():
    """What the machine offers the entry's file and video I/O: the versions
    of the modules it could import (None: absent), ffmpeg on PATH, the libav
    headers, and the free disk beside the checkout."""
    import importlib
    import torch
    mods = {}
    for name in ("safetensors", "cv2", "PIL", "transformers",
                 "sentencepiece", "tokenizers", "imageio", "av", "decord"):
        try:
            mods[name] = getattr(importlib.import_module(name), "__version__",
                                 "?")
        except ImportError:
            mods[name] = None
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "modules": mods,
            "ffmpeg": shutil.which("ffmpeg"),
            "libav_headers": any(Path(d, "libavformat").is_dir() for d in (
                "/usr/include", "/usr/local/include",
                "/usr/include/x86_64-linux-gnu")),
            "disk_free_gb": shutil.disk_usage(ROOT).free / 1e9}


def write_lora_files(cfg, gen, out_dir):
    """Two rank-32 bf16 LoRA files over all ten linears of every block of
    ``cfg``, written by the port's writer: a kohya-format "FusionX" file
    (``lora_unet_*``, alpha 16) and a PEFT-format "VideoCoF" file (bare
    ``lora_A``/``lora_B``, no alpha). Returns their paths and the port's
    names of the modules they touch."""
    import torch
    from videocof_torch.models.weights import DIT_BLOCK_NAMES
    from videocof_torch.utils.checkpoint import write_safetensors
    d, f = cfg.dim, cfg.ffn_dim
    dims = {"ffn.0": (d, f), "ffn.2": (f, d)}
    kohya, peft = {}, {}
    for i in range(cfg.num_layers):
        for src in DIT_BLOCK_NAMES:
            din, dout = dims.get(src, (d, d))
            for sd, down, up in ((kohya, "lora_down", "lora_up"),
                                 (peft, "lora_A", "lora_B")):
                a = torch.randn(LORA_RANK, din, generator=gen,
                                device=gen.device) / din ** 0.5
                b = 0.02 * torch.randn(dout, LORA_RANK, generator=gen,
                                       device=gen.device)
                if sd is kohya:
                    base = "lora_unet_" + f"blocks.{i}.{src}".replace(".", "_")
                    sd[f"{base}.{down}.weight"] = a.to(torch.bfloat16)
                    sd[f"{base}.{up}.weight"] = b.to(torch.bfloat16)
                    sd[f"{base}.alpha"] = torch.tensor(LORA_ALPHA)
                else:
                    sd[f"blocks.{i}.{src}.{down}.weight"] = a.to(torch.bfloat16)
                    sd[f"blocks.{i}.{src}.{up}.weight"] = b.to(torch.bfloat16)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = (str(out_dir / "fusionx_lora.safetensors"),
             str(out_dir / "videocof_lora.safetensors"))
    for path, sd in zip(paths, (kohya, peft)):
        write_safetensors(path, sd)
    names = {f"blocks.{i}.{dst}" for i in range(cfg.num_layers)
             for dst in DIT_BLOCK_NAMES.values()}
    return paths, names


def compare(name, got, want, quiet=False, rel_tol=REL_TOL):
    """Gate ``got`` against ``want``: finite, max abs error <= TOL *
    max(1, max |want|) (a few bf16 ulps of the largest value: gradients can
    exceed 1) and relative L2 error <= rel_tol (None: not gated); returns
    (max abs err, relative L2 err). ``quiet`` logs only a failure."""
    import torch
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / want.float().norm()).item()
    top = want.float().abs().max().item()
    tol = TOL * max(1.0, top)
    ok = (bool(torch.isfinite(got).all()) and err <= tol
          and (rel_tol is None or rel <= rel_tol))
    if not (quiet and ok):
        log(f"[kernel vs plain] {name}: max abs err {err:.3e} (tol "
            f"{tol:.3g}), relative L2 err {rel:.3e} (tol {rel_tol}), max "
            f"|plain| {top:.3e}: {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"kernel disagrees with its plain version: {name}")
    return err, rel


def round_trip_phase(dit):
    """Write ``dit`` to the published layout (two shards, their index, a
    config.json) with the port's writer, read it back to its device with
    the port's reader and converter, and fail unless every tensor and the
    config come back equal. Returns the read's GB/s."""
    import torch
    from videocof_torch.models import weights
    from videocof_torch.utils import checkpoint
    cfg = dit.cfg
    dev = next(dit.parameters()).device
    dtype = dit.patch_embed.weight.dtype
    ckpt = SCRATCH / "dit_checkpoint"
    t0 = time.perf_counter()
    nbytes = checkpoint.save_dit_checkpoint_dir(str(ckpt), dit, cfg,
                                                num_shards=2)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read_cfg = weights.dit_config_from_checkpoint(str(ckpt))
    read = {k: v.to(dev) for k, v in weights.convert_dit_state_dict(
        weights.load_state_dict(str(ckpt)), read_cfg, dtype).items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want = dit.state_dict()
    shards = sorted(p.name for p in ckpt.glob("*.safetensors"))
    same = (set(read) == set(want) and all(
        read[k].dtype == v.dtype and torch.equal(read[k], v)
        for k, v in want.items()))
    log(f"[entry] the DiT to the published layout: {shards}, "
        f"{nbytes / 1e9:.3f} GB written in {write_s:.2f} s; read back to the "
        f"device (mapped files, from the page cache) in {read_s:.2f} s, "
        f"{nbytes / read_s / 1e9:.2f} GB/s; config == the DiT's: "
        f"{read_cfg == cfg}; {len(read)} tensors bit for bit: "
        f"{'ok' if same else 'FAIL'}")
    if read_cfg != cfg:
        fail(f"dit_config_from_checkpoint gave {read_cfg}")
    if not same:
        fail("the DiT read back from the published layout differs")
    shutil.rmtree(ckpt)
    return nbytes / read_s / 1e9


def entry_phase(card, dcfg, geo, gen, prompt, want_shape, want_launches,
                counters):
    """`fast_infer.main()` in this process with random weights (the
    factory's default, ``dcfg``) and two LoRA files merged, on a clip
    written with cv2. Fails unless the output, its files, the launches
    (``counters``: read, reset) and the merge are right: the CLI hands the
    factory both LoRA files, in order, and exactly the weights they name
    differ from an unmerged draw. Returns the phase's record."""
    import numpy as np
    import torch
    from videocof_torch.cli import fast_infer
    from videocof_torch.utils import video_io
    launch_counts, reset_launch_counts = counters
    (fusionx, videocof), names = write_lora_files(dcfg, gen, SCRATCH)
    base = draw_unmerged(dcfg, gen.device)
    prints = {k: fingerprint(v) for k, v in base.state_dict().items()}
    del base
    out_dir = SCRATCH / "out"
    clip = write_clip("entry", geo)
    argv = ["--video_path", str(clip), "--prompt", prompt, "--output_dir",
            str(out_dir), "--random_init", "--repeat_rope", "--height",
            str(geo.height), "--width", str(geo.width), "--source_frames",
            str(geo.source_frames), "--reasoning_frames",
            str(geo.reasoning_frames), "--num_inference_steps",
            str(geo.num_inference_steps), "--seed", str(SEED),
            "--enable_acceleration_lora", "--acceleration_lora_path", fusionx,
            "--videocof_path", videocof]
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_loads() as built:
        arrays = fast_infer.main(argv).get(clip.name)
    entry_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    if arrays is None:
        fail("fast_infer.main() edited no item")
    if len(built) != 1:
        fail(f"the entry built {len(built)} pipelines, expected 1")
    lora_paths, pipe = built.pop()
    changed = changed_weights(pipe.dit, prints)
    want_changed = {f"{n}.weight" for n in names}
    del pipe, prints
    log(f"[entry] LoRA files handed to the factory: {lora_paths}; weights "
        f"changed from the unmerged draw: {len(changed)}, the files name "
        f"{len(want_changed)}: {changed == want_changed}")
    if lora_paths != [fusionx, videocof]:
        fail(f"the entry merged {lora_paths}, expected {[fusionx, videocof]}")
    if changed != want_changed:
        fail(f"the entry's merge changed {sorted(changed ^ want_changed)[:5]}")
    vid = arrays["reason_edit"]
    log(f"[entry] output {vid.shape} min {vid.min():.4f} max {vid.max():.4f};"
        f" {entry_s:.3f} s (weights drawn, 2 LoRA files merged, decode, "
        f"edit, encode); peak {peak_gb} GB; launches {launches}")
    if vid.shape != want_shape or arrays["edit"].shape[2] != geo.source_frames:
        fail(f"entry output {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail("entry output frames not finite or outside [0, 1]")
    if launches != want_launches:
        fail(f"the entry launched {launches}, expected {want_launches}")
    files = sorted(p.name for p in out_dir.glob("*"))
    want_files = [f"gen_{clip.stem}{s}" for s in (
        ".mp4", "_compare.mp4", "_info.txt", "_reason_edit.mp4")]
    info = video_io.video_info(str(out_dir / f"gen_{clip.stem}.mp4"))
    log(f"[entry] files {files}; gen_{clip.stem}.mp4: {info[0]} frames "
        f"of {info[1]}x{info[2]}")
    if files != want_files or info[:3] != (geo.source_frames, geo.height,
                                           geo.width):
        fail(f"entry files {files}, {info}")
    if fast_infer.main(argv):
        fail("the resumed entry edited an item again")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    return {"card": card, "seconds": entry_s, "peak_memory_gb": peak_gb,
            "launches": launches, "files": files}


def edit_14b_phase(card, cfg14, geo, gen, video, prompt, want_shape,
                   want_launches, counters):
    """The 14B edit: `factory.load_pipeline("", random_init=True,
    dit_cfg=cfg14)` with two LoRA files at ``cfg14``'s shapes (written to
    LORA_DIR, kept for the fp8 and serving phases); the merged weights
    against fingerprints of a second, unmerged draw (and the two merges
    recomputed on two modules); the 4-step edit of ``video`` (output, launches: 2 x
    layers x steps of B1 and nothing else, every block call through the
    DiT's fused passes, stage walls, peak memory); one DiT step under
    torch.profiler. Returns (the edit's launches, its final latents on the
    host, the two LoRA files' paths, the fused passes' launches by pass,
    None off CUDA)."""
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.configs import WanVAEConfig
    from videocof_torch.models import weights
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    from videocof_torch.ops import dit_fused as df
    from videocof_torch.pipeline import latent_frame_count
    launch_counts, reset_launch_counts = counters
    dev, bf16 = gen.device, torch.bfloat16
    cuda = dev.type == "cuda"
    (fusionx, videocof), names = write_lora_files(cfg14, gen, LORA_DIR)
    # the unmerged weights, drawn as the factory draws them (the DiT first,
    # from a generator seeded with the seed), kept as fingerprints
    t0 = time.perf_counter()
    base = draw_unmerged(cfg14, dev)
    prints = {k: fingerprint(v) for k, v in base.state_dict().items()}
    spot = ("blocks.0.self_attn.q.weight",
            f"blocks.{cfg14.num_layers - 1}.ffn.fc2.weight")
    kept = {k: base.state_dict()[k].clone() for k in spot}
    del base
    if cuda:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    pipe = factory.load_pipeline("", random_init=True, dit_cfg=cfg14,
                                 seed=SEED, lora_paths=[(fusionx, 1.0),
                                                        (videocof, 1.0)])
    if cuda:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    sd = pipe.dit.state_dict()
    changed = changed_weights(pipe.dit, prints)
    want_changed = {f"{n}.weight" for n in names}
    # the two merges in order, recomputed on the kept modules
    files = [weights.load_state_dict(p) for p in (fusionx, videocof)]
    exact = True
    for k in spot:
        mod = k[:-len(".weight")]
        i = int(mod.split(".")[1])
        src = next(a for a, b in weights.DIT_BLOCK_NAMES.items()
                   if mod.endswith("." + b))
        w = kept[k]
        for lora_sd, key, (down, up), scale in (
                (files[0], f"lora_unet_blocks_{i}_{src.replace('.', '_')}",
                 ("lora_down", "lora_up"), LORA_ALPHA / LORA_RANK),
                (files[1], f"blocks.{i}.{src}", ("lora_A", "lora_B"), 1.0)):
            a = lora_sd[f"{key}.{down}.weight"].to(dev).float()
            b = lora_sd[f"{key}.{up}.weight"].to(dev).float()
            w = (w.float() + 1.0 * scale * (b @ a)).to(w.dtype)
        exact = exact and torch.equal(w, sd[k])
    log(f"[edit 14B] LoRA files (rank {LORA_RANK}, bf16, {len(names)} modules "
        f"each) merged while building the pipeline in {build_s:.1f} s "
        f"(unmerged draw and fingerprints {t1 - t0:.1f} s); weights changed: "
        f"{len(changed)}, the files name {len(want_changed)}: "
        f"{changed == want_changed}; the two merges recomputed on {spot}: "
        f"{'ok' if exact else 'FAIL'}")
    if changed != want_changed:
        fail(f"the merge changed {sorted(changed ^ want_changed)[:5]}")
    if not exact:
        fail("the merged weights differ from the recomputed merges")
    del sd, kept, files, prints

    timings = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    df.reset_counts()
    t0 = time.perf_counter()
    out = pipe(video, prompt, source_frames=geo.source_frames,
               reasoning_frames=geo.reasoning_frames,
               num_inference_steps=geo.num_inference_steps,
               guidance_scale=geo.guidance_scale, shift=geo.shift,
               sampler=geo.sampler, repeat_rope=geo.repeat_rope, cot=geo.cot,
               seed=geo.seed, timings=timings, output_latents=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    dit_launches = (check_dit_fused("edit 14B", cfg14.num_layers
                                    * geo.num_inference_steps)
                    if cuda else None)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    want = dict(want_launches, flash_attention_fwd=(
        2 * cfg14.num_layers * geo.num_inference_steps))
    vid = out.videos
    log(f"[edit 14B] output {vid.shape} min {vid.min():.4f} max "
        f"{vid.max():.4f}")
    if vid.shape != want_shape:
        fail(f"14B output shape {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail("14B output frames not finite or outside [0, 1]")
    if launches != want:
        fail(f"the 14B edit launched {launches}, expected {want}")
    vcfg = WanVAEConfig()
    tc, sc = vcfg.temporal_compression_ratio, vcfg.spatial_compression_ratio
    cond = latent_frame_count(geo.source_frames, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    _, ph, pw = cfg14.patch_size
    grid = (2 * cond + ground, geo.height // sc // ph, geo.width // sc // pw)
    L, Lt = grid[0] * grid[1] * grid[2], cfg14.text_len
    flops = dit_step_flops(cfg14, L, Lt)
    steps = [timings[f"step{i}"] for i in range(geo.num_inference_steps)]
    log("[edit 14B] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[edit 14B] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb} GB; launches {launches}; DiT {flops:.3e} FLOP/step, "
        f"{flops / statistics.median(steps) / 1e12:.1f} TFLOP/s (median "
        f"step)")
    latents = out.latents
    del out, vid
    # one DiT step of the edit's geometry under torch.profiler
    x = torch.randn(1, cfg14.in_dim, grid[0], geo.height // sc,
                    geo.width // sc, generator=gen, device=dev).to(bf16)
    ctx = torch.randn(1, Lt, cfg14.text_dim, generator=gen, device=dev
                      ).to(bf16)
    cos, sin = (torch.as_tensor(arr, device=dev) for arr in
                make_rope_for_geometry(cfg14, grid, f_src=cond,
                                       f_ground=ground))
    t = torch.full((1,), 937.0, device=dev)
    prof = None
    if cuda:
        with torch.no_grad():
            prof = profile_kernels(lambda: pipe.dit(x, t, ctx, cos, sin))
        report_profile(f"one 14B DiT step at {L} tokens", *prof)
    log("[edit 14B] " + json.dumps({
        "card": card, "seconds_per_edit": wall, "stages_s": timings,
        "peak_memory_gb": peak_gb, "dit_flop_per_step": flops,
        "launches": launches, "build_s": build_s,
        "profiled_step": prof and {"wall_ms": prof[0], "busy_ms": prof[1]}}))
    return launches, latents, (fusionx, videocof), dit_launches


def write_clip(tag, geo):
    """Write CLIP_FRAMES random uint8 frames (seed SEED) at the geometry's
    size as an mp4v clip with cv2, the codec the port's video I/O reads
    with; fails unless cv2 is importable and writes it. Returns its path."""
    import numpy as np
    try:
        import cv2
    except ImportError:
        fail(f"{tag}: cv2 is not importable; the port's video I/O needs it")
    SCRATCH.mkdir(parents=True, exist_ok=True)
    clip = SCRATCH / "clip.mp4"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"), 16,
                             (geo.width, geo.height))
    frames = np.random.default_rng(SEED).integers(
        0, 256, (CLIP_FRAMES, geo.height, geo.width, 3), dtype=np.uint8)
    for fr in frames:
        writer.write(fr)
    writer.release()
    if not clip.exists():
        fail(f"{tag}: cv2 {cv2.__version__} wrote no mp4v clip")
    log(f"[{tag}] cv2 {cv2.__version__}: a {CLIP_FRAMES}-frame "
        f"{geo.height}x{geo.width} mp4v clip")
    return clip


@contextlib.contextmanager
def recorded_loads(**override):
    """Record (the LoRA paths it was handed, the pipeline) of every
    `factory.load_pipeline` call while the block runs; ``override``
    replaces arguments of each call."""
    from videocof_torch import factory
    real, built = factory.load_pipeline, []

    def load_recorded(*a, **kw):
        pipe = real(*a, **{**kw, **override})
        built.append(([p for p, _ in kw.get("lora_paths") or ()], pipe))
        return pipe
    factory.load_pipeline = load_recorded
    try:
        yield built
    finally:
        factory.load_pipeline = real


@contextlib.contextmanager
def b1_calls():
    """Record (batch, Lq, Lk, the key mask or None, heads) of every call of
    B1's wrapper body (`flash_attention._forward_b1`, which launches the
    kernel on a CUDA tensor) while the block runs; the masks are read
    afterwards, so the run is not synchronized per call."""
    from videocof_torch.ops import flash_attention as fa
    real, seen = fa._forward_b1, []

    def spy(q, k, v, kv_mask, scale):
        seen.append((q.shape[0], q.shape[1], k.shape[1], kv_mask,
                     q.shape[2]))
        return real(q, k, v, kv_mask, scale)
    fa._forward_b1 = spy
    try:
        yield seen
    finally:
        fa._forward_b1 = real


def b1_shapes(seen):
    """{(batch, Lq, Lk, valid keys of each row or None): calls} of a
    `b1_calls` record."""
    shapes = {}
    for B, Lq, Lk, mask, _ in seen:
        key = (B, Lq, Lk, None if mask is None
               else tuple(mask.sum(dim=1).tolist()))
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def check_video(tag, vid, want_shape):
    """Fail unless ``vid`` has ``want_shape`` and finite values in [0, 1]."""
    import numpy as np
    log(f"[{tag}] output {vid.shape} min {vid.min():.4f} max {vid.max():.4f}")
    if vid.shape != want_shape:
        fail(f"{tag} output shape {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail(f"{tag} output frames not finite or outside [0, 1]")


def check_launches(tag, launches, want):
    if launches != want:
        fail(f"the {tag} launched {launches}, expected {want}")


def extrapolation_phase(card, pipe, geo, gen, prompt, counters,
                        want_launches):
    """The 4x length-extrapolation edit: a uint8 clip of EXTRAP_FRAMES
    frames (4x the 33-frame clip: 34 latent frames) with 4 reasoning frames,
    4 Flow-UniPC steps, repeat RoPE and RIFLEx (k 6, the default L_test), the
    VAE streamed; the output, the launches (2 x layers x steps of B1 and
    nothing else), stage walls and peak memory; then one DiT step of its
    geometry under torch.profiler. Returns (the clip, the phase's
    record, its final latents and uint8 frames)."""
    import numpy as np
    import torch
    from videocof_torch.models.rope import riflex_angle_table
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    from videocof_torch.pipeline import latent_frame_count
    launch_counts, reset_launch_counts = counters
    dcfg, dev = pipe.dit.cfg, pipe.device
    cuda = dev.type == "cuda"
    tc = pipe.vae.cfg.temporal_compression_ratio
    sc = pipe.vae.cfg.spatial_compression_ratio
    video = np.random.default_rng(SEED).integers(
        0, 256, (1, 3, EXTRAP_FRAMES, geo.height, geo.width), dtype=np.uint8)
    cond = latent_frame_count(EXTRAP_FRAMES, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    _, ph, pw = dcfg.patch_size
    grid = (2 * cond + ground, geo.height // sc // ph, geo.width // sc // pw)
    L = grid[0] * grid[1] * grid[2]
    log(f"[4x edit] {EXTRAP_FRAMES} source frames: {grid[0]} latent frames "
        f"({cond} + {ground} + {cond}), {L} DiT tokens; RIFLEx k "
        f"{RIFLEX_K}, L_test 66 (the default)")
    timings = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen:
        out = pipe(video, prompt, source_frames=EXTRAP_FRAMES,
                   reasoning_frames=geo.reasoning_frames,
                   num_inference_steps=geo.num_inference_steps,
                   shift=geo.shift, sampler=geo.sampler, repeat_rope=True,
                   seed=geo.seed, riflex_k=RIFLEX_K, timings=timings,
                   output_latents=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    shapes = b1_shapes(seen)
    # phase 21's ring edit is held against this one
    ref = {"latents": out.latents,
           "u8": np.round(out.videos * 255).astype(np.uint8)}
    per_layer = dcfg.num_layers * geo.num_inference_steps
    check_video("4x edit", out.videos, (1, 3, 1 + (ground - 1) * tc
                                         + EXTRAP_FRAMES, geo.height,
                                         geo.width))
    check_launches("4x edit", launches, want_launches)
    want_shapes = {(1, L, L, None): per_layer,
                   (1, L, TEXT_TOKENS, None): per_layer}
    if shapes != want_shapes:
        fail(f"the 4x edit's B1 calls {shapes} != {want_shapes}")
    flops = dit_step_flops(dcfg, L, TEXT_TOKENS)
    steps = [timings[f"step{i}"] for i in range(geo.num_inference_steps)]
    log("[4x edit] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[4x edit] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb} GB; launches {launches}; DiT {flops:.3e} FLOP/step, "
        f"{flops / statistics.median(steps) / 1e12:.1f} TFLOP/s (median "
        f"step)")
    del out
    x = torch.randn(1, dcfg.in_dim, grid[0], geo.height // sc,
                    geo.width // sc, generator=gen, device=dev).to(pipe.dtype)
    ctx = torch.randn(1, TEXT_TOKENS, dcfg.text_dim, generator=gen,
                      device=dev).to(pipe.dtype)
    table = riflex_angle_table(dcfg.head_dim, RIFLEX_K, 66,
                               max_pos=dcfg.rope_max_pos,
                               theta=dcfg.rope_theta)
    cos, sin = (torch.as_tensor(a, device=dev) for a in make_rope_for_geometry(
        dcfg, grid, f_src=cond, f_ground=ground, temporal_table=table))
    t = torch.full((1,), 937.0, device=dev)
    prof = None
    if cuda:
        with torch.no_grad():
            prof = profile_kernels(lambda: pipe.dit(x, t, ctx, cos, sin))
        report_profile(f"one DiT step of the 4x edit at {L} tokens", *prof)
    record = {"card": card, "tokens": L, "seconds_per_edit": wall,
              "stages_s": timings, "peak_memory_gb": peak_gb,
              "dit_flop_per_step": flops, "launches": launches,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "b1_launches": {"4x self": shapes.get((1, L, L, None), 0),
                              "4x cross": shapes.get(
                                  (1, L, TEXT_TOKENS, None), 0)},
              "profiled_step": prof and {"wall_ms": prof[0],
                                         "busy_ms": prof[1]}}
    log("[4x edit] " + json.dumps(record))
    return video, record, ref


def ragged_phase(card, pipe, geo, prompt, items, counters, want_launches):
    """The ragged batch: `batch_edit` over two items of different lengths
    (``items``: uint8 clips [1, 3, T_i, H, W]) as one batch of 2, seeds 0
    and 1; the launches (2 x layers x steps of B1 at batch 2, the
    self-attention ones with the batch's key mask, and nothing else),
    seconds and peak memory; each item's final latents against its own
    `pipe()` run with the same seed, so the same noise (relative L2 <=
    RAGGED_REL_TOL). Returns (the phase's record, item 0's own final
    latents)."""
    import numpy as np
    import torch
    from videocof_torch.pipeline import batch_edit, latent_frame_count
    launch_counts, reset_launch_counts = counters
    dcfg, dev = pipe.dit.cfg, pipe.device
    cuda = dev.type == "cuda"
    tc = pipe.vae.cfg.temporal_compression_ratio
    sc = pipe.vae.cfg.spatial_compression_ratio
    ground = latent_frame_count(geo.reasoning_frames, tc)
    _, ph, pw = dcfg.patch_size
    frames = [v.shape[2] for v in items]
    tokens = [(2 * latent_frame_count(f, tc) + ground) * (geo.height // sc
              // ph) * (geo.width // sc // pw) for f in frames]
    embeds = pipe.encode_prompt([prompt])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen:
        outs = batch_edit(pipe, [v[0] for v in items], frames,
                          [embeds] * len(items),
                          reasoning_frames=geo.reasoning_frames,
                          num_inference_steps=geo.num_inference_steps,
                          shift=geo.shift, sampler=geo.sampler, seeds=[0, 1],
                          output_latents=True)
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    shapes = b1_shapes(seen)
    L = max(tokens)
    per_layer = dcfg.num_layers * geo.num_inference_steps
    want_shapes = {(2, L, L, tuple(tokens)): per_layer,
                   (2, L, TEXT_TOKENS, None): per_layer}
    log(f"[ragged] batch_edit of {frames} source frames ({tokens} tokens) as "
        f"one batch of 2: {wall:.3f} s, peak device memory {peak_gb} GB; "
        f"launches {launches}; B1 calls by (batch, Lq, Lk, valid keys per "
        f"row): {shapes}")
    for i, out in enumerate(outs):
        check_video(f"ragged item {i}", out.videos, (
            1, 3, 1 + (ground - 1) * tc + frames[i], geo.height, geo.width))
    check_launches("ragged batch", launches, want_launches)
    if shapes != want_shapes:
        fail(f"the ragged batch's B1 calls {shapes} != {want_shapes}")
    rels, item_s, refs = [], [], []
    for i, out in enumerate(outs):
        t0 = time.perf_counter()
        refs.append(pipe(items[i], prompt, source_frames=frames[i],
                         reasoning_frames=geo.reasoning_frames,
                         num_inference_steps=geo.num_inference_steps,
                         shift=geo.shift, sampler=geo.sampler, seed=i,
                         output_latents=True).latents)
        item_s.append(time.perf_counter() - t0)
        ref = refs[-1]
        rel = float(np.linalg.norm(out.latents - ref) / np.linalg.norm(ref))
        rels.append(rel)
        log(f"[ragged] item {i} ({frames[i]} frames): final latents against "
            f"its own run, relative L2 {rel:.3e} (tol {RAGGED_REL_TOL}): "
            f"{'ok' if rel <= RAGGED_REL_TOL else 'FAIL'}")
        if not rel <= RAGGED_REL_TOL:
            fail(f"ragged item {i} strays from its own run")
    record = {"card": card, "frames": frames, "tokens": tokens,
              "seconds": wall, "peak_memory_gb": peak_gb,
              "launches": launches,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "b1_launches": {"ragged self": shapes.get(
                  (2, L, L, tuple(tokens)), 0)},
              "rel_l2_vs_own_run": rels,
              "own_run_s": item_s}
    log("[ragged] " + json.dumps(record))
    return record, refs[0]


def paired_phase(card, pipe, geo, video, prompt, counters, want_launches):
    """The paired edit (``cot=False``): [source | target] latents, no
    reasoning frames, 4 steps; the output and the launches (2 x layers x
    steps of B1, nothing else). Returns the phase's record."""
    import torch
    launch_counts, reset_launch_counts = counters
    cuda = pipe.device.type == "cuda"
    timings = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(video, prompt, source_frames=geo.source_frames,
               num_inference_steps=geo.num_inference_steps, shift=geo.shift,
               sampler=geo.sampler, repeat_rope=geo.repeat_rope, cot=False,
               seed=geo.seed, timings=timings)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    check_video("paired edit", out.videos, (1, 3, geo.source_frames,
                                            geo.height, geo.width))
    if out.ground_videos is not None:
        fail("the paired edit returned reasoning frames")
    check_launches("paired edit", launches, want_launches)
    record = {"card": card, "seconds_per_edit": wall, "stages_s": timings,
              "peak_memory_gb": peak_gb, "launches": launches}
    log("[paired edit] " + json.dumps(record))
    return record


def vae_phase(card, pipe, video, latents, n_edit):
    """The streaming VAE against the whole-sequence VAE on the 4-step
    edit's clip (encode) and final latents (the decode of the edit segment,
    the last ``n_edit`` latent frames). In the pipeline's dtype: seconds
    (the second of two runs each), peak memory above what was allocated
    before, and the uint8 frames of each. The reference is the
    whole-sequence VAE in fp32 (TF32 is off). Fails unless the streamed VAE
    in fp32 equals it (relative L2 of mu and of the decoded frames <=
    VAE_FP32_REL_TOL), and unless the streamed one in the pipeline's dtype
    strays from it by at most VAE_STREAM_FACTOR times the whole-sequence
    one. Returns the phase's record."""
    import copy
    import torch
    from videocof_torch.models import wan_vae_streaming as stream
    cuda = pipe.device.type == "cuda"
    vae, dtype = pipe.vae, pipe.dtype
    x = pipe._prepare_video(video)
    x32 = torch.as_tensor(video, device=pipe.device).float() * (2 / 255) - 1
    z = torch.as_tensor(latents[:, :, -n_edit:], device=pipe.device)

    def run(fn, runs=2):
        """(result, seconds of the last run, its peak GB above the
        start)."""
        for _ in range(runs):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with torch.no_grad():
                res = fn()
            if cuda:
                torch.cuda.synchronize()
            s = time.perf_counter() - t0
        peak = ((torch.cuda.max_memory_allocated() - base) / 1e9 if cuda
                else None)
        return res, s, peak

    def to_u8(y):
        return torch.round(y.float() * 127.5 + 127.5).to(torch.uint8)

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    def levels(a, b):
        d = (a.int() - b.int()).abs()
        return {"mean": d.float().mean().item(), "max": d.max().item(),
                "share_differing": (d > 0).float().mean().item()}

    enc, dec = pipe.vae_encode_chunk, pipe.vae_decode_chunk
    rows = {
        "encode whole": run(lambda: vae.encode(x)[0]),
        "encode streaming": run(lambda: stream.encode_streaming(
            vae, x, chunk_latent=enc)[0]),
        "decode whole": run(lambda: to_u8(vae.decode(z.to(dtype)))),
        "decode streaming": run(lambda: stream.decode_streaming_u8(
            vae, z, chunk_latent=dec, compute_dtype=dtype)),
    }
    ref_vae = copy.deepcopy(vae).float()
    ref = {  # one run each
        "encode whole": run(lambda: ref_vae.encode(x32)[0], 1),
        "encode streaming": run(lambda: stream.encode_streaming(
            ref_vae, x32, chunk_latent=enc)[0], 1),
        "decode whole": run(lambda: ref_vae.decode(z.float()), 1),
        "decode streaming": run(lambda: stream.decode_streaming(
            ref_vae, z.float(), chunk_latent=dec), 1),
    }
    del ref_vae
    mu32, y32 = ref["encode whole"][0], ref["decode whole"][0]
    u8_32 = to_u8(y32)
    fp32 = {"mu_rel_l2": rel(ref["encode streaming"][0], mu32),
            "frames_rel_l2": rel(ref["decode streaming"][0], y32),
            "u8": levels(to_u8(ref["decode streaming"][0]), u8_32)}
    err = {way: {"mu_rel_l2_vs_fp32": rel(rows[f"encode {way}"][0], mu32),
                 "u8_vs_fp32": levels(rows[f"decode {way}"][0], u8_32)}
           for way in ("whole", "streaming")}
    record = {"card": card, "frames": video.shape[2],
              "latent_frames_decoded": z.shape[2], "dtype": str(dtype),
              "mu_rel_l2_streaming_vs_whole": rel(
                  rows["encode streaming"][0], rows["encode whole"][0]),
              "u8_streaming_vs_whole": levels(rows["decode streaming"][0],
                                              rows["decode whole"][0]),
              "fp32_streaming_vs_whole": fp32,
              "vs_fp32_whole": err,
              **{k: {"seconds": s, "peak_gb_above_start": p}
                 for k, (_, s, p) in rows.items()},
              **{f"{k} fp32": {"seconds": s, "peak_gb_above_start": p}
                 for k, (_, s, p) in ref.items()}}
    for k, (_, s, p) in list(rows.items()) + [(f"{k} fp32", v) for k, v in
                                              ref.items()]:
        log(f"[vae] {k}: {s:.3f} s, peak {p} GB above what was allocated")
    log(f"[vae] streaming against whole ({dtype}): mu relative L2 "
        f"{record['mu_rel_l2_streaming_vs_whole']:.3e}; uint8 frames "
        f"{record['u8_streaming_vs_whole']}")
    ok = True
    for key in ("mu_rel_l2", "frames_rel_l2"):
        good = fp32[key] <= VAE_FP32_REL_TOL
        ok = ok and good
        log(f"[vae] fp32 streaming against fp32 whole, {key} {fp32[key]:.3e}"
            f" (tol {VAE_FP32_REL_TOL}): {'ok' if good else 'FAIL'}")
    log(f"[vae] fp32 streaming against fp32 whole, uint8 frames {fp32['u8']}")
    for key, name in (("mu_rel_l2_vs_fp32", "mu relative L2"),
                      ("u8_vs_fp32", "uint8 mean |levels|")):
        w, st = err["whole"][key], err["streaming"][key]
        if isinstance(w, dict):
            w, st = w["mean"], st["mean"]
        good = st <= VAE_STREAM_FACTOR * w
        ok = ok and good
        log(f"[vae] {dtype} against the whole-sequence VAE in fp32, {name}: "
            f"whole {w:.3e}, streaming {st:.3e} (tol {VAE_STREAM_FACTOR} x "
            f"whole): {'ok' if good else 'FAIL'}")
    if not ok:
        fail("the streaming VAE strays from the whole-sequence VAE in fp32")
    log("[vae] " + json.dumps(record))
    return record


def infer_phase(card, geo, prompt, counters):
    """`videocof_torch.cli.infer.main()` in this process with its defaults
    (50 Flow-UniPC steps, guidance 5 against the default negative prompt,
    TeaCache with Wan2.1 T2V 14B's coefficients) on random 1.3B weights
    (the factory's default) and a clip written with cv2; the TeaCache plan
    these weights give, the output and its files, and the launches: 2 x
    layers x computed steps of B1, each at batch 2 (CFG), nothing else.
    Returns the phase's record."""
    import torch
    from videocof_torch.cli import infer
    from videocof_torch.models.teacache import plan_teacache_skips
    from videocof_torch.schedulers import get_scheduler
    launch_counts, reset_launch_counts = counters
    clip, out_dir = write_clip("infer", geo), SCRATCH / "infer_out"
    argv = ["--video_path", str(clip), "--prompt", prompt, "--output_dir",
            str(out_dir), "--random_init", "--repeat_rope", "--height",
            str(geo.height), "--width", str(geo.width), "--seed", str(SEED)]
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_loads() as built, b1_calls() as seen:
        arrays = infer.main(argv).get(clip.name)
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    if arrays is None or len(built) != 1:
        fail(f"infer.main() edited {arrays is not None} item(s) with "
             f"{len(built)} pipelines")
    pipe = built.pop()[1]
    args = infer.parse_args(argv)
    sched = get_scheduler(args.sampler)
    sched.set_timesteps(args.num_inference_steps, shift=args.shift)
    plan = plan_teacache_skips(pipe.dit, sched.timesteps,
                               infer.generation_kwargs(args)[
                                   "teacache_coefficients"],
                               args.teacache_threshold,
                               args.num_skip_start_steps)
    computed = plan.count(False)
    nl = pipe.dit.cfg.num_layers
    del pipe
    shapes = b1_shapes(seen)
    log(f"[infer] TeaCache plan of these random weights (threshold "
        f"{args.teacache_threshold}, {args.num_skip_start_steps} warm-up "
        f"steps, Wan2.1 T2V 14B's coefficients): {sum(plan)} of "
        f"{len(plan)} steps skipped, "
        + "".join("s" if s else "c" for s in plan)
        + f"; {computed} computed")
    want = dict(dict.fromkeys(launches, 0),
                flash_attention_fwd=2 * nl * computed)
    vid = arrays["reason_edit"]
    check_video("infer", vid, (1, 3, 1 + geo.source_frames, geo.height,
                               geo.width))
    log(f"[infer] {wall:.3f} s (weights drawn, decode, 50-step CFG edit, "
        f"encode); peak {peak_gb} GB; launches {launches}; B1 calls by "
        f"(batch, Lq, Lk, mask): {shapes}")
    check_launches("infer CLI", launches, want)
    if {k[0] for k in shapes} != {2}:
        fail(f"the infer CLI's B1 calls are not all at batch 2: {shapes}")
    files = sorted(p.name for p in out_dir.glob("*"))
    want_files = [f"gen_{clip.stem}{s}" for s in (
        ".mp4", "_compare.mp4", "_info.txt", "_reason_edit.mp4")]
    if files != want_files:
        fail(f"infer files {files}")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    record = {"card": card, "seconds": wall, "peak_memory_gb": peak_gb,
              "launches": launches,
              "teacache_plan": "".join("s" if s else "c" for s in plan),
              "computed_steps": computed, "files": files}
    log("[infer] " + json.dumps(record))
    return record


def profile_dit_step(label, dit, grid, cond, ground, seed):
    """One DiT forward at ``grid`` (the chain-of-frames RoPE of ``cond``
    source and ``ground`` reasoning latent frames) on random bf16 inputs
    under torch.profiler; prints the breakdown and returns (wall ms, busy
    ms)."""
    import torch
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    cfg, dev = dit.cfg, next(dit.parameters()).device
    _, ph, pw = cfg.patch_size
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(1, cfg.in_dim, grid[0], grid[1] * ph, grid[2] * pw,
                    generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, TEXT_TOKENS, cfg.text_dim, generator=g,
                      device=dev).to(torch.bfloat16)
    cos, sin = (torch.as_tensor(a, device=dev) for a in make_rope_for_geometry(
        cfg, grid, f_src=cond, f_ground=ground))
    t = torch.full((1,), 937.0, device=dev)
    with torch.no_grad():
        prof = profile_kernels(lambda: dit(x, t, ctx, cos, sin))
    report_profile(f"{label} at {grid[0] * grid[1] * grid[2]} tokens", *prof)
    return {"wall_ms": prof[0], "busy_ms": prof[1]}


def quantized_linears(dit):
    """The linears of ``dit`` that store fp8 weights."""
    import torch
    from videocof_torch.utils.fp8 import is_fp8
    return [m for m in dit.modules()
            if isinstance(m, torch.nn.Linear) and is_fp8(m)]


def fp8_14b_phase(card, cfg14, geo, gen, video, prompt, want_shape,
                  counters, lora_paths, latents_bf16):
    """fp8 weights and runtime LoRA on the Wan2.1 14B: the unmerged draw of
    `factory.load_pipeline("", random_init=True, dit_cfg=cfg14)`, one DiT
    forward on a small latent in bf16, then `quantize_dit_fp8` on the card
    (the DiT's bytes before and after; a block's fp8 weights and scales
    equal bit for bit to the CPU's quantization of its bf16 weights, and
    its dequantized weights to the plain formula); the same forward in fp8
    within JAX's bound (mean |err| < FP8_ERR_REL x mean |base| +
    FP8_ERR_ABS); the edit's two LoRA files attached as runtime adapters
    (`load_runtime_lora`, no leftover); the 4-step edit of ``video``
    (output, 2 x layers x steps of B1 and nothing else, stage walls, peak),
    its final latents against the bf16 merged edit's (``latents_bf16``,
    relative L2, printed); and the dequantization's and the adapters'
    fusion's share of a DiT step (CUDA events). Returns the phase's
    record."""
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.models import lora
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    from videocof_torch.utils import fp8
    launch_counts, reset_launch_counts = counters
    dev, bf16 = gen.device, torch.bfloat16
    t0 = time.perf_counter()
    pipe = factory.load_pipeline("", random_init=True, dit_cfg=cfg14,
                                 seed=SEED)
    dit = pipe.dit
    before = fp8.fp8_bytes(dit)
    lin = dit.blocks[0].self_attn.q
    w_cpu = lin.weight.detach().cpu()
    # one forward on a small latent (3 x 8 x 8 tokens) in bf16 and in fp8
    grid = (3, 8, 8)
    _, ph, pw = cfg14.patch_size
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    x = torch.randn(1, cfg14.in_dim, grid[0], grid[1] * ph, grid[2] * pw,
                    generator=g, device=dev).to(bf16)
    ctx = torch.randn(1, TEXT_TOKENS, cfg14.text_dim, generator=g,
                      device=dev).to(bf16)
    cos, sin = (torch.as_tensor(a, device=dev)
                for a in make_rope_for_geometry(cfg14, grid))
    t = torch.full((1,), 937.0, device=dev)
    with torch.no_grad():
        base = dit(x, t, ctx, cos, sin).float()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fp8.quantize_dit_fp8(dit)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t1
    after = fp8.fp8_bytes(dit)
    q_cpu, s_cpu = fp8.quantize_weight(w_cpu)
    same_q = (torch.equal(lin.weight.view(torch.uint8).cpu(),
                          q_cpu.view(torch.uint8))
              and torch.equal(lin.weight_scale.cpu(), s_cpu))
    same_deq = torch.equal(fp8.dequantize(lin).cpu(),
                           (q_cpu.float() * s_cpu).to(bf16))
    with torch.no_grad():
        out = dit(x, t, ctx, cos, sin).float()
    err = (out - base).abs().mean().item()
    base_mean = base.abs().mean().item()
    bound = FP8_ERR_REL * base_mean + FP8_ERR_ABS
    fwd_ok = bool(torch.isfinite(out).all()) and err < bound
    n_q = len(quantized_linears(dit))
    log(f"[fp8 14B] built in {t1 - t0:.1f} s, quantized {n_q} linears on the "
        f"card in {quant_s:.2f} s: DiT {before / 1e9:.3f} GB -> "
        f"{after / 1e9:.3f} GB ({after / before:.3f}x); block 0's q weight "
        f"and scale equal to the CPU's quantization bit for bit: "
        f"{'ok' if same_q else 'FAIL'}; dequantized equal to (q.float() * "
        f"scale).to(bf16) bit for bit: {'ok' if same_deq else 'FAIL'}")
    log(f"[fp8 14B] one DiT forward ({grid[0] * grid[1] * grid[2]} tokens), "
        f"fp8 against bf16: mean |err| {err:.4e}, mean |bf16| "
        f"{base_mean:.4e}, bound {bound:.4e} (JAX's test): "
        f"{'ok' if fwd_ok else 'FAIL'}")
    if not (same_q and same_deq):
        fail("fp8 quantization on the card differs from the CPU's")
    if not fwd_ok:
        fail("the fp8 DiT's forward strays from the bf16 one")
    del base, out, x, ctx, cos, sin
    runtime, leftover = lora.load_runtime_lora(
        [(p, 1.0) for p in lora_paths], cfg14)
    if runtime is None or leftover:
        fail(f"the LoRA files gave runtime {runtime is not None}, leftover "
             f"{sorted(leftover)}")
    pipe.set_runtime_lora(runtime)
    ranks = {r.down.shape[0] for b in runtime[0].blocks for m in b.values()
             for r in m.values()}
    log(f"[fp8 14B] runtime adapters from {len(lora_paths)} files: ranks "
        f"{sorted(ranks)} (concatenated), scale {runtime[1]}")
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe(video, prompt, source_frames=geo.source_frames,
               reasoning_frames=geo.reasoning_frames,
               num_inference_steps=geo.num_inference_steps,
               guidance_scale=geo.guidance_scale, shift=geo.shift,
               sampler=geo.sampler, repeat_rope=geo.repeat_rope, cot=geo.cot,
               seed=geo.seed, timings=timings, output_latents=True)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_video("fp8 14B", res.videos, want_shape)
    want = dict(dict.fromkeys(launches, 0), flash_attention_fwd=(
        2 * cfg14.num_layers * geo.num_inference_steps))
    check_launches("fp8 14B edit", launches, want)
    rel = float(np.linalg.norm(res.latents - latents_bf16)
                / np.linalg.norm(latents_bf16))
    log("[fp8 14B] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[fp8 14B] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb} GB; launches {launches}; final latents against the bf16 "
        f"merged edit's (phase 8): relative L2 {rel:.4e}")
    # the dequantization's and the adapters' fusion's share of a step (each
    # result dropped at once, as a step drops it)
    lins, ad = quantized_linears(dit), runtime[0]

    def dequantize_all():
        for m in lins:
            fp8.dequantize(m)

    def fuse_all():
        for b, a in zip(dit.blocks, ad.blocks):
            lora.fuse_block_adapters(b, a, 1.0)
    deq_ms = cuda_ms(dequantize_all, runs=3)
    fuse_ms = cuda_ms(fuse_all, runs=3)
    step_ms = 1e3 * statistics.median(
        timings[f"step{i}"] for i in range(geo.num_inference_steps))
    log(f"[fp8 14B] dequantizing every fp8 weight once: {deq_ms:.2f} ms "
        f"({deq_ms / step_ms:.1%} of a {step_ms:.1f} ms step); the blocks' "
        f"adapters fused over fp8 (dequantization included, what a step "
        f"runs): {fuse_ms:.2f} ms ({fuse_ms / step_ms:.1%})")
    record = {"card": card, "dit_bytes_bf16": before, "dit_bytes_fp8": after,
              "quantize_s": quant_s, "forward_mean_abs_err": err,
              "forward_bound": bound, "seconds_per_edit": wall,
              "stages_s": timings, "peak_memory_gb": peak_gb,
              "launches": launches, "rel_l2_vs_bf16_merged": rel,
              "dequant_ms": deq_ms, "fuse_ms": fuse_ms, "step_ms": step_ms}
    log("[fp8 14B] " + json.dumps(record))
    del pipe, dit, runtime, ad, lins, res
    return record


def a14b_pipeline(gen):
    """The Wan2.2 A14B on the card at full width and depth: umT5-XXL and
    the Wan2.1 VAE from ``gen``, then the two WAN22_T2V_A14B experts from
    seeds SEED + 1 (base) and SEED + 2 (high noise), each quantized to fp8
    as soon as it is drawn, so at most one bf16 expert is ever resident.
    Returns (the `Wan22Pipeline`, build seconds, the build's peak GB)."""
    import torch
    from videocof_torch.configs import (T5Config, WAN22_T2V_A14B,
                                        WanVAEConfig)
    from videocof_torch.models.t5_encoder import init_t5_encoder
    from videocof_torch.models.wan_dit import init_wan_dit
    from videocof_torch.models.wan_vae import init_wan_vae
    from videocof_torch.pipeline import Wan22Pipeline
    from videocof_torch.utils.fp8 import quantize_dit_fp8
    dev, bf16 = gen.device, torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t5 = init_t5_encoder(T5Config(), gen, bf16, dev)
    vae = init_wan_vae(WanVAEConfig(), gen, bf16, dev)
    experts = []
    for seed in (SEED + 1, SEED + 2):
        g = torch.Generator(device=dev).manual_seed(seed)
        experts.append(quantize_dit_fp8(init_wan_dit(WAN22_T2V_A14B, g, bf16,
                                                     dev)))
        torch.cuda.empty_cache()
    pipe = Wan22Pipeline(experts[0], vae, t5, dtype=bf16, dit_2=experts[1])
    torch.cuda.synchronize()
    return (pipe, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9)


def a14b_tokens(pipe, geo, frames, reasoning_frames=None):
    """DiT tokens of ``frames`` source frames (with ``reasoning_frames``:
    the chain-of-frames latents, source twice and the reasoning frames) at
    the geometry's size."""
    from videocof_torch.pipeline import latent_frame_count
    tc = pipe.vae.cfg.temporal_compression_ratio
    sc = pipe.vae.cfg.spatial_compression_ratio
    _, ph, pw = pipe.dit.cfg.patch_size
    n = latent_frame_count(frames, tc)
    if reasoning_frames is not None:
        n = 2 * n + latent_frame_count(reasoning_frames, tc)
    return n * (geo.height // sc // ph) * (geo.width // sc // pw)


@contextlib.contextmanager
def expert_forwards(pipe):
    """Count each expert's DiT forwards (a pre-hook on its first block)."""
    calls = {"dit": 0, "dit_2": 0}
    hooks = [getattr(pipe, n).blocks[0].register_forward_pre_hook(
        lambda *_, n=n: calls.__setitem__(n, calls[n] + 1)) for n in calls]
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


def a14b_edit_phase(card, geo, gen, video, prompt, want_shape, counters):
    """The Wan2.2 A14B dual-expert chain-of-frames edit (`a14b_pipeline`):
    the 480x832 33 + 4-frame edit of ``video`` in A14B_STEPS Flow-UniPC
    steps at shift A14B_SHIFT, guidance 1; ``split_idx`` (the leading
    high-noise steps, 0 < split < steps), each expert's forwards, exactly
    2 x layers x steps B1 calls (self and cross at the 40 heads) and
    nothing else, stage walls, and the peak below the card's memory.
    Returns (the pipeline, the phase's record)."""
    import torch
    from videocof_torch.pipeline import latent_frame_count
    from videocof_torch.schedulers import get_scheduler
    launch_counts, reset_launch_counts = counters
    pipe, build_s, build_peak = a14b_pipeline(gen)
    dcfg = pipe.dit.cfg
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    sched = get_scheduler(geo.sampler)
    sched.set_timesteps(A14B_STEPS, shift=A14B_SHIFT)
    split = pipe._split_idx(sched)
    log(f"[A14B edit] two fp8 experts, umT5-XXL and the VAE built in "
        f"{build_s:.1f} s, peak {build_peak:.2f} GB while building; "
        f"timesteps {[round(float(t), 1) for t in sched.timesteps]} at shift "
        f"{A14B_SHIFT}, boundary {pipe.boundary * pipe.num_train_timesteps}: "
        f"split_idx {split}")
    if not 0 < split < A14B_STEPS:
        fail(f"split_idx {split}: the edit would run one expert only")
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen, expert_forwards(pipe) as calls:
        out = pipe(video, prompt, source_frames=geo.source_frames,
                   reasoning_frames=geo.reasoning_frames,
                   num_inference_steps=A14B_STEPS, guidance_scale=1.0,
                   shift=A14B_SHIFT, sampler=geo.sampler,
                   repeat_rope=geo.repeat_rope, seed=geo.seed,
                   timings=timings)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = b1_shapes(seen)
    check_video("A14B edit", out.videos, want_shape)
    per = dcfg.num_layers * A14B_STEPS
    check_launches("A14B edit", launches, dict(
        dict.fromkeys(launches, 0), flash_attention_fwd=2 * per))
    L = a14b_tokens(pipe, geo, geo.source_frames, geo.reasoning_frames)
    want_shapes = {(1, L, L, None): per, (1, L, TEXT_TOKENS, None): per}
    log("[A14B edit] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[A14B edit] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb:.2f} GB of {total_gb:.2f} GB; DiT forwards: base expert "
        f"{calls['dit']}, high-noise expert {calls['dit_2']}; B1 calls by "
        f"(batch, Lq, Lk, mask): {shapes}")
    if calls != {"dit": A14B_STEPS - split, "dit_2": split}:
        fail(f"the experts ran {calls}, expected {split} high-noise and "
             f"{A14B_STEPS - split} base forwards")
    if shapes != want_shapes:
        fail(f"the A14B edit's B1 calls {shapes} != {want_shapes}")
    if not peak_gb < total_gb:
        fail(f"the A14B edit peaked at {peak_gb} GB")
    tc = pipe.vae.cfg.temporal_compression_ratio
    sc = pipe.vae.cfg.spatial_compression_ratio
    _, ph, pw = dcfg.patch_size
    cond = latent_frame_count(geo.source_frames, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    prof = profile_dit_step(
        "one fp8 A14B expert step", pipe.dit,
        (2 * cond + ground, geo.height // sc // ph, geo.width // sc // pw),
        cond, ground, SEED + 15)
    record = {"card": card, "split_idx": split, "forwards": calls,
              "build_s": build_s, "build_peak_gb": build_peak,
              "seconds_per_edit": wall, "stages_s": timings,
              "peak_memory_gb": peak_gb, "launches": launches,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "profiled_step": prof}
    log("[A14B edit] " + json.dumps(record))
    return pipe, record


def a14b_t2v_phase(card, pipe, geo, prompt, counters):
    """A14B text-to-video (`Wan22Pipeline.text_to_video`) at 480x832 with
    T2V_FRAMES frames (JAX's default: 21 latent frames, 32,760 tokens) in
    A14B_STEPS steps, guidance T2V_GUIDANCE against the default negative
    prompt and T2V_GUIDANCE_2 on the high-noise steps, batched CFG (batch
    2): the output, each expert's forwards, exactly 2 x layers x steps B1
    calls at batch 2 and nothing else, stage walls and peak. Returns the
    phase's record."""
    import torch
    launch_counts, reset_launch_counts = counters
    dcfg = pipe.dit.cfg
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen, expert_forwards(pipe) as calls:
        out = pipe.text_to_video(
            prompt, negative_prompt=geo.negative_prompt, height=geo.height,
            width=geo.width, num_frames=T2V_FRAMES,
            num_inference_steps=A14B_STEPS, guidance_scale=T2V_GUIDANCE,
            guidance_scale_2=T2V_GUIDANCE_2, shift=A14B_SHIFT, seed=geo.seed,
            timings=timings)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = b1_shapes(seen)
    check_video("A14B t2v", out.videos, (1, 3, T2V_FRAMES, geo.height,
                                         geo.width))
    per = dcfg.num_layers * A14B_STEPS
    check_launches("A14B t2v", launches, dict(
        dict.fromkeys(launches, 0), flash_attention_fwd=2 * per))
    L = a14b_tokens(pipe, geo, T2V_FRAMES)
    want_shapes = {(2, L, L, None): per, (2, L, TEXT_TOKENS, None): per}
    log("[A14B t2v] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[A14B t2v] {T2V_FRAMES} frames, {L} tokens: {wall:.3f} s; peak "
        f"device memory {peak_gb:.2f} GB; forwards {calls}; B1 calls by "
        f"(batch, Lq, Lk, mask): {shapes}")
    if shapes != want_shapes:
        fail(f"the A14B t2v's B1 calls {shapes} != {want_shapes}")
    record = {"card": card, "tokens": L, "seconds": wall,
              "stages_s": timings, "peak_memory_gb": peak_gb,
              "launches": launches, "forwards": calls,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "b1_launches": {"A14B t2v self": shapes.get((2, L, L, None), 0),
                              "A14B t2v cross": shapes.get(
                                  (2, L, TEXT_TOKENS, None), 0)}}
    log("[A14B t2v] " + json.dumps(record))
    return record


def ti2v_phase(card, geo, prompt, counters):
    """The TI2V-5B with the Wan2.2 VAE: `factory.load_pipeline("",
    random_init=True, dit_cfg=WAN22_TI2V_5B, vae_cfg=Wan22VAEConfig())` in
    bf16 edits a 33 + 4-frame clip at TI2V_HW (19 latent frames of 44 x 80,
    16,720 tokens) in 4 steps at shift A14B_SHIFT: output, 2 x layers x
    steps B1 calls at the 24 heads and nothing else, stage walls, peak. Then
    the streaming Wan2.2 VAE against the whole-sequence one, with the DiT
    and umT5 freed: in bf16 on the source clip (encode) and the edit's last
    9 latent frames (decode to uint8): seconds, peak above the start, mu's
    relative L2 and the uint8 difference; and, as for Wan2.1 (phase 12),
    against the whole-sequence VAE in fp32 (TF32 off) on the clip's first
    9 frames (3 latent frames: the 33-frame fp32 decode would not fit
    beside its activations): the streamed VAE in fp32 within
    VAE_FP32_REL_TOL relative L2 (mu, frames), the streamed one in bf16 no
    further than VAE_STREAM_FACTOR x the whole one. Returns (the phase's
    record)."""
    import copy
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.configs import WAN22_TI2V_5B, Wan22VAEConfig
    from videocof_torch.models import wan_vae22_streaming as stream
    from videocof_torch.pipeline import latent_frame_count
    launch_counts, reset_launch_counts = counters
    height, width = TI2V_HW
    t0 = time.perf_counter()
    pipe = factory.load_pipeline("", random_init=True, dit_cfg=WAN22_TI2V_5B,
                                 vae_cfg=Wan22VAEConfig(), seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    vcfg, dcfg = pipe.vae.cfg, pipe.dit.cfg
    tc, sc = vcfg.temporal_compression_ratio, vcfg.spatial_compression_ratio
    video = np.random.default_rng(SEED).integers(
        0, 256, (1, 3, geo.source_frames, height, width), dtype=np.uint8)
    cond = latent_frame_count(geo.source_frames, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    _, ph, pw = dcfg.patch_size
    L = (2 * cond + ground) * (height // sc // ph) * (width // sc // pw)
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen:
        out = pipe(video, prompt, source_frames=geo.source_frames,
                   reasoning_frames=geo.reasoning_frames,
                   num_inference_steps=geo.num_inference_steps,
                   shift=A14B_SHIFT, sampler=geo.sampler,
                   repeat_rope=geo.repeat_rope, seed=geo.seed,
                   timings=timings, output_latents=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = b1_shapes(seen)
    check_video("TI2V-5B edit", out.videos, (
        1, 3, 1 + (ground - 1) * tc + geo.source_frames, height, width))
    per = dcfg.num_layers * geo.num_inference_steps
    check_launches("TI2V-5B edit", launches, dict(
        dict.fromkeys(launches, 0), flash_attention_fwd=2 * per))
    want_shapes = {(1, L, L, None): per, (1, L, TEXT_TOKENS, None): per}
    log(f"[TI2V-5B] built in {build_s:.1f} s; {2 * cond + ground} latent "
        f"frames of {height // sc} x {width // sc}, {L} tokens, "
        f"{dcfg.num_heads} heads of {dcfg.head_dim}")
    log("[TI2V-5B] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[TI2V-5B] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb:.2f} GB; launches {launches}; B1 calls by (batch, Lq, Lk, "
        f"mask): {shapes}")
    if shapes != want_shapes:
        fail(f"the TI2V-5B edit's B1 calls {shapes} != {want_shapes}")
    prof = profile_dit_step(
        "one TI2V-5B step", pipe.dit,
        (2 * cond + ground, height // sc // ph, width // sc // pw), cond,
        ground, SEED + 17)
    record = {"card": card, "tokens": L, "build_s": build_s,
              "seconds_per_edit": wall, "stages_s": timings,
              "peak_memory_gb": peak_gb, "launches": launches,
              "b1_calls": {str(k): n for k, n in shapes.items()},
              "b1_launches": {"5B self": shapes.get((1, L, L, None), 0),
                              "5B cross": shapes.get(
                                  (1, L, TEXT_TOKENS, None), 0)},
              "profiled_step": prof}
    # the VAE alone: the DiT and umT5 leave the card
    vae, dtype, dev = pipe.vae, pipe.dtype, pipe.device
    enc, dec = pipe.vae_encode_chunk, pipe.vae_decode_chunk
    x = pipe._prepare_video(video)
    z = torch.as_tensor(out.latents[:, :, -cond:], device=dev)
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()

    def run(fn, runs=2):
        for _ in range(runs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with torch.no_grad():
                res = fn()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        return res, s, (torch.cuda.max_memory_allocated() - start) / 1e9

    def to_u8(y):
        return torch.round(y.float() * 127.5 + 127.5).to(torch.uint8)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def levels(a, b):
        d = (a.int() - b.int()).abs()
        return {"mean": d.float().mean().item(), "max": d.max().item(),
                "share_differing": (d > 0).float().mean().item()}

    rows = {
        "encode whole": run(lambda: vae.encode(x)[0]),
        "encode streaming": run(lambda: stream.encode_streaming(
            vae, x, chunk_latent=enc)[0]),
        "decode whole": run(lambda: to_u8(vae.decode(z.to(dtype)))),
        "decode streaming": run(lambda: stream.decode_streaming_u8(
            vae, z, chunk_latent=dec, compute_dtype=dtype)),
    }
    mu_rel = rel(rows["encode streaming"][0], rows["encode whole"][0])
    u8 = levels(rows["decode streaming"][0], rows["decode whole"][0])
    for k, (_, s, p) in rows.items():
        log(f"[TI2V-5B vae] {k} ({geo.source_frames} frames, {dtype}): "
            f"{s:.3f} s, peak {p:.2f} GB above what was allocated")
    log(f"[TI2V-5B vae] streaming against whole ({dtype}): mu relative L2 "
        f"{mu_rel:.3e}; uint8 frames {u8}")
    walls = {k: {"seconds": s, "peak_gb_above_start": p}
             for k, (_, s, p) in rows.items()}
    del rows
    torch.cuda.empty_cache()
    # against the whole-sequence VAE in fp32 on the clip's first 9 frames
    x9, z3 = x[:, :, :9], z[:, :, :3]
    x9_32 = torch.as_tensor(video[:, :, :9], device=dev).float() * (2 / 255) - 1
    small = {
        "encode whole": run(lambda: vae.encode(x9)[0], 1),
        "encode streaming": run(lambda: stream.encode_streaming(
            vae, x9, chunk_latent=enc)[0], 1),
        "decode whole": run(lambda: to_u8(vae.decode(z3.to(dtype))), 1),
        "decode streaming": run(lambda: stream.decode_streaming_u8(
            vae, z3, chunk_latent=dec, compute_dtype=dtype), 1)}
    ref_vae = copy.deepcopy(vae).float()
    ref = {"encode whole": run(lambda: ref_vae.encode(x9_32)[0], 1),
           "encode streaming": run(lambda: stream.encode_streaming(
               ref_vae, x9_32, chunk_latent=enc)[0], 1),
           "decode whole": run(lambda: ref_vae.decode(z3.float()), 1),
           "decode streaming": run(lambda: stream.decode_streaming(
               ref_vae, z3.float(), chunk_latent=dec), 1)}
    del ref_vae
    mu32, y32 = ref["encode whole"][0], ref["decode whole"][0]
    fp32 = {"mu_rel_l2": rel(ref["encode streaming"][0], mu32),
            "frames_rel_l2": rel(ref["decode streaming"][0], y32)}
    err = {way: {"mu_rel_l2_vs_fp32": rel(small[f"encode {way}"][0], mu32),
                 "u8_vs_fp32": levels(small[f"decode {way}"][0],
                                      to_u8(y32))["mean"]}
           for way in ("whole", "streaming")}
    ok = True
    for key, v in fp32.items():
        good = v <= VAE_FP32_REL_TOL
        ok = ok and good
        log(f"[TI2V-5B vae] fp32 streaming against fp32 whole (9 frames), "
            f"{key} {v:.3e} (tol {VAE_FP32_REL_TOL}): "
            f"{'ok' if good else 'FAIL'}")
    for key in ("mu_rel_l2_vs_fp32", "u8_vs_fp32"):
        w, st = err["whole"][key], err["streaming"][key]
        good = st <= VAE_STREAM_FACTOR * w
        ok = ok and good
        log(f"[TI2V-5B vae] {dtype} against the whole-sequence VAE in fp32 "
            f"(9 frames), {key}: whole {w:.3e}, streaming {st:.3e} (tol "
            f"{VAE_STREAM_FACTOR} x whole): {'ok' if good else 'FAIL'}")
    if not ok:
        fail("the streaming Wan2.2 VAE strays from the whole-sequence VAE")
    record["vae"] = {"mu_rel_l2_streaming_vs_whole": mu_rel,
                     "u8_streaming_vs_whole": u8, "fp32_9_frames": fp32,
                     "vs_fp32_whole_9_frames": err, **walls}
    log("[TI2V-5B] " + json.dumps(record))
    return record


def wan22_entries_phase(card, geo, gen, prompt, counters):
    """The entries on a Wan2.2 checkpoint directory: a published-layout
    A14B MoE directory (`save_wan_checkpoint_dir`: two WAN22_T2V_A14B
    experts at full width and ENTRY22_LAYERS layers each, the Wan2.1 VAE,
    umT5-XXL) read back by `fast_infer.main([... "--quantize", "fp8"])`
    (the 4-step edit of a cv2 clip at shift A14B_SHIFT) and by
    `infer.main([... "--t2v", "--quantize", "fp8", "--guidance_scale_2",
    ...])` (its defaults: 50 steps, CFG 5; 65 frames); each must build a
    `Wan22Pipeline` whose experts hold fp8 weights, write its files and
    launch B1 2 x layers x steps times (batch 2 under CFG) and nothing
    else. The directory has no tokenizer files, so the factory is handed
    ``require_real_tokenizer=False`` (the hash tokenizer). Its umT5 and VAE
    files are kept in SHARED_DIR for phases 22-23. Returns the phase's
    record."""
    import torch
    from videocof_torch import factory
    from videocof_torch.cli import fast_infer, infer
    from videocof_torch.configs import T5Config, WAN22_T2V_A14B, WanVAEConfig
    from videocof_torch.models.t5_encoder import init_t5_encoder
    from videocof_torch.models.wan_dit import init_wan_dit
    from videocof_torch.models.wan_vae import init_wan_vae
    from videocof_torch.pipeline import Wan22Pipeline
    from videocof_torch.utils import checkpoint, video_io
    from videocof_torch.utils.fp8 import is_fp8
    launch_counts, reset_launch_counts = counters
    dev, bf16 = gen.device, torch.bfloat16
    # the directory has no tokenizer files: look for none anywhere else
    os.environ["HF_HUB_OFFLINE"] = "1"
    cfg = WAN22_T2V_A14B.replace(num_layers=ENTRY22_LAYERS)
    root = SCRATCH / "wan22_a14b"
    t0 = time.perf_counter()
    t5 = init_t5_encoder(T5Config(), gen, bf16, dev)
    vae = init_wan_vae(WanVAEConfig(), gen, bf16, dev)
    d1, d2 = (init_wan_dit(cfg, torch.Generator(device=dev).manual_seed(s),
                           bf16, dev) for s in (SEED + 3, SEED + 4))
    nbytes = checkpoint.save_wan_checkpoint_dir(str(root), d1, vae, t5,
                                                dit_2=d2)
    write_s = time.perf_counter() - t0
    del t5, vae, d1, d2
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[entry 2.2] a Wan2.2 A14B directory ({ENTRY22_LAYERS} layers per "
        f"expert, full width) written in {write_s:.1f} s, {nbytes / 1e9:.2f} "
        f"GB: {sorted(p.name for p in root.iterdir())}")
    clip = write_clip("entry 2.2", geo)
    records = {}
    runs = {
        "fast_infer": (fast_infer, [
            "--video_path", str(clip), "--prompt", prompt,
            "--source_frames", str(geo.source_frames), "--reasoning_frames",
            str(geo.reasoning_frames), "--num_inference_steps",
            str(geo.num_inference_steps), "--repeat_rope"],
            2 * ENTRY22_LAYERS * geo.num_inference_steps, 1),
        "infer": (infer, ["--t2v", "--prompt", prompt, "--guidance_scale_2",
                          str(T2V_GUIDANCE_2)],
                  2 * ENTRY22_LAYERS * 50, 2),
    }
    for name, (cli, extra, want_b1, batch) in runs.items():
        out_dir = SCRATCH / f"{name}_out"
        argv = ["--model_name", str(root), "--output_dir", str(out_dir),
                "--quantize", "fp8", "--shift", str(A14B_SHIFT), "--height",
                str(geo.height), "--width", str(geo.width), "--seed",
                str(SEED)] + extra
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with recorded_loads(require_real_tokenizer=False) as built, \
                b1_calls() as seen:
            arrays = cli.main(argv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if len(built) != 1 or len(arrays) != 1:
            fail(f"{name} built {len(built)} pipelines and wrote "
                 f"{len(arrays)} items")
        pipe = built.pop()[1]
        fp8_ok = isinstance(pipe, Wan22Pipeline) and all(
            is_fp8(d.blocks[0].self_attn.q) and is_fp8(d.blocks[-1].ffn.fc2)
            for d in (pipe.dit, pipe.dit_2))
        del pipe
        files = sorted(p.name for p in out_dir.glob("*"))
        shapes = b1_shapes(seen)
        # the item's own video (not the reason+edit or side-by-side ones)
        mp4 = out_dir / next(f for f in files if f.endswith(".mp4") and not
                             f.endswith(("_compare.mp4", "_reason_edit.mp4")))
        info = video_io.video_info(str(mp4))
        log(f"[entry 2.2] {name}.main({' '.join(argv[4:])}): {wall:.3f} s, "
            f"peak {peak_gb:.2f} GB; a Wan22Pipeline with fp8 experts: "
            f"{'ok' if fp8_ok else 'FAIL'}; files {files}; {mp4.name}: "
            f"{info[0]} frames of {info[1]}x{info[2]}; launches {launches}; "
            f"B1 calls by (batch, Lq, Lk, mask): {shapes}")
        if not fp8_ok:
            fail(f"{name} did not build a Wan22Pipeline with fp8 experts")
        check_launches(f"{name} on Wan2.2", launches, dict(
            dict.fromkeys(launches, 0), flash_attention_fwd=want_b1))
        if {k[0] for k in shapes} != {batch}:
            fail(f"{name}'s B1 calls are not all at batch {batch}: {shapes}")
        if not files or info[1:3] != (geo.height, geo.width):
            fail(f"{name} wrote {files}, {info}")
        records[name] = {"seconds": wall, "peak_memory_gb": peak_gb,
                         "launches": launches, "files": files}
    shutil.rmtree(SHARED_DIR, ignore_errors=True)
    SHARED_DIR.mkdir(parents=True)
    for name in (factory.VAE_SUBPATH, factory.T5_SUBPATH):
        shutil.move(str(root / name), str(SHARED_DIR / name))
    shutil.rmtree(SCRATCH, ignore_errors=True)
    record = {"card": card, "write_s": write_s, "bytes": nbytes, **records}
    log("[entry 2.2] " + json.dumps(record))
    return record


# ------------------------------------------------------- 26-28: the families

def family_geometry():
    """{family: (batch, joint tokens, heads, head dim)} of B1's one call
    shape on each family's phase: CogVideoX-5B's self-attention over 226
    text + 13 x 30 x 45 video tokens under batched CFG, Flux-dev's 512 + 64
    x 64, QwenImage's 256 + 64 x 64 (run once per guidance branch)."""
    from videocof_torch.models.cogvideox import COGVIDEOX_5B
    from videocof_torch.models.flux import FLUX_DEV
    from videocof_torch.models.qwenimage import QWENIMAGE
    h, w = COG_HW
    f_lat = (COG_FRAMES - 1) // 4 + 1
    p = COGVIDEOX_5B.patch_size
    cog_L = COG_TEXT + f_lat * (h // 8 // p) * (w // 8 // p)
    img_L = (FAMILY_HW[0] // 16) * (FAMILY_HW[1] // 16)
    return {"cogvideox": (2, cog_L, COGVIDEOX_5B.num_attention_heads,
                          COGVIDEOX_5B.attention_head_dim),
            "flux": (1, FLUX_TEXT + img_L, FLUX_DEV.num_attention_heads,
                     FLUX_DEV.attention_head_dim),
            "qwenimage": (1, QWEN_TEXT + img_L, QWENIMAGE.num_attention_heads,
                          QWENIMAGE.attention_head_dim)}


@contextlib.contextmanager
def timed_calls(owner, name):
    """While the block runs, ``owner.name`` (a module's function or an
    object's method) synchronizes the device around each call and records
    into the yielded list its wall seconds, and into the list's ``peaks``
    (GB) the device memory peak during the call and into ``before`` the
    peak before it (the peak statistics restart with each call)."""
    import torch
    real = getattr(owner, name)
    walls = type("Walls", (list,), {})()
    walls.peaks, walls.before = [], []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        walls.before.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        walls.peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        return out
    setattr(owner, name, timed)
    try:
        yield walls
    finally:
        setattr(owner, name, real)


def family_cut(model, n, n_single=None):
    """A family DiT holding ``model``'s first ``n`` blocks (and, for Flux,
    its first ``n_single`` single-stream blocks): the same tensors."""
    from torch import nn
    cut = nn.Module.__new__(type(model))
    cut.__dict__ = dict(model.__dict__, _modules=dict(model._modules))
    cut.blocks = nn.ModuleList(model.blocks[:n])
    kw = {"num_layers": n}
    if n_single is not None:
        cut.single_blocks = nn.ModuleList(model.single_blocks[:n_single])
        kw["num_single_layers"] = n_single
    cut.cfg = model.cfg.replace(**kw)
    return cut


def naive_gate(tag, forward, layers_note):
    """``forward(backend)`` through B1 and through the naive backend: fail
    unless finite and within DIT_REL_TOL relative L2. Returns the error."""
    import torch
    with torch.no_grad():
        got = forward(None)
        want = forward("naive")
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    ok = bool(torch.isfinite(got).all()) and rel <= DIT_REL_TOL
    log(f"[{tag}] one DiT forward ({layers_note}) through B1 vs the naive "
        f"backend: relative L2 {rel:.3e} (tol {DIT_REL_TOL}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the {tag} DiT through B1 disagrees with the naive backend")
    return rel


def check_media(tag, out, want_shape, lo=0.0):
    """Fail unless ``out`` has ``want_shape``, finite values in [lo, 1] and
    is not constant."""
    import numpy as np
    log(f"[{tag}] output {out.shape} min {out.min():.4f} max {out.max():.4f}"
        f" std {out.std():.4f}")
    if out.shape != want_shape:
        fail(f"{tag} output shape {out.shape} != {want_shape}")
    if not (np.isfinite(out).all() and out.min() >= lo and out.max() <= 1.0
            and out.std() > 0):
        fail(f"{tag} output not finite, outside [{lo}, 1] or constant")


def family_run(tag, card, counters, call, want_b1, forward_mod, forward_name,
               decode_owner, decode_name):
    """``call()`` through the kernels: exactly ``want_b1`` B1 calls
    ({(batch, Lq, Lk, None): calls}) and nothing else, the DiT forwards'
    walls (``forward_mod.forward_name``), the decode's wall and peak
    (``decode_owner.decode_name``), the call's wall and peak. Returns
    (output, record)."""
    import torch
    launch_counts, reset_launch_counts = counters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen, \
            timed_calls(forward_mod, forward_name) as steps, \
            timed_calls(decode_owner, decode_name) as decodes:
        out = call()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    shapes = b1_shapes(seen)
    peaks = decodes.peaks
    peak = max([torch.cuda.max_memory_allocated() / 1e9, *steps.peaks,
                *steps.before, *peaks, *decodes.before])
    record = {"card": card, "seconds": wall, "forward_s": list(steps),
              "decode_s": list(decodes), "decode_peak_gb": peaks,
              "peak_memory_gb": peak, "launches": launches,
              "b1_calls": {str(k): n for k, n in shapes.items()}}
    log(f"[{tag}] {wall:.3f} s, peak {peak:.2f} GB; DiT forwards (s) "
        + ", ".join(f"{s:.3f}" for s in steps)
        + f"; decode {', '.join(f'{s:.3f}' for s in decodes)} s at a peak "
        f"of {', '.join(f'{p:.2f}' for p in peaks)} GB; launches "
        f"{launches}; B1 calls by (batch, Lq, Lk, mask): {shapes}")
    check_launches(tag, launches, dict(dict.fromkeys(launches, 0),
                                       flash_attention_fwd=sum(
                                           want_b1.values())))
    if shapes != want_b1:
        fail(f"the {tag}'s B1 calls {shapes} != {want_b1}")
    return out, record


def cogvideox_phase(card, gen, counters):
    """CogVideoX-5B (42 blocks of 48 heads of 64) with its causal 3D VAE,
    random bf16 weights from the seed: `CogVideoXPipeline` at 480x720, 49
    frames, 226 text tokens, CFG 6 (batch 2), COG_STEPS DDIM steps: 42 x
    steps B1 calls at [2, 17,776] and nothing else; the whole-clip decode's
    wall and peak; one forward of the first FAMILY_NAIVE_LAYERS blocks at
    the call's geometry against the naive backend. Returns the record."""
    import torch
    from videocof_torch.models import cogvideox as cog
    from videocof_torch.models.cogvideox_vae import (COGVIDEOX_VAE,
                                                     init_cogvideox_vae)
    from videocof_torch.pipeline import CogVideoXPipeline
    bf16, dev = torch.bfloat16, gen.device
    t0 = time.perf_counter()
    dit = cog.init_cogvideox(cog.COGVIDEOX_5B, gen, bf16)
    vae = init_cogvideox_vae(COGVIDEOX_VAE, gen, bf16)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    pipe = CogVideoXPipeline(dit, vae, dtype=bf16)
    cfg = dit.cfg
    emb = torch.randn(1, COG_TEXT, cfg.text_embed_dim, generator=gen,
                      device=dev)
    neg = torch.randn(1, COG_TEXT, cfg.text_embed_dim, generator=gen,
                      device=dev)
    B, L, _, _ = family_geometry()["cogvideox"]
    h, w = COG_HW

    def call():
        return pipe(emb, neg, height=h, width=w, num_frames=COG_FRAMES,
                    num_inference_steps=COG_STEPS,
                    guidance_scale=COG_GUIDANCE, seed=SEED)

    out, record = family_run(
        "CogVideoX-5B", card, counters, call,
        {(B, L, L, None): cfg.num_layers * COG_STEPS}, cog,
        "cogvideox_forward", vae, "decode")
    check_media("CogVideoX-5B", out, (1, 3, COG_FRAMES, h, w))
    f_lat = (COG_FRAMES - 1) // 4 + 1
    x = torch.randn(2, f_lat, cfg.in_channels, h // 8, w // 8, generator=gen,
                    device=dev)
    ctx = torch.cat([neg, emb])
    t = torch.full((2,), 937.0, device=dev)
    cut = family_cut(dit, FAMILY_NAIVE_LAYERS)
    rel = naive_gate("CogVideoX-5B", lambda b: cog.cogvideox_forward(
        cut, x, ctx, t, attn_backend=b),
        f"the first {FAMILY_NAIVE_LAYERS} of {cfg.num_layers} blocks, batch "
        f"2, {L} tokens")
    record.update(draw_s=draw_s, tokens=L, rel_l2_vs_naive=rel,
                  naive_layers=FAMILY_NAIVE_LAYERS,
                  b1_launches={"cogvideox self": cfg.num_layers * COG_STEPS})
    del pipe, dit, vae, cut, out, x
    gc.collect()
    torch.cuda.empty_cache()
    log("[CogVideoX-5B] " + json.dumps(record))
    return record


def fp8_forward_error(v_fp8, v_bf16):
    """(mean |err|, bound) of an fp8 forward against the bf16 one."""
    err = (v_fp8.float() - v_bf16.float()).abs().mean().item()
    return err, FP8_ERR_REL * v_bf16.float().abs().mean().item() + \
        FP8_ERR_ABS


def flux_phase(card, gen, counters):
    """Flux-dev (19 double-stream and 38 single-stream blocks of 24 heads
    of 128, the guidance embedding) with its KL VAE, random bf16 weights
    from the seed: `FluxPipeline` at 1024x1024, 512 text tokens, guidance
    3.5, FAMILY_STEPS steps, in bf16 and again after `quantize_dit_fp8`
    with `FLUX_FP8_EXCLUDE`: each 57 x steps B1 calls at [1, 4,608] and
    nothing else; one forward of the first FAMILY_NAIVE_LAYERS double and
    single blocks against the naive backend; one whole fp8 forward against
    the bf16 one within JAX's bound. Returns the record."""
    import torch
    from videocof_torch.models import flux as flux_lib
    from videocof_torch.models import kl_vae
    from videocof_torch.pipeline import FluxPipeline
    from videocof_torch.utils.fp8 import fp8_bytes, quantize_dit_fp8
    bf16, dev = torch.bfloat16, gen.device
    t0 = time.perf_counter()
    dit = flux_lib.init_flux(flux_lib.FLUX_DEV, gen, bf16)
    vae = kl_vae.init_kl_vae_decoder(kl_vae.FLUX_KL_VAE, gen, bf16)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    decode = kl_vae.make_decode_fn(vae, compute_dtype=bf16)
    pipe = FluxPipeline(dit, decode_fn=decode, dtype=bf16)
    cfg = dit.cfg
    emb = torch.randn(1, FLUX_TEXT, cfg.joint_attention_dim, generator=gen,
                      device=dev)
    pooled = torch.randn(1, cfg.pooled_projection_dim, generator=gen,
                         device=dev)
    B, L, _, _ = family_geometry()["flux"]
    h, w = FAMILY_HW
    per = (cfg.num_layers + cfg.num_single_layers) * FAMILY_STEPS

    def call():
        return pipe(emb, pooled, height=h, width=w,
                    num_inference_steps=FAMILY_STEPS, guidance=FLUX_GUIDANCE,
                    seed=SEED)

    # one forward at the call's geometry: its inputs, for the naive gate
    # and the fp8 bound
    Li = L - FLUX_TEXT
    x = torch.randn(1, Li, cfg.in_channels, generator=gen, device=dev)
    yy, xx = torch.meshgrid(torch.arange(h // 16), torch.arange(w // 16),
                            indexing="ij")
    img_ids = torch.stack([torch.zeros_like(yy), yy, xx], -1).reshape(
        Li, 3).float().to(dev)
    txt_ids = torch.zeros(FLUX_TEXT, 3, device=dev)
    tt = torch.full((1,), 0.9, device=dev)
    g = torch.full((1,), FLUX_GUIDANCE, device=dev)

    def forward(model, backend=None):
        return flux_lib.flux_forward(model, x, emb, pooled, tt, img_ids,
                                     txt_ids, guidance=g,
                                     attn_backend=backend)

    records = {}
    for mode in ("bf16", "fp8"):
        if mode == "fp8":
            before = fp8_bytes(dit)
            t0 = time.perf_counter()
            quantize_dit_fp8(dit, exclude=flux_lib.FLUX_FP8_EXCLUDE)
            torch.cuda.synchronize()
            quant_s = time.perf_counter() - t0
            with torch.no_grad():
                v_fp8 = forward(dit)
            err, lim = fp8_forward_error(v_fp8, v_bf16)
            log(f"[Flux-dev fp8] quantize_dit_fp8 {quant_s:.2f} s: DiT "
                f"{before / 1e9:.2f} -> {fp8_bytes(dit) / 1e9:.2f} GB; one "
                f"forward against bf16: mean |err| {err:.4e} (bound "
                f"{lim:.4e}): {'ok' if err < lim else 'FAIL'}")
            if not err < lim:
                fail("Flux-dev in fp8 strays from bf16 beyond JAX's bound")
        out, rec = family_run(
            f"Flux-dev {mode}", card, counters, call,
            {(B, L, L, None): per}, flux_lib, "flux_forward", pipe,
            "decode_fn")
        # the pipeline returns decode_fn's pixels in [-1, 1], as JAX's
        check_media(f"Flux-dev {mode}", out, (1, 3, h, w), lo=-1.0)
        if mode == "bf16":
            image_bf16 = out
            with torch.no_grad():
                v_bf16 = forward(dit)
            cut = family_cut(dit, FAMILY_NAIVE_LAYERS, FAMILY_NAIVE_LAYERS)
            rec["rel_l2_vs_naive"] = naive_gate(
                "Flux-dev", lambda b: forward(cut, b),
                f"the first {FAMILY_NAIVE_LAYERS} of {cfg.num_layers} double"
                f" and {FAMILY_NAIVE_LAYERS} of {cfg.num_single_layers} "
                f"single blocks, {L} tokens")
            del cut
        else:
            rec.update(fp8_forward_mean_err=err, fp8_bound=lim,
                       quantize_s=quant_s, dit_gb_bf16=before / 1e9,
                       dit_gb_fp8=fp8_bytes(dit) / 1e9,
                       image_rel_l2_vs_bf16=_rel_l2(out, image_bf16))
            log(f"[Flux-dev fp8] image against the bf16 run: relative L2 "
                f"{rec['image_rel_l2_vs_bf16']:.3e}")
        records[mode] = rec
    record = {"draw_s": draw_s, "tokens": L, **records,
              "b1_launches": {"flux joint": per}}
    del pipe, dit, vae, decode, out, image_bf16, x, v_fp8, v_bf16
    gc.collect()
    torch.cuda.empty_cache()
    log("[Flux-dev] " + json.dumps(record))
    return record


def qwenimage_phase(card, gen, counters):
    """QwenImage (60 blocks of 24 heads of 128) with its VAE (the Wan2.1
    VAE, one frame), random bf16 weights from the seed: `QwenImagePipeline`
    at 1024x1024, a 256-token prompt, true CFG 4, FAMILY_STEPS steps: 60 x
    2 x steps B1 calls at [1, 4,352] and nothing else; one forward of the
    first FAMILY_NAIVE_LAYERS blocks against the naive backend. Returns the
    record."""
    import torch
    from videocof_torch.models import qwenimage as qwen_lib
    from videocof_torch.models.qwenimage_vae import QWENIMAGE_VAE_CONFIG
    from videocof_torch.models.wan_vae import init_wan_vae
    from videocof_torch.pipeline import QwenImagePipeline
    bf16, dev = torch.bfloat16, gen.device
    t0 = time.perf_counter()
    dit = qwen_lib.init_qwenimage(qwen_lib.QWENIMAGE, gen, bf16)
    vae = init_wan_vae(QWENIMAGE_VAE_CONFIG, gen, bf16, dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    pipe = QwenImagePipeline(dit, vae, dtype=bf16)
    cfg = dit.cfg
    emb = torch.randn(1, QWEN_TEXT, cfg.joint_attention_dim, generator=gen,
                      device=dev)
    neg = torch.randn(1, QWEN_TEXT, cfg.joint_attention_dim, generator=gen,
                      device=dev)
    B, L, _, _ = family_geometry()["qwenimage"]
    h, w = FAMILY_HW
    per = cfg.num_layers * 2 * FAMILY_STEPS

    def call():
        return pipe(emb, neg, height=h, width=w,
                    num_inference_steps=FAMILY_STEPS,
                    true_cfg_scale=QWEN_CFG, seed=SEED)

    out, record = family_run(
        "QwenImage", card, counters, call, {(B, L, L, None): per}, qwen_lib,
        "qwenimage_forward", vae, "decode")
    check_media("QwenImage", out, (1, 3, h, w))
    Li = L - QWEN_TEXT
    x = torch.randn(1, Li, cfg.in_channels, generator=gen, device=dev)
    ii, ti = (a.to(dev) for a in qwen_lib.qwen_position_ids(
        (1, h // 16, w // 16), QWEN_TEXT))
    tt = torch.full((1,), 0.9, device=dev)
    cut = family_cut(dit, FAMILY_NAIVE_LAYERS)
    rel = naive_gate("QwenImage", lambda b: qwen_lib.qwenimage_forward(
        cut, x, emb, tt, ii, ti, attn_backend=b),
        f"the first {FAMILY_NAIVE_LAYERS} of {cfg.num_layers} blocks, {L} "
        f"tokens")
    record.update(draw_s=draw_s, tokens=L, rel_l2_vs_naive=rel,
                  naive_layers=FAMILY_NAIVE_LAYERS,
                  b1_launches={"qwenimage joint": per})
    del pipe, dit, vae, cut, out, x
    gc.collect()
    torch.cuda.empty_cache()
    log("[QwenImage] " + json.dumps(record))
    return record


def write_family_dirs(root, gen):
    """Published-layout (diffusers) pipeline directories of the three
    families at full width and FAMILY_DIR_LAYERS layers (Flux: as many of
    each kind), random bf16 weights, with their VAEs, written by the port's
    `save_family_checkpoint_dir`. Returns {family: path}."""
    import torch
    from videocof_torch.models import cogvideox as cog
    from videocof_torch.models import flux as flux_lib
    from videocof_torch.models import kl_vae
    from videocof_torch.models import qwenimage as qwen_lib
    from videocof_torch.models.cogvideox_vae import (COGVIDEOX_VAE,
                                                     init_cogvideox_vae)
    from videocof_torch.models.qwenimage_vae import QWENIMAGE_VAE_CONFIG
    from videocof_torch.models.wan_vae import init_wan_vae
    from videocof_torch.utils.checkpoint import save_family_checkpoint_dir
    bf16, n = torch.bfloat16, FAMILY_DIR_LAYERS
    makers = {
        "cogvideox": lambda: (
            cog.init_cogvideox(cog.COGVIDEOX_5B.replace(num_layers=n), gen,
                               bf16),
            init_cogvideox_vae(COGVIDEOX_VAE, gen, bf16)),
        "flux": lambda: (
            flux_lib.init_flux(flux_lib.FLUX_DEV.replace(
                num_layers=n, num_single_layers=n), gen, bf16),
            kl_vae.init_kl_vae_decoder(kl_vae.FLUX_KL_VAE, gen, bf16)),
        "qwenimage": lambda: (
            qwen_lib.init_qwenimage(qwen_lib.QWENIMAGE.replace(num_layers=n),
                                    gen, bf16),
            init_wan_vae(QWENIMAGE_VAE_CONFIG, gen, bf16, gen.device))}
    paths = {}
    for family, make in makers.items():
        dit, vae = make()
        paths[family] = save_family_checkpoint_dir(str(root / family), dit,
                                                   vae)
        del dit, vae
    torch.cuda.empty_cache()
    return paths


def family_serving_phase(card, geo, prompt, clip, gen, counters,
                         out_frames):
    """The serving path of the families: a 1.3B Wan controller (random
    weights, its load arguments those of ``serving.api --random_init``)
    behind `serving.api`'s handler; for each family, the update endpoint on
    its published-layout directory (`write_family_dirs`), the switch
    checked (the resident family, B1's launches of the request), and one
    embeddings-in request with an ``embeddings_path`` .npz inside the
    allowlist (VIDEOCOF_MODEL_DIRS and VIDEOCOF_ASSET_DIRS): an mp4 for
    CogVideoX, a png for the image families, decoded and checked; then the
    switch back to Wan and one edit of the serving clip. Returns the
    record."""
    import base64
    import io
    import numpy as np
    import torch
    from PIL import Image
    from videocof_torch import factory
    from videocof_torch.serving import VideoCoFController, api
    from videocof_torch.utils import video_io
    launch_counts, reset_launch_counts = counters
    models = SCRATCH / "family_models"
    models.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    paths = write_family_dirs(models, gen)
    write_s = time.perf_counter() - t0
    env = {k: os.environ.get(k) for k in ("VIDEOCOF_MODEL_DIRS",
                                          "VIDEOCOF_ASSET_DIRS")}
    os.environ["VIDEOCOF_MODEL_DIRS"] = str(models)
    os.environ["VIDEOCOF_ASSET_DIRS"] = str(models)
    wan_kwargs = dict(random_init=True, seed=SEED)
    controller = VideoCoFController(factory.load_pipeline("", **wan_kwargs),
                                    wan_load_kwargs=wan_kwargs)
    from videocof_torch.models.cogvideox import COGVIDEOX_5B
    from videocof_torch.models.flux import FLUX_DEV
    from videocof_torch.models.qwenimage import QWENIMAGE
    dims = {"cogvideox": (COGVIDEOX_5B.text_embed_dim, None),
            "flux": (FLUX_DEV.joint_attention_dim,
                     FLUX_DEV.pooled_projection_dim),
            "qwenimage": (QWENIMAGE.joint_attention_dim, None)}
    n = FAMILY_DIR_LAYERS
    requests = {
        "cogvideox": dict(height=COG_HW[0], width=COG_HW[1],
                          num_frames=SERVE_COG_FRAMES,
                          sample_step_slider=SERVE_FAMILY_STEPS),
        "flux": dict(height=FAMILY_HW[0], width=FAMILY_HW[1],
                     sample_step_slider=SERVE_FAMILY_STEPS),
        "qwenimage": dict(height=FAMILY_HW[0], width=FAMILY_HW[1],
                          sample_step_slider=SERVE_FAMILY_STEPS)}
    b1 = {"cogvideox": n * SERVE_FAMILY_STEPS,
          "flux": 2 * n * SERVE_FAMILY_STEPS,
          "qwenimage": n * 2 * SERVE_FAMILY_STEPS}
    text_len = {"cogvideox": COG_TEXT, "flux": FLUX_TEXT,
                "qwenimage": QWEN_TEXT}
    rng = np.random.default_rng(SEED)
    records = {}
    try:
        with http_server(controller) as url:
            for family, path in paths.items():
                t0 = time.perf_counter()
                code, reply = http_call(url, api.UPDATE_ENDPOINT, {
                    "diffusion_transformer_path": path})
                switch_s = time.perf_counter() - t0
                if (code, reply.get("message")) != (200, "Success") or \
                        controller.family != family:
                    fail(f"switch to {family}: {code} {reply}, resident "
                         f"{controller.family}")
                dim, pooled = dims[family]
                arrays = {"text_embeddings": rng.standard_normal(
                    (1, text_len[family], dim)).astype(np.float32)}
                if family != "flux":
                    arrays["negative_embeddings"] = rng.standard_normal(
                        (1, text_len[family], dim)).astype(np.float32)
                else:
                    arrays["pooled_projections"] = rng.standard_normal(
                        (1, pooled)).astype(np.float32)
                npz = models / f"{family}_embeds.npz"
                np.savez(npz, **arrays)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                t0 = time.perf_counter()
                code, reply = http_call(url, api.ENDPOINT, dict(
                    requests[family], embeddings_path=str(npz),
                    seed_textbox=SEED))
                request_s = time.perf_counter() - t0
                launches = launch_counts()
                if code != 200 or reply.get("family") != family:
                    fail(f"the {family} request: {code} {reply}")
                check_launches(f"{family} request", launches, dict(
                    dict.fromkeys(launches, 0),
                    flash_attention_fwd=b1[family]))
                if family == "cogvideox":
                    mp4 = SCRATCH / "cogvideox_reply.mp4"
                    mp4.write_bytes(base64.b64decode(
                        reply["base64_encoding"]))
                    got = video_io.video_info(str(mp4))[:3]
                    want = (SERVE_COG_FRAMES, *COG_HW)
                else:
                    img = Image.open(io.BytesIO(base64.b64decode(
                        reply["base64_image"])))
                    got, want = (img.height, img.width), FAMILY_HW
                if tuple(got) != tuple(want):
                    fail(f"the {family} reply holds {got}, expected {want}")
                records[family] = {
                    "switch_s": switch_s, "request_s": request_s,
                    "launches": launches, "reply": list(got),
                    "peak_memory_gb":
                        torch.cuda.max_memory_allocated() / 1e9}
                log(f"[family serving] {family}: switch {switch_s:.2f} s, "
                    f"request {request_s:.2f} s, reply {got}, launches "
                    f"{launches}, peak "
                    f"{records[family]['peak_memory_gb']:.2f} GB")
            wan_dir = models / "wan"
            wan_dir.mkdir(exist_ok=True)
            t0 = time.perf_counter()
            code, reply = http_call(url, api.UPDATE_ENDPOINT, {
                "diffusion_transformer_path": str(wan_dir)})
            back_s = time.perf_counter() - t0
            if (code, reply.get("message")) != (200, "Success") or \
                    controller.family != "wan":
                fail(f"switch back to Wan: {code} {reply}")
            reset_launch_counts()
            t0 = time.perf_counter()
            code, reply = http_call(url, api.ENDPOINT, edit_payload(
                geo, prompt, b64_file(clip)))
            edit_s = time.perf_counter() - t0
            if code != 200:
                fail(f"the edit after the switch back: {code} {reply}")
            reply_video("family serving", reply, geo, out_frames,
                        "wan_reply.mp4")
            check_launches("edit after the switch back", launch_counts(),
                           dict(dict.fromkeys(launch_counts(), 0),
                                flash_attention_fwd=2 * factory.
                                WAN21_T2V_1_3B.num_layers
                                * geo.num_inference_steps))
            log(f"[family serving] back to Wan {back_s:.2f} s; an edit "
                f"{edit_s:.2f} s: ok")
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    record = {"card": card, "write_s": write_s, **records,
              "back_to_wan_s": back_s, "wan_edit_s": edit_s}
    del controller
    shutil.rmtree(models, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("[family serving] " + json.dumps(record))
    return record


def _family_sp_rank(rank, world, init_file, out_dir, inputs):
    """One rank of the Flux Ulysses run on cuda:0 beside the other, in a
    gloo world: Flux-dev at full width cut to FAMILY_SP_LAYERS double and
    single blocks, drawn from the seed, `enable_sequence_parallel(seq=
    world)`, the generation of ``inputs``; the output, B1's launches and
    calls, the seconds, into ``out_dir/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from videocof_torch.models import flux as flux_lib
    from videocof_torch.ops import flash_attention as fa
    from videocof_torch.parallel import rank_device
    from videocof_torch.pipeline import FluxPipeline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    dev = rank_device()
    torch.cuda.set_device(dev)
    pipe = family_sp_pipeline(FluxPipeline, flux_lib, dev)
    pipe.enable_sequence_parallel(seq=world, mode="ulysses")
    dist.barrier()
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with b1_calls() as seen:
        out = pipe(**inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"out": out, "launches": fa.launch_counts(),
           "b1": {str(k): v for k, v in _b1_by_shape(seen).items()},
           "seconds": wall}
    dist.barrier()
    dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def family_sp_pipeline(pipeline_cls, flux_lib, dev):
    """The Flux pipeline of the SP run: Flux-dev's width cut to
    FAMILY_SP_LAYERS blocks of each kind, bf16 from the seed, latents
    out."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cfg = flux_lib.FLUX_DEV.replace(num_layers=FAMILY_SP_LAYERS,
                                    num_single_layers=FAMILY_SP_LAYERS)
    return pipeline_cls(flux_lib.init_flux(cfg, gen, torch.bfloat16),
                        dtype=torch.bfloat16, device=dev)


def family_sp_phase(card, counters):
    """Flux at full width under Ulysses at two gloo ranks sharing the card
    (FAMILY_SP_LAYERS double and single blocks, 1024x1024, 512 text
    tokens, 2 steps), each rank's latents against world 1's run of the
    same weights and seed within SP_REL_TOL, B1's calls by shape (each
    rank: half of the 24 heads over all 4,608 tokens). Returns the
    record."""
    import numpy as np
    import torch
    from videocof_torch.models import flux as flux_lib
    from videocof_torch.ops import flash_attention as fa
    from videocof_torch.parallel import rank_device
    from videocof_torch.pipeline import FluxPipeline
    dev = rank_device()
    rng = np.random.default_rng(SEED)
    cfg = flux_lib.FLUX_DEV
    inputs = dict(
        text_embeddings=rng.standard_normal(
            (1, FLUX_TEXT, cfg.joint_attention_dim)).astype(np.float32),
        pooled_projections=rng.standard_normal(
            (1, cfg.pooled_projection_dim)).astype(np.float32),
        height=FAMILY_HW[0], width=FAMILY_HW[1], num_inference_steps=2,
        guidance=FLUX_GUIDANCE, seed=SEED)
    pipe = family_sp_pipeline(FluxPipeline, flux_lib, dev)
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pipe(**inputs)
    world1_s = time.perf_counter() - t0
    world1_b1 = fa.launch_counts()["flash_attention_fwd"]
    del pipe
    torch.cuda.empty_cache()
    out = SCRATCH / "family_sp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    _spawn_ranks(_family_sp_rank, SP_DEGREE, (str(out / "rdzv"), str(out),
                                              inputs), "family SP")
    spawn_s = time.perf_counter() - t0
    B, L, N, D = family_geometry()["flux"]
    per = 2 * FAMILY_SP_LAYERS * 2
    ranks = []
    for r in range(SP_DEGREE):
        res = torch.load(out / f"rank{r}.pt", weights_only=False)
        rel = _rel_l2(res["out"], want)
        ranks.append({"rel_l2_vs_world1": rel, "seconds": res["seconds"],
                      "launches": res["launches"], "b1": res["b1"]})
        log(f"[family SP] rank {r}: {res['seconds']:.2f} s, latents vs "
            f"world 1 relative L2 {rel:.3e} (tol {SP_REL_TOL}); launches "
            f"{res['launches']}; B1 calls {res['b1']}")
        want_b1 = {str((1, L, L, N // SP_DEGREE, False)): per}
        if not rel <= SP_REL_TOL or res["b1"] != want_b1:
            fail(f"family SP rank {r}: relative L2 {rel:.3e}, B1 "
                 f"{res['b1']} (expected {want_b1})")
    shutil.rmtree(out, ignore_errors=True)
    record = {"card": card, "world1_s": world1_s, "world1_b1": world1_b1,
              "spawn_s": spawn_s, "ranks": ranks}
    log("[family SP] " + json.dumps(record))
    return record


@contextlib.contextmanager
def http_server(controller):
    """`serving.api`'s handler in front of ``controller`` on a free
    loopback port, served by a thread; yields its URL. The server and its
    thread stop when the block ends."""
    import threading
    from http.server import ThreadingHTTPServer
    from videocof_torch.serving import api
    server = ThreadingHTTPServer(("127.0.0.1", 0), api.make_handler(
        controller, threading.Lock()))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)


def http_call(url, path, payload=None, content_length=None, timeout=900):
    """(status, reply) of a GET (no payload) or a json POST to ``url`` +
    ``path``: the reply parsed as json where it is json, else its text.
    ``content_length`` announces that many bytes and sends none (a server
    must refuse an oversized body before reading it)."""
    import http.client
    host, port = url.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        if content_length is not None:
            conn.putrequest("POST", path)
            conn.putheader("Content-Length", str(content_length))
            conn.endheaders()
        elif payload is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    try:
        return resp.status, json.loads(data)
    except ValueError:
        return resp.status, data.decode()


def metric_values(text):
    """{name: value} of the ``videocof_*`` samples of a /metrics reply."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^videocof_(\w+) (\S+)$", text, re.M)}


def check_metrics(tag, url, want):
    """Fail unless /metrics reports ``want`` ({name: value})."""
    code, text = http_call(url, "/metrics")
    got = metric_values(text) if code == 200 else {}
    seen = {k: got.get(k) for k in want}
    log(f"[{tag}] /metrics: {seen}")
    if seen != want:
        fail(f"{tag}: /metrics reports {seen}, expected {want}")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def b64_file(path):
    import base64
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def edit_payload(geo, prompt, clip_b64, **extra):
    """The reference API's request for the 4-step edit of the geometry."""
    return {"prompt_textbox": prompt, "source_video": clip_b64,
            "seed_textbox": SEED, "sample_step_slider":
            geo.num_inference_steps, "cfg_scale_slider": geo.guidance_scale,
            "source_frames": geo.source_frames,
            "reasoning_frames": geo.reasoning_frames, **extra}


def reply_video(tag, reply, geo, want_frames, name):
    """Decode a reply's base64 mp4 with cv2 (written under SCRATCH); fail
    unless it holds ``want_frames`` frames of the geometry's size."""
    import base64
    from videocof_torch.utils import video_io
    path = SCRATCH / name
    path.write_bytes(base64.b64decode(reply.get("base64_encoding", "")))
    info = video_io.video_info(str(path))
    if info[:3] != (want_frames, geo.height, geo.width):
        fail(f"{tag}: the reply's mp4 holds {info[0]} frames of "
             f"{info[1]}x{info[2]}, expected {want_frames} of "
             f"{geo.height}x{geo.width}")
    return info


def serving_14b_phase(card, cfg14, geo, prompt, counters, lora_paths, clip,
                      want_frames):
    """The Wan2.1 14B server with fp8 weights, runtime LoRA and umT5
    offload, in this process: `factory.load_pipeline(random_init=True,
    quantize="fp8", offload_t5=True)` behind `VideoCoFController` and
    `serving.api`'s handler on a thread; four POSTs of ``clip`` (base64
    mp4) with the LoRA files of SERVE_LORAS; per request the reply, its
    mp4, the B1 calls (2 x layers x steps at 40 heads and no other
    launch), the allocated memory after it (below the fp8 DiT, the VAE,
    the adapters and SERVE_MEM_SLACK: umT5 is not resident), the walls
    (client, the controller's edit, the text stage, the LoRA switch) and
    the peak; the adapters gone after "none"; requests 1-3 pairwise
    different and request 4 equal to request 1 bit for bit (the arrays
    handed to the mp4 encoder); then /metrics, /healthz, the page and the
    refusals, counted as the JAX package counts them, with the port's own
    refusal of a LoRA file outside VIDEOCOF_MODEL_DIRS (which names
    LORA_DIR for the phase). Returns the phase's record."""
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.serving import VideoCoFController, api
    from videocof_torch.utils import fp8
    launch_counts, reset_launch_counts = counters
    os.environ.pop("VIDEOCOF_ASSET_DIRS", None)
    # the LoRA files a request names must lie in the model allowlist
    os.environ["VIDEOCOF_MODEL_DIRS"] = str(LORA_DIR)
    t0 = time.perf_counter()
    pipe = factory.load_pipeline("", random_init=True, dit_cfg=cfg14,
                                 seed=SEED, quantize="fp8", offload_t5=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident = {"dit": fp8.fp8_bytes(pipe.dit), "vae": fp8.fp8_bytes(pipe.vae)}
    t5_bytes = fp8.fp8_bytes(pipe.t5)
    t5_host = all(p.device.type == "cpu" and p.is_pinned()
                  for p in pipe.t5.parameters())
    log(f"[serve 14B] factory.load_pipeline(random_init, fp8, offload_t5) in "
        f"{build_s:.1f} s: fp8 DiT {resident['dit'] / 1e9:.3f} GB and VAE "
        f"{resident['vae'] / 1e9:.3f} GB on the card, umT5 "
        f"{t5_bytes / 1e9:.3f} GB pinned in host memory: "
        f"{'ok' if t5_host else 'FAIL'}")
    if not t5_host:
        fail("offload_t5 left umT5's weights off pinned host memory")
    controller = VideoCoFController(pipe)
    encoded, cur = [], {}
    real_enc = controller.encode_video_base64
    real_gen, real_lora = controller.generate, controller.ensure_lora

    def enc(video, fps=16):
        encoded.append(np.asarray(video))
        return real_enc(video, fps)

    def gen_timed(**kw):
        t = time.perf_counter()
        out = real_gen(timings=cur.setdefault("stages_s", {}), **kw)
        cur["edit_s"] = time.perf_counter() - t
        return out

    def lora_timed(*a, **kw):
        t = time.perf_counter()
        real_lora(*a, **kw)
        torch.cuda.synchronize()
        cur["lora_s"] = time.perf_counter() - t
    controller.encode_video_base64 = enc
    controller.generate = gen_timed
    controller.ensure_lora = lora_timed
    clip_b64 = b64_file(clip)
    fusionx, videocof = lora_paths
    files = {"fusionx": fusionx, "videocof": videocof, "none": "none"}
    per = cfg14.num_layers * geo.num_inference_steps
    want = dict(dict.fromkeys(launch_counts(), 0),
                flash_attention_fwd=2 * per)
    requests, L = [], None
    with http_server(controller) as url:
        for i, name in enumerate(SERVE_LORAS):
            cur.clear()
            tag = f"serve 14B request {i + 1} ({name})"
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            with b1_calls() as seen:
                t = time.perf_counter()
                code, reply = http_call(url, api.ENDPOINT, edit_payload(
                    geo, prompt, clip_b64, lora_model_path=files[name],
                    lora_alpha_slider=1.0))
                wall = time.perf_counter() - t
            launches = launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.synchronize()
            between = torch.cuda.memory_allocated()
            runtime = pipe.dit.runtime_lora
            ad_bytes = fp8.fp8_bytes(runtime[0]) if runtime else 0
            limit = (resident["dit"] + resident["vae"] + ad_bytes
                     + SERVE_MEM_SLACK)
            if code != 200 or reply.get("message") != "Success":
                fail(f"{tag}: {code} {str(reply)[:300]}")
            info = reply_video(tag, reply, geo, want_frames, f"reply{i}.mp4")
            shapes = b1_shapes(seen)
            heads = {c[4] for c in seen}
            L = max(k[1] for k in shapes)
            stages = cur.get("stages_s", {})
            log(f"[{tag}] client {wall:.3f} s, the controller's edit "
                f"{cur['edit_s']:.3f} s (text stage "
                f"{stages.get('text', 0.0):.3f} s), LoRA switch "
                f"{cur.get('lora_s', 0.0):.3f} s; peak {peak_gb:.2f} GB; "
                f"allocated after it {between / 1e9:.3f} GB (limit "
                f"{limit / 1e9:.3f}: DiT + VAE + adapters "
                f"{ad_bytes / 1e9:.3f} GB + {SERVE_MEM_SLACK / 1e9:.0f} GB); "
                f"mp4 {info[0]} frames of {info[1]}x{info[2]}; B1 calls "
                f"{shapes} at heads {sorted(heads)}; launches {launches}")
            log(f"[{tag}] stage walls (s): " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()))
            check_launches(tag, launches, want)
            if shapes != {(1, L, L, None): per,
                          (1, L, TEXT_TOKENS, None): per} or heads != {
                    cfg14.num_heads}:
                fail(f"{tag}: B1 calls {shapes} at heads {heads}")
            if between >= limit:
                fail(f"{tag}: {between / 1e9:.3f} GB allocated between "
                     f"requests, above {limit / 1e9:.3f} GB")
            if (runtime is None) != (name == "none"):
                fail(f"{tag}: runtime adapters attached: "
                     f"{runtime is not None}")
            requests.append({"lora": name, "client_s": wall,
                             "edit_s": cur["edit_s"], "stages_s": stages,
                             "lora_switch_s": cur.get("lora_s"),
                             "peak_memory_gb": peak_gb,
                             "allocated_between_gb": between / 1e9,
                             "launches": launches})
            del runtime     # the next request's reading must not hold it
        edits = [e[:, :, -geo.source_frames:] for e in encoded]
        differ = all(not np.array_equal(edits[a], edits[b])
                     for a, b in ((0, 1), (0, 2), (1, 2)))
        diff = np.abs(encoded[3] - encoded[0])
        same = bool(diff.max() == 0)
        log(f"[serve 14B] edits of requests 1, 2, 3 differ pairwise: "
            f"{'ok' if differ else 'FAIL'}; request 4 (FusionX again) equal "
            f"to request 1 bit for bit: {'ok' if same else 'FAIL'} (max "
            f"difference {diff.max():.3e}, share of values that differ "
            f"{float((diff > 0).mean()):.3e})")
        if not differ:
            fail("the 14B server's edits under other LoRA sets are equal")
        if not same:
            fail("request 4 differs from request 1 under the same LoRA file")
        check_metrics("serve 14B", url, {
            "requests_total": 4, "failures_total": 0,
            "generate_seconds_count": 4, "busy": 0})
        code, health = http_call(url, "/healthz")
        page_code, page = http_call(url, "/")
        log(f"[serve 14B] /healthz {code} {health}; / {page_code}, "
            f"{len(page)} characters")
        if code != 200 or health.get("status") != "ok":
            fail(f"/healthz answered {code} {health}")
        if page_code != 200 or api.ENDPOINT not in page:
            fail(f"/ answered {page_code}")
        probes = [
            ("an unknown path", "/nowhere", {}, None, 404),
            ("a missing video", api.ENDPOINT, {"prompt_textbox": prompt},
             None, 400),
            ("an embeddings-in payload", api.ENDPOINT,
             {"embeddings_path": "assets/embeds.npz"}, None, 400),
            ("a source_video_path outside the allowlist", api.ENDPOINT,
             {"prompt_textbox": prompt, "source_video_path": str(clip)},
             None, 403),
            ("an update outside VIDEOCOF_MODEL_DIRS", api.UPDATE_ENDPOINT,
             {"diffusion_transformer_path": str(SCRATCH)}, None, 403),
            ("a lora_model_path outside VIDEOCOF_MODEL_DIRS", api.ENDPOINT,
             edit_payload(geo, prompt, clip_b64, lora_model_path=str(clip)),
             None, 403),
            ("an oversized Content-Length", api.ENDPOINT, None, 10 ** 12,
             413)]
        for label, path, payload, length, want_code in probes:
            code, body = http_call(url, path, payload, content_length=length)
            log(f"[serve 14B] {label}: {code} {body}")
            if code != want_code:
                fail(f"the server answered {label} with {code}, expected "
                     f"{want_code}")
        # the JAX API counts a refused video as a failed request, and the
        # port a refused LoRA file too; the other refusals come before the
        # counting
        check_metrics("serve 14B", url, {
            "requests_total": 7, "failures_total": 3,
            "generate_seconds_count": 4, "busy": 0})
    os.environ.pop("VIDEOCOF_MODEL_DIRS", None)
    record = {"card": card, "build_s": build_s, "tokens": L,
              "dit_bytes": resident["dit"], "vae_bytes": resident["vae"],
              "t5_host_bytes": t5_bytes, "requests": requests}
    log("[serve 14B] " + json.dumps(record))
    return record


def swap_phase(card, dcfg, geo, gen, prompt, counters, clip, want_frames):
    """The ComfyUI nodes and the weight swap at 1.3B: `VideoCoFModelLoader`
    twice (one build) and `VideoCoFEdit` on a torch IMAGE wire of ``clip``
    (2 x layers x steps B1 launches); then that pipeline behind the API: a
    second DiT draw written by `save_dit_checkpoint_dir`, swapped in by the
    update endpoint (in place: the DiT equal to the draw bit for bit, the
    allocated memory flat within SWAP_MEM_SLACK, the peak within the
    largest tensor + SWAP_PEAK_SLACK), an edit request after it against a
    `WanPipeline` on the second draw with the same VAE and umT5 (final
    latents within SWAP_REL_TOL); the LoRA sequence FusionX, VideoCoF, none
    merged in bf16 (the largest ulp distance from the original weights,
    printed); two concurrent requests (both answered, one after the other,
    ``busy`` >= 1 while they run); then the DiT quantized to fp8, an
    adapter attached and the same swap (fp8 weights and scales equal to
    `quantize_dit_fp8` of the draw bit for bit, the adapters detached).
    Returns the phase's record."""
    import threading
    import numpy as np
    import torch
    from videocof_torch.comfyui.comfyui_nodes import (VideoCoFEdit,
                                                      VideoCoFModelLoader)
    from videocof_torch.models.wan_dit import init_wan_dit
    from videocof_torch.pipeline import WanPipeline
    from videocof_torch.serving import VideoCoFController, api
    from videocof_torch.utils import checkpoint, video_io
    from videocof_torch.utils.fp8 import FP8, quantize_dit_fp8
    launch_counts, reset_launch_counts = counters
    dev, bf16 = gen.device, torch.bfloat16
    want = dict(dict.fromkeys(launch_counts(), 0), flash_attention_fwd=(
        2 * dcfg.num_layers * geo.num_inference_steps))

    # ComfyUI: the loader's one cached build, the edit node on a torch wire
    t0 = time.perf_counter()
    (pipe,) = VideoCoFModelLoader().load("", "none", True)
    (again,) = VideoCoFModelLoader().load("", "none", True)
    build_s = time.perf_counter() - t0
    frames, _, _ = video_io.load_video_frames(str(clip), geo.source_frames)
    wire = torch.from_numpy(frames[0].transpose(1, 2, 3, 0).astype(
        np.float32) / 255.0)
    reset_launch_counts()
    t0 = time.perf_counter()
    (out,) = VideoCoFEdit().edit(
        pipe, wire, prompt, steps=geo.num_inference_steps,
        guidance_scale=geo.guidance_scale, seed=SEED,
        reasoning_frames=geo.reasoning_frames)
    comfy_s = time.perf_counter() - t0
    launches = launch_counts()
    want_shape = (geo.source_frames, geo.height, geo.width, 3)
    ok = (isinstance(out, torch.Tensor) and tuple(out.shape) == want_shape
          and bool(torch.isfinite(out).all()) and 0.0 <= out.min().item()
          and out.max().item() <= 1.0)
    log(f"[comfyui] the loader twice: one pipeline: {again is pipe} "
        f"({build_s:.1f} s); the edit node on a torch IMAGE wire "
        f"{tuple(wire.shape)}: {type(out).__name__} {tuple(out.shape)} in "
        f"[{out.min().item():.4f}, {out.max().item():.4f}], {comfy_s:.3f} s; "
        f"launches {launches}")
    if again is not pipe:
        fail("VideoCoFModelLoader built its pipeline twice")
    if not ok:
        fail(f"VideoCoFEdit returned {type(out).__name__} "
             f"{tuple(getattr(out, 'shape', ()))}, expected {want_shape}")
    check_launches("ComfyUI edit", launches, want)
    VideoCoFModelLoader._cache_pipe = None      # the controller owns it now
    del out, again, wire, frames

    # the swap into bf16 weights, in place
    ckpt = SCRATCH / "swap_dit"
    draw = init_wan_dit(dcfg, torch.Generator(device=dev).manual_seed(
        SEED + 7), bf16, dev)
    checkpoint.save_dit_checkpoint_dir(str(ckpt), draw, dcfg)
    # the draw itself, on the host: the swap is held against it, not
    # against the file read back through the loader the swap uses
    drawn = {k: v.cpu() for k, v in draw.state_dict().items()}
    del draw
    torch.cuda.empty_cache()
    os.environ["VIDEOCOF_MODEL_DIRS"] = str(SCRATCH)
    controller = VideoCoFController(pipe)
    clip_b64 = b64_file(clip)
    with http_server(controller) as url:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        largest = max(t.numel() * t.element_size()
                      for t in pipe.dit.state_dict().values())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        code, reply = http_call(url, api.UPDATE_ENDPOINT,
                                {"diffusion_transformer_path": str(ckpt)})
        torch.cuda.synchronize()
        swap_s = time.perf_counter() - t0
        after = torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated()
        resident = pipe.dit.state_dict()
        exact = set(drawn) == set(resident) and all(
            torch.equal(resident[k].cpu(), v) for k, v in drawn.items())
        log(f"[swap] update endpoint {code} {reply} in {swap_s:.3f} s; the "
            f"DiT equal to the saved draw bit for bit, tensor by tensor: "
            f"{'ok' if exact else 'FAIL'};"
            f" allocated {before / 1e9:.3f} -> {after / 1e9:.3f} GB (slack "
            f"{SWAP_MEM_SLACK / 1e6:.0f} MB); peak {peak / 1e9:.3f} GB, limit "
            f"{(before + largest + SWAP_PEAK_SLACK) / 1e9:.3f} GB (largest "
            f"tensor {largest / 1e6:.1f} MB)")
        if code != 200 or reply.get("message") != "Success" or not exact:
            fail("the weight swap did not load the checkpoint")
        if abs(after - before) > SWAP_MEM_SLACK:
            fail(f"the weight swap moved the allocated memory by "
                 f"{(after - before) / 1e6:.1f} MB")
        if peak > before + largest + SWAP_PEAK_SLACK:
            fail(f"the weight swap peaked at {peak / 1e9:.3f} GB: a second "
                 f"model on the card")
        del drawn, resident

        # an edit after the swap against a pipeline on the second draw
        latents = {}

        def keep_latents(p, key):
            real = p._decode_outputs

            def decode(lat, *a):
                latents[key] = lat.float().cpu()
                return real(lat, *a)
            p._decode_outputs = decode
        keep_latents(pipe, "server")
        reset_launch_counts()
        t0 = time.perf_counter()
        code, reply = http_call(url, api.ENDPOINT,
                                edit_payload(geo, prompt, clip_b64))
        edit_s = time.perf_counter() - t0
        del pipe._decode_outputs
        if code != 200 or reply.get("message") != "Success":
            fail(f"the edit after the swap: {code} {str(reply)[:300]}")
        reply_video("swap", reply, geo, want_frames, "swap.mp4")
        check_launches("edit after the swap", launch_counts(), want)
        direct = WanPipeline(init_wan_dit(dcfg, torch.Generator(
            device=dev).manual_seed(SEED + 7), bf16, dev), pipe.vae, pipe.t5,
            pipe.tokenizer)
        keep_latents(direct, "direct")
        VideoCoFController(direct).generate(
            video_path=str(clip), prompt=prompt, seed=SEED,
            num_inference_steps=geo.num_inference_steps,
            guidance_scale=geo.guidance_scale,
            source_frames=geo.source_frames,
            reasoning_frames=geo.reasoning_frames)
        del direct
        torch.cuda.empty_cache()
        rel = float((latents["server"] - latents["direct"]).norm()
                    / latents["direct"].norm())
        log(f"[swap] an edit request after the swap ({edit_s:.3f} s): final "
            f"latents against a WanPipeline built on the second draw with "
            f"the same VAE and umT5: relative L2 {rel:.3e} (tol "
            f"{SWAP_REL_TOL})")
        if not rel <= SWAP_REL_TOL:
            fail(f"the swapped server's edit strays from the second draw's: "
                 f"{rel:.3e}")

        # the LoRA sequence merged into bf16 weights and out again
        orig = {k: v.clone() for k, v in pipe.dit.state_dict().items()}
        (fx, vc), _ = write_lora_files(dcfg, gen, SCRATCH / "lora_1.3b")
        t0 = time.perf_counter()
        for path in (fx, vc, None):
            controller.ensure_lora(path)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        def ordered(t):         # bf16 bits -> integers in value order
            i = t.view(torch.int16).int()
            return torch.where(i < 0, -(i & 0x7FFF), i)
        ulps, err, changed = 0, 0.0, 0
        for k, v in pipe.dit.state_dict().items():
            if v.dtype == bf16 and not torch.equal(v, orig[k]):
                changed += 1
                ulps = max(ulps, (ordered(v) - ordered(orig[k])).abs().max()
                           .item())
                err = max(err, (v.float() - orig[k].float()).abs().max()
                          .item())
        log(f"[swap] LoRA FusionX, then VideoCoF, then none merged in bf16 "
            f"in {merge_s:.3f} s: {changed} weights not back bit for bit, "
            f"the largest distance {ulps} ulp, {err:.3e} absolute (the JAX "
            f"package's unmerge is not exact either)")
        del orig

        # two requests at once: answered, one after the other
        spans, polled, done = [], [], threading.Event()
        real_gen = controller.generate

        def spanned(**kw):
            t = time.perf_counter()
            try:
                return real_gen(**kw)
            finally:
                spans.append((t, time.perf_counter()))
        controller.generate = spanned
        replies = [None, None]

        def post(i):
            replies[i] = http_call(url, api.ENDPOINT, edit_payload(
                geo, prompt, clip_b64, seed_textbox=SEED + i))

        def poll():
            while not done.is_set():
                polled.append(metric_values(http_call(url, "/metrics")[1])[
                    "busy"])
                time.sleep(0.2)
        poller = threading.Thread(target=poll)
        poller.start()
        threads = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        both_s = time.perf_counter() - t0
        done.set()
        poller.join(timeout=30)
        controller.generate = real_gen
        spans.sort()
        serial = len(spans) == 2 and spans[0][1] <= spans[1][0]
        answered = all(r and r[0] == 200 and r[1].get("message") == "Success"
                       for r in replies)
        log(f"[swap] two concurrent requests: answered "
            f"{[r and r[0] for r in replies]} in {both_s:.3f} s; one after "
            f"the other: {'ok' if serial else 'FAIL'}; busy polled up to "
            f"{max(polled, default=0):.0f}")
        if not answered or any(th.is_alive() for th in threads):
            fail(f"the concurrent requests: {[r and r[0] for r in replies]}")
        if not serial:
            fail(f"the concurrent generations overlapped: {spans}")
        if not max(polled, default=0) >= 1:
            fail("/metrics never read busy >= 1 during the requests")

        # the swap into fp8 weights with runtime adapters attached
        quantize_dit_fp8(pipe.dit)
        controller.ensure_lora(fx)
        attached = pipe.dit.runtime_lora is not None
        t0 = time.perf_counter()
        code, reply = http_call(url, api.UPDATE_ENDPOINT,
                                {"diffusion_transformer_path": str(ckpt)})
        torch.cuda.synchronize()
        swap8_s = time.perf_counter() - t0
        ref = quantize_dit_fp8(init_wan_dit(dcfg, torch.Generator(
            device=dev).manual_seed(SEED + 7), bf16, dev))   # the draw again
        want_sd, got_sd = ref.state_dict(), pipe.dit.state_dict()
        same = set(want_sd) == set(got_sd) and all(
            torch.equal(*(t.view(torch.uint8) if t.dtype == FP8 else t
                          for t in (got_sd[k], v)))
            for k, v in want_sd.items())
        detached = pipe.dit.runtime_lora is None
        log(f"[swap] into fp8 weights with runtime adapters attached "
            f"({attached}): {code} {reply} in {swap8_s:.3f} s; fp8 weights "
            f"and scales equal to quantize_dit_fp8 of the draw bit for bit: "
            f"{'ok' if same else 'FAIL'}; adapters detached: "
            f"{'ok' if detached else 'FAIL'}")
        if not (attached and code == 200 and same and detached):
            fail("the swap into fp8 weights")
        del ref, want_sd, got_sd
    os.environ.pop("VIDEOCOF_MODEL_DIRS", None)
    record = {"card": card, "build_s": build_s, "comfyui_edit_s": comfy_s,
              "swap_s": swap_s, "swap_peak_gb": peak / 1e9,
              "allocated_before_gb": before / 1e9,
              "allocated_after_gb": after / 1e9,
              "largest_tensor_mb": largest / 1e6,
              "edit_after_swap_s": edit_s, "rel_l2_vs_second_draw": rel,
              "lora_merge_s": merge_s, "lora_unmerge_max_ulp": ulps,
              "lora_unmerge_max_abs": err,
              "concurrent_two_s": both_s, "swap_fp8_s": swap8_s}
    log("[swap] " + json.dumps(record))
    return record


def serving_entry_phase(card, geo, prompt, clip, want_frames):
    """`python -m videocof_torch.serving.api --random_init --offload_t5` as
    a subprocess on a free port, with VIDEOCOF_ASSET_DIRS naming SCRATCH:
    /healthz within SERVER_START_S; `WorkerPool` sees it healthy and maps
    two payloads (``source_video_path`` inside the allowlist) to two
    "Success" replies; `VideoCoFClient.post_to_host` writes an mp4 that cv2
    reads back at the geometry; the server exits within SERVER_STOP_S of
    SIGTERM. On a failure the server's log tail is printed. Returns the
    phase's record."""
    from videocof_torch.serving import VideoCoFClient
    from videocof_torch.serving.multihost import WorkerPool
    from videocof_torch.utils import video_io
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    log_path = SCRATCH / "server.log"
    env = dict(os.environ, VIDEOCOF_ASSET_DIRS=str(SCRATCH),
               PYTHONUNBUFFERED="1")
    argv = [sys.executable, "-m", "videocof_torch.serving.api",
            "--random_init", "--offload_t5", "--port", str(port)]
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=logf,
                                stderr=subprocess.STDOUT)

    def bad(msg):
        log("[serve entry] the server's log, last lines:\n"
            + "\n".join(log_path.read_text().splitlines()[-40:]))
        fail(msg)
    record = {"card": card}
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                bad(f"the server exited with {proc.returncode} before "
                    f"answering /healthz")
            try:
                if http_call(url, "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > SERVER_START_S:
                bad(f"no /healthz within {SERVER_START_S} s")
            time.sleep(1.0)
        record["ready_s"] = time.perf_counter() - t0
        pool = WorkerPool([url], timeout=900)
        healthy = pool.healthy()
        payloads = [{"prompt_textbox": prompt,
                     "source_video_path": str(clip),
                     "seed_textbox": SEED + i,
                     "sample_step_slider": geo.num_inference_steps,
                     "source_frames": geo.source_frames,
                     "reasoning_frames": geo.reasoning_frames}
                    for i in range(2)]
        t0 = time.perf_counter()
        replies = pool.map(payloads)
        record["pool_map_two_s"] = time.perf_counter() - t0
        messages = [r.get("message") for r in replies]
        save = SCRATCH / "client" / "edit.mp4"
        t0 = time.perf_counter()
        out = VideoCoFClient(url, timeout=900).post_to_host(
            prompt, video_path=str(clip), save_path=str(save),
            seed_textbox=SEED, sample_step_slider=geo.num_inference_steps,
            source_frames=geo.source_frames,
            reasoning_frames=geo.reasoning_frames)
        record["client_s"] = time.perf_counter() - t0
        info = video_io.video_info(str(save)) if save.exists() else None
        log(f"[serve entry] {' '.join(argv[1:])}: /healthz after "
            f"{record['ready_s']:.1f} s; WorkerPool.healthy() {healthy}; "
            f"map of two payloads {messages} in "
            f"{record['pool_map_two_s']:.3f} s; VideoCoFClient.post_to_host "
            f"{out.get('message')} in {record['client_s']:.3f} s, wrote "
            f"{info}")
        if healthy != [url]:
            bad(f"WorkerPool.healthy() gave {healthy}")
        if messages != ["Success", "Success"]:
            bad(f"WorkerPool.map gave {messages}")
        if info is None or info[:3] != (want_frames, geo.height, geo.width):
            bad(f"post_to_host wrote {info}")
    finally:
        t0 = time.perf_counter()
        proc.terminate()
        try:
            proc.wait(timeout=SERVER_STOP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"the server did not exit within {SERVER_STOP_S} s")
    record["stop_s"] = time.perf_counter() - t0
    log(f"[serve entry] SIGTERM: exited with {proc.returncode} in "
        f"{record['stop_s']:.2f} s")
    log("[serve entry] " + json.dumps(record))
    return record


def nccl_phase(card):
    """`init_distributed` on NCCL as a world of 1 over
    ``tcp://127.0.0.1:<free port>``: an all_reduce of a CUDA tensor, then
    `destroy_process_group`."""
    import torch
    import torch.distributed as dist
    from videocof_torch.serving.multihost import init_distributed
    t0 = time.perf_counter()
    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    backend = dist.get_backend()
    x = torch.arange(4, dtype=torch.float32, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    ok = backend == "nccl" and x.tolist() == [0.0, 1.0, 2.0, 3.0]
    dist.destroy_process_group()
    wall = time.perf_counter() - t0
    log(f"[nccl] init_distributed: backend {backend}, world of 1, "
        f"all_reduce {x.tolist()}, destroyed, in {wall:.2f} s: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("init_distributed on NCCL")
    return {"card": card, "backend": backend, "seconds": wall}


# ------------------------------------------------- phase 21: parallelism
# The collectives the parallel path runs, each probed on CUDA tensors by two
# ranks on the one card (a pair of processes per backend and collective, so
# that one that crashes or hangs takes no other probe with it).
PROBE_OPS = ("all_reduce", "all_to_all_single", "all_gather_into_tensor",
             "reduce_scatter_tensor", "batch_isend_irecv",
             # phase 29's: the pipeline's hop (`_collectives.ppermute`, every
             # split empty but the neighbour's) and the experts' bytes
             "all_to_all_single_uneven", "all_reduce_uint8",
             # and FSDP's reduce-scatter of a bf16 full fine-tune's
             # gradients
             "reduce_scatter_tensor_bf16")
PROBE_TIMEOUT_S = 120


def _probe_worker(rank, world, init_file, backend, op, out_path):
    """One rank of a probe: ``op`` on a CUDA tensor of ``backend``; writes
    {"ok": bool, "error": str | None} to ``out_path.rank<r>``."""
    import torch
    import torch.distributed as dist
    result = {"ok": False, "error": None}
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank)
        dev = torch.device("cuda", 0)
        x = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank
        if op == "all_reduce":
            dist.all_reduce(x)
            want = (torch.arange(4 * world, device=dev) * world
                    + sum(range(world))).float()
        elif op == "all_to_all_single":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
            want = torch.cat([torch.arange(4 * rank, 4 * rank + 4,
                                           device=dev).float() + s
                              for s in range(world)])
            x = out
        elif op == "all_gather_into_tensor":
            out = torch.empty(world * x.numel(), device=dev)
            dist.all_gather_into_tensor(out, x)
            want = torch.cat([torch.arange(4 * world, device=dev).float() + s
                              for s in range(world)])
            x = out
        elif op == "all_to_all_single_uneven":
            # rank i sends its 4 * world values to rank i + 1 alone
            out = torch.empty_like(x)
            recv = [0] * world
            send = [0] * world
            recv[(rank - 1) % world] = x.numel()
            send[(rank + 1) % world] = x.numel()
            dist.all_to_all_single(out, x, recv, send)
            want = torch.arange(4 * world, device=dev).float() + (
                (rank - 1) % world)
            x = out
        elif op == "all_reduce_uint8":
            # the owner's bytes, the zeros of the others
            x = (torch.arange(4 * world, device=dev) % 251 + 1).to(
                torch.uint8) * (rank == 0)
            dist.all_reduce(x)
            want = (torch.arange(4 * world, device=dev) % 251 + 1).to(
                torch.uint8)
        elif op.startswith("reduce_scatter_tensor"):
            dtype = torch.bfloat16 if op.endswith("bf16") else torch.float32
            out = torch.empty(4, device=dev, dtype=dtype)
            dist.reduce_scatter_tensor(out, x.to(dtype))
            want = (torch.arange(4 * rank, 4 * rank + 4, device=dev) * world
                    + sum(range(world))).to(dtype)
            x = out
        else:
            out = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
                   dist.P2POp(dist.irecv, out, (rank - 1) % world)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            want = torch.arange(4 * world, device=dev).float() + (
                (rank - 1) % world)
            x = out
        torch.cuda.synchronize()
        result["ok"] = bool(torch.equal(x, want))
        if not result["ok"]:
            result["error"] = f"wrong values {x.tolist()}"
        dist.destroy_process_group()
    except Exception as e:      # the probe's answer: recorded, not raised
        result["error"] = f"{type(e).__name__}: {str(e).strip()[:400]}"
    Path(f"{out_path}.rank{rank}").write_text(json.dumps(result))


def start_probes(world=2):
    """Start the probes of the collectives on CUDA tensors of two ranks on
    cuda:0: NCCL (one all_reduce: two ranks on one device) and gloo (every
    collective of the path), a pair of processes each; `finish_probes`
    collects them."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    base = SCRATCH / "probe"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    jobs = [("nccl", "all_reduce")] + [("gloo", op) for op in PROBE_OPS]
    procs = {}
    for backend, op in jobs:
        tag = f"{backend}_{op}"
        out = base / f"{tag}.json"
        procs[(backend, op)] = [
            ctx.Process(target=_probe_worker,
                        args=(r, world, str(base / f"{tag}.rdzv"), backend,
                              op, str(out)))
            for r in range(world)]
    for ps in procs.values():
        for p in ps:
            p.start()
    return procs, base, time.perf_counter() + PROBE_TIMEOUT_S, world


def finish_probes(started):
    """{backend: {op: result}} of `start_probes`: a rank that crashes or
    outlives ``PROBE_TIMEOUT_S`` from the start is recorded as such (its
    exit code or "timeout") and killed."""
    procs, base, deadline, world = started
    results = {}
    for (backend, op), ps in procs.items():
        codes = []
        for p in ps:
            p.join(max(0.0, deadline - time.perf_counter()))
            if p.is_alive():
                p.kill()
                p.join()
                codes.append("timeout")
            else:
                codes.append(p.exitcode)
        answers = []
        for r in range(world):
            out = base / f"{backend}_{op}.json.rank{r}"
            answers.append(json.loads(out.read_text()) if out.exists()
                           else {"ok": False, "error": "no answer"})
        res = {"ok": all(a["ok"] for a in answers),
               "error": "; ".join(f"rank {r}: {a['error']}"
                                  for r, a in enumerate(answers)
                                  if a["error"]) or None,
               "exit_codes": codes}
        results.setdefault(backend, {})[op] = res
        log(f"[parallel] probe {backend} {op} on CUDA tensors, 2 ranks on "
            f"cuda:0: {'ok' if res['ok'] else 'refused'}"
            + ("" if res["ok"] else f": {res['error']} (exit codes "
               f"{codes})"))
    shutil.rmtree(base, ignore_errors=True)
    return results


def _edit_kw(geo):
    """The 4-step edit's arguments of a `GenerationConfig`."""
    return dict(source_frames=geo.source_frames,
                reasoning_frames=geo.reasoning_frames,
                num_inference_steps=geo.num_inference_steps,
                shift=geo.shift, sampler=geo.sampler,
                repeat_rope=geo.repeat_rope, seed=geo.seed)


def sp_tokens(dcfg, geo, source_frames):
    """DiT tokens of a CoF edit of ``source_frames`` at ``geo`` (the Wan2.1
    VAE's 4x temporal, 8x spatial compression)."""
    from videocof_torch.pipeline import latent_frame_count
    cond = latent_frame_count(source_frames)
    ground = latent_frame_count(geo.reasoning_frames)
    _, ph, pw = dcfg.patch_size
    return ((2 * cond + ground) * (geo.height // 8 // ph)
            * (geo.width // 8 // pw))


def _b1_by_shape(seen):
    """{"(batch, Lq, Lk, heads, masked)": calls} of a `b1_calls` record."""
    shapes = {}
    for B, Lq, Lk, mask, heads in seen:
        key = str((B, Lq, Lk, heads, mask is not None))
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def _sp_edit_rank(rank, world, init_file, out_dir, video, prompt, edit_kw,
                  negative, layers):
    """One rank of phase 21 (b) and (d), on cuda:0 beside the other, in a
    gloo world: the factory's 1.3B pipeline from the seed (its first
    ``layers`` layers), then the 4-step
    edit with Ulysses over seq ``world`` and the guidance-5 edit with one
    guidance branch per data rank; for each, the final latents (and on
    rank 0 the uint8 frames), the launches and B1 calls by shape, the stage
    walls and the peak memory, into ``out_dir/rank<r>.pt``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from videocof_torch import factory
    from videocof_torch.ops import flash_attention as fa
    from videocof_torch.parallel import rank_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    dev = rank_device()
    torch.cuda.set_device(dev)
    with shallow_1_3b(layers):
        pipe = factory.load_pipeline("", random_init=True, seed=SEED,
                                     device=dev)
    results = {"device": str(dev)}
    for job, sp_kw, kw in (
            ("ulysses", dict(seq=world, mode="ulysses"), {}),
            ("cfg", dict(data=world, seq=1, cfg_parallel=True),
             dict(guidance_scale=5.0, negative_prompt=negative))):
        pipe.enable_sequence_parallel(**sp_kw)
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        timings = {}
        t0 = time.perf_counter()
        with b1_calls() as seen, dit_step_memory(pipe) as mem:
            out = pipe(video, prompt, output_latents=True, timings=timings,
                       **edit_kw, **kw)
        wall = time.perf_counter() - t0
        peak = max(mem["pre_gb"], torch.cuda.max_memory_allocated() / 1e9)
        results[job] = {
            "latents": out.latents, "launches": fa.launch_counts(),
            "b1": _b1_by_shape(seen), "stages_s": timings, "seconds": wall,
            "peak_memory_gb": peak, "dit_steps_gb": mem["dit_steps_gb"],
            "u8": (np.round(out.videos * 255).astype(np.uint8)
                   if rank == 0 else None)}
        pipe.disable_sequence_parallel()
    dist.barrier()
    dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


@contextlib.contextmanager
def dit_step_memory(pipe):
    """While the block runs: the device memory the pipeline's denoising
    steps take above what was allocated when they started (the DiT's
    activations), in GB, into the yielded dict's "dit_steps_gb"; the peak
    before them into "pre_gb" (the peak statistics restart with the
    steps: the call's peak is the larger of "pre_gb" and the peak read
    after it)."""
    import torch
    rec = {}
    real = pipe._t2v_denoise

    def denoise(*args, **kw):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        rec["pre_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        rec["dit_steps_gb"] = (torch.cuda.max_memory_allocated() - start) / 1e9
        return out

    pipe._t2v_denoise = denoise
    try:
        yield rec
    finally:
        del pipe._t2v_denoise


def _spawn_ranks(target, world, args, tag):
    """``target(rank, world, *args)`` in ``world`` spawned processes; each
    is waited for (SP_TIMEOUT_S in all) and killed if it outlives it. Fails
    the run unless every rank exits 0."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + SP_TIMEOUT_S
    codes = []
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
        if p.is_alive():
            p.kill()
            p.join()
            codes.append("timeout")
        else:
            codes.append(p.exitcode)
    if codes != [0] * world:
        fail(f"{tag}: ranks exited {codes}")


def _u8_diff(a, b):
    """(largest, mean) difference of two uint8 arrays, in levels."""
    import numpy as np
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float(d.mean())


def _rel_l2(got, want):
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def sp_edit_phase(card, geo, video, prompt, counters, probe):
    """Phase 21 (b) Ulysses at seq 2 and (d) CFG parallelism at data 2, two
    gloo ranks on the one card (NCCL refuses two ranks on one device, the
    probe's finding), each rank's edit against the world-1 edit of the same
    factory weights and seed in this process: the largest and mean uint8
    difference, the latents' relative L2 (<= SP_REL_TOL), B1's launches on
    each rank by shape, each rank's peak beside world 1's. ``probe()``
    (phase 21 (a), started before) is collected between the world-1 edits
    and the ranks; the path's collectives must have passed it."""
    import numpy as np
    import torch
    from videocof_torch import factory
    launch_counts, reset_launch_counts = counters
    edit_kw = _edit_kw(geo)
    negative = geo.negative_prompt
    pipe = factory.load_pipeline("", random_init=True, seed=SEED)
    ref = {}
    for job, kw in (("ulysses", {}),
                    ("cfg", dict(guidance_scale=5.0,
                                 negative_prompt=negative))):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with dit_step_memory(pipe) as mem:
            out = pipe(video, prompt, output_latents=True, **edit_kw, **kw)
        torch.cuda.synchronize()
        ref[job] = {"latents": out.latents, "seconds":
                    time.perf_counter() - t0,
                    "u8": np.round(out.videos * 255).astype(np.uint8),
                    "peak_memory_gb": max(
                        mem["pre_gb"], torch.cuda.max_memory_allocated() / 1e9),
                    "dit_steps_gb": mem["dit_steps_gb"],
                    "launches": launch_counts()}
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()
    probed = probe()
    for op in ("all_reduce", "all_to_all_single", "all_gather_into_tensor"):
        if not probed["gloo"][op]["ok"]:
            fail(f"gloo {op} on CUDA tensors: {probed['gloo'][op]}")
    base = SCRATCH / "sp_edit"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    free, total = torch.cuda.mem_get_info()
    log(f"[parallel] edit ranks start with {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB free on the card (this process holds "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB)")
    t0 = time.perf_counter()
    _spawn_ranks(_sp_edit_rank, SP_DEGREE,
                 (str(base / "rdzv"), str(base), video, prompt, edit_kw,
                  negative, SP_LAYERS), "phase 21 edits")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(base / f"rank{r}.pt", weights_only=False)
             for r in range(SP_DEGREE)]
    shutil.rmtree(base, ignore_errors=True)
    dcfg = factory.WAN21_T2V_1_3B
    L = sp_tokens(dcfg, geo, geo.source_frames)
    heads, layers = dcfg.num_heads, dcfg.num_layers
    steps = geo.num_inference_steps
    record = {"card": card, "world": SP_DEGREE, "backend": "gloo",
              "ranks_seconds_total": spawn_s, "probe": probed}
    for job, want_b1 in (
            ("ulysses", {str((1, L, L, heads // SP_DEGREE, False)):
                         layers * steps,
                         str((1, L // SP_DEGREE, TEXT_TOKENS, heads,
                              False)): layers * steps}),
            ("cfg", {str((1, L, L, heads, False)): layers * steps,
                     str((1, L, TEXT_TOKENS, heads, False)):
                     layers * steps})):
        w1 = ref[job]
        rec = {"world1": {k: w1[k] for k in ("seconds", "peak_memory_gb",
                                             "dit_steps_gb", "launches")},
               "ranks": []}
        for r, got in enumerate(ranks):
            g = got[job]
            rel = _rel_l2(g["latents"], w1["latents"])
            row = {"device": got["device"], "latents_rel_l2": rel,
                   **{k: g[k] for k in ("seconds", "peak_memory_gb",
                                        "dit_steps_gb", "launches", "b1",
                                        "stages_s")}}
            if g["u8"] is not None:
                row["u8_max_diff"], row["u8_mean_diff"] = _u8_diff(
                    g["u8"], w1["u8"])
                if g["u8"].shape != w1["u8"].shape:
                    fail(f"phase 21 {job}: frames {g['u8'].shape} != "
                         f"{w1['u8'].shape}")
            rec["ranks"].append(row)
            log(f"[parallel] {job} rank {r} on {got['device']}: latents "
                f"relative L2 {rel:.3e} (gate {SP_REL_TOL})"
                + (f", uint8 max {row['u8_max_diff']} mean "
                   f"{row['u8_mean_diff']:.4f}" if "u8_max_diff" in row
                   else "")
                + f"; {g['seconds']:.3f} s; peak {g['peak_memory_gb']:.2f} "
                f"GB, the DiT steps {g['dit_steps_gb']:.3f} GB over their "
                f"start (world 1: {w1['peak_memory_gb']:.2f} GB, "
                f"{w1['dit_steps_gb']:.3f} GB, {w1['seconds']:.3f} s); B1 "
                f"calls {g['b1']}")
            if not np.isfinite(g["latents"]).all() or rel > SP_REL_TOL:
                fail(f"phase 21 {job} rank {r}: latents {rel:.3e} from "
                     f"world 1's")
            if g["b1"] != want_b1:
                fail(f"phase 21 {job} rank {r}: B1 calls {g['b1']}, "
                     f"expected {want_b1}")
            if g["launches"]["flash_attention_fwd"] != 2 * layers * steps:
                fail(f"phase 21 {job} rank {r}: launches {g['launches']}")
        record[job] = rec
    log("[parallel] edits " + json.dumps(record))
    return record


def sp_ring_phase(card, geo, prompt, ref4, counters):
    """Phase 21 (c): ring attention on the 4x edit. gloo carries no
    point-to-point on CUDA tensors (the probe), and NCCL refuses two ranks
    on one card, so ring runs here at world 1 under NCCL: one shard, B2
    over all 107,640 keys and the fp32 LSE combine, the cross-attention
    B1; held against phase 9's 4x edit of the same weights and seed."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from videocof_torch import factory
    from videocof_torch.serving.multihost import init_distributed
    launch_counts, reset_launch_counts = counters
    video4 = np.random.default_rng(SEED).integers(   # phase 9's clip
        0, 256, (1, 3, EXTRAP_FRAMES, geo.height, geo.width), dtype=np.uint8)
    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                     backend="nccl")
    pipe = factory.load_pipeline("", random_init=True, seed=SEED)
    pipe.enable_sequence_parallel(seq=1, mode="ring")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    timings = {}
    t0 = time.perf_counter()
    with b1_calls() as seen:
        out = pipe(video4, prompt, output_latents=True, timings=timings,
                   riflex_k=RIFLEX_K, **dict(_edit_kw(geo),
                                             source_frames=EXTRAP_FRAMES))
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    backend = dist.get_backend()
    pipe.disable_sequence_parallel()
    dist.destroy_process_group()
    L = sp_tokens(pipe.dit.cfg, geo, EXTRAP_FRAMES)
    layers, steps = pipe.dit.cfg.num_layers, geo.num_inference_steps
    heads = pipe.dit.cfg.num_heads
    del pipe
    rel = _rel_l2(out.latents, ref4["latents"])
    u8 = np.round(out.videos * 255).astype(np.uint8)
    umax, umean = _u8_diff(u8, ref4["u8"])
    b1 = _b1_by_shape(seen)
    want_b1 = {str((1, L, TEXT_TOKENS, heads, False)): layers * steps}
    want = {"flash_attention_fwd": layers * steps,
            "flash_attention_fwd_lse": layers * steps}
    record = {"card": card, "world": 1, "backend": backend, "tokens": L,
              "seconds": wall, "stages_s": timings, "peak_memory_gb": peak_gb,
              "launches": launches, "b1": b1, "latents_rel_l2": rel,
              "u8_max_diff": umax, "u8_mean_diff": umean}
    log(f"[parallel] ring 4x edit at world 1 ({backend}): {wall:.3f} s, "
        f"peak {peak_gb:.2f} GB, latents relative L2 {rel:.3e} from phase "
        f"9's (gate {SP_REL_TOL}), uint8 max {umax} mean {umean:.4f}; "
        f"launches {launches}")
    if backend != "nccl" or rel > SP_REL_TOL or b1 != want_b1 or any(
            launches[k] != n for k, n in want.items()):
        fail(f"phase 21 ring: {record}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    log("[parallel] ring " + json.dumps(record))
    return record


@contextlib.contextmanager
def step_memory():
    """While the block runs: for each training step (forward, backward,
    update) the device memory it takes above what was allocated when it
    started, in GB, into the yielded dict's "steps"; the peak before it
    into "pre" (the peak statistics restart with each step)."""
    import torch
    from videocof_torch.training import train_step
    rec, real = {"steps": [], "pre": []}, train_step._run_step

    def run_step(*args, **kw):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        rec["pre"].append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        rec["steps"].append((torch.cuda.max_memory_allocated() - start)
                            / 1e9)
        return out

    train_step._run_step = run_step
    try:
        yield rec
    finally:
        train_step._run_step = real


def _train_run(argv, bands=None):
    """`videocof_torch.cli.train.main(argv)` in this process: its losses,
    launches, peak memory (and each step's over its start), stage walls,
    seconds, and the adapters and first moments it saved at step 1.
    ``bands``: the trainer draws its timesteps from that many bands (a
    world-1 run repeating a data-parallel run's draws)."""
    import torch
    from videocof_torch.cli import train as train_cli
    from videocof_torch.ops import flash_attention as fa
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_training(bands) as rec, step_memory() as mem:
        trainer = train_cli.main(argv)
    wall = time.perf_counter() - t0
    peak = max(mem["pre"] + [torch.cuda.max_memory_allocated() / 1e9])
    out = {"losses": trainer.losses, "launches": fa.launch_counts(),
           "peak_memory_gb": peak, "steps_gb": mem["steps"],
           "stages_s": rec["stages"], "seconds": wall,
           "step1": {k: v.cpu() for k, v in rec["saves"][1][1].items()
                     if not k.endswith((".exp_avg_sq", ".step"))}}
    del trainer, rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_rank_main(out_dir, jobs_json):
    """One rank of phase 21 (e), started by ``torch.distributed.run``: for
    each (mode, argv) of the JSON file, `_train_run(argv)`, into
    ``out_dir/<mode>.rank<RANK>.pt``."""
    import torch
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mode, argv in json.loads(Path(jobs_json).read_text()).items():
        with shallow_1_3b(SP_LAYERS):
            run = _train_run(argv)
        torch.save(run, os.path.join(
            out_dir, f"{mode}.rank{os.environ['RANK']}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def _run_group(cmd, env, tag):
    """``cmd`` in its own session, killed with its children if it outlives
    SP_TIMEOUT_S; fails the run unless it exits 0."""
    import signal
    proc = subprocess.Popen(cmd, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        text, _ = proc.communicate(timeout=SP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        fail(f"{tag}: timed out after {SP_TIMEOUT_S} s: {text[-3000:]}")
    if proc.returncode != 0:
        # each rank's own lines first (the first to fail is the cause)
        first = [ln for ln in text.splitlines() if ln.startswith("[rank0]")]
        fail(f"{tag}: exit {proc.returncode}: rank 0: "
             + "\n".join(first[-80:]) + f"\n... the end: {text[-3000:]}")
    return text


def sp_train_phase(card, geo):
    """Phase 21 (e): `cli.train` in the two ranks of one
    ``torch.distributed.run --nproc_per_node=2`` on the one card (gloo),
    rank 16, two steps, once with ``--mesh_seq 2`` (Ulysses: B2 and B3
    through the all-to-alls) and once with ``--mesh_data 2`` (the base
    FSDP-sharded, data-parallel adapters, batch 2); each against a world-1
    run of the CLI (in this process, before) on the same
    triplets, seed and timesteps (batch 2 and a sampler of 2 bands for
    the data run), with the clip off (``--grad_clip 1e6``) so that the
    gradient is compared at its reduced size, and umT5 off the card
    (``--offload_t5``: two ranks holding it, 35.8 GB each, beside this
    process's leftovers ran out of memory): the first step's loss
    (relative, <= SP_LOSS_TOL) and gradient (AdamW's first moment after
    step 1, 0.1 g: relative L2 <= SP_GRAD_TOL), the adapters' move
    (printed: AdamW's first step moves each entry by lr times the sign of
    its gradient, so a gradient near 0 may flip it), each rank's launches
    and peak."""
    import numpy as np
    import torch
    json_path, root = write_triplets(geo)
    common = ["--train_json", str(json_path), "--random_init", "--lora_rank",
              str(TRAIN_CLI_RANK), "--save_every", "1", "--height",
              str(geo.height), "--width", str(geo.width), "--source_frames",
              str(geo.source_frames), "--target_frames",
              str(geo.source_frames), "--reasoning_frames",
              str(geo.reasoning_frames), "--grad_clip", "1e6",
              "--offload_t5"]
    attentions = 2 * SP_LAYERS
    record = {"card": card, "world": SP_DEGREE, "backend": "gloo"}
    # mode: (its flags, world 1's flags, world 1's timestep bands)
    modes = {"seq": (["--mesh_seq", str(SP_DEGREE)], [], None),
             "data": (["--mesh_data", str(SP_DEGREE), "--batch_size",
                       str(SP_DEGREE)],
                      ["--batch_size", str(SP_DEGREE)], SP_DEGREE)}
    # world 1: one step of each, in this process
    world1 = {}
    for mode, (_, ref_extra, bands) in modes.items():
        world1[mode] = _train_run(common + ref_extra + [
            "--steps", "1", "--checkpoint_dir", str(root / f"w1_{mode}")],
            bands)
    # world 2: both runs in one `torch.distributed.run`
    out = root / "ranks"
    out.mkdir(parents=True, exist_ok=True)
    jobs = root / "jobs.json"
    jobs.write_text(json.dumps({
        mode: common + extra + ["--steps", str(SP_TRAIN_STEPS),
                                "--checkpoint_dir", str(root / mode),
                                "--dist_backend", "gloo"]
        for mode, (extra, _, _) in modes.items()}))
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={SP_DEGREE}", "--master_addr=127.0.0.1",
           f"--master_port={free_port()}", str(ROOT / "chip_smoke.py"),
           "--train-rank", str(out), str(jobs)]
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[parallel] training ranks start with {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB free on the card (this process holds "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB)")
    t0 = time.perf_counter()
    _run_group(cmd, env, "phase 21 training")
    record["torchrun_seconds"] = time.perf_counter() - t0
    for mode in modes:
        w1 = world1[mode]
        want_step1 = w1.pop("step1")
        ranks = [torch.load(out / f"{mode}.rank{r}.pt", weights_only=False)
                 for r in range(SP_DEGREE)]
        rec = {"world1": w1, "ranks": []}
        want = {"flash_attention_fwd": 0,
                "flash_attention_fwd_lse": 2 * attentions * SP_TRAIN_STEPS,
                "flash_attention_bwd": attentions * SP_TRAIN_STEPS}

        def norm(state, keys, other=None):
            return np.sqrt(sum(float((state[k].double() - (
                0 if other is None else other[k].double())).square().sum())
                for k in keys))

        moments = [k for k in want_step1 if k.endswith(".exp_avg")]
        ups = [k for k in want_step1 if k.endswith(".up")]
        adapters = [k for k in want_step1 if k.startswith("adapters.")]
        for r, got in enumerate(ranks):
            w1_loss = w1["losses"][0]
            loss_rel = abs(got["losses"][0] - w1_loss) / abs(w1_loss)
            grad_rel = (norm(got["step1"], moments, want_step1)
                        / norm(want_step1, moments))
            # the move is ``up`` (initialized to 0) and the same decay of
            # ``down`` on both sides
            move_rel = (norm(got["step1"], adapters, want_step1)
                        / norm(want_step1, ups))
            row = {"losses": got["losses"], "loss_rel": loss_rel,
                   "grad_rel_l2": grad_rel,
                   "adapters_move_rel_l2": move_rel,
                   **{k: got[k] for k in ("launches", "peak_memory_gb",
                                          "steps_gb", "seconds",
                                          "stages_s")}}
            rec["ranks"].append(row)
            log(f"[parallel] train {mode} rank {r}: losses {got['losses']} "
                f"(world 1 {w1_loss:.6f}, relative {loss_rel:.3e}, gate "
                f"{SP_LOSS_TOL}); gradient {grad_rel:.3e} relative L2 from "
                f"world 1's (gate {SP_GRAD_TOL}); adapters' move "
                f"{move_rel:.3e} relative L2 from world 1's; launches "
                f"{got['launches']} (expected {want}); peak "
                f"{got['peak_memory_gb']:.2f} GB, a step "
                f"{max(got['steps_gb']):.2f} GB over its start (world 1 "
                f"{w1['peak_memory_gb']:.2f}, {max(w1['steps_gb']):.2f} GB); "
                f"{got['seconds']:.1f} s")
            if (len(got["losses"]) != SP_TRAIN_STEPS
                    or not np.isfinite(got["losses"]).all()
                    or loss_rel > SP_LOSS_TOL or grad_rel > SP_GRAD_TOL):
                fail(f"phase 21 training {mode} rank {r}: {row}")
            check_launches(f"phase 21 training {mode} rank {r}",
                           {k: got["launches"][k] for k in want}, want)
        record[mode] = rec
    shutil.rmtree(root, ignore_errors=True)
    log("[parallel] train " + json.dumps(record, default=str))
    return record


def write_triplets(geo):
    """TRAIN_TRIPLETS triplets of cv2-written clips (source, grounded,
    edited; CLIP_FRAMES frames each, random uint8 from the seed, a gray
    rectangle on the grounded clip for the gray modes to find) and their
    triplet JSON: the first ones at the geometry's size, the last at
    TRAIN_OTHER_HW, so that `resize_center_crop` scales and crops it.
    Returns (the JSON's path, the clips' directory)."""
    import numpy as np
    try:
        import cv2
    except ImportError:
        fail("training from files: cv2 is not importable; the dataset "
             "reads video with it")
    root = SCRATCH / "triplets"
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    items = []
    for i, instruction in enumerate(TRAIN_INSTRUCTIONS):
        h, w = (TRAIN_OTHER_HW if i == len(TRAIN_INSTRUCTIONS) - 1
                else (geo.height, geo.width))
        names = {}
        for role in ("src", "ground", "edit"):
            frames = rng.integers(0, 256, (CLIP_FRAMES, h, w, 3),
                                  dtype=np.uint8)
            if role == "ground":
                frames[:, h // 4: h // 2, w // 4: w // 2] = 128
            names[role] = str(root / f"t{i}_{role}.mp4")
            writer = cv2.VideoWriter(names[role],
                                     cv2.VideoWriter_fourcc(*"mp4v"), 16,
                                     (w, h))
            for fr in frames:
                writer.write(fr)
            writer.release()
        items.append({"original_video": names["src"],
                      "grounded_video": names["ground"],
                      "edited_video": names["edit"],
                      "edit_instruction": instruction})
    path = root / "train.json"
    path.write_text(json.dumps(items))
    log(f"[train files] {len(items)} triplets of {CLIP_FRAMES}-frame mp4v "
        f"clips (cv2 {cv2.__version__}): {len(items) - 1} at "
        f"{geo.height}x{geo.width}, 1 at {TRAIN_OTHER_HW[0]}x"
        f"{TRAIN_OTHER_HW[1]}")
    return path, root


class MixedModes:
    """The phase's triplets through `CoTTripletDataset`, item i in the
    grounding mode TRAIN_MODES[i] (gradual grounding, the gray overlay),
    recording each item's read seconds. The overlay mode gives the whole
    overlaid source stream as its grounding stream (JAX's dataset does the
    same); the trainer takes ``reasoning_frames`` grounding frames, so the
    item keeps the first ones, those the overlay marks."""

    def __init__(self, json_path, tcfg):
        from videocof_torch.data import CoTTripletDataset
        kw = dict(height=tcfg.height, width=tcfg.width,
                  source_frames=tcfg.source_frames,
                  target_frames=tcfg.target_frames,
                  reasoning_frames=tcfg.reasoning_frames, seed=SEED)
        self.sets = {mode: CoTTripletDataset(str(json_path), **kw, **opts)
                     for mode, opts in (("plain", {}),
                                        ("gradual", {"gradual_ground": True}),
                                        ("overlay", {"gray_viz": "overlay"}))}
        self.reasoning = tcfg.reasoning_frames
        self.read_s = []
        self.overlay_marked = None

    def __len__(self):
        return len(TRAIN_MODES)

    def __getitem__(self, i):
        import numpy as np
        t0 = time.perf_counter()
        sample = self.sets[TRAIN_MODES[i]][i]
        if TRAIN_MODES[i] == "overlay":
            ground, src = sample["pixel_ground"], sample["pixel_src"]
            if ground.shape != src.shape:
                fail(f"the overlay's grounding stream {ground.shape}")
            self.overlay_marked = not np.array_equal(
                ground[:, :self.reasoning], src[:, :self.reasoning])
            sample["pixel_ground"] = ground[:, :self.reasoning]
        self.read_s.append(time.perf_counter() - t0)
        return sample


def train_state_tensors(state):
    """Copies of a LoRA train state's tensors: the adapters, both AdamW
    moments and its step counts, by name."""
    out = {f"adapters.{k}": v.detach().clone()
           for k, v in state.adapters.state_dict().items()}
    for i, st in state.optimizer.adamw.state_dict()["state"].items():
        out.update({f"adamw.{i}.{k}": v.clone() for k, v in st.items()})
    return out


def state_distance(got, want):
    """{group: relative L2 of ``got`` from ``want``} over two
    `train_state_tensors` records, by group: the adapters, each AdamW
    moment, the step counts."""
    import torch
    groups = {}
    for key, w in want.items():
        group = key.rsplit(".", 1)[-1] if key.startswith("adamw.") else (
            "adapters")
        num, den = groups.get(group, (0.0, 0.0))
        groups[group] = (num + (got[key].double() - w.double()).square()
                         .sum().item(), den + w.double().square().sum().item())
    return {g: (num / den) ** 0.5 if den else num ** 0.5
            for g, (num, den) in groups.items()}


def same_state(tag, got, want):
    """Fail unless two `train_state_tensors` records are equal bit for bit."""
    import torch
    bad = sorted(k for k in want if k not in got
                 or got[k].dtype != want[k].dtype
                 or not torch.equal(got[k], want[k]))
    log(f"[train files] {tag}: {len(want)} tensors, "
        f"{len(want) - len(bad)} equal bit for bit")
    if bad or set(got) != set(want):
        fail(f"{tag}: tensors differ: {bad[:5]}")


@contextlib.contextmanager
def recorded_training(bands=None):
    """While the block runs: every `CoFTrainer.train` call records its
    steps' stage walls (into ``rec["stages"]``), and every
    `save_train_state` call its seconds and a copy of the state it saved
    (``rec["saves"]``: {step: (seconds, `train_state_tensors`)}). With
    ``bands``, the trainer draws its timesteps from a sampler of that many
    bands."""
    import torch
    from videocof_torch.training import DiscreteSampling
    from videocof_torch.training import trainer as trainer_mod
    from videocof_torch.utils import checkpoint
    rec = {"stages": [], "saves": {}}
    real_train = trainer_mod.CoFTrainer.train
    real_save = checkpoint.save_train_state

    def train(self, sample_iter, total_steps=None, timings=None):
        if bands is not None:
            self.sampler = DiscreteSampling(group_num=bands)
        return real_train(self, sample_iter, total_steps,
                          timings=rec["stages"] if timings is None
                          else timings)

    def save(path, state):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_save(path, state)
        rec["saves"][state.step] = (time.perf_counter() - t0,
                                    train_state_tensors(state))
        return out

    trainer_mod.CoFTrainer.train = train
    checkpoint.save_train_state = save
    try:
        yield rec
    finally:
        trainer_mod.CoFTrainer.train = real_train
        checkpoint.save_train_state = real_save


def step_walls(stages):
    """Each step's wall seconds: the sum of its stage walls."""
    return [sum(st.values()) for st in stages]


def log_steps(tag, stages):
    walls = step_walls(stages)
    for i, (st, w) in enumerate(zip(stages, walls)):
        log(f"[{tag}] step {i + 1}{' (warm-up)' if i == 0 else ''}: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in st.items())
            + f"; wall {w:.3f} s")
    return walls


def train_files_phase(card, dcfg, geo, prompt, video, want_shape,
                      want_launches, counters, idle_synthetic):
    """Training as users run it, at 1.3B (the factory's random draw): (a)
    the triplet JSON of cv2 clips; (b) `videocof_torch.cli.train.main()` in
    this process, TRAIN_CLI_STEPS LoRA steps saving every
    TRAIN_SAVE_EVERY and exporting the adapters; (c) the saved states
    restored into a fresh trainer and one more step from it and from the
    state in memory; (d) the exported file merged into the pipeline and a
    4-step edit; (e) `PrefetchLoader -> device_prefetch -> CoFTrainer` and
    one profiled step beside phase 6's idle share (``idle_synthetic``);
    (f) one step under each of TRAIN_REMAT_POLICIES. Fails on any fault.
    Returns (the phase's record, the triplet JSON, the CLI run's
    launches)."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from videocof_torch.cli import train as train_cli
    from videocof_torch.data.loader import PrefetchLoader, device_prefetch
    from videocof_torch.models.lora import merge_lora
    from videocof_torch.training import (CoFTrainer, adamw,
                                         make_lora_train_step)
    from videocof_torch.utils import checkpoint
    launch_counts, reset_launch_counts = counters
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda" if cuda else "cpu")
    t_phase = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak(reset=False):
        if not cuda:
            return None
        if reset:
            torch.cuda.reset_peak_memory_stats()
        return torch.cuda.max_memory_allocated() / 1e9

    # (a) the data
    json_path, root = write_triplets(geo)
    prints = {k: fingerprint(v) for k, v in
              draw_unmerged(dcfg, dev).state_dict().items()}

    # (b) the CLI
    ckpt_dir, lora_path = root / "ckpt", root / "videocof_lora.safetensors"
    argv = ["--train_json", str(json_path), "--random_init", "--lora_rank",
            str(TRAIN_CLI_RANK), "--steps", str(TRAIN_CLI_STEPS),
            "--save_every", str(TRAIN_SAVE_EVERY), "--checkpoint_dir",
            str(ckpt_dir), "--export_lora", str(lora_path), "--height",
            str(geo.height), "--width", str(geo.width), "--source_frames",
            str(geo.source_frames), "--target_frames",
            str(geo.source_frames), "--reasoning_frames",
            str(geo.reasoning_frames)]
    peak(reset=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_loads() as built, recorded_training() as rec:
        trainer = train_cli.main(argv)
    cli_s = time.perf_counter() - t0
    cli_launches = launch_counts()
    cli_peak = peak()
    pipe = built[0][1]
    tcfg = trainer.tcfg
    attentions = 2 * dcfg.num_layers
    want_train = dict(want_launches, flash_attention_fwd=0,
                      flash_attention_fwd_lse=2 * attentions * TRAIN_CLI_STEPS,
                      flash_attention_bwd=attentions * TRAIN_CLI_STEPS)
    steps = checkpoint.checkpoint_steps(str(ckpt_dir))
    changed = changed_weights(pipe.dit, prints)
    del prints
    log(f"[train files] cli.train.main(): {cli_s:.3f} s (weights drawn, "
        f"{TRAIN_CLI_STEPS} steps reading the clips, {len(rec['saves'])} "
        f"saves, the export); losses {trainer.losses}")
    walls = log_steps("train files", rec["stages"])
    save_s = {s: sec for s, (sec, _) in rec["saves"].items()}
    log(f"[train files] seconds per step {statistics.median(walls[1:]):.3f} "
        f"(median after the warm-up; 'prepare' holds the cv2 reads); saves "
        f"{save_s} s; checkpoints {steps}; peak device memory {cli_peak} "
        f"GB; launches {cli_launches} (expected {want_train}); base weights "
        f"changed: {len(changed)}")
    if (len(trainer.losses) != TRAIN_CLI_STEPS
            or not np.isfinite(trainer.losses).all()):
        fail(f"CLI training losses {trainer.losses}")
    want_steps = list(range(TRAIN_SAVE_EVERY, TRAIN_CLI_STEPS + 1,
                            TRAIN_SAVE_EVERY))
    if steps != want_steps or sorted(rec["saves"]) != want_steps:
        fail(f"checkpoints {steps}, saves {sorted(rec['saves'])}, expected "
             f"{want_steps}")
    if changed:
        fail(f"CLI training changed base weights: {sorted(changed)[:5]}")
    check_launches("CLI training", cli_launches, want_train)
    if not lora_path.exists():
        fail("the CLI exported no LoRA file")
    record = {"card": card, "cli_seconds": cli_s, "losses": trainer.losses,
              "stages_s": rec["stages"], "seconds_per_step": walls,
              "save_s": save_s, "peak_memory_gb": cli_peak,
              "launches": cli_launches}

    # (c) resume: each checkpoint into a fresh trainer, bit for bit against
    # the state as it was saved; then one more step from the restored
    # latest state and from the state in memory, on one sample with one
    # seeded generator
    fresh = CoFTrainer(pipe.dit, pipe.vae, pipe.t5, pipe.tokenizer,
                       dataclasses.replace(tcfg, checkpoint_dir=None),
                       device=dev)
    restore_s = {}
    for step in want_steps:
        latest = step == want_steps[-1]
        sync()
        t0 = time.perf_counter()
        checkpoint.restore_train_state(str(ckpt_dir), fresh.state,
                                       step=None if latest else step)
        sync()
        restore_s[step] = time.perf_counter() - t0
        if fresh.state.step != step:
            fail(f"restored step {fresh.state.step}, expected {step}")
        same_state(f"step {step} restored{' (the latest)' if latest else ''}"
                   " vs the state saved", train_state_tensors(fresh.state),
                   rec["saves"][step][1])
    same_state("the latest restored vs the state in memory",
               train_state_tensors(fresh.state),
               train_state_tensors(trainer.state))
    # B3 reduce-adds dq's key tiles in no fixed order (its source says so),
    # so two steps from one state differ in the last bits of the gradients:
    # the loss must be equal bit for bit, the states within RESUME_REL_TOL,
    # beside the spread of two steps from the same (restored) state
    sample = MixedModes(json_path, tcfg).sets["plain"][0]
    after = []
    for t in (trainer, fresh, None):
        if t is None:           # the restored state once more
            t = fresh
            checkpoint.restore_train_state(str(ckpt_dir), t.state)
        t.generator.manual_seed(SEED + 1)
        t.train(iter([sample]), total_steps=1, timings=[])
        after.append((t.losses[-1], train_state_tensors(t.state)))
    (loss_mem, mem), (loss_res, res), (loss_again, again) = after
    d_res, d_spread = state_distance(res, mem), state_distance(again, res)
    log(f"[train files] restore seconds {restore_s}; one more step: loss "
        f"{loss_res!r} restored, {loss_mem!r} in memory, {loss_again!r} "
        f"restored again; state restored vs in memory (relative L2) "
        f"{d_res}, restored vs restored again {d_spread}")
    if not loss_res == loss_mem == loss_again:
        fail("the step after the restore differs from the one in memory")
    if d_res["step"] or d_spread["step"] or max(
            d_res.values()) > RESUME_REL_TOL:
        fail(f"the state after the restored step: {d_res}")
    record.update(restore_s=restore_s, resume_state_rel_l2=d_res,
                  resume_spread_rel_l2=d_spread)
    adapters = copy.deepcopy(trainer.state.adapters)
    del trainer, rec, sample

    # (d) the exported LoRA merged into the pipeline; a 4-step edit
    merged = merge_lora(pipe.dit, str(lora_path))
    reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(video, prompt, source_frames=geo.source_frames,
               reasoning_frames=geo.reasoning_frames,
               num_inference_steps=geo.num_inference_steps,
               guidance_scale=geo.guidance_scale, shift=geo.shift,
               sampler=geo.sampler, repeat_rope=geo.repeat_rope,
               cot=geo.cot, seed=geo.seed)
    record["edit_seconds"] = time.perf_counter() - t0
    edit_launches = launch_counts()
    log(f"[train files] the exported LoRA merged into {len(merged)} "
        f"modules; the edit {record['edit_seconds']:.3f} s, launches "
        f"{edit_launches}")
    if len(merged) != 10 * dcfg.num_layers:
        fail(f"the exported LoRA merged {len(merged)} modules")
    check_video("train files", out.videos, want_shape)
    check_launches("edit with the trained LoRA", edit_launches, dict(
        want_launches, flash_attention_fwd=2 * dcfg.num_layers
        * geo.num_inference_steps))
    del out

    # (e) the loader in front of the step (over the merged base)
    mixed = MixedModes(json_path, tcfg)
    loader = PrefetchLoader(mixed, batch_size=1, num_threads=LOADER_THREADS,
                            seed=SEED, epochs=1)
    stream = device_prefetch(loader.sample_iter(), size=2)
    fed_stages = []
    for _ in range(LOADER_STEPS):
        fresh.train(stream, total_steps=1, timings=fed_stages)
    fed = profile_kernels(lambda: fresh.train(stream, total_steps=1))
    leftover = list(stream)        # the epoch's end: the loader's threads end
    fed_walls = log_steps("train files, loader-fed", fed_stages)
    log(f"[train files] loader-fed seconds per step "
        f"{statistics.median(fed_walls[1:]):.3f} (median after the first; "
        f"{LOADER_THREADS} threads); the loader read {len(mixed.read_s)} "
        f"triplets at {statistics.mean(mixed.read_s):.3f} s each (max "
        f"{max(mixed.read_s):.3f}); the overlay marked its grounding "
        f"frames: {mixed.overlay_marked}; modes {TRAIN_MODES}")
    idle_fed = report_profile("one loader-fed LoRA training step", *fed)
    show = lambda x: "not measured" if x is None else f"{x:.1%}"  # noqa
    log(f"[train files] idle share of a training step: {show(idle_fed)} "
        f"loader-fed, {show(idle_synthetic)} on phase 6's in-memory samples")
    if leftover or len(mixed.read_s) != len(TRAIN_MODES):
        fail(f"the loader read {len(mixed.read_s)} triplets, "
             f"{len(leftover)} left over")
    if mixed.overlay_marked is not True:
        fail("the gray overlay marked no grounding frame")
    if not np.isfinite(fresh.losses).all():
        fail(f"loader-fed losses {fresh.losses}")
    record["loader"] = {"seconds_per_step": fed_walls, "stages_s": fed_stages,
                        "read_s": mixed.read_s, "threads": LOADER_THREADS,
                        "profiled_wall_ms": fed[0], "idle_share": idle_fed,
                        "idle_share_synthetic": idle_synthetic}

    # (f) one LoRA step under each remat policy, on one batch and one noise
    # draw, from the trained adapters (their up is not zero); umT5 leaves
    # the card once the batch is prepared: the steps run the DiT alone
    batch = fresh.prepare_batch([mixed.sets["plain"][1]])
    batch["timesteps"] = torch.tensor([600], device=dev)
    noise = torch.randn(batch["x0"].shape, device=dev, generator=torch.
                        Generator(device=dev).manual_seed(SEED))
    del fresh, loader, stream, mixed
    pipe.t5.to("cpu")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    dit = pipe.dit
    remat = {}
    for policy in TRAIN_REMAT_POLICIES:
        dit.cfg = dit.cfg.replace(remat_tag_names=str(policy).startswith(
            "save_names:"))
        init_fn, step_fn = make_lora_train_step(
            dit, adamw(tcfg.learning_rate, tcfg.weight_decay,
                       tcfg.grad_clip), rank=TRAIN_CLI_RANK, remat=policy)
        state = init_fn(adapters=copy.deepcopy(adapters))
        grads, real_step = [], state.optimizer.step

        def step_capturing(real_step=real_step, params=state.optimizer.params,
                           grads=grads):
            grads.append(torch.cat([p.grad.float().reshape(-1)
                                    for p in params]))
            real_step()

        state.optimizer.step = step_capturing
        peak(reset=True)
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        _, loss = step_fn(state, batch, noise=noise)
        sync()
        remat[str(policy)] = dict(seconds=time.perf_counter() - t0,
                                  peak_memory_gb=peak(), loss=loss,
                                  launches=launch_counts(), grads=grads[0])
        del state, init_fn, step_fn, grads
    dit.cfg = dit.cfg.replace(remat_tag_names=False)
    ref = remat[str(True)]
    want_remat = dict(want_launches, flash_attention_fwd=0,
                      flash_attention_fwd_lse=2 * attentions,
                      flash_attention_bwd=attentions)
    for name, r in remat.items():
        r["grad_rel_l2"] = ((r["grads"] - ref["grads"]).norm()
                            / ref["grads"].norm()).item()
        same_loss = torch.equal(r["loss"], ref["loss"])
        log(f"[train files] remat {name}: {r['seconds']:.3f} s, peak "
            f"{r['peak_memory_gb']} GB, loss {r['loss'].item()!r} (full "
            f"remat's bit for bit: {same_loss}), adapter gradients "
            f"{r['grad_rel_l2']:.3e} relative L2 from full remat's, "
            f"launches {r['launches']}")
        if not same_loss:
            fail(f"remat {name}: the loss differs from full remat's")
        if not r["grad_rel_l2"] <= REMAT_GRAD_REL_TOL:
            fail(f"remat {name}: gradients {r['grad_rel_l2']:.3e} from full "
                 f"remat's")
        check_launches(f"remat policy {name}", r["launches"], want_remat)
    record["remat"] = {k: {key: v[key] for key in (
        "seconds", "peak_memory_gb", "launches", "grad_rel_l2")}
        for k, v in remat.items()}
    log(f"[train files] (a)-(f) in {time.perf_counter() - t_phase:.1f} s")
    return record, json_path, cli_launches


def train_14b_phase(card, cfg14, geo, json_path, want_launches, counters):
    """(g) TRAIN_14B_STEPS steps of `CoFTrainer` (rank TRAIN_14B_RANK LoRA,
    full remat, the geometry's size and frames) on `factory.load_pipeline("",
    random_init=True, dit_cfg=cfg14)` drawn on the card, on the phase's
    triplets read beforehand: finite losses, base weights unchanged, the
    launches; seconds per step, stage walls, peak. Returns its record."""
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.training import CoFTrainer, TrainerConfig
    launch_counts, reset_launch_counts = counters
    cuda = torch.cuda.is_available()
    t0 = time.perf_counter()
    pipe = factory.load_pipeline("", random_init=True, seed=SEED,
                                 dit_cfg=cfg14)
    if cuda:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prints = {k: fingerprint(v) for k, v in pipe.dit.state_dict().items()}
    tcfg = TrainerConfig(height=geo.height, width=geo.width,
                         source_frames=geo.source_frames,
                         target_frames=geo.source_frames,
                         reasoning_frames=geo.reasoning_frames,
                         lora_rank=TRAIN_14B_RANK)
    trainer = CoFTrainer(pipe.dit, pipe.vae, pipe.t5, pipe.tokenizer, tcfg,
                         device=pipe.device)
    mixed = MixedModes(json_path, tcfg)
    samples = iter([mixed[i] for i in range(TRAIN_14B_STEPS)])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stages = []
    for _ in range(TRAIN_14B_STEPS):
        trainer.train(samples, total_steps=1, timings=stages)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    attentions = 2 * cfg14.num_layers
    want = dict(want_launches, flash_attention_fwd=0,
                flash_attention_fwd_lse=2 * attentions * TRAIN_14B_STEPS,
                flash_attention_bwd=attentions * TRAIN_14B_STEPS)
    changed = changed_weights(pipe.dit, prints)
    log(f"[train 14B] {cfg14.num_layers} blocks of {cfg14.dim}, "
        f"{cfg14.num_heads} heads, rank {TRAIN_14B_RANK}; drawn in "
        f"{build_s:.1f} s; losses {trainer.losses}")
    walls = log_steps("train 14B", stages)
    log(f"[train 14B] seconds per step {walls[-1]:.3f} (step 2); peak "
        f"device memory {peak_gb} GB; launches {launches} (expected "
        f"{want}); base weights changed: {len(changed)}")
    if not np.isfinite(trainer.losses).all():
        fail(f"14B training losses {trainer.losses}")
    if changed:
        fail(f"14B training changed base weights: {sorted(changed)[:5]}")
    check_launches("14B LoRA training", launches, want)
    return {"card": card, "build_s": build_s, "losses": trainer.losses,
            "stages_s": stages, "seconds_per_step": walls,
            "peak_memory_gb": peak_gb, "launches": launches,
            "layers": cfg14.num_layers, "rank": TRAIN_14B_RANK}


# ------------------------------------ phases 22-25: the other Wan variants
# Each drives its pipeline at full width on random weights from the seed,
# 480x832, VARIANT_FRAMES frames (9 latent frames, 14,040 tokens), in
# VARIANT_STEPS Flow-UniPC steps at JAX's shift 5 with guidance
# VARIANT_GUIDANCE (batched CFG, batch 2), then once more with the naive
# attention backend from the same seed: the final latents within the DiT
# gate.

def variant_tokens(geo):
    """(latent frames, DiT tokens, latent frames' tokens) of a variant's
    VARIANT_FRAMES-frame clip at the geometry's size."""
    lat = (VARIANT_FRAMES - 1) // 4 + 1
    per_frame = (geo.height // 16) * (geo.width // 16)
    return lat, lat * per_frame, per_frame


def variant_run(tag, card, pipe, call, counters, want_shape, want_shapes):
    """Run ``call(pipe, timings)`` (output_latents=True) through the
    kernels: the output, exactly ``want_shapes`` B1 calls ({(batch, Lq,
    Lk, None): calls}) and nothing else, stage walls, peak; then the same
    call with the naive backend, its final latents against the kernels'
    within DIT_REL_TOL. Returns the run's record."""
    import torch
    launch_counts, reset_launch_counts = counters
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen:
        out = call(pipe, timings)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = b1_shapes(seen)
    check_video(tag, out.videos, want_shape)
    log(f"[{tag}] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[{tag}] {wall:.3f} s; peak device memory {peak_gb:.2f} GB; "
        f"launches {launches}; B1 calls by (batch, Lq, Lk, mask): {shapes}")
    check_launches(tag, launches, dict(dict.fromkeys(launches, 0),
                                       flash_attention_fwd=sum(
                                           want_shapes.values())))
    if shapes != want_shapes:
        fail(f"the {tag}'s B1 calls {shapes} != {want_shapes}")
    backend, pipe.attn_backend = pipe.attn_backend, "naive"
    t0 = time.perf_counter()
    ref = call(pipe, None)
    naive_s = time.perf_counter() - t0
    pipe.attn_backend = backend
    got, want = (torch.from_numpy(o.latents) for o in (out, ref))
    rel = ((got - want).norm() / want.norm()).item()
    ok = bool(torch.isfinite(got).all()) and rel <= DIT_REL_TOL
    log(f"[{tag}] final latents through the kernels vs the naive backend "
        f"({naive_s:.1f} s): relative L2 {rel:.3e} (tol {DIT_REL_TOL}): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the {tag}'s latents disagree with the naive backend's")
    return {"card": card, "seconds": wall, "stages_s": timings,
            "peak_memory_gb": peak_gb, "launches": launches,
            "b1_calls": {str(k): n for k, n in shapes.items()},
            "latents_rel_l2_vs_naive": rel, "naive_s": naive_s}


def variant_cli(tag, geo, cli_argv, counters, want_b1, check_pipe):
    """`fast_infer.main(cli_argv)` in this process, the factory handed
    ``require_real_tokenizer=False`` (the directory has no tokenizer): one
    pipeline built (``check_pipe(pipe)`` names what it lacks, or None),
    one item written at the geometry's size with VARIANT_FRAMES frames,
    exactly
    ``want_b1`` B1 launches and nothing else. Returns the run's record."""
    import torch
    from videocof_torch.cli import fast_infer
    from videocof_torch.utils import video_io
    launch_counts, reset_launch_counts = counters
    out_dir = Path(cli_argv[cli_argv.index("--output_dir") + 1])
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_loads(require_real_tokenizer=False) as built, \
            b1_calls() as seen:
        arrays = fast_infer.main(cli_argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(built) != 1 or len(arrays) != 1:
        fail(f"{tag} built {len(built)} pipelines and wrote {len(arrays)} "
             f"items")
    lacks = check_pipe(built.pop()[1])
    files = sorted(p.name for p in out_dir.glob("*"))
    mp4 = next((out_dir / f for f in files if f.endswith(".mp4")), None)
    info = video_io.video_info(str(mp4)) if mp4 else None
    log(f"[{tag}] fast_infer.main({' '.join(cli_argv)}): {wall:.3f} s, peak "
        f"{peak_gb:.2f} GB; pipeline: {lacks or 'ok'}; files {files}; "
        f"{info}; launches {launches}; B1 calls by (batch, Lq, Lk, mask): "
        f"{b1_shapes(seen)}")
    if lacks:
        fail(f"{tag}: the CLI's pipeline {lacks}")
    check_launches(tag, launches, dict(dict.fromkeys(launches, 0),
                                       flash_attention_fwd=want_b1))
    if info is None or info[:3] != (VARIANT_FRAMES, geo.height, geo.width):
        fail(f"{tag} wrote {files}, {info}")
    return {"seconds": wall, "peak_memory_gb": peak_gb,
            "launches": launches, "files": files}


def i2v_phase(card, geo, gen, prompt, counters):
    """Image-to-video at WAN21_I2V_14B's width on its first
    VARIANT_14B_LAYERS of 40 blocks of 5120 with the CLIP ViT-H/14 tower,
    both drawn by `factory.load_pipeline("", random_init=True,
    dit_cfg=...)`: `image_to_video` of a 480x832 uint8 start image with the
    tower run on the card (stage "clip"), layers x steps B1 calls each of
    self (batch 2, 14,040 tokens),
    text cross (512 keys) and image cross (257 keys), against the naive
    backend. Then the entry: a published-layout i2v directory (the DiT at
    full width and CLI_LAYERS layers, its config's model_type "i2v", the
    Wan2.1 VAE and umT5-XXL files phase 18 wrote, and the CLIP file) read
    by `fast_infer.main([..., "--start_image", png])`, whose pipeline must
    hold the tower. Returns the phase's record."""
    import numpy as np
    import torch
    from PIL import Image
    from videocof_torch import factory
    from videocof_torch.configs import WAN21_I2V_14B
    from videocof_torch.models.clip_vision import (CLIP_FILE, CLIP_VIT_H_14,
                                                   ClipVision,
                                                   export_clip_state_dict,
                                                   init_clip_vision)
    from videocof_torch.models.wan_dit import init_wan_dit
    from videocof_torch.utils import checkpoint
    lat, L, _ = variant_tokens(geo)
    t0 = time.perf_counter()
    cfg_i2v = WAN21_I2V_14B.replace(num_layers=VARIANT_14B_LAYERS)
    pipe = factory.load_pipeline("", random_init=True, dit_cfg=cfg_i2v,
                                 seed=SEED)
    build_s = time.perf_counter() - t0
    image = np.random.default_rng(SEED).integers(
        0, 256, (geo.height, geo.width, 3), dtype=np.uint8)

    def call(p, timings):
        return p.image_to_video(
            image, prompt, num_frames=VARIANT_FRAMES, height=geo.height,
            width=geo.width, negative_prompt=geo.negative_prompt,
            num_inference_steps=VARIANT_STEPS, guidance_scale=VARIANT_GUIDANCE,
            shift=VARIANT_SHIFT, seed=SEED, clip=p.clip, output_latents=True,
            timings=timings)

    per = cfg_i2v.num_layers * VARIANT_STEPS
    shapes = {(2, L, L, None): per, (2, L, TEXT_TOKENS, None): per,
              (2, L, 257, None): per}
    log(f"[i2v] WAN21_I2V_14B and CLIP ViT-H/14 drawn in {build_s:.1f} s; "
        f"{lat} latent frames, {L} tokens")
    record = variant_run("i2v", card, pipe, call, counters,
                         (1, 3, VARIANT_FRAMES, geo.height, geo.width), shapes)
    record.update(build_s=build_s, tokens=L, b1_launches={
        "i2v self": per, "i2v text cross": per, "i2v image cross": per})
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # the entry on a published-layout i2v directory
    dev, bf16 = gen.device, torch.bfloat16
    os.environ["HF_HUB_OFFLINE"] = "1"
    shutil.rmtree(SCRATCH, ignore_errors=True)
    root = SCRATCH / "wan21_i2v"
    cfg = WAN21_I2V_14B.replace(num_layers=CLI_LAYERS)
    t0 = time.perf_counter()
    dit = init_wan_dit(cfg, gen, bf16, dev)
    clip = init_clip_vision(CLIP_VIT_H_14, gen, bf16, dev)
    nbytes = checkpoint.save_dit_checkpoint_dir(str(root), dit, cfg)
    csd = {k: v.cpu() for k, v in export_clip_state_dict(
        clip.state_dict(), CLIP_VIT_H_14).items()}
    torch.save(csd, root / CLIP_FILE)
    nbytes += sum(v.numel() * v.element_size() for v in csd.values())
    for name in (factory.VAE_SUBPATH, factory.T5_SUBPATH):
        (root / name).symlink_to(SHARED_DIR / name)
    write_s = time.perf_counter() - t0
    del dit, clip, csd
    gc.collect()
    torch.cuda.empty_cache()
    png = SCRATCH / "start.png"
    Image.fromarray(image).save(png)
    log(f"[i2v entry] an i2v directory ({CLI_LAYERS} layers, full width, "
        f"with {CLIP_FILE}) written in {write_s:.1f} s, {nbytes / 1e9:.2f} "
        f"GB: {sorted(p.name for p in root.iterdir())}")
    argv = ["--model_name", str(root), "--start_image", str(png), "--prompt",
            prompt, "--output_dir", str(SCRATCH / "i2v_out"), "--num_frames",
            str(VARIANT_FRAMES), "--height", str(geo.height), "--width",
            str(geo.width), "--shift", str(VARIANT_SHIFT), "--seed",
            str(SEED)]
    record["entry"] = variant_cli(
        "i2v entry", geo, argv, counters, 3 * CLI_LAYERS * VARIANT_STEPS,
        lambda p: None if isinstance(p.clip, ClipVision) and
        p.dit.cfg.model_type == "i2v" else "lacks the i2v DiT or its tower")
    record["entry"].update(write_s=write_s, bytes=nbytes)
    log("[i2v] " + json.dumps(record))
    return record


def live_vace(vace, gen):
    """``vace``'s zero-init projections made live (small random weights),
    so that the hints reach the base stream."""
    import torch
    with torch.no_grad():
        for lin in [vace.before_proj, *vace.after_proj]:
            d = lin.weight.shape[1]
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen,
                                         device=gen.device) * 0.1 / d ** 0.5)
    return vace


def lora_forward_check(tag, dit, forward, gen, counters, want_shapes):
    """Two rank-32 LoRA files for ``dit``'s layers (`write_lora_files`):
    ``forward(dit)`` (one DiT forward of the phase's geometry) with them
    attached as runtime adapters, through B1 exactly ``want_shapes``
    ({(batch, Lq, Lk, None): calls}) and nothing else, against the same
    forward of a copy of ``dit`` with both merged (within DIT_REL_TOL);
    each at least ten times that distance from the un-adapted forward.
    Returns (the runtime adapters on the card, the record)."""
    import copy
    import torch
    from videocof_torch.models.lora import load_runtime_lora, merge_lora
    launch_counts, reset_launch_counts = counters
    paths, _ = write_lora_files(dit.cfg, gen, SCRATCH / f"{tag}_lora")
    runtime, left = load_runtime_lora([(p, 1.0) for p in paths], dit.cfg)
    if runtime is None or left:
        fail(f"{tag}: the LoRA files' runtime adapters {runtime}, left "
             f"{sorted(left)}")
    runtime = (runtime[0].to(gen.device), runtime[1])
    with torch.no_grad():
        plain = forward(dit).float()
        dit.runtime_lora = runtime
        reset_launch_counts()
        with b1_calls() as seen:
            adapted = forward(dit).float()
            torch.cuda.synchronize()
        launches = launch_counts()
        dit.runtime_lora = None
        merged_dit = copy.deepcopy(dit)
        for path in paths:
            merge_lora(merged_dit, path)
        merged = forward(merged_dit).float()
    del merged_dit
    shutil.rmtree(SCRATCH / f"{tag}_lora", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rel = _rel_l2(adapted.cpu().numpy(), merged.cpu().numpy())
    moved = min(_rel_l2(a.cpu().numpy(), plain.cpu().numpy())
                for a in (adapted, merged))
    shapes = b1_shapes(seen)
    rec = {"runtime_vs_merged_rel_l2": rel, "moved_rel_l2": moved,
           "b1_calls": {str(k): n for k, n in shapes.items()},
           "launches": launches}
    log(f"[{tag} LoRA] one DiT forward with two rank-{LORA_RANK} files as "
        f"runtime adapters vs merged: relative L2 {rel:.3e} (tol "
        f"{DIT_REL_TOL}); each {moved:.3e} from the un-adapted forward "
        f"(at least 10x); B1 calls {shapes}; launches {launches}")
    check_launches(f"{tag} LoRA forward", launches,
                   dict(dict.fromkeys(launches, 0), flash_attention_fwd=sum(
                       want_shapes.values())))
    if shapes != want_shapes:
        fail(f"the {tag} LoRA forward's B1 calls {shapes} != {want_shapes}")
    if not (torch.isfinite(adapted).all() and rel <= DIT_REL_TOL
            and moved >= 10 * rel):
        fail(f"{tag}: the runtime adapters' forward {rec}")
    return runtime, rec


def fp8_lora_check(tag, pipe, call, runtime, counters, want_shapes):
    """``pipe``'s DiT quantized to fp8 in place, then ``call(pipe, None)``
    with ``runtime`` attached (`set_runtime_lora`), through B1 exactly
    ``want_shapes``, and without: the final latents must move by more
    than LORA_MOVED_MIN. Returns the record."""
    import numpy as np
    import torch
    from videocof_torch.utils.fp8 import quantize_dit_fp8
    launch_counts, reset_launch_counts = counters
    quantize_dit_fp8(pipe.dit)
    pipe.set_runtime_lora(runtime)
    reset_launch_counts()
    t0 = time.perf_counter()
    with b1_calls() as seen:
        adapted = call(pipe, None)
        torch.cuda.synchronize()
    adapted_s = time.perf_counter() - t0
    launches = launch_counts()
    pipe.set_runtime_lora(None)
    plain = call(pipe, None)
    moved = _rel_l2(adapted.latents, plain.latents)
    shapes = b1_shapes(seen)
    rec = {"seconds": adapted_s, "moved_rel_l2": moved,
           "b1_calls": {str(k): n for k, n in shapes.items()}}
    log(f"[{tag} LoRA] the fp8 pipeline with the runtime adapters in "
        f"{adapted_s:.2f} s: final latents {moved:.3e} from the un-adapted "
        f"fp8 run's (more than {LORA_MOVED_MIN}); B1 calls {shapes}")
    check_launches(f"{tag} fp8 LoRA pipeline", launches,
                   dict(dict.fromkeys(launches, 0), flash_attention_fwd=sum(
                       want_shapes.values())))
    if shapes != want_shapes:
        fail(f"the {tag} fp8 LoRA pipeline's B1 calls {shapes} != "
             f"{want_shapes}")
    if not (np.isfinite(adapted.latents).all() and moved > LORA_MOVED_MIN):
        fail(f"{tag}: the fp8 pipeline's runtime adapters {rec}")
    return rec


def vace_lora_phase(geo, gen, parts, vace, vace_call, counters):
    """Phase 23's runtime LoRA: `lora_forward_check` on `vace_forward` at
    the phase's geometry (batch 1, the base layers and the hint blocks
    each a self and a cross B1 call), then `fp8_lora_check` on the VACE
    pipeline of ``parts`` (its DiT quantized in place). Returns the
    records."""
    import torch
    from videocof_torch.models.wan_dit import make_rope_for_geometry
    from videocof_torch.models.wan_dit_vace import vace_forward
    from videocof_torch.pipeline import VacePipeline
    dev, bf16 = gen.device, torch.bfloat16
    dit, vae = parts[0], parts[1]
    cfg = dit.cfg
    lat, L, _ = variant_tokens(geo)
    grid = (lat, geo.height // 16, geo.width // 16)
    sc = vae.cfg.spatial_compression_ratio
    vace_in = 2 * vae.cfg.z_dim + sc * sc
    x = torch.randn(1, vae.cfg.z_dim, lat, 2 * grid[1], 2 * grid[2],
                    generator=gen, device=dev).to(bf16)
    vctx = torch.randn(1, vace_in, lat, 2 * grid[1], 2 * grid[2],
                       generator=gen, device=dev).to(bf16)
    ctx = torch.randn(1, TEXT_TOKENS, cfg.text_dim, generator=gen,
                      device=dev).to(bf16)
    cos, sin = (torch.as_tensor(a, device=dev)
                for a in make_rope_for_geometry(cfg, grid))
    t = torch.full((1,), 937.0, device=dev)
    blocks = cfg.num_layers + vace.n_vace
    runtime, forward = lora_forward_check(
        "VACE", dit, lambda d: vace_forward(d, vace, x, vctx, t, ctx, cos,
                                            sin),
        gen, counters, {(1, L, L, None): blocks,
                        (1, L, TEXT_TOKENS, None): blocks})
    del x, vctx, ctx, cos, sin
    per = blocks * VARIANT_STEPS
    fp8 = fp8_lora_check(
        "VACE", VacePipeline(*parts, vace=vace), vace_call, runtime,
        counters, {(2, L, L, None): per, (2, L, TEXT_TOKENS, None): per})
    return {"lora_forward": forward, "lora_fp8": fp8}


def s2v_lora_phase(geo, gen, pipe, audio, call, counters):
    """Phase 25's runtime LoRA: `lora_forward_check` on `wan_s2v_forward`
    at the phase's geometry (batch 1: each layer a self and a cross B1
    call, the injection one over the audio tokens), then `fp8_lora_check`
    on ``pipe`` (its DiT quantized in place). Returns the records."""
    import torch
    from videocof_torch.models.rope import build_rope_cos_sin
    from videocof_torch.models.wan_dit_s2v import wan_s2v_forward
    dev, cfg = gen.device, pipe.dit.cfg
    lat, L, per_frame = variant_tokens(geo)
    grid = (lat, geo.height // 16, geo.width // 16)
    x = torch.randn(1, pipe.vae.cfg.z_dim, lat, 2 * grid[1], 2 * grid[2],
                    generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, TEXT_TOKENS, cfg.text_dim, generator=gen,
                      device=dev).to(torch.bfloat16)
    cos, sin = (torch.as_tensor(a, device=dev)[None] for a in
                build_rope_cos_sin(grid, cfg.head_dim))
    seg = torch.zeros(L, dtype=torch.long, device=dev)
    feats = torch.as_tensor(audio, device=dev)
    t = torch.full((1,), 937.0, device=dev)
    runtime, forward = lora_forward_check(
        "S2V", pipe.dit, lambda d: wan_s2v_forward(
            d, pipe.s2v, x, t, ctx, cos, sin, seg, audio_feats=feats),
        gen, counters, {(1, L, L, None): cfg.num_layers,
                        (1, L, TEXT_TOKENS, None): cfg.num_layers,
                        (lat, per_frame, AUDIO_TOKENS, None): 1})
    del x, ctx, cos, sin, seg, feats
    per = cfg.num_layers * VARIANT_STEPS
    fp8 = fp8_lora_check(
        "S2V", pipe, call, runtime, counters, {
            (2, L, L, None): per, (2, L, TEXT_TOKENS, None): per,
            (2 * lat, per_frame, AUDIO_TOKENS, None): VARIANT_STEPS})
    return {"lora_forward": forward, "lora_fp8": fp8}


def vace_camera_phase(card, geo, gen, prompt, counters):
    """VACE and camera control at Wan2.1 1.3B (`factory.load_pipeline("",
    random_init=True)`, cut to its first VARIANT_1_3B_LAYERS layers by
    the caller): (a) `VacePipeline` with a hint block every 2 layers
    (stride 2, control context of 96 channels, live projections)
    generating under a uint8 control clip and a region mask: (layers +
    hint blocks) x steps self and cross B1 calls; (b) `CameraPipeline`
    with the adapter (24 -> 1536) on `pose_params_to_embedding` of
    VARIANT_FRAMES pose rows (a dolly with a pan): layers x steps each;
    both against the naive backend; (c) the entry:
    a published-layout VACE directory (CLI_LAYERS base layers and their
    hint block, the VAE and umT5 files phase 18 wrote) read by
    `fast_infer.main([..., "--control_video", clip, "--control_mask",
    clip])`. Returns the phase's records."""
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.configs import WAN21_T2V_1_3B
    from videocof_torch.data.camera import pose_params_to_embedding
    from videocof_torch.models.camera_adapter import init_camera_adapter
    from videocof_torch.models.wan_dit import init_wan_dit
    from videocof_torch.models.wan_dit_vace import (export_vace_state_dict,
                                                    init_vace_params)
    from videocof_torch.pipeline import CameraPipeline, VacePipeline
    from videocof_torch.utils import checkpoint
    dev, bf16 = gen.device, torch.bfloat16
    lat, L, _ = variant_tokens(geo)
    base = factory.load_pipeline("", random_init=True, seed=SEED)
    cfg = base.dit.cfg
    parts = (base.dit, base.vae, base.t5, base.tokenizer)
    rng = np.random.default_rng(SEED)
    control = rng.integers(0, 256, (1, 3, VARIANT_FRAMES, geo.height,
                                    geo.width), dtype=np.uint8)
    mask = np.zeros((1, 1, VARIANT_FRAMES, geo.height, geo.width),
                    np.float32)
    mask[..., geo.height // 4:3 * geo.height // 4,
         geo.width // 4:3 * geo.width // 4] = 1.0
    sc = base.vae.cfg.spatial_compression_ratio
    vace_in = 2 * base.vae.cfg.z_dim + sc * sc       # 96 at Wan2.1's VAE
    vace = live_vace(init_vace_params(cfg, gen, stride=2, vace_in_dim=vace_in,
                                      dtype=bf16, device=dev), gen)
    vpipe = VacePipeline(*parts, vace=vace)

    def vace_call(p, timings):
        return p.control_to_video(
            prompt, control, mask=mask, negative_prompt=geo.negative_prompt,
            num_inference_steps=VARIANT_STEPS, guidance_scale=VARIANT_GUIDANCE,
            shift=VARIANT_SHIFT, seed=SEED, output_latents=True,
            timings=timings)

    per = (cfg.num_layers + vace.n_vace) * VARIANT_STEPS
    want = (1, 3, VARIANT_FRAMES, geo.height, geo.width)
    rec_vace = variant_run("VACE", card, vpipe, vace_call, counters, want, {
        (2, L, L, None): per, (2, L, TEXT_TOKENS, None): per})
    rec_vace.update(tokens=L, hint_blocks=vace.n_vace, stride=vace.stride)
    del vpipe
    adapter = init_camera_adapter(gen, in_dim=24, out_dim=cfg.dim,
                                  dtype=bf16, device=dev)
    cpipe = CameraPipeline(*parts, camera=adapter)
    rows = []
    for i in range(VARIANT_FRAMES):
        yaw = 0.01 * i
        w2c = np.eye(4)[:3].copy()
        w2c[:, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]]
        w2c[2, 3] = -0.03 * i
        rows.append([float(i), 0.6, 1.07, 0.5, 0.5, 0.0, 0.0,
                     *w2c.reshape(-1).tolist()])

    # the naive run takes the rays the timed run made from the pose rows
    # (the host's Plücker maps cost seconds, the same either way)
    emb = pose_params_to_embedding(np.asarray(rows, np.float32), geo.width,
                                   geo.height)

    def cam_call(p, timings):
        return p.camera_to_video(
            prompt, rows if timings is not None else emb,
            negative_prompt=geo.negative_prompt,
            height=geo.height, width=geo.width, num_frames=VARIANT_FRAMES,
            num_inference_steps=VARIANT_STEPS, guidance_scale=VARIANT_GUIDANCE,
            shift=VARIANT_SHIFT, seed=SEED, output_latents=True,
            timings=timings)

    per = cfg.num_layers * VARIANT_STEPS
    rec_cam = variant_run("camera", card, cpipe, cam_call, counters, want, {
        (2, L, L, None): per, (2, L, TEXT_TOKENS, None): per})
    rec_cam["tokens"] = L
    del cpipe

    rec_vace.update(vace_lora_phase(geo, gen, parts, vace, vace_call,
                                     counters))
    del base, parts, vace, adapter
    gc.collect()
    torch.cuda.empty_cache()

    # the entry on a published-layout VACE directory
    root = SCRATCH / "wan21_vace"
    root.mkdir(parents=True, exist_ok=True)
    small = WAN21_T2V_1_3B.replace(num_layers=CLI_LAYERS)
    t0 = time.perf_counter()
    dit = init_wan_dit(small, gen, bf16, dev)
    branch = live_vace(init_vace_params(small, gen, stride=2,
                                        vace_in_dim=vace_in, dtype=bf16,
                                        device=dev), gen)
    nbytes = checkpoint.save_dit_checkpoint_dir(
        str(root), dit, small,
        extra=export_vace_state_dict(branch.state_dict(), small, 2))
    for name in (factory.VAE_SUBPATH, factory.T5_SUBPATH):
        (root / name).symlink_to(SHARED_DIR / name)
    write_s = time.perf_counter() - t0
    del dit, branch
    gc.collect()
    torch.cuda.empty_cache()
    clip = write_clip("VACE entry", geo)
    argv = ["--model_name", str(root), "--control_video", str(clip),
            "--control_mask", str(clip), "--prompt", prompt, "--output_dir",
            str(SCRATCH / "vace_out"), "--num_frames", str(VARIANT_FRAMES),
            "--vace_scale", "0.8", "--shift", str(VARIANT_SHIFT), "--seed",
            str(SEED)]
    rec_vace["entry"] = variant_cli(
        "VACE entry", geo, argv, counters,
        2 * (CLI_LAYERS + 1) * VARIANT_STEPS,
        lambda p: None if isinstance(p, VacePipeline) and p.vace.stride == 2
        else "is no VacePipeline of stride 2")
    rec_vace["entry"].update(write_s=write_s, bytes=nbytes)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    shutil.rmtree(SHARED_DIR, ignore_errors=True)
    log("[VACE] " + json.dumps(rec_vace))
    log("[camera] " + json.dumps(rec_cam))
    return rec_vace, rec_cam


def s2v_phase(card, geo, gen, prompt, counters):
    """Speech-to-video at the 14B's width on its first VARIANT_14B_LAYERS
    of 40 layers (`factory.load_pipeline("", random_init=True,
    dit_cfg=...)` and `init_s2v_params`, audio_dim 1024, 4 audio tokens,
    injected at layer 0 with a live output projection): `speech_to_video`
    of seeded audio features [1, 9, 1024]: layers x steps self and cross
    B1 calls, and the audio injection's B1 calls
    at batch 2 x 9 latent frames over 4 keys, against the naive backend.
    Returns the phase's record."""
    import numpy as np
    import torch
    from videocof_torch import factory
    from videocof_torch.configs import WAN21_T2V_14B
    from videocof_torch.models.wan_dit_s2v import init_s2v_params
    from videocof_torch.pipeline import S2VPipeline
    lat, L, per_frame = variant_tokens(geo)
    t0 = time.perf_counter()
    cfg_s2v = WAN21_T2V_14B.replace(num_layers=VARIANT_14B_LAYERS)
    base = factory.load_pipeline("", random_init=True, dit_cfg=cfg_s2v,
                                 seed=SEED + 5)
    s2v = init_s2v_params(cfg_s2v, gen, audio_dim=AUDIO_DIM,
                          num_audio_token=AUDIO_TOKENS, inject_layers=(0,),
                          dtype=torch.bfloat16, device=gen.device)
    with torch.no_grad():
        o = s2v.audio_injector.layers["0"].o.weight
        o.copy_(torch.randn(o.shape, generator=gen, device=gen.device)
                * 0.1 / o.shape[1] ** 0.5)
    pipe = S2VPipeline(base.dit, base.vae, base.t5, base.tokenizer, s2v=s2v)
    build_s = time.perf_counter() - t0
    del base
    audio = np.random.default_rng(SEED).standard_normal(
        (1, lat, AUDIO_DIM)).astype(np.float32)

    def call(p, timings):
        return p.speech_to_video(
            prompt, audio, negative_prompt=geo.negative_prompt,
            height=geo.height, width=geo.width, num_frames=VARIANT_FRAMES,
            num_inference_steps=VARIANT_STEPS, guidance_scale=VARIANT_GUIDANCE,
            shift=VARIANT_SHIFT, seed=SEED, output_latents=True,
            timings=timings)

    per = cfg_s2v.num_layers * VARIANT_STEPS
    audio_shape = (2 * lat, per_frame, AUDIO_TOKENS, None)
    record = variant_run("S2V", card, pipe, call, counters,
                         (1, 3, VARIANT_FRAMES, geo.height, geo.width), {
                             (2, L, L, None): per,
                             (2, L, TEXT_TOKENS, None): per,
                             audio_shape: VARIANT_STEPS})
    record.update(build_s=build_s, tokens=L,
                  b1_launches={"s2v audio": VARIANT_STEPS})

    record.update(s2v_lora_phase(geo, gen, pipe, audio, call, counters))
    del pipe, s2v
    gc.collect()
    torch.cuda.empty_cache()
    log("[S2V] " + json.dumps(record))
    return record


# ------------------------- phase 29: tensor, pipeline, expert parallelism
# gloo worlds of 2 and 4 ranks sharing the one card (NCCL refuses two ranks
# on one device), each rank's result held against world 1 on the same
# layers in this process. Weights and inputs are drawn from the seed, the
# same on every rank; a rank's results go to ``out_dir/rank<r>.pt``.

def _p29_init(rank, world, init_file):
    """A rank of a phase-29 world: gloo, its card, TF32 off; a fault's
    traceback to stderr."""
    import faulthandler
    import torch
    import torch.distributed as dist
    faulthandler.enable()
    sys.path.insert(0, str(ROOT))
    from videocof_torch.parallel import rank_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    dev = rank_device()
    torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def gloo_sums():
    """While the block runs: the all-reduces of the parallel collectives
    (`_collectives._sum`: TP's row-parallel sums, its q/k norms' sums of
    squares, the pipeline's output), each synchronized and timed, into the
    yielded dict's "calls", "bytes" and "seconds"."""
    import torch
    from videocof_torch.parallel import _collectives as col
    real, rec = col._sum, {"calls": 0, "bytes": 0, "seconds": 0.0}

    def timed(x, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(x, group)
        torch.cuda.synchronize()
        rec["calls"] += 1
        rec["bytes"] += x.numel() * x.element_size()
        rec["seconds"] += time.perf_counter() - t0
        return out
    col._sum = timed
    try:
        yield rec
    finally:
        col._sum = real


def stack_bytes(*stacks):
    """Bytes of the blocks of ``stacks`` (parameters and buffers, as
    stored)."""
    from videocof_torch.utils.fp8 import fp8_bytes
    return sum(fp8_bytes(b) for s in stacks for b in s)


def tp_edit_pipeline(dev, lora_paths):
    """Phase 29 (a)'s pipeline: the factory's draw at WAN21_T2V_14B's width
    cut to its first TP_EDIT_LAYERS layers, fp8, the two LoRA files as
    runtime adapters; umT5 at T5_TINY (the edit is given the prompt's
    embeddings)."""
    from videocof_torch import factory
    from videocof_torch.configs import T5_TINY, WAN21_T2V_14B
    from videocof_torch.models.lora import load_runtime_lora
    cfg = WAN21_T2V_14B.replace(num_layers=TP_EDIT_LAYERS)
    pipe = factory.load_pipeline("", random_init=True, seed=SEED,
                                 dit_cfg=cfg, t5_cfg=T5_TINY, quantize="fp8",
                                 device=dev)
    runtime, _ = load_runtime_lora([(p, 1.0) for p in lora_paths], cfg)
    pipe.set_runtime_lora(runtime)
    return pipe


def tp_edit_run(pipe, inputs):
    """The 4-step edit of ``inputs`` on ``pipe``: latents, B1 calls by
    shape, launches, stage walls, seconds, peak, the all-reduces."""
    import torch
    from videocof_torch.ops import flash_attention as fa
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    with b1_calls() as seen, gloo_sums() as sums:
        out = pipe(inputs["video"], "", prompt_embeds=inputs["embeds"],
                   output_latents=True, timings=timings, **inputs["kw"])
    torch.cuda.synchronize()
    return {"latents": out.latents, "b1": _b1_by_shape(seen),
            "launches": fa.launch_counts(), "stages_s": timings,
            "seconds": time.perf_counter() - t0, "all_reduce": sums,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "block_bytes": stack_bytes(pipe.dit.blocks)}


def tp_family_models(dev):
    """Phase 29 (b)'s DiTs at full width, bf16 from the seed, with their
    inputs: Flux-dev cut to TP_FAMILY_LAYERS blocks of each kind at
    1024x1024 with 512 text tokens, QwenImage cut to TP_FAMILY_LAYERS
    blocks with 256, CogVideoX-5B cut to TP_FAMILY_LAYERS blocks on the
    480x720 49-frame clip with 226 tokens under batched CFG."""
    import torch
    from videocof_torch.models import cogvideox as cog
    from videocof_torch.models import flux as flux_lib
    from videocof_torch.models import qwenimage as qwen_lib
    n, bf16 = TP_FAMILY_LAYERS, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    fcfg = flux_lib.FLUX_DEV.replace(num_layers=n, num_single_layers=n)
    qcfg = qwen_lib.QWENIMAGE.replace(num_layers=n)
    ccfg = cog.COGVIDEOX_5B.replace(num_layers=n)
    side = FAMILY_HW[0] // 16
    rows, cols = torch.meshgrid(torch.arange(side), torch.arange(side),
                                indexing="ij")
    iids = torch.stack([torch.zeros_like(rows), rows, cols], -1).reshape(
        side * side, 3).float().to(dev)
    qi, qt = qwen_lib.qwen_position_ids((1, side, side), QWEN_TEXT)
    f_lat = (COG_FRAMES - 1) // 4 + 1
    return {
        "flux": (flux_lib.init_flux(fcfg, gen, bf16), (
            randn(1, side * side, fcfg.in_channels),
            randn(1, FLUX_TEXT, fcfg.joint_attention_dim),
            randn(1, fcfg.pooled_projection_dim),
            torch.tensor([0.7], device=dev), iids,
            torch.zeros(FLUX_TEXT, 3, device=dev),
            torch.tensor([FLUX_GUIDANCE], device=dev))),
        "qwenimage": (qwen_lib.init_qwenimage(qcfg, gen, bf16), (
            randn(1, side * side, qcfg.in_channels),
            randn(1, QWEN_TEXT, qcfg.joint_attention_dim),
            torch.tensor([0.7], device=dev), qi.to(dev), qt.to(dev))),
        "cogvideox": (cog.init_cogvideox(ccfg, gen, bf16), (
            randn(2, f_lat, ccfg.in_channels, COG_HW[0] // 8,
                  COG_HW[1] // 8),
            randn(2, COG_TEXT, ccfg.text_embed_dim),
            torch.tensor([500.0, 500.0], device=dev)))}


def tp_family_run(models, mesh=None):
    """Each family's forward, tensor-parallel over ``mesh``'s model axis
    when given: output, B1 calls, seconds, the blocks' bytes."""
    import torch
    from videocof_torch.parallel import (apply_tp, make_tp_attention,
                                         validate_tp)
    res = {}
    for name, (model, args) in models.items():
        attn = None
        if mesh is not None:
            validate_tp(model.cfg, mesh)
            apply_tp(model, mesh)
            attn = make_tp_attention(mesh)
        stacks = [model.blocks] + ([model.single_blocks]
                                   if hasattr(model, "single_blocks") else [])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), b1_calls() as seen:
            out = model(*args, attn_backend=attn)
        torch.cuda.synchronize()
        res[name] = {"out": out.float().cpu(), "b1": _b1_by_shape(seen),
                     "seconds": time.perf_counter() - t0,
                     "block_bytes": stack_bytes(*stacks)}
    return res


def pp_setup(dev, geo):
    """Phase 29 (d): the Wan2.1 1.3B's 30 blocks at full width, bf16 from
    the seed, and a batch of PP_BATCH at the edit's 29,640 tokens: the fp32
    stream, e0, the bf16 context, the CoF RoPE tables."""
    import torch
    from videocof_torch.configs import WAN21_T2V_1_3B
    from videocof_torch.models.wan_dit import (init_wan_dit,
                                               make_rope_for_geometry)
    from videocof_torch.pipeline import latent_frame_count
    cfg = WAN21_T2V_1_3B
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    blocks = list(init_wan_dit(cfg, gen, torch.bfloat16, dev).blocks)
    cond = latent_frame_count(geo.source_frames)
    ground = latent_frame_count(geo.reasoning_frames)
    grid = (2 * cond + ground, geo.height // 16, geo.width // 16)
    L = grid[0] * grid[1] * grid[2]
    cos, sin = make_rope_for_geometry(cfg, grid, f_src=cond, f_ground=ground)
    x = torch.randn(PP_BATCH, L, cfg.dim, generator=gen, device=dev)
    e0 = 0.1 * torch.randn(PP_BATCH, 6, cfg.dim, generator=gen, device=dev)
    ctx = torch.randn(PP_BATCH, TEXT_TOKENS, cfg.dim, generator=gen,
                      device=dev).to(torch.bfloat16)
    rope = tuple(torch.as_tensor(a, device=dev) for a in (cos, sin))
    return blocks, (x, e0, ctx), rope


def pp_grads(blocks, offset=0):
    """{"<block index>.<name>": its gradient on the CPU} of ``blocks``
    (the first at ``offset``), the gradients then dropped."""
    out = {f"{offset + i}.{k}": p.grad.float().cpu()
           for i, blk in enumerate(blocks) for k, p in blk.named_parameters()}
    for blk in blocks:
        blk.zero_grad(set_to_none=True)
    return out


def ep_setup(dev):
    """Phase 29 (e): two Wan2.2 A14B-width experts of EP_LAYERS layers from
    two seeds, each quantized to fp8 as it is drawn, a shell of their
    structure on the meta device, and a 14,040-token input (9 latent
    frames at 480x832) with 512 text tokens."""
    import torch
    from videocof_torch.configs import WAN22_T2V_A14B
    from videocof_torch.models.wan_dit import (WanDiT, init_wan_dit,
                                               make_rope_for_geometry)
    from videocof_torch.utils.fp8 import quantize_dit_fp8
    cfg = WAN22_T2V_A14B.replace(num_layers=EP_LAYERS)
    experts = [quantize_dit_fp8(init_wan_dit(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 40 + s),
        torch.bfloat16, dev)) for s in (1, 2)]
    shell = quantize_dit_fp8(WanDiT(cfg, torch.bfloat16, "meta"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    grid = (9, 30, 52)
    cos, sin = make_rope_for_geometry(cfg, grid)
    args = (torch.randn(1, cfg.in_dim, 9, 60, 104, generator=gen, device=dev),
            torch.tensor([900.0], device=dev),
            torch.randn(1, TEXT_TOKENS, cfg.text_dim, generator=gen,
                        device=dev),
            *(torch.as_tensor(a, device=dev) for a in (cos, sin)))
    return experts, shell, args


def _p29_rank2(rank, world, init_file, out_dir, lora_paths, edit_inputs,
               geo):
    """One rank of phase 29's world of 2: (a) the TP edit, (b) the TP
    family forwards, (d) the pipeline over the 1.3B's blocks and its
    backward, (e) the experts one a rank."""
    import torch
    from torch.func import functional_call
    from videocof_torch.ops import flash_attention as fa
    from videocof_torch.parallel import (ep_param_shardings, make_mesh,
                                         pp_param_shardings, pp_scan_blocks,
                                         select_expert, stack_experts)
    dev = _p29_init(rank, world, init_file)
    res = {"device": str(dev)}
    t0 = time.perf_counter()
    # (a) the CoF edit at the 14B's width, tp 2
    pipe = tp_edit_pipeline(dev, lora_paths)
    whole = stack_bytes(pipe.dit.blocks)
    pipe.enable_sequence_parallel(model=world)
    res["edit"] = dict(tp_edit_run(pipe, edit_inputs), whole_bytes=whole)
    del pipe
    torch.cuda.empty_cache()
    # (b) the families' forwards, tp 2
    mesh = make_mesh(model=world)
    res["families"] = tp_family_run(tp_family_models(dev), mesh)
    torch.cuda.empty_cache()
    # (d) GPipe over the 1.3B's 30 blocks, S = 2, M = PP_MICRO; then the
    # backward through the first PP_GRAD_BLOCKS blocks
    blocks, (x, e0, ctx), rope = pp_setup(dev, geo)
    mesh = make_mesh(seq=world)
    stage = pp_param_shardings(mesh, blocks)
    grad_stage = pp_param_shardings(mesh, blocks[:PP_GRAD_BLOCKS])
    first = blocks.index(grad_stage[0])
    del blocks

    def block_fn(blk, h, cond):
        return blk(h, cond[0], cond[1], rope)

    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad(), gloo_sums() as sums:
        out = pp_scan_blocks(mesh, block_fn, stage, x, (e0, ctx),
                             microbatches=PP_MICRO)
    torch.cuda.synchronize()
    pp = {"out": out.float().cpu(), "seconds": time.perf_counter() - t1,
          "launches": fa.launch_counts(), "all_reduce": sums,
          "block_bytes": stack_bytes(stage)}
    del out, stage
    fa.reset_launch_counts()
    xg = x.clone().requires_grad_()
    t1 = time.perf_counter()
    out = pp_scan_blocks(mesh, block_fn, grad_stage, xg, (e0, ctx),
                         microbatches=PP_MICRO)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    pp.update(grad_seconds=time.perf_counter() - t1,
              grad_launches=fa.launch_counts(),
              grads=pp_grads(grad_stage, first),
              grad_x=xg.grad.float().cpu())
    res["pp"] = pp
    del out, xg, grad_stage, x, e0, ctx
    torch.cuda.empty_cache()
    # (e) two fp8 experts, one a rank
    experts, shell, args = ep_setup(dev)
    mesh = make_mesh(data=world)
    stack = ep_param_shardings(mesh, stack_experts(*experts))
    own = experts[rank]
    del experts
    torch.cuda.empty_cache()
    ep = {"owner_of": rank,
          "resident_bytes": sum(t.numel() * t.element_size()
                                for t in stack.local.values())}
    with torch.no_grad():
        ep["own"] = own(*args).float().cpu()
        for k in range(2):
            t1 = time.perf_counter()
            sel = select_expert(stack, k)
            torch.cuda.synchronize()
            ep[f"select_s_{k}"] = time.perf_counter() - t1
            ep[k] = functional_call(shell, sel, args).float().cpu()
            del sel
    res["ep"] = ep
    res["seconds"] = time.perf_counter() - t0
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def tp_train_setup(dev, geo):
    """Phase 29 (c): the Wan2.1 1.3B at full width cut to TP_TRAIN_LAYERS
    layers, bf16 from the seed, and a batch of 2 at the edit's 29,640
    tokens (the CoF frame mask, 512 text tokens) with its noise."""
    import torch
    from videocof_torch.configs import WAN21_T2V_1_3B
    from videocof_torch.models.wan_dit import (init_wan_dit,
                                               make_rope_for_geometry)
    from videocof_torch.pipeline import latent_frame_count
    cfg = WAN21_T2V_1_3B.replace(num_layers=TP_TRAIN_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    dit = init_wan_dit(cfg, gen, torch.bfloat16, dev)
    cond = latent_frame_count(geo.source_frames)
    ground = latent_frame_count(geo.reasoning_frames)
    grid = (2 * cond + ground, geo.height // 16, geo.width // 16)
    cos, sin = make_rope_for_geometry(cfg, grid, f_src=cond, f_ground=ground)
    shape = (2, cfg.in_dim, grid[0], 2 * grid[1], 2 * grid[2])
    mask = torch.ones(grid[0], device=dev)
    mask[:cond] = 0.0
    batch = {"x0": torch.randn(shape, generator=gen, device=dev),
             "context": torch.randn(2, TEXT_TOKENS, cfg.text_dim,
                                    generator=gen, device=dev),
             "rope_cos": torch.as_tensor(cos, device=dev),
             "rope_sin": torch.as_tensor(sin, device=dev),
             "timesteps": torch.tensor([300, 800], device=dev),
             "frame_mask": mask}
    noise = torch.randn(shape, generator=gen, device=dev)
    # the second step's, which the restored train states take
    noise2 = torch.randn(shape, generator=gen, device=dev)
    return dit, batch, (noise, noise2)


def tp_train_step(dit, batch, noise, mesh=None, rows=slice(None)):
    """One full fine-tuning step (AdamW at TP_TRAIN_LR, the default remat)
    on ``batch``'s ``rows``: the loss, the parameters before it (off a
    mesh), the gradients AdamW took and the parameters after it (FSDP
    shards gathered), on the CPU; launches, seconds, peak; and the state
    and its step function."""
    import torch
    from videocof_torch.ops import flash_attention as fa
    from videocof_torch.training.train_step import adamw, make_train_step
    from videocof_torch.utils.checkpoint import whole_state
    before = (None if mesh is not None else
              {k: v.float().cpu() for k, v in dit.state_dict().items()})
    state, step_fn = tp_train_state(dit, mesh)
    log(f"[tp train] the step's state made (mesh: {mesh is not None})")
    grads, real = {}, state.optimizer.adamw.step

    def recording(*a, **kw):
        for name, p in state.params.named_parameters():
            grads[name] = whole_state(p.grad).float().cpu()
        return real(*a, **kw)
    state.optimizer.adamw.step = recording
    qw = state.params.blocks[0].self_attn.q.weight
    q_local = tuple((qw.to_local() if hasattr(qw, "to_local") else qw).shape)
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b = {k: (v[rows] if k in ("x0", "context", "timesteps") else v)
         for k, v in batch.items()}
    state, loss = step_fn(state, b, noise=noise[rows])
    torch.cuda.synchronize()
    state.optimizer.adamw.step = real
    return {"loss": float(loss), "before": before, "grads": grads,
            "q_local": q_local,
            "params": {k: whole_state(v).float().cpu()
                       for k, v in state.params.state_dict().items()},
            "launches": fa.launch_counts(),
            "seconds": time.perf_counter() - t0,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "state": state, "step_fn": step_fn}


def tp_train_state(dit, mesh=None):
    """A full fine-tuning state of ``dit`` over ``mesh`` (AdamW at
    TP_TRAIN_LR) and its step function."""
    from videocof_torch.training.train_step import adamw, make_train_step
    init_fn, step_fn = make_train_step(
        dit, adamw(TP_TRAIN_LR, 0.0), mesh=mesh, fsdp_min_size=TP_FSDP_MIN)
    return init_fn(), step_fn


def held_state(state):
    """Copies of every tensor of a full fine-tuning state as this rank
    holds it (its shards): parameters, AdamW's moments and step counts."""
    out = {}

    def local(t):
        return (t.to_local() if hasattr(t, "to_local") else t
                ).detach().clone()
    for k, v in state.params.state_dict().items():
        out["params." + k] = local(v)
    for i, st in state.optimizer.adamw.state_dict()["state"].items():
        out.update({f"adamw.{i}.{k}": local(v) for k, v in st.items()})
    return out


def unequal(got, want):
    """The names whose tensors differ in any bit (or that one side
    lacks)."""
    import torch
    return sorted(k for k in set(got) | set(want)
                  if k not in got or k not in want
                  or got[k].dtype != want[k].dtype
                  or not torch.equal(got[k], want[k]))


def tp_resume(dev, geo, state, step_fn, mesh, rows, ckpt, batch, noise2):
    """Phase 29 (c)'s train state on one rank of the TP x FSDP world (the
    second step on ``batch``'s ``rows`` with ``noise2``'s):
    `save_train_state` after the first step (seconds, whether the
    directory is there as it returns), the second step from the state in
    memory, a fresh state of the same layout restored from the file
    (seconds; the tensors it holds that differ from the saved state's) and
    its second step (the loss; the tensors that differ from the second
    step in memory, and their relative L2); the whole parameters after the
    second step in memory (rank 0)."""
    import torch
    from videocof_torch.utils.checkpoint import (restore_train_state,
                                                 save_train_state,
                                                 whole_state_dict)
    b = {k: (v[rows] if k in ("x0", "context", "timesteps") else v)
         for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_train_state(ckpt, state)
    save_s = time.perf_counter() - t0
    there = os.path.isdir(path)
    saved = held_state(state)
    state, loss2 = step_fn(state, b, noise=noise2[rows])
    after = held_state(state)
    whole2 = {k: v.cpu() for k, v in whole_state_dict(state.params).items()}
    del state
    dit, _, _ = tp_train_setup(dev, geo)
    fresh, fresh_step = tp_train_state(dit, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_train_state(ckpt, fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored = held_state(fresh)
    fresh, loss2_restored = fresh_step(fresh, b, noise=noise2[rows])
    after_r = held_state(fresh)
    differ = unequal(after_r, after)
    rel = _cat_rel_l2([(after_r[k].float().cpu().numpy(),
                        after[k].float().cpu().numpy())
                       for k in after if k.startswith("params.")])
    return {"path": path, "there": there, "save_s": save_s,
            "restore_s": restore_s, "n_held": len(saved),
            "restored_differ": unequal(restored, saved),
            "loss2": float(loss2), "loss2_restored": float(loss2_restored),
            "step2_differ": len(differ), "step2_rel_l2": rel,
            "whole2": whole2 if torch.distributed.get_rank() == 0 else None}


def _p29_rank4(rank, world, init_file, out_dir, geo):
    """One rank of phase 29's world of 4: (c) the TP x FSDP step over data
    2 x model 2, this rank's data row."""
    import torch
    from videocof_torch.parallel import make_mesh, tp_param_shardings
    dev = _p29_init(rank, world, init_file)
    dit, batch, (noise, noise2) = tp_train_setup(dev, geo)
    mesh = make_mesh(data=2, model=2)
    log(f"[tp train] rank {rank}: drawn, mesh made")
    dims = tp_param_shardings(mesh, dit)
    d = mesh.get_local_rank("data")
    res = tp_train_step(dit, batch, noise, mesh, slice(d, d + 1))
    log(f"[tp train] rank {rank}: stepped")
    state, step_fn = res.pop("state"), res.pop("step_fn")
    del dit, noise
    res["resume"] = tp_resume(dev, geo, state, step_fn, mesh,
                              slice(d, d + 1), os.path.join(out_dir, "ckpt"),
                              batch, noise2)
    log(f"[tp train] rank {rank}: saved, restored, stepped again")
    res.update(dims=dims, model_rank=mesh.get_local_rank("model"),
               data_rank=d)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _cat_rel_l2(pairs):
    """Relative L2 of the concatenation of (got, want) pairs."""
    import numpy as np
    num = sum(float(np.square(np.asarray(g, np.float64)
                              - np.asarray(w, np.float64)).sum())
              for g, w in pairs)
    den = sum(float(np.square(np.asarray(w, np.float64)).sum())
              for _, w in pairs)
    return (num / den) ** 0.5


def xlm_phase():
    """Phase 29 (f): xlm-roberta-large with its CLIP head at full size, fp32
    from the seed, on two prompts of 77 ids (row 1 padded past 40): the
    hidden states' and the embedding's shape and finiteness, row 1 alone
    against row 1 in the batch (the padding keys masked, mean-pooled
    away), seconds."""
    import torch
    from videocof_torch.models import xlm_roberta as xr
    from videocof_torch.parallel import rank_device
    dev = rank_device()
    cfg = xr.XLMR_LARGE
    t0 = time.perf_counter()
    model = xr.init_xlm_roberta(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 50))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.randint(2, cfg.vocab_size, (2, 77), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED + 51))
    ids[1, 40:] = cfg.pad_id
    t0 = time.perf_counter()
    with torch.no_grad():
        hidden = xr.xlm_roberta_encode(model, ids)
        emb = xr.xlm_roberta_clip_text(model, ids)
        alone = xr.xlm_roberta_clip_text(model, ids[1:, :40])
    torch.cuda.synchronize()
    rel = _rel_l2(alone.cpu().numpy(), emb[1:].cpu().numpy())
    rec = {"config": "XLMR_LARGE", "params": sum(p.numel() for p in
                                                 model.parameters()),
           "build_s": build_s, "forward_s": time.perf_counter() - t0,
           "hidden": list(hidden.shape), "embedding": list(emb.shape),
           "padded_row_vs_alone_rel_l2": rel}
    log("[xlm-roberta] " + json.dumps(rec))
    if (list(hidden.shape) != [2, 77, cfg.dim]
            or list(emb.shape) != [2, cfg.out_dim]
            or not torch.isfinite(hidden).all()
            or not torch.isfinite(emb).all() or rel > 1e-4):
        fail(f"xlm-roberta-large: {rec}")
    return rec


def tp_train_phase(geo):
    """Phase 29 (c): the TP x FSDP step over data 2 x model 2 (a world of
    4), each rank against world 1's step in this process, its gradients
    and AdamW's moves cut to the rank's TP shard. Returns the record."""
    import torch
    from videocof_torch.parallel import rank_device
    from videocof_torch.parallel.tp import shard_param
    base = SCRATCH / "tp_train"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    dit, batch, (noise, noise2) = tp_train_setup(rank_device(), geo)
    w1_train = tp_train_step(dit, batch, noise)
    del dit, noise, w1_train["state"], w1_train["step_fn"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _spawn_ranks(_p29_rank4, 4, (str(base / "rdzv4"), str(base), geo),
                 "phase 29, world 4")
    world4_s = time.perf_counter() - t0
    r4 = [torch.load(base / f"rank{r}.pt", weights_only=False)
          for r in range(4)]
    rec = {"world4_s": world4_s,
           "world1": {k: w1_train[k] for k in (
               "loss", "seconds", "peak_memory_gb", "launches")},
           "ranks": [],
           "resume": tp_resume_world1(base / "ckpt", r4, w1_train, batch,
                                      noise2, geo)}
    del batch, noise2
    shutil.rmtree(base, ignore_errors=True)
    d_model = w1_train["params"]["blocks.0.self_attn.q.weight"].shape[0]
    for r, got in enumerate(r4):
        m = got["model_rank"]

        def cut(tree, k):
            return shard_param(k, tree[k], got["dims"][k], 2, m).numpy()

        grel = _cat_rel_l2([(got["grads"][k].numpy(),
                             cut(w1_train["grads"], k))
                            for k in got["grads"]])
        # AdamW's moves against world 1's (each about lr in size; a
        # gradient within the ranks' rounding of 0 may turn its sign)
        urel = _cat_rel_l2([
            (got["params"][k].numpy() - cut(w1_train["before"], k),
             cut(w1_train["params"], k) - cut(w1_train["before"], k))
            for k in got["params"]])
        lrel = abs(got["loss"] - w1_train["loss"]) / abs(w1_train["loss"])
        row = {"loss": got["loss"], "loss_rel": lrel, "grad_rel_l2": grel,
               "moves_rel_l2": urel, "q_local": got["q_local"],
               **{k: got[k] for k in ("seconds", "peak_memory_gb",
                                      "launches")}}
        rec["ranks"].append(row)
        log(f"[tp train] rank {r} (data {got['data_rank']}, model {m}): "
            f"loss {got['loss']:.6f} (world 1 {w1_train['loss']:.6f}, "
            f"relative {lrel:.3e}, gate {SP_LOSS_TOL}); gradients "
            f"{grel:.3e} relative L2 from world 1's shard (gate "
            f"{SP_GRAD_TOL}); AdamW's moves {urel:.3e} from world 1's "
            f"(gate {TP_UPDATE_TOL}); q weight {got['q_local']}; "
            f"{got['seconds']:.2f} s (world 1 {w1_train['seconds']:.2f} s),"
            f" peak {got['peak_memory_gb']:.2f} GB (world 1 "
            f"{w1_train['peak_memory_gb']:.2f} GB); launches "
            f"{got['launches']}")
        if (lrel > SP_LOSS_TOL or grel > SP_GRAD_TOL or urel > TP_UPDATE_TOL
                or got["q_local"] != (d_model // 2, d_model // 2)):
            fail(f"phase 29 TP x FSDP rank {r}: {row}")
    log(f"[tp train] world 4 in {world4_s:.1f} s")
    return rec


def tp_resume_world1(ckpt, r4, w1_train, batch, noise2, geo):
    """Phase 29 (c)'s train state after the ranks' runs: every rank
    returned once the directory existed; a fresh state of each rank's
    layout restored from the file held its shards bit for bit, and the
    second step from it took the loss of the second step in memory bit for
    bit, its parameters within TP_RESUME_TOL (B3 adds dq's key tiles in
    no fixed order); the file holds the model's global shapes; the same
    file restored into a world-1 state on the card, whose second step is
    held to the world-1 gates against the ranks' (the loss within
    SP_LOSS_TOL, AdamW's moves within TP_UPDATE_TOL). Returns the
    record."""
    import torch
    from videocof_torch.parallel import rank_device
    from videocof_torch.utils.checkpoint import restore_train_state
    rows = []
    for r, got in enumerate(r4):
        res = got["resume"]
        row = {k: res[k] for k in ("there", "save_s", "restore_s", "n_held",
                                   "loss2", "loss2_restored",
                                   "step2_differ", "step2_rel_l2")}
        row["restored_differ"] = res["restored_differ"][:5]
        rows.append(row)
        log(f"[tp train] rank {r}: save {res['save_s']:.2f} s (directory "
            f"there on return: {res['there']}), restore "
            f"{res['restore_s']:.2f} s; restored tensors unequal to the "
            f"saved ones {len(res['restored_differ'])} of {res['n_held']}; "
            f"second step's loss {res['loss2_restored']!r} from the restored "
            f"state, {res['loss2']!r} in memory; its tensors unequal "
            f"{res['step2_differ']} of {res['n_held']}, parameters "
            f"{res['step2_rel_l2']:.3e} relative L2 (gate {TP_RESUME_TOL})")
        if (not res["there"] or res["restored_differ"]
                or res["loss2_restored"] != res["loss2"]
                or res["step2_rel_l2"] > TP_RESUME_TOL
                or res["path"] != r4[0]["resume"]["path"]):
            fail(f"phase 29 TP x FSDP train state, rank {r}: {row}")
    t0 = time.perf_counter()
    payload = torch.load(Path(r4[0]["resume"]["path"]) / "train_state.pt",
                         map_location="cpu", weights_only=True)
    load_s = time.perf_counter() - t0
    want = {k: tuple(v.shape) for k, v in w1_train["params"].items()}
    got = {k: tuple(v.shape) for k, v in payload["params"].items()}
    moments = sorted(tuple(st["exp_avg"].shape)
                     for st in payload["optimizer"]["state"].values())
    log(f"[tp train] the file ({load_s:.2f} s to read): {len(got)} "
        f"parameters, q weight {got.get('blocks.0.self_attn.q.weight')}, "
        f"fc1 {got.get('blocks.0.ffn.fc1.weight')}")
    if got != want or moments != sorted(want.values()):
        fail(f"phase 29 TP x FSDP train state: the file's shapes are not "
             f"the model's: {[k for k in want if got.get(k) != want[k]][:5]}")
    dev = rank_device()
    dit, _, _ = tp_train_setup(dev, geo)
    state, step_fn = tp_train_state(dit)
    t0 = time.perf_counter()
    restore_train_state(str(ckpt), state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state, loss = step_fn(state, batch, noise=noise2)
    whole2 = r4[0]["resume"]["whole2"]
    w1 = {k: v.float() for k, v in payload["params"].items()}
    moves = _cat_rel_l2([
        ((v.float().cpu() - w1[k]).numpy(), (whole2[k].float() - w1[k]).numpy())
        for k, v in state.params.state_dict().items()])
    lrel = abs(float(loss) - r4[0]["resume"]["loss2"]) / abs(
        r4[0]["resume"]["loss2"])
    w1_row = {"restore_s": restore_s, "loss2": float(loss), "loss_rel": lrel,
              "moves_rel_l2": moves}
    log(f"[tp train] the file restored at world 1 in {restore_s:.2f} s: "
        f"second step's loss {float(loss):.6f} ({lrel:.3e} from the ranks', "
        f"gate {SP_LOSS_TOL}); AdamW's moves {moves:.3e} from the ranks' "
        f"(gate {TP_UPDATE_TOL})")
    if lrel > SP_LOSS_TOL or moves > TP_UPDATE_TOL:
        fail(f"phase 29 TP x FSDP train state restored at world 1: {w1_row}")
    del dit, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"ranks": rows, "file_read_s": load_s, "world1": w1_row}


def tp_phase(card, geo, video, probed):
    """Phase 29 (a)-(f) (module docstring): world 1 in this process, then
    the world of 2, then the world of 4. Fails on a collective the probe
    found refused, on a rank that fails or disagrees with world 1, on
    wrong B1 calls, on a TP rank holding more than TP_BYTES_SHARE of the
    blocks' bytes. Returns the record."""
    import numpy as np
    import torch
    from videocof_torch.configs import WAN21_T2V_14B
    from videocof_torch.parallel import rank_device
    for op in ("all_reduce", "all_reduce_uint8", "all_to_all_single",
               "all_to_all_single_uneven", "all_gather_into_tensor",
               "reduce_scatter_tensor_bf16"):
        if not probed["gloo"][op]["ok"]:
            fail(f"gloo {op} on CUDA tensors: {probed['gloo'][op]}")
    dev = rank_device()
    t_phase = time.perf_counter()
    base = SCRATCH / "tp"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    cfg14 = WAN21_T2V_14B.replace(num_layers=TP_EDIT_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    lora_paths, _ = write_lora_files(cfg14, gen, base / "lora")
    edit_inputs = {"video": video, "kw": _edit_kw(geo),
                   "embeds": torch.randn(1, TEXT_TOKENS, cfg14.text_dim,
                                         generator=gen, device=dev).cpu()}
    # world 1
    t0 = time.perf_counter()
    pipe = tp_edit_pipeline(dev, lora_paths)
    w1_edit = tp_edit_run(pipe, edit_inputs)
    del pipe
    w1_fam = tp_family_run(tp_family_models(dev))
    torch.cuda.empty_cache()
    blocks, (x, e0, ctx), rope = pp_setup(dev, geo)
    with torch.no_grad():
        h = x
        t1 = time.perf_counter()
        for blk in blocks:
            h = blk(h, e0, ctx, rope)
        torch.cuda.synchronize()
    w1_pp = {"out": h.float().cpu(), "seconds": time.perf_counter() - t1}
    xg = x.clone().requires_grad_()
    h = xg
    for blk in blocks[:PP_GRAD_BLOCKS]:
        h = blk(h, e0, ctx, rope)
    h.float().square().mean().backward()
    w1_pp.update(grads=pp_grads(blocks[:PP_GRAD_BLOCKS]),
                 grad_x=xg.grad.float().cpu())
    del blocks, x, e0, ctx, h, xg
    gc.collect()
    torch.cuda.empty_cache()
    world1_s = time.perf_counter() - t0
    # the world of 2, then the world of 4
    t0 = time.perf_counter()
    _spawn_ranks(_p29_rank2, 2, (str(base / "rdzv2"), str(base), lora_paths,
                                 edit_inputs, geo), "phase 29, world 2")
    spawn2_s = time.perf_counter() - t0
    r2 = [torch.load(base / f"rank{r}.pt", weights_only=False)
          for r in range(2)]
    for r in range(2):
        (base / f"rank{r}.pt").unlink()
    rec = {"card": card, "backend": "gloo", "world1_s": world1_s,
           "world2_s": spawn2_s}
    log(f"[tp] world 1 in {world1_s:.1f} s, the world of 2 in "
        f"{spawn2_s:.1f} s")

    # (a) the TP edit
    L = sp_tokens(cfg14, geo, geo.source_frames)
    steps, n14 = geo.num_inference_steps, cfg14.num_heads
    want_b1 = {str((1, L, L, n14 // 2, False)): TP_EDIT_LAYERS * steps,
               str((1, L, TEXT_TOKENS, n14 // 2, False)):
               TP_EDIT_LAYERS * steps}
    rec["edit"] = {"world1": {k: w1_edit[k] for k in (
        "seconds", "stages_s", "peak_memory_gb", "block_bytes", "b1")},
        "ranks": []}
    for r, got in enumerate(r2):
        g = got["edit"]
        rel = _rel_l2(g["latents"], w1_edit["latents"])
        share = g["block_bytes"] / g["whole_bytes"]
        row = {"latents_rel_l2": rel, "block_bytes_share": share,
               **{k: g[k] for k in ("seconds", "stages_s", "peak_memory_gb",
                                    "block_bytes", "b1", "launches",
                                    "all_reduce")}}
        rec["edit"]["ranks"].append(row)
        log(f"[tp edit] rank {r}: latents relative L2 {rel:.3e} from world "
            f"1's (gate {SP_REL_TOL}); {g['seconds']:.2f} s (world 1 "
            f"{w1_edit['seconds']:.2f} s); blocks {g['block_bytes'] / 1e9:.3f}"
            f" of {g['whole_bytes'] / 1e9:.3f} GB ({share:.4f}); peak "
            f"{g['peak_memory_gb']:.2f} GB (world 1 "
            f"{w1_edit['peak_memory_gb']:.2f} GB); all-reduces "
            f"{g['all_reduce']['calls']} of {g['all_reduce']['bytes'] / 1e9:.2f}"
            f" GB in {g['all_reduce']['seconds']:.2f} s; B1 calls {g['b1']}")
        if not np.isfinite(g["latents"]).all() or rel > SP_REL_TOL:
            fail(f"phase 29 TP edit rank {r}: {rel:.3e} from world 1")
        if g["b1"] != want_b1 or share > TP_BYTES_SHARE:
            fail(f"phase 29 TP edit rank {r}: B1 {g['b1']} (expected "
                 f"{want_b1}), block bytes share {share:.4f}")

    # (b) the families
    fam = family_geometry()
    rec["families"] = {}
    for name, w1 in w1_fam.items():
        B, Lf, N, _ = fam[name]
        want = {str((B, Lf, Lf, N // 2, False)):
                TP_FAMILY_LAYERS * (2 if name == "flux" else 1)}
        rows = []
        for r, got in enumerate(r2):
            g = got["families"][name]
            rel = _rel_l2(g["out"].numpy(), w1["out"].numpy())
            share = g["block_bytes"] / w1["block_bytes"]
            rows.append({"rel_l2": rel, "seconds": g["seconds"],
                         "b1": g["b1"], "block_bytes_share": share})
            log(f"[tp {name}] rank {r}: relative L2 {rel:.3e} from world "
                f"1's (gate {SP_REL_TOL}); {g['seconds']:.3f} s (world 1 "
                f"{w1['seconds']:.3f} s); block bytes {share:.4f} of world "
                f"1's; B1 calls {g['b1']}")
            if not rel <= SP_REL_TOL or g["b1"] != want \
                    or share > TP_BYTES_SHARE:
                fail(f"phase 29 TP {name} rank {r}: {rows[-1]} (B1 "
                     f"expected {want})")
        rec["families"][name] = {"world1_s": w1["seconds"], "ranks": rows}

    # (d) the pipeline
    rec["pp"] = {"world1_s": w1_pp["seconds"], "ranks": []}
    for r, got in enumerate(r2):
        g = got["pp"]
        rel = _rel_l2(g["out"].numpy(), w1_pp["out"].numpy())
        grel = _cat_rel_l2([(v.numpy(), w1_pp["grads"][k].numpy())
                            for k, v in g["grads"].items()])
        xrel = _rel_l2(g["grad_x"].numpy(), w1_pp["grad_x"].numpy())
        row = {"rel_l2": rel, "grad_rel_l2": grel, "grad_x_rel_l2": xrel,
               **{k: g[k] for k in ("seconds", "grad_seconds", "launches",
                                    "grad_launches", "all_reduce",
                                    "block_bytes")}}
        rec["pp"]["ranks"].append(row)
        log(f"[pp] rank {r}: 30 blocks over 2 stages, {PP_MICRO} "
            f"microbatches: relative L2 {rel:.3e} from the sequential "
            f"blocks' (gate {SP_REL_TOL}), {g['seconds']:.2f} s (world 1 "
            f"{w1_pp['seconds']:.2f} s); the backward through "
            f"{PP_GRAD_BLOCKS} blocks: its blocks' gradients {grel:.3e}, "
            f"the stream's {xrel:.3e} (gate {SP_GRAD_TOL}), "
            f"{g['grad_seconds']:.2f} s; launches {g['launches']}, "
            f"backward {g['grad_launches']}")
        if not rel <= SP_REL_TOL or not max(grel, xrel) <= SP_GRAD_TOL:
            fail(f"phase 29 PP rank {r}: {row}")
        if len(g["grads"]) * 2 != len(w1_pp["grads"]):
            fail(f"phase 29 PP rank {r}: gradients of {len(g['grads'])} "
                 f"tensors, world 1 {len(w1_pp['grads'])}")

    # (e) the experts
    own = {got["ep"]["owner_of"]: got["ep"]["own"] for got in r2}
    rec["ep"] = {"ranks": []}
    for r, got in enumerate(r2):
        g = got["ep"]
        same = [bool(torch.equal(g[k], own[k])) for k in range(2)]
        rec["ep"]["ranks"].append({
            "resident_bytes": g["resident_bytes"], "bit_for_bit": same,
            "select_s": [g["select_s_0"], g["select_s_1"]]})
        log(f"[ep] rank {r} (owner of expert {g['owner_of']}, "
            f"{g['resident_bytes'] / 1e9:.3f} GB resident): select_expert "
            f"k = 0, 1 in {g['select_s_0']:.2f}, {g['select_s_1']:.2f} s; "
            f"the forward equal to the owner's bit for bit: {same}")
        if not all(same):
            fail(f"phase 29 EP rank {r}: the selected expert's forward "
                 f"differs from its owner's")

    shutil.rmtree(base, ignore_errors=True)
    rec["train"] = tp_train_phase(geo)
    rec["xlm_roberta"] = xlm_phase()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[tp] phase 29 in {rec['seconds']:.1f} s (world 1 {world1_s:.1f} "
        f"s, world 2 {spawn2_s:.1f} s, world 4 {rec['train']['world4_s']:.1f}"
        f" s; the ranks "
        f"share the card's SMs: no multi-GPU speed)")
    return rec


def check_timing_lines(text, stages):
    """Fail unless ``text`` (the stderr of a pipeline built under
    ``VIDEOCOF_TIMING=1``) holds one ``[pipeline] <label>: <s>s`` line a
    stage, in order, and nothing else."""
    lines = text.splitlines()
    labels = [m.group(1) for m in map(re.compile(
        r"^\[pipeline\] ([^:]+): \d+\.\d\ds$").match, lines) if m]
    log("[timing] VIDEOCOF_TIMING=1 printed: " + " | ".join(lines))
    if labels != stages or len(lines) != len(stages):
        fail(f"VIDEOCOF_TIMING=1 printed {lines}, expected one line for each "
             f"of {stages}")


def helpers_phase(vid, geo):
    """Phase 4's checks of the ported helpers: `default_backend` on the
    card; `save_videos_grid` of the edit's frames with the colour pin,
    read back by cv2 (frames and size);
    `get_video_to_video_latent` on a cv2 clip of the geometry's size (at
    fps 8 of its 16, and a ref image); `merge_video_audio` without
    ffmpeg. Returns their seconds."""
    import numpy as np
    from videocof_torch.ops import default_backend
    from videocof_torch.utils import (get_video_to_video_latent,
                                      merge_video_audio, save_videos_grid)
    from videocof_torch.utils.video_io import video_info
    if default_backend() != "flash":
        fail(f"default_backend() on the card is {default_backend()!r}")
    t0 = time.perf_counter()
    grid_path = SCRATCH / "grid.mp4"
    SCRATCH.mkdir(parents=True, exist_ok=True)
    save_videos_grid(vid, str(grid_path), color_transfer_post_process=True)
    grid_s = time.perf_counter() - t0
    T, H, W = vid.shape[2:]
    got = video_info(str(grid_path))[:3]
    log(f"[helpers] default_backend() {default_backend()!r}; "
        f"save_videos_grid of {vid.shape} with the colour pin in "
        f"{grid_s:.2f} s: cv2 reads (frames, height, width) {got}")
    if got != (T, H, W):
        fail(f"save_videos_grid wrote {got}, expected {(T, H, W)}")
    clip = write_clip("helpers", geo)
    ref = np.random.default_rng(SEED).integers(0, 256, (64, 96, 3),
                                               dtype=np.uint8)
    t0 = time.perf_counter()
    video, mask, ref_out, clip_image = get_video_to_video_latent(
        str(clip), geo.source_frames, (geo.height, geo.width), fps=8,
        ref_image=ref)
    v2v_s = time.perf_counter() - t0
    want = (1, 3, CLIP_FRAMES // 2, geo.height, geo.width)
    log(f"[helpers] get_video_to_video_latent in {v2v_s:.2f} s: video "
        f"{video.shape} in [{video.min():.4f}, {video.max():.4f}], mask "
        f"{mask.shape} {np.unique(mask).tolist()}, ref {ref_out.shape}")
    if (video.shape != want or video.dtype != np.float32
            or video.min() < 0 or video.max() > 1
            or mask.shape != (1, 1) + want[2:] or not (mask == 255).all()
            or ref_out.shape != (1, 3, 1, 64, 96)
            or not np.array_equal(clip_image, ref)):
        fail(f"get_video_to_video_latent: video {video.shape}, mask "
             f"{mask.shape}, ref {ref_out.shape}, expected {want}")
    audio = SCRATCH / "audio.wav"
    audio.write_bytes(b"\0" * 64)
    try:
        merge_video_audio(str(grid_path), str(audio))
    except RuntimeError as exc:
        log(f"[helpers] merge_video_audio: RuntimeError ({exc})")
    else:
        fail("merge_video_audio did not raise without ffmpeg")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    return {"grid_s": grid_s, "v2v_s": v2v_s}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from videocof_torch.configs import (GenerationConfig, T5Config,
                                        WAN21_T2V_14B, WAN21_T2V_1_3B,
                                        WAN22_T2V_A14B, WAN22_TI2V_5B,
                                        Wan22VAEConfig, WanVAEConfig)
    from videocof_torch.models.lora import ADAPTER_TARGETS, init_lora_adapters
    from videocof_torch.models.t5_encoder import init_t5_encoder
    from videocof_torch.models.teacache import (get_teacache_coefficients,
                                                plan_teacache_skips)
    from videocof_torch.models.wan_dit import (init_wan_dit,
                                               make_rope_for_geometry)
    from videocof_torch.models.wan_vae import init_wan_vae
    from videocof_torch.ops import _build
    from videocof_torch.ops import dit_fused as df
    from videocof_torch.ops import flash_attention as fa
    from videocof_torch.ops import int8_attention as i8
    from videocof_torch.pipeline import WanPipeline, latent_frame_count
    from videocof_torch.schedulers import get_scheduler
    from videocof_torch.training import (CoFTrainer, TrainerConfig,
                                         flow_matching_loss)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    names = list(fa.KERNEL_WRAPPERS)    # B1, B2, B3
    names8 = list(i8.KERNEL_WRAPPERS)   # B4: its pre-pass and its attention

    def launch_counts():
        return {**fa.launch_counts(), **i8.launch_counts()}

    def reset_launch_counts():
        fa.reset_launch_counts()
        i8.reset_launch_counts()

    # ------------------------------------------------------------ 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("[env] " + json.dumps(environment()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_s = fa.build()
    log(f"[build] nvcc in parallel: " + ", ".join(
        f"{src} {s:.2f} s" for src, s in build_s.items())
        + f" (wall {time.perf_counter() - t0:.2f} s)")
    for src in build_s:
        build_log = _build.build_info[src]["log"]
        for kernel, regs, st, ld, smem in ptxas_report(build_log):
            log(f"[build] {kernel}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B, static shared memory {smem} B")
        for line in build_log.splitlines():
            # warnings, and ptxas's notes of serialized wgmmas (C7515)
            if "warning" in line.lower() or "Performance Loss" in line:
                log(f"[build] {src}: {line.strip()}")
    log(f"[build] k_prepass_kernel's dynamic shared memory: its stages of "
        f"at most {i8.PREPASS_STAGE_BYTES} B each; resident CTAs (its grid "
        f"and the most chunks a slab): " + ", ".join(
            f"D={Dh} {str(dt)[6:]} {i8._resident(0, Dh, dt)}"
            for Dh in i8.HEAD_DIMS for dt in i8.DTYPES))
    # one instantiation per type, head dim (and LSE flag for the forward)
    for source, kernel, opcodes, want in (
            (fa.SOURCE, "flash_fwd_kernel", SASS_OPCODES,
             len(fa.DTYPES) * len(fa.HEAD_DIMS) * 2),
            (fa.BWD_SOURCE, "flash_bwd_kernel", SASS_OPCODES,
             len(fa.DTYPES) * len(fa.HEAD_DIMS)),
            (i8.SOURCE, "int8_attn_kernel", SASS_OPCODES_INT8,
             len(i8.DTYPES) * len(i8.HEAD_DIMS))):
        sass, gmma = sass_counts(_build.library_path(source), kernel, opcodes)
        for label, counts in sass.items():
            log(f"[sass] {label}: " + ", ".join(
                f"{op} {n}" for op, n in counts.items()))
        log(f"[sass] {kernel}: wgmma opcodes seen: {gmma}")
        if len(sass) != want or any(0 in c.values() for c in sass.values()):
            fail(f"{kernel}'s SASS lacks one of {opcodes}: {sass}")

    # ----------------------------------------------------- 2. kernels vs plain
    log(f"[smoke] phase 2 starts at {time.perf_counter() - t_start:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def qkv(B, Lq, Lk, N, D, dtype=bf16):
        return [randn(B, L, N, D, dtype=dtype) for L in (Lq, Lk, Lk)]

    geo = GenerationConfig()
    vcfg, dcfg = WanVAEConfig(), WAN21_T2V_1_3B
    tc, sc = vcfg.temporal_compression_ratio, vcfg.spatial_compression_ratio
    cond = latent_frame_count(geo.source_frames, tc)
    ground = latent_frame_count(geo.reasoning_frames, tc)
    latent_frames = 2 * cond + ground
    _, ph, pw = dcfg.patch_size
    L = latent_frames * (geo.height // sc // ph) * (geo.width // sc // pw)
    N, D, Lt = dcfg.num_heads, dcfg.head_dim, TEXT_TOKENS
    log(f"[geometry] {latent_frames} latent frames, {L} DiT tokens, "
        f"{N} heads of {D}")
    # the 4x edit's tokens, and the ragged batch's two rows (the 4-step
    # edit's clip and a RAGGED_FRAMES one)
    per_frame = (geo.height // sc // ph) * (geo.width // sc // pw)
    L4 = (2 * latent_frame_count(EXTRAP_FRAMES, tc) + ground) * per_frame
    ragged = (L, (2 * latent_frame_count(RAGGED_FRAMES, tc) + ground)
              * per_frame)
    log(f"[geometry] 4x edit ({EXTRAP_FRAMES} frames): {L4} DiT tokens; "
        f"ragged batch ({geo.source_frames} and {RAGGED_FRAMES} frames): "
        f"{ragged} tokens")
    # B1's shapes on the 4x edit and the ragged batch: (batch, Lq, Lk),
    # the valid keys of each row (None: no mask)
    new_b1 = {"4x self": ((1, L4, L4), None),
              "4x cross": ((1, L4, Lt), None),
              "ragged self": ((2, ragged[1], ragged[1]), ragged)}
    # B1's shapes on the Wan2.2 paths: (batch, Lq, Lk), heads
    v22 = Wan22VAEConfig()
    L5 = ((2 * latent_frame_count(geo.source_frames, tc) + ground)
          * (TI2V_HW[0] // v22.spatial_compression_ratio // ph)
          * (TI2V_HW[1] // v22.spatial_compression_ratio // pw))
    Lt2v = latent_frame_count(T2V_FRAMES, tc) * per_frame
    b1_22 = {"5B self": ((1, L5, L5), WAN22_TI2V_5B.num_heads),
             "5B cross": ((1, L5, Lt), WAN22_TI2V_5B.num_heads),
             "A14B t2v self": ((2, Lt2v, Lt2v), WAN22_T2V_A14B.num_heads),
             "A14B t2v cross": ((2, Lt2v, Lt), WAN22_T2V_A14B.num_heads)}
    log(f"[geometry] TI2V-5B edit at {TI2V_HW[0]}x{TI2V_HW[1]}: {L5} DiT "
        f"tokens; A14B text-to-video, {T2V_FRAMES} frames: {Lt2v} tokens")
    # B1's shapes on the other Wan variants (phases 22-25): the i2v 14B's
    # self, text and image cross-attention under batched CFG, and S2V's
    # audio injection (batch 2 x latent frames, a frame's tokens, 4 keys)
    lat_v, Lv, frame_v = variant_tokens(geo)
    b1_var = {"i2v self": ((2, Lv, Lv), WAN21_T2V_14B.num_heads),
              "i2v text cross": ((2, Lv, Lt), WAN21_T2V_14B.num_heads),
              "i2v image cross": ((2, Lv, 257), WAN21_T2V_14B.num_heads),
              "s2v audio": ((2 * lat_v, frame_v, AUDIO_TOKENS),
                            WAN21_T2V_14B.num_heads)}
    log(f"[geometry] the variants' {VARIANT_FRAMES} frames: {lat_v} latent "
        f"frames, {Lv} DiT tokens, {frame_v} a frame")
    # B1's shapes on the other families (phases 26-28): (batch, joint
    # tokens, heads, head dim) and, for QwenImage's key-masked path (a text
    # mask folded into the joint key mask), the valid keys of each row
    fam = family_geometry()
    fam_text = {"cogvideox": COG_TEXT, "flux": FLUX_TEXT,
                "qwenimage": QWEN_TEXT}
    b1_fam = {f"{name} joint": (geo_f, None) for name, geo_f in fam.items()}
    qB, qL, qN, qD = fam["qwenimage"]
    b1_fam["qwenimage joint, text mask"] = (
        (2, qL, qN, qD), (qL - QWEN_TEXT // 4, qL))
    log("[geometry] the families' joint sequences (batch, tokens, heads, "
        "head dim): " + json.dumps(fam))

    def ragged_mask(lengths, Lk):
        if lengths is None:
            return None
        return (torch.arange(Lk, device=dev)[None]
                < torch.tensor(lengths, device=dev)[:, None])

    cases = [
        ("self-attention, 2 of 12 heads", (1, L, L, 2, D), None, bf16),
        ("cross-attention", (1, L, Lt, N, D), None, bf16),
        ("ragged L=3000", (1, 3000, 3000, 4, D), None, bf16),
        ("key mask, fully masked batch row", (2, 1000, 777, 3, D), "mask",
         bf16),
        ("head_dim 64", (1, 3000, 3000, 4, 64), None, bf16),
        ("fp16", (1, 1000, 700, 2, D), None, torch.float16),
    ]
    errs = {n: [0.0, 0.0] for n in names + names8 + ["int8_flash_attention"]}

    def note(kernel, err_rel):
        errs[kernel] = [max(a, b) for a, b in zip(errs[kernel], err_rel)]

    def check_forward(label, q, k, v, mask, quiet=False):
        """B1 and B2 against their plain versions (out, LSE), and B1(q,
        scale) equal bit for bit to B2(round(q * scale), scale 1): the
        kernel scales q in the same two roundings. Returns (the scale-folded
        q, B2's plain out and LSE)."""
        Dh, dtype = q.shape[-1], q.dtype
        out1 = fa.flash_attention(q, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, kv_mask=mask)
        note("flash_attention_fwd",
             compare(f"B1 {label}", out1, ref, quiet=quiet))
        # B2, on the scale-folded q as the training forward runs it
        qs = q * fa._rounded(Dh ** -0.5, dtype)
        out, lse = fa.flash_fwd_lse(qs, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_fwd_lse_reference(qs, k, v, kv_mask=mask)
        note("flash_attention_fwd_lse",
             compare(f"B2 out {label}", out, ref, quiet=quiet))
        lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)
                   ).max().item()
        lse_ok = bool(torch.isfinite(lse).all()) and lse_err <= LSE_TOL
        same = torch.equal(out1, out)
        if not (quiet and lse_ok and same):
            log(f"[kernel vs plain] B2 lse {label}: max relative err "
                f"{lse_err:.3e} (tol {LSE_TOL}), lse in "
                f"[{ref_lse.min().item():.4g}, {ref_lse.max().item():.4g}]: "
                f"{'ok' if lse_ok else 'FAIL'}; B1 == B2 on the scale-folded "
                f"q bit for bit: {'ok' if same else 'FAIL'}")
        if not lse_ok:
            fail(f"B2's LSE disagrees with its plain version: {label}")
        if not same:
            fail(f"B1 and B2 differ on the scale-folded q: {label}")
        return qs, ref, ref_lse

    c1 = {}     # B3's relative L2 against the fp32 plain backward, by case

    def check_backward(label, qs, k, v, ref, ref_lse, quiet=False):
        """B3 against the plain backward in its own arithmetic (P and dS
        rounded, ``rounded=True``) and in JAX's fp32 arithmetic, from the
        plain LSE and delta so that the kernel is held alone."""
        B, Lq, Nh, Dh = qs.shape
        do = randn(B, Lq, Nh, Dh, dtype=qs.dtype)
        delta = fa.flash_bwd_delta(ref, do)
        got = fa.flash_bwd(qs, k, v, do, ref_lse, delta)
        torch.cuda.synchronize()
        # with one key P = 1 and dS = P (dP - delta) = 0 but for rounding:
        # dq and dk are rounding noise there, held by the absolute bound
        noise = ("dq", "dk") if k.shape[1] == 1 else ()
        want = {rounded: (fa.flash_bwd_dq_reference(
                    qs, k, v, do, ref_lse, delta, rounded=rounded),
                    *fa.flash_bwd_dkv_reference(qs, k, v, do, ref_lse, delta,
                                                rounded=rounded))
                for rounded in (True, False)}
        sizes = {}
        for part, g, w, w32 in zip(("dq", "dk", "dv"), got, want[True],
                                   want[False]):
            err, rel = compare(
                f"B3 {part} vs rounded plain {label}", g, w, quiet=quiet,
                rel_tol=None if part in noise else B3_ROUNDED_TOL)
            # the noise's relative error (over a norm near 0) is not kept
            note("flash_attention_bwd", (err, 0.0 if part in noise else rel))
            # C1's size on these inputs: the rounded plain vs the fp32 one
            size = ((w.float() - w32.float()).norm() / w32.float().norm()
                    ).item()
            _, rel = compare(
                f"B3 {part} vs fp32 plain (the rounding alone: {size:.3e}) "
                f"{label}", g, w32, quiet=quiet,
                rel_tol=None if part in noise else B3_FP32_FACTOR * size)
            sizes[part] = {"kernel": rel, "rounded_plain": size}
        if not quiet:
            c1[label] = sizes
        del want

    for name, shape, masked, dtype in cases:
        B, Lq, Lk, Nh, Dh = shape
        label = f"{name} {shape} {str(dtype)[6:]}"
        q, k, v = qkv(*shape, dtype=dtype)
        mask = None
        if masked:
            mask = torch.rand(B, Lk, generator=gen, device=dev) > 0.3
            mask[-1] = False
        qs, ref, ref_lse = check_forward(label, q, k, v, mask)
        if masked:
            # B3 takes no mask (the masked path's backward is plain, as in
            # JAX): hold it at this case's shape without the mask
            ref, ref_lse = fa.flash_fwd_lse_reference(qs, k, v)
            label += " (B3 unmasked)"
        check_backward(label, qs, k, v, ref, ref_lse)
        del q, k, v, qs, ref, ref_lse
    # B1 and B2 at lengths on and beside their 128-row q tiles and 128-key
    # K/V tiles (TMA's zero fill, the -inf of the ragged keys, rows never
    # stored), at both head dims and both types; one line unless one fails
    edges = [(Lq, Lk, Dh, dtype) for Lq in (1, 127, 129)
             for Lk in (1, 127, 129, 512)
             for Dh, dtype in ((D, bf16), (64, torch.float16))]
    for Lq, Lk, Dh, dtype in edges:
        check_forward(f"tile edge Lq={Lq} Lk={Lk} D={Dh} {str(dtype)[6:]}",
                      *qkv(2, Lq, Lk, 3, Dh, dtype=dtype), None, quiet=True)
    log(f"[kernel vs plain] B1, B2 at {len(edges)} tile-edge lengths (Lq "
        f"1/127/129 x Lk 1/127/129/512, D {D} bf16 and D 64 fp16): ok; "
        f"B1 == B2 bit for bit in each")
    # B1 at the 14B's 40 heads of 128, at the self and cross shapes of its
    # edit (the plain version chunks its rows: its logits stay near 1 GiB)
    N14 = WAN21_T2V_14B.num_heads
    err14 = {}
    for shape_name, (B, Lq, Lk) in (("self", (1, L, L)), ("cross", (1, L, Lt))):
        q, k, v = qkv(B, Lq, Lk, N14, D)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err14[shape_name] = compare(
            f"B1 {shape_name}-attention at the 14B's {N14} heads "
            f"{(B, Lq, Lk, N14, D)} bfloat16", out,
            fa.flash_attention_reference(q, k, v))
        note("flash_attention_fwd", err14[shape_name])
        del q, k, v, out

    def shape_errs(fn, keys=("flash_attention_fwd_lse",
                             "flash_attention_bwd")):
        """Run ``fn()`` with the error maxima of ``keys`` (B2's and B3's)
        set aside: returns the maxima it noted, which also join ``errs``."""
        saved = {key: errs[key] for key in keys}
        for key in keys:
            errs[key] = [0.0, 0.0]
        fn()
        got = {key: errs[key] for key in keys}
        for key in keys:
            errs[key] = [max(a, b) for a, b in zip(saved[key], got[key])]
        return got

    # B2 and B3 at the 14B's 40 heads, the shapes of its LoRA training step
    # (phase 20): B2's out and LSE, and B3 against the rounded and the fp32
    # plain backward
    err14_train = {}
    for shape_name, (B, Lq, Lk) in (("self", (1, L, L)), ("cross", (1, L, Lt))):
        label = (f"{shape_name}-attention at the 14B's {N14} heads "
                 f"{(B, Lq, Lk, N14, D)} bfloat16")
        q, k, v = qkv(B, Lq, Lk, N14, D)

        def check_both():
            qs, ref, ref_lse = check_forward(label, q, k, v, None)
            check_backward(label, qs, k, v, ref, ref_lse)

        err14_train[shape_name] = shape_errs(check_both)
        del q, k, v
        torch.cuda.empty_cache()
    # B1, B2 and B3 at the shapes of the parallel paths (phase 21): Ulysses
    # at seq 2 gives each rank half the heads over the whole sequence for
    # self-attention (B1; B2 and B3 in training) and half the tokens for
    # the local cross-attention; ring at world 1 runs B2 over the 4x
    # edit's whole sequence (one shard)
    sp_shapes = {"sp self": ((1, L, L), N // SP_DEGREE, True),
                 "sp cross": ((1, L // SP_DEGREE, Lt), N, True),
                 "ring 4x": ((1, L4, L4), N, False)}
    err_sp = {}
    for label, ((B, Lq, Lk), Nh, backward) in sp_shapes.items():
        q, k, v = qkv(B, Lq, Lk, Nh, D)
        tag = f"{label} {(B, Lq, Lk, Nh, D)} bfloat16"

        def check_sp():
            qs, ref, ref_lse = check_forward(tag, q, k, v, None)
            if backward:
                check_backward(tag, qs, k, v, ref, ref_lse)

        err_sp[label] = shape_errs(check_sp, keys=names)
        del q, k, v
        torch.cuda.empty_cache()
    # B1 at the 4x edit's and the ragged batch's shapes (the plain version
    # takes its q rows in chunks, so it holds the kernel against all keys
    # at 107,640 tokens too)
    err_new = {}
    for label, ((B, Lq, Lk), lengths) in new_b1.items():
        q, k, v = qkv(B, Lq, Lk, N, D)
        mask = ragged_mask(lengths, Lk)
        out = fa.flash_attention(q, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        err_new[label] = compare(
            f"B1 {label} {(B, Lq, Lk, N, D)} bfloat16"
            + (f", row keys {lengths}" if lengths else ""), out,
            fa.flash_attention_reference(q, k, v, kv_mask=mask))
        note("flash_attention_fwd", err_new[label])
        del q, k, v, out, mask
        torch.cuda.empty_cache()
    # B1 at the Wan2.2 paths' shapes: the TI2V-5B's 24 heads at its 704x1280
    # edit (16,720 tokens), the A14B's 40 heads at text-to-video's 81
    # frames under batched CFG (batch 2, 32,760 tokens)
    err22 = {}
    for label, ((B, Lq, Lk), Nh) in b1_22.items():
        q, k, v = qkv(B, Lq, Lk, Nh, D)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err22[label] = compare(f"B1 {label} {(B, Lq, Lk, Nh, D)} bfloat16",
                               out, fa.flash_attention_reference(q, k, v))
        note("flash_attention_fwd", err22[label])
        del q, k, v, out
        torch.cuda.empty_cache()
    # B1 at the variants' shapes: 257 keys (one valid key in the third
    # 128-key tile) and 4 keys (far below one tile: TMA's zero rows and the
    # Pallas wrapper's 124 padded keys) at the 14B's 40 heads
    err_var = {}
    for label, ((B, Lq, Lk), Nh) in b1_var.items():
        q, k, v = qkv(B, Lq, Lk, Nh, D)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err_var[label] = compare(f"B1 {label} {(B, Lq, Lk, Nh, D)} bfloat16",
                                 out, fa.flash_attention_reference(q, k, v))
        note("flash_attention_fwd", err_var[label])
        del q, k, v, out
        torch.cuda.empty_cache()
    # B1 at the families' shapes: CogVideoX-5B's head dim 64 at 17,776
    # tokens (138 whole 128-key tiles and 112 keys: the ragged edge in the
    # kernel), Flux-dev's and QwenImage's 24 heads of 128, and QwenImage's
    # joint key mask with row 0's text padded past 3/4 of its tokens
    err_fam = {}

    def fam_mask_text(lengths, Bm, Lk, Lt_f):
        """The joint mask [text | image] of a text mask: row i's text keys
        past its length masked, every image key kept."""
        if lengths is None:
            return None
        keys = torch.arange(Lk, device=dev)[None]
        txt_len = torch.tensor([n - (Lk - Lt_f) for n in lengths],
                               device=dev)[:, None]
        return (keys >= Lt_f) | (keys < txt_len)

    for label, ((Bf, Lf, Nf, Df), lengths) in b1_fam.items():
        q, k, v = qkv(Bf, Lf, Lf, Nf, Df)
        mask = fam_mask_text(lengths, Bf, Lf, QWEN_TEXT)
        out = fa.flash_attention(q, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        err_fam[label] = compare(
            f"B1 {label} {(Bf, Lf, Lf, Nf, Df)} bfloat16"
            + (f", row keys {lengths}" if lengths else ""), out,
            fa.flash_attention_reference(q, k, v, kv_mask=mask))
        note("flash_attention_fwd", err_fam[label])
        del q, k, v, out, mask
        torch.cuda.empty_cache()
    # B1, B2 and B3 at the head-local shapes of tensor parallelism (phase
    # 29): the 14B edit's 20 of 40 heads at tp 2 (B1), the 1.3B's 6 of 12
    # in the TP x FSDP step (B2, B3), its 3 at tp 4 (all three; phases 2-3
    # only), the image families' 12 of 24 and CogVideoX-5B's 24 of 48 heads
    # of 64 (B1)
    b1_only = ("flash_attention_fwd",)
    tp_shapes = {
        "tp 14B self": ((1, L, L), N14 // 2, D, b1_only),
        "tp 14B cross": ((1, L, Lt), N14 // 2, D, b1_only),
        "tp 1.3B self": ((1, L, L), N // 2, D, tuple(names)),
        "tp 1.3B cross": ((1, L, Lt), N // 2, D, tuple(names)),
        "tp4 1.3B self": ((1, L, L), N // 4, D, tuple(names))}
    for name in ("flux", "qwenimage", "cogvideox"):
        Bf, Lf, Nf, Df = fam[name]
        tp_shapes[f"tp {name} joint"] = ((Bf, Lf, Lf), Nf // 2, Df, b1_only)
    err_tp = {}
    for label, ((B, Lq, Lk), Nh, Dh, kernels) in tp_shapes.items():
        q, k, v = qkv(B, Lq, Lk, Nh, Dh)
        tag = f"{label} {(B, Lq, Lk, Nh, Dh)} bfloat16"

        def check_tp():
            if kernels == b1_only:
                out = fa.flash_attention(q, k, v)
                torch.cuda.synchronize()
                note("flash_attention_fwd", compare(
                    f"B1 {tag}", out, fa.flash_attention_reference(q, k, v)))
            else:
                qs, ref, ref_lse = check_forward(tag, q, k, v, None)
                check_backward(tag, qs, k, v, ref, ref_lse)

        err_tp[label] = shape_errs(check_tp, keys=names)
        del q, k, v
        torch.cuda.empty_cache()
    # B3 at lengths on and beside its 64-row q tiles and 128-key tiles (TMA's
    # zero rows, the masked keys of the ragged key tile, dQ rows past Lq
    # dropped by the reduce-add, lse and delta rows padded to 16 bytes)
    edges_bwd = [(Lq, Lk, Dh, dtype) for Lq in (1, 63, 65, 129)
                 for Lk in (1, 127, 129, 512)
                 for Dh, dtype in ((D, bf16), (64, torch.float16))]
    for Lq, Lk, Dh, dtype in edges_bwd:
        q, k, v = qkv(2, Lq, Lk, 3, Dh, dtype=dtype)
        qs = q * fa._rounded(Dh ** -0.5, dtype)
        check_backward(f"tile edge Lq={Lq} Lk={Lk} D={Dh} {str(dtype)[6:]}",
                       qs, k, v, *fa.flash_fwd_lse_reference(qs, k, v),
                       quiet=True)
    log(f"[kernel vs plain] B3 at {len(edges_bwd)} tile-edge lengths (Lq "
        f"1/63/65/129 x Lk 1/127/129/512, D {D} bf16 and D 64 fp16): ok "
        f"against both plain versions")
    log("[C1] B3's relative L2 against the fp32 plain backward (JAX's "
        "arithmetic): " + json.dumps(c1))
    torch.cuda.empty_cache()

    # B4: the pre-pass against its plain version on `k_mean`, the
    # attention kernel against its plain version on the same quantized K,
    # and the two together against B4's plain version and against
    # unquantized attention; batch 2 at the path's shapes (batched CFG)
    cases8 = [
        ("self-attention, CFG batch, 2 of 12 heads", (2, L, L, 2, D), None,
         bf16),
        ("cross-attention, CFG batch", (2, L, Lt, N, D), None, bf16),
        ("ragged L=3000", (1, 3000, 3000, 4, D), None, bf16),
        ("key mask, fully masked batch row", (2, 1000, 777, 3, D), "mask",
         bf16),
        ("head_dim 256", (1, 3000, 3000, 2, 256), None, bf16),
        ("fp16", (1, 1000, 700, 2, D), None, torch.float16),
    ]
    def check_prepass(label, k, quiet=False):
        """The pre-pass twice: its mean against `k_mean` (MEAN_ULPS), and
        the same bits (int8 K, scales, mean) from both launches; returns
        (ki, sk). ``quiet`` logs only a failure."""
        ki, sk, mean = i8.int8_quantize_k(k)
        ki2, sk2, mean2 = i8.int8_quantize_k(k)
        torch.cuda.synchronize()
        want = i8.k_mean(k)
        tol = MEAN_ULPS * 2.0 ** -24 * k.float().abs().mean(dim=1)
        over = ((mean - want).abs() / tol).max().item()
        same = (torch.equal(ki, ki2) and torch.equal(sk, sk2)
                and torch.equal(mean, mean2))
        ok = over <= 1.0 and same
        if not (quiet and ok):
            log(f"[kernel vs plain] B4 pre-pass {label}: K mean max abs err "
                f"{(mean - want).abs().max().item():.3e}, {over:.3e} of its "
                f"tolerance ({MEAN_ULPS} x 2^-24 x mean |k|); two launches "
                f"bit for bit: {same}: {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"B4's pre-pass mean strays or is not deterministic: "
                 f"{label}")
        return ki, sk

    def check_quantization(label, k, quiet=False):
        """``check_prepass``, then its int8 K and scales against the plain
        version on `k_mean` (at most one level off, in at most
        QUANT_FLIP_TOL of the values; scales within 1e-6); returns (ki,
        sk). ``quiet`` logs only a failure."""
        ki, sk = check_prepass(label, k, quiet)
        ki_ref, sk_ref = i8.quantize_k_reference(k, i8.k_mean(k))
        levels = (ki.int() - ki_ref.int()).abs()
        flips = (levels > 0).float().mean().item()
        sk_err = ((sk - sk_ref).abs() / sk_ref).max().item()
        deq = ki.float() * sk[..., None]
        deq_ref = ki_ref.float() * sk_ref[..., None]
        deq_err = (deq - deq_ref).abs().max().item()
        deq_rel = ((deq - deq_ref).norm() / deq_ref.norm()).item()
        ok = (levels.max().item() <= 1 and flips <= QUANT_FLIP_TOL
              and sk_err <= 1e-6)
        if not (quiet and ok):
            log(f"[kernel vs plain] B4 pre-pass {label}: int8 values off by "
                f"<= {levels.max().item()} level in a share {flips:.3e} (tol "
                f"1 level, {QUANT_FLIP_TOL}), row scales max relative err "
                f"{sk_err:.3e} (tol 1e-6), dequantized K max abs err "
                f"{deq_err:.3e}: {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"B4's quantization pre-pass disagrees: {label}")
        note("int8_quantize_k", (deq_err, deq_rel))
        return ki, sk

    def check_int8(label, q, k, v, mask, quiet=False):
        """B4's pre-pass, its attention kernel and the whole of it against
        their plain versions, and the whole against unquantized attention
        (cosine); ``quiet`` logs only a failure."""
        B = q.shape[0]
        ki, sk = check_quantization(label, k, quiet)
        out = i8.int8_attention_fwd(q, ki, sk, v, kv_mask=mask)
        torch.cuda.synchronize()
        ref = i8.int8_attention_reference(q, ki, sk, v, kv_mask=mask)
        note("int8_attention_fwd",
             compare(f"B4 attention {label}", out, ref, quiet=quiet))
        del out, ref, ki, sk
        out = i8.int8_flash_attention(q, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        ref = i8.int8_flash_attention_reference(q, k, v, kv_mask=mask)
        note("int8_flash_attention",
             compare(f"B4 whole {label}", out, ref, quiet=quiet))
        # a fully masked row averages V over each wrapper's own padded
        # length (B1's key block is 1024, B4's 512): left out here
        rows = slice(0, B - 1) if mask is not None else slice(None)
        exact = fa.flash_attention_reference(q, k, v, kv_mask=mask)[rows]
        got, exact = out[rows].float(), exact.float()
        diff = got - exact
        rel = (diff.norm() / exact.norm()).item()
        cos = (got * exact).sum().item() / (got.norm() * exact.norm()).item()
        if not (quiet and cos > COS_TOL):
            log(f"[int8 vs unquantized] B4 {label}: relative L2 err "
                f"{rel:.3e}, cosine similarity {cos:.6f} (tol > {COS_TOL}): "
                f"{'ok' if cos > COS_TOL else 'FAIL'}")
        if not cos > COS_TOL:
            fail(f"B4 strays from unquantized attention: {label}")

    for name, shape, masked, dtype in cases8:
        B, Lq, Lk, Nh, Dh = shape
        q, k, v = qkv(*shape, dtype=dtype)
        mask = None
        if masked:
            mask = torch.rand(B, Lk, generator=gen, device=dev) > 0.3
            mask[-1] = False
        check_int8(f"{name} {shape} {str(dtype)[6:]}", q, k, v, mask)
        del q, k, v, mask
    # B4 at lengths on and beside its 128-row q tiles and its K/V tiles (128
    # keys at D = 128, 64 at D = 256); one line unless one fails
    edges8 = [(Lq, Lk, Dh, dtype) for Lq in (1, 127, 129)
              for Lk in (1, 127, 129, 512)
              for Dh, dtype in ((D, bf16), (256, torch.float16))]
    for Lq, Lk, Dh, dtype in edges8:
        check_int8(f"tile edge Lq={Lq} Lk={Lk} D={Dh} {str(dtype)[6:]}",
                   *qkv(2, Lq, Lk, 3, Dh, dtype=dtype), None, quiet=True)
    log(f"[kernel vs plain] B4 at {len(edges8)} tile-edge lengths (Lq "
        f"1/127/129 x Lk 1/127/129/512, D {D} bf16 and D 256 fp16): ok")
    # the pre-pass's own edges (PREPASS_LENGTHS): its gates and the
    # quantization's, on one line unless one fails
    edges_pre = [(Lk, Dh, dtype) for Lk in PREPASS_LENGTHS
                 for Dh, dtype in ((D, bf16), (256, torch.float16))]
    for Lk, Dh, dtype in edges_pre:
        k = randn(*((1, Lk, 1) if Lk > 30000 else (2, Lk, 3)), Dh,
                  dtype=dtype)
        check_quantization(f"slab edge Lk={Lk} D={Dh} {str(dtype)[6:]}", k,
                           quiet=True)
        del k
    log(f"[kernel vs plain] B4 pre-pass at {len(edges_pre)} slab-edge "
        f"lengths (Lk {'/'.join(map(str, PREPASS_LENGTHS))}, D {D} bf16 and "
        f"D 256 fp16): ok (mean, bit for bit, int8 levels, scales)")
    torch.cuda.empty_cache()

    # the kernels inside a full-width DiT (2 blocks) on a small latent: the
    # forward, and the gradient of LoRA adapters (non-zero up, so every
    # adapter gets one) against the naive backend
    small = dcfg.replace(num_layers=2)
    dit_small = init_wan_dit(small, gen, bf16, dev)
    x = torch.randn(1, small.in_dim, 5, 30, 52, generator=gen, device=dev)
    ctx = randn(1, Lt, small.text_dim)
    cos, sin = (torch.as_tensor(a, device=dev) for a in make_rope_for_geometry(
        small, (5, 15, 26), f_src=2, f_ground=1))
    t = torch.full((1,), 937.0, device=dev)
    with torch.no_grad():
        v_flash = dit_small(x.to(bf16), t, ctx, cos, sin, attn_backend="flash")
        v_naive = dit_small(x.to(bf16), t, ctx, cos, sin, attn_backend="naive")
    rel = ((v_flash - v_naive).norm() / v_naive.norm()).item()
    log(f"[kernel vs plain] 2-block 1.3B-width DiT, 1950 tokens, flash vs "
        f"naive: relative L2 error {rel:.3e} (tol {DIT_REL_TOL})")
    if not (torch.isfinite(v_flash).all() and rel <= DIT_REL_TOL):
        fail("DiT through the kernels disagrees with the naive backend")
    before = launch_counts()
    with torch.no_grad():
        v_int8 = dit_small(x.to(bf16), t, ctx, cos, sin, attn_backend="int8")
    after = launch_counts()
    ran = {n: after[n] - before[n] for n in after}
    rel = ((v_int8 - v_naive).norm() / v_naive.norm()).item()
    log(f"[kernel vs plain] 2-block 1.3B-width DiT, 1950 tokens, int8 (B4) "
        f"vs naive: relative L2 error {rel:.3e} (tol {DIT_INT8_REL_TOL}); "
        f"launches {ran}")
    if not (torch.isfinite(v_int8).all() and rel <= DIT_INT8_REL_TOL):
        fail("DiT through B4 disagrees with the naive backend")
    if ran != dict(dict.fromkeys(names, 0), int8_quantize_k=4,
                   int8_attention_fwd=4):
        fail(f"DiT through B4 launched {ran}")
    # the same forward naming no backend, routed to B4 by the variable
    before = launch_counts()
    os.environ["VIDEOCOF_ATTENTION_TYPE"] = "int8"
    try:
        with torch.no_grad():
            v_env = dit_small(x.to(bf16), t, ctx, cos, sin)
    finally:
        del os.environ["VIDEOCOF_ATTENTION_TYPE"]
    after = launch_counts()
    ran = {n: after[n] - before[n] for n in after}
    log(f"[kernel vs plain] the same forward with no backend under "
        f"VIDEOCOF_ATTENTION_TYPE=int8: launches {ran}; equal to the int8 "
        f"forward bit for bit: {torch.equal(v_env, v_int8)}")
    if ran != dict(dict.fromkeys(names, 0), int8_quantize_k=4,
                   int8_attention_fwd=4):
        fail(f"VIDEOCOF_ATTENTION_TYPE=int8 did not route the DiT to B4: "
             f"{ran}")
    if ((v_env.float() - v_int8.float()).norm() / v_int8.float().norm()
            ).item() > 1e-3:
        fail("the DiT routed to B4 by VIDEOCOF_ATTENTION_TYPE disagrees with "
             "its int8 forward")
    del v_env
    try:
        leaf = torch.zeros(1, 64, 2, 128, dtype=bf16, device=dev,
                           requires_grad=True)
        i8.int8_flash_attention(leaf, leaf, leaf)
    except NotImplementedError as exc:
        log(f"[int8] under autograd: raises NotImplementedError ({exc})")
    else:
        fail("B4 under autograd did not raise")
    del v_int8
    dit_small.requires_grad_(False)
    adapters = init_lora_adapters(small, gen, rank=16)
    with torch.no_grad():
        for p in adapters.parameters():
            if p.abs().max() == 0:
                p.copy_(1e-2 * torch.randn(p.shape, generator=gen, device=dev))
    noise = torch.randn(x.shape, generator=gen, device=dev)
    frame_mask = torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0], device=dev)
    grads = {}
    for backend in ("flash", "naive"):
        adapters.zero_grad(set_to_none=True)
        before = fa.launch_counts()
        loss = flow_matching_loss(
            dit_small, x, ctx, cos, sin, torch.tensor([700], device=dev),
            noise, attn_backend=backend, remat=True, frame_mask=frame_mask,
            lora=(adapters, adapters.scale))
        loss.backward()
        after = fa.launch_counts()
        grads[backend] = torch.cat([p.grad.flatten()
                                    for p in adapters.parameters()])
        if backend == "flash" and [after[n] - before[n] for n in names] != [
                0, 8, 4]:
            fail(f"DiT gradient through the kernels launched "
                 f"{ {n: after[n] - before[n] for n in names} }")
    rel = ((grads["flash"] - grads["naive"]).norm()
           / grads["naive"].norm()).item()
    log(f"[kernel vs plain] 2-block 1.3B-width DiT, LoRA adapter gradient "
        f"(remat, frame mask), flash vs naive: relative L2 error {rel:.3e} "
        f"(tol {DIT_REL_TOL})")
    if not (torch.isfinite(grads["flash"]).all() and rel <= DIT_REL_TOL):
        fail("LoRA gradient through the kernels disagrees with the naive "
             "backend")
    del dit_small, v_flash, v_naive, adapters, grads, loss
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 3. timing
    log(f"[smoke] phase 3 starts at {time.perf_counter() - t_start:.1f} s")
    F = torch.nn.functional

    def time_flash(Nh, kernels, plain_runs_self, shapes=None,
                   plain_warmup=1):
        """``kernels`` (of B1, B2, B3) at ``Nh`` heads at the self and
        cross shapes, or at ``shapes`` ((label, (B, Lq, Lk), plain runs,
        heads), ...): kernel, plain version (after ``plain_warmup``
        runs), library call, bound."""
        timing = {}
        if shapes is None:
            shapes = (("self", (1, L, L), plain_runs_self, Nh),
                      ("cross", (1, L, Lt), 10, Nh))
        for shape_name, (B, Lq, Lk), plain_runs, Nh, *head_dim in shapes:
            Dh = head_dim[0] if head_dim else D
            q, k, v = qkv(B, Lq, Lk, Nh, Dh)
            qs = q * fa._rounded(Dh ** -0.5, bf16)
            do = randn(B, Lq, Nh, Dh)
            out, lse = fa.flash_fwd_lse(qs, k, v)
            delta = fa.flash_bwd_delta(out, do)
            runs = {
                "flash_attention_fwd": (
                    lambda: fa.flash_attention(q, k, v),
                    lambda: fa.flash_attention_reference(q, k, v)),
                "flash_attention_fwd_lse": (
                    lambda: fa.flash_fwd_lse(qs, k, v),
                    lambda: fa.flash_fwd_lse_reference(qs, k, v)),
                # the wrapper: the dQ accumulator's zeroing, the kernel,
                # the cast
                "flash_attention_bwd": (
                    lambda: fa.flash_bwd(qs, k, v, do, lse, delta),
                    lambda: (fa.flash_bwd_dq_reference(
                        qs, k, v, do, lse, delta, rounded=True),
                        fa.flash_bwd_dkv_reference(
                            qs, k, v, do, lse, delta, rounded=True))),
            }
            # yardsticks: SDPA's forward without and with a gradient to
            # carry (then it keeps its LSE), and SDPA's backward alone
            qt, kt, vt, dot = (a.transpose(1, 2) for a in (q, k, v, do))
            lq, lk, lv = (a.detach().requires_grad_() for a in (qt, kt, vt))
            with torch.enable_grad():
                sdpa_out = F.scaled_dot_product_attention(lq, lk, lv)

            def sdpa_fwd_grad():
                with torch.enable_grad():
                    F.scaled_dot_product_attention(lq, lk, lv)

            library = {
                "flash_attention_fwd":
                    lambda: F.scaled_dot_product_attention(qt, kt, vt),
                "flash_attention_fwd_lse": sdpa_fwd_grad,
                "flash_attention_bwd": lambda: torch.autograd.grad(
                    sdpa_out, (lq, lk, lv), dot, retain_graph=True),
            }
            work = kernel_work(B, Lq, Lk, Nh, Dh)
            shape = f"B={B} Lq={Lq} Lk={Lk} N={Nh} D={Dh} bf16"
            timing[shape_name] = {}
            for kname in kernels:
                kernel_fn, plain_fn = runs[kname]
                ms = cuda_ms(kernel_fn, runs=10)
                plain_ms = cuda_ms(plain_fn, runs=plain_runs,
                                   warmup=plain_warmup)
                library_ms = cuda_ms(library[kname], runs=10)
                bound_ms, bound_by = bound(*work[kname])
                tflops = work[kname][0] / ms / 1e9
                timing[shape_name][kname] = dict(
                    shape=shape, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms, tflops=tflops)
                log(f"[timing] {kname} {shape_name} {shape}: kernel_ms "
                    f"{ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) "
                    f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                    f"(share of bound {bound_ms / ms:.1%}; {tflops:.1f} "
                    f"TFLOP/s, library "
                    f"{work[kname][0] / library_ms / 1e9:.1f})")
            del q, k, v, qs, do, out, lse, delta, qt, kt, vt, dot
            del lq, lk, lv, sdpa_out, runs, library
            torch.cuda.empty_cache()
        return timing

    timing = time_flash(N, names, 1)
    # B2 and B3 at the 14B's 40 heads (its LoRA training step, phase 20)
    timing14_train = time_flash(N14, names[1:], 1, plain_warmup=0)
    # B1, B2 and B3 at the parallel paths' shapes (phase 21)
    timing_sp = time_flash(N, names, 1, shapes=[
        (label, shape, 1, Nh) for label, (shape, Nh, backward)
        in sp_shapes.items() if backward])
    timing_sp.update(time_flash(N, ["flash_attention_fwd_lse"], 1, shapes=[
        ("ring 4x", sp_shapes["ring 4x"][0], 1, N)], plain_warmup=0))

    # B1, B2 and B3 at tensor parallelism's head-local shapes (phase 29)
    timing_tp = {}
    for label, ((B, Lq, Lk), Nh, Dh, kernels) in tp_shapes.items():
        timing_tp.update(time_flash(Nh, list(kernels), 1, shapes=[
            (label, (B, Lq, Lk), 1, Nh, Dh)], plain_warmup=0))
        for kname in kernels:
            timing_tp[label][kname].update(
                max_abs_err=err_tp[label][kname][0],
                max_rel_l2_err=err_tp[label][kname][1])

    # B1 at the 14B's 40 heads: kernel, plain version, SDPA and the bound
    timing14 = {}
    for shape_name, (B, Lq, Lk), plain_runs in (("self", (1, L, L), 1),
                                                ("cross", (1, L, Lt), 10)):
        q, k, v = qkv(B, Lq, Lk, N14, D)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        work = kernel_work(B, Lq, Lk, N14, D)["flash_attention_fwd"]
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), runs=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v),
                           runs=plain_runs, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt), runs=10)
        bound_ms, bound_by = bound(*work)
        shape = f"B={B} Lq={Lq} Lk={Lk} N={N14} D={D} bf16"
        timing14[shape_name] = dict(
            shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms,
            tflops=work[0] / ms / 1e9,
            max_abs_err=err14[shape_name][0],
            max_rel_l2_err=err14[shape_name][1])
        log(f"[timing] flash_attention_fwd {shape_name} at the 14B's heads "
            f"{shape}: kernel_ms {ms:.4f} bound_ms {bound_ms:.4f} "
            f"({bound_by}) plain_ms {plain_ms:.4f} library_ms "
            f"{library_ms:.4f} (share of bound {bound_ms / ms:.1%}; "
            f"{work[0] / ms / 1e9:.1f} TFLOP/s, library "
            f"{work[0] / library_ms / 1e9:.1f})")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # B1 at the 4x edit's and the ragged batch's shapes; the ragged shape's
    # bound twice: the work the kernel does (both rows at full length) and
    # the work the rows need (each at its own length: what packing would
    # do); SDPA's memory-efficient backend takes the key mask
    from torch.nn.attention import SDPBackend, sdpa_kernel
    timing_new = {}
    for label, ((B, Lq, Lk), lengths) in new_b1.items():
        q, k, v = qkv(B, Lq, Lk, N, D)
        mask = ragged_mask(lengths, Lk)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kv_mask=mask),
                     runs=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, kv_mask=mask), runs=1 if Lk > 1000 else 5, warmup=0)
        if mask is None:
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt), runs=10)
        else:
            bias = mask[:, None, None, :]
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias), runs=10)
        flops, nbytes = kernel_work(B, Lq, Lk, N, D)["flash_attention_fwd"]
        mask_bytes = 0 if mask is None else mask.numel()
        row = dict(shape=f"B={B} Lq={Lq} Lk={Lk} N={N} D={D} bf16"
                   + (f" row keys {list(lengths)}" if lengths else ""),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   max_abs_err=err_new[label][0],
                   max_rel_l2_err=err_new[label][1])
        padded_ms, _ = bound(flops, nbytes + mask_bytes)
        if lengths:   # the rows' own work is what this data needs
            works = [kernel_work(1, n, n, N, D)["flash_attention_fwd"]
                     for n in lengths]
            flops = sum(w[0] for w in works)
            nbytes = sum(w[1] for w in works)
            row["bound_ms_padded"] = padded_ms
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes + mask_bytes)
        timing_new[label] = row
        log(f"[timing] flash_attention_fwd {label} {row['shape']}: kernel_ms "
            f"{ms:.4f} bound_ms {row['bound_ms']:.4f} ({row['bound_by']})"
            + (f", bound of the padded work {padded_ms:.4f}" if lengths
               else "")
            + f" plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} (share "
            f"of bound {row['bound_ms'] / ms:.1%}; {flops / ms / 1e9:.1f} "
            f"TFLOP/s of the rows' work, library "
            f"{flops / library_ms / 1e9:.1f})")
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()

    # B1 at the Wan2.2 paths' shapes: kernel, plain version, SDPA, bound
    timing22 = {}
    for label, ((B, Lq, Lk), Nh) in {**b1_22, **b1_var}.items():
        q, k, v = qkv(B, Lq, Lk, Nh, D)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        work = kernel_work(B, Lq, Lk, Nh, D)["flash_attention_fwd"]
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), runs=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v),
                           runs=1 if Lk > 1000 else 5,
                           warmup=0 if Lk > 1000 else 1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt), runs=10)
        bound_ms, bound_by = bound(*work)
        timing22[label] = dict(
            shape=f"B={B} Lq={Lq} Lk={Lk} N={Nh} D={D} bf16", ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, tflops=work[0] / ms / 1e9,
            max_abs_err={**err22, **err_var}[label][0],
            max_rel_l2_err={**err22, **err_var}[label][1])
        log(f"[timing] flash_attention_fwd {label} "
            f"{timing22[label]['shape']}: kernel_ms {ms:.4f} bound_ms "
            f"{bound_ms:.4f} ({bound_by}) plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} (share of bound {bound_ms / ms:.1%}"
            f"; {work[0] / ms / 1e9:.1f} TFLOP/s, library "
            f"{work[0] / library_ms / 1e9:.1f})")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # B1 at the families' shapes: kernel, plain version, SDPA (its
    # memory-efficient backend under the key mask), bound
    timing_fam = {}
    for label, ((Bf, Lf, Nf, Df), lengths) in b1_fam.items():
        q, k, v = qkv(Bf, Lf, Lf, Nf, Df)
        mask = fam_mask_text(lengths, Bf, Lf, QWEN_TEXT)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kv_mask=mask),
                     runs=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, kv_mask=mask), runs=1, warmup=0)
        if mask is None:
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt), runs=10)
        else:
            bias = mask[:, None, None, :]
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias), runs=10)
        flops, nbytes = kernel_work(Bf, Lf, Lf, Nf, Df)["flash_attention_fwd"]
        bound_ms, bound_by = bound(flops, nbytes + (
            0 if mask is None else mask.numel()))
        timing_fam[label] = dict(
            shape=f"B={Bf} Lq={Lf} Lk={Lf} N={Nf} D={Df} bf16"
            + (f" row keys {list(lengths)}" if lengths else ""), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, tflops=flops / ms / 1e9,
            max_abs_err=err_fam[label][0],
            max_rel_l2_err=err_fam[label][1])
        log(f"[timing] flash_attention_fwd {label} "
            f"{timing_fam[label]['shape']}: kernel_ms {ms:.4f} bound_ms "
            f"{bound_ms:.4f} ({bound_by}) plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} (share of bound {bound_ms / ms:.1%}"
            f"; {flops / ms / 1e9:.1f} TFLOP/s, library "
            f"{flops / library_ms / 1e9:.1f})")
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()

    # B4 at the standard edit's shapes (batched CFG: batch 2): the whole of
    # it (pre-pass and attention) and each kernel; the yardstick is SDPA's
    # unquantized bf16 forward, which is not the same function (no PyTorch
    # call computes int8 attention); B1 at the same shapes says whether the
    # int8 QK^T pays. Beside the pre-pass: `k_mean` alone, the torch
    # reduction over K that preceded it until the mean moved into it, and
    # one B4 call under torch.profiler, which must show the two kernels and
    # nothing else (their device times recorded)
    timing8 = {}
    for shape_name, (B, Lq, Lk), plain_runs in (("self", (2, L, L), 1),
                                                ("cross", (2, L, Lt), 10)):
        q, k, v = qkv(B, Lq, Lk, N, D)
        # the pre-pass's gates (phase 2's) at the main path's shape: every
        # head, as many slabs and rounds as the standard edit's launches
        ki, sk = check_quantization(
            f"{shape_name} at the main path's shape {tuple(k.shape)}", k)
        runs = {
            "int8_flash_attention": (
                lambda: i8.int8_flash_attention(q, k, v),
                lambda: i8.int8_flash_attention_reference(q, k, v)),
            "int8_quantize_k": (lambda: i8.int8_quantize_k(k),
                                lambda: i8.quantize_k_reference(
                                    k, i8.k_mean(k))),
            "int8_attention_fwd": (
                lambda: i8.int8_attention_fwd(q, ki, sk, v),
                lambda: i8.int8_attention_reference(q, ki, sk, v)),
        }
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                          runs=10)
        b1_ms = cuda_ms(lambda: fa.flash_attention(q, k, v), runs=10)
        ops = 4 * B * N * Lq * Lk * D    # int8 QK^T and bf16 PV together
        bounds = int8_bounds(B, Lq, Lk, N, D)
        shape = f"B={B} Lq={Lq} Lk={Lk} N={N} D={D} bf16"
        timing8[shape_name] = {}
        for kname, (kernel_fn, plain_fn) in runs.items():
            ms = cuda_ms(kernel_fn, runs=10)
            plain_ms = cuda_ms(plain_fn, runs=plain_runs, warmup=1)
            bound_ms, bound_by = bounds[kname]
            timing8[shape_name][kname] = dict(
                shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                sdpa_unquantized_ms=sdpa_ms, b1_ms=b1_ms)
            attention = kname != "int8_quantize_k"
            if attention:
                timing8[shape_name][kname]["tops"] = ops / ms / 1e9
            log(f"[timing] {kname} {shape_name} {shape}: kernel_ms {ms:.4f} "
                f"bound_ms {bound_ms:.4f} ({bound_by}) plain_ms "
                f"{plain_ms:.4f} (share of bound {bound_ms / ms:.1%}"
                + (f"; {ops / ms / 1e9:.1f} TOP/s, int8 and bf16 together; "
                   f"B1 (bf16) at this shape {b1_ms:.4f} ms, {b1_ms / ms:.3f}x"
                   f" this" if attention else "")
                + f"); SDPA bf16 forward, unquantized, not the same "
                f"function: {sdpa_ms:.4f} ms")
        pre = timing8[shape_name]["int8_quantize_k"]
        pre["k_mean_ms"] = cuda_ms(lambda: i8.k_mean(k), runs=10)
        pre["pair_bound_ms"] = bounds["k_mean + quantize"][0]
        def b4_call():
            # a first kernel of its own (a fill): the trace may miss the
            # first one
            torch.zeros(1, device=q.device)
            i8.int8_flash_attention(q, k, v)

        _, busy_ms, prof = profile_kernels(b4_call, tries=3)
        warm = sum(n for _, n, name in prof if "fill" in name.lower())
        seen = {name: (ms, n) for ms, n, name in prof
                if "fill" not in name.lower()}
        mine = {key: [(ms, n) for name, (ms, n) in seen.items()
                      if key in name] for key in ("k_prepass_kernel",
                                                  "int8_attn_kernel")}
        if busy_ms <= 0.0:
            fail(f"one B4 call at the {shape_name} shape under "
                 "torch.profiler recorded no device events: its kernels "
                 "cannot be shown")
        elif (len(seen) != 2 or warm > 1
              or any(len(m) != 1 or m[0][1] != 1 for m in mine.values())):
            fail(f"one B4 call at the {shape_name} shape launched "
                 f"{sorted(seen)} and {warm} fills: expected "
                 "k_prepass_kernel and int8_attn_kernel once each and "
                 "nothing else but the warm-up's fill")
        else:
            pre["device_ms"] = mine["k_prepass_kernel"][0][0]
            timing8[shape_name]["int8_attention_fwd"]["device_ms"] = mine[
                "int8_attn_kernel"][0][0]
            log(f"[timing] one B4 call at the {shape_name} shape under "
                f"torch.profiler: k_prepass_kernel {pre['device_ms']:.4f} "
                f"ms and int8_attn_kernel "
                f"{mine['int8_attn_kernel'][0][0]:.4f} ms of device time, "
                "no other kernel (no torch reduction over K)")
        log(f"[timing] k_mean alone (the parent's torch reduction over K, "
            f"no longer on the path) {shape_name}: {pre['k_mean_ms']:.4f} "
            f"ms; the parent's pair's bound (K read twice) "
            f"{pre['pair_bound_ms']:.4f} ms against the pre-pass's "
            f"{pre['bound_ms']:.4f} ms")
        del q, k, v, ki, sk, runs, qt, kt, vt
        torch.cuda.empty_cache()

    # the DiT's fused elementwise passes at the 14B's and the 1.3B's widths
    timing_dit = dit_fused_phase(((WAN21_T2V_14B.dim, N14), (dcfg.dim, N)),
                                 L)

    # ----------------------------------------------------------- 4. the edit
    log(f"[smoke] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    t5 = init_t5_encoder(T5Config(), gen, bf16, dev)
    vae = init_wan_vae(vcfg, gen, bf16, dev)
    dit = init_wan_dit(dcfg, gen, bf16, dev)
    # the edit prints its stage walls to stderr (JAX's VIDEOCOF_TIMING)
    os.environ["VIDEOCOF_TIMING"] = "1"
    try:
        pipe = WanPipeline(dit, vae, t5, dtype=bf16)
    finally:
        del os.environ["VIDEOCOF_TIMING"]
    torch.cuda.synchronize()
    log(f"[edit] random weights (seed {SEED}) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    video = np.random.default_rng(SEED).integers(
        0, 256, (1, 3, geo.source_frames, geo.height, geo.width),
        dtype=np.uint8)
    prompt = "replace the red car with a blue bicycle"
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    df.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()) as err:
        out = pipe(video, prompt, source_frames=geo.source_frames,
                   reasoning_frames=geo.reasoning_frames,
                   num_inference_steps=geo.num_inference_steps,
                   guidance_scale=geo.guidance_scale, shift=geo.shift,
                   sampler=geo.sampler, repeat_rope=geo.repeat_rope,
                   cot=geo.cot, seed=geo.seed, timings=timings)
    wall = time.perf_counter() - t0
    edit_launches = launch_counts()
    check_timing_lines(err.getvalue(), list(timings))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    out_frames = 1 + (ground - 1) * tc + geo.source_frames
    want_shape = (1, 3, out_frames, geo.height, geo.width)
    want_launches = dict.fromkeys(names + names8, 0)
    want_launches["flash_attention_fwd"] = (2 * dcfg.num_layers
                                            * geo.num_inference_steps)
    vid = out.videos
    log(f"[edit] output {vid.shape} min {vid.min():.4f} max {vid.max():.4f}")
    if vid.shape != want_shape:
        fail(f"output shape {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail("output frames not finite or outside [0, 1]")
    if edit_launches != want_launches:
        fail(f"the edit launched {edit_launches}, expected {want_launches}")
    # every block call through the DiT's fused passes
    dit_launches = check_dit_fused(
        "edit", dcfg.num_layers * geo.num_inference_steps)
    step_flops = dit_step_flops(dcfg, L, Lt)
    steps = [timings[f"step{i}"] for i in range(geo.num_inference_steps)]
    log("[edit] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    log(f"[edit] seconds per edit {wall:.3f}; peak device memory "
        f"{peak_gb:.2f} GB; launches {edit_launches}; DiT "
        f"{step_flops:.3e} FLOP/step, {step_flops / statistics.median(steps) / 1e12:.1f} "
        f"TFLOP/s (median step)")
    log("[edit] " + json.dumps({
        "card": card, "seconds_per_edit": wall, "stages_s": timings,
        "peak_memory_gb": peak_gb, "dit_flop_per_step": step_flops,
        "launches": edit_launches}))
    helpers_phase(vid, geo)
    del out, vid

    # one DiT step of the edit's geometry under torch.profiler: device time
    # by kernel, and the device's idle share of the step's wall time
    grid = (latent_frames, geo.height // sc // ph, geo.width // sc // pw)
    x = torch.randn(1, dcfg.in_dim, latent_frames, geo.height // sc,
                    geo.width // sc, generator=gen, device=dev).to(bf16)
    ctx = randn(1, Lt, dcfg.text_dim)
    cos, sin = (torch.as_tensor(arr, device=dev) for arr in
                make_rope_for_geometry(dcfg, grid, f_src=cond,
                                       f_ground=ground))
    t = torch.full((1,), 937.0, device=dev)
    with torch.no_grad():
        report_profile(f"one DiT step at {L} tokens",
                       *profile_kernels(lambda: dit(x, t, ctx, cos, sin)))
    del x, ctx, cos, sin, pipe
    torch.cuda.empty_cache()

    # ------------------------------------------------ 5. the standard edit
    log(f"[smoke] phase 5 starts at {time.perf_counter() - t_start:.1f} s")
    std = GenerationConfig(num_inference_steps=STD_STEPS, guidance_scale=5.0,
                           enable_teacache=True)
    pipe = WanPipeline(first_layers(dit, STD_LAYERS), vae, t5, dtype=bf16,
                       attn_backend="int8")
    sched = get_scheduler(std.sampler)
    sched.set_timesteps(std.num_inference_steps, shift=std.shift)
    coeffs = get_teacache_coefficients("wan2.1-t2v-1.3b")
    own_plan = plan_teacache_skips(dit, sched.timesteps, coeffs,
                                   std.teacache_threshold,
                                   std.teacache_skip_start_steps)
    plan = pinned_teacache_plan(std.num_inference_steps, TEACACHE_PIN)
    show = lambda p: "".join("s" if x else "c" for x in p)  # noqa: E731
    log(f"[standard edit] TeaCache plan these random weights give "
        f"(threshold {std.teacache_threshold}, {std.teacache_skip_start_steps}"
        f" warm-up steps): {sum(own_plan)} of {len(own_plan)} steps skipped, "
        f"{show(own_plan)}; pinned at {TEACACHE_PIN}: {sum(plan)} skipped, "
        f"{show(plan)}")
    std_timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(video, prompt, negative_prompt=std.negative_prompt,
               source_frames=std.source_frames,
               reasoning_frames=std.reasoning_frames,
               num_inference_steps=std.num_inference_steps,
               guidance_scale=std.guidance_scale, shift=std.shift,
               sampler=std.sampler, repeat_rope=std.repeat_rope, cot=std.cot,
               seed=std.seed, enable_teacache=std.enable_teacache,
               teacache_threshold=std.teacache_threshold,
               teacache_skip_start_steps=std.teacache_skip_start_steps,
               teacache_coefficients=coeffs, teacache_forced_plan=plan,
               cfg_skip_ratio=std.cfg_skip_ratio, timings=std_timings)
    std_wall = time.perf_counter() - t0
    std_launches = launch_counts()
    std_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    computed = plan.count(False)
    want_std = dict(dict.fromkeys(names, 0),
                    int8_quantize_k=2 * STD_LAYERS * computed,
                    int8_attention_fwd=2 * STD_LAYERS * computed)
    vid = out.videos
    log(f"[standard edit] output {vid.shape} min {vid.min():.4f} max "
        f"{vid.max():.4f}")
    if vid.shape != want_shape:
        fail(f"standard edit output shape {vid.shape} != {want_shape}")
    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        fail("standard edit frames not finite or outside [0, 1]")
    if std_launches != want_std:
        fail(f"the standard edit launched {std_launches}, expected "
             f"{want_std}")
    walls = [v for k, v in std_timings.items() if k.startswith("step")]
    skipped = [v for k, v in std_timings.items() if k.endswith("skipped")]
    computed_walls = [v for k, v in std_timings.items()
                      if k.startswith("step") and not k.endswith("skipped")]
    log("[standard edit] stage walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in std_timings.items()))
    log(f"[standard edit] seconds per edit {std_wall:.3f}; peak device memory "
        f"{std_peak_gb:.2f} GB; launches {std_launches}; {computed} computed "
        f"steps of {STD_LAYERS} layers, median "
        f"{statistics.median(computed_walls):.3f} s (batch 2); "
        f"{len(skipped)} skipped steps, median "
        f"{statistics.median(skipped):.3f} s; the 50 steps {sum(walls):.3f} s")
    log("[standard edit] " + json.dumps({
        "card": card, "seconds_per_edit": std_wall, "stages_s": std_timings,
        "peak_memory_gb": std_peak_gb, "launches": std_launches,
        "teacache_plan": show(plan), "teacache_plan_own": show(own_plan)}))
    del out, vid, pipe

    # one batched-CFG DiT step (batch 2) through B4 under torch.profiler
    x = torch.randn(2, dcfg.in_dim, latent_frames, geo.height // sc,
                    geo.width // sc, generator=gen, device=dev).to(bf16)
    ctx = randn(2, Lt, dcfg.text_dim)
    cos, sin = (torch.as_tensor(arr, device=dev) for arr in
                make_rope_for_geometry(dcfg, grid, f_src=cond,
                                       f_ground=ground))
    t = torch.full((2,), 937.0, device=dev)
    with torch.no_grad():
        prof5 = profile_kernels(lambda: dit(x, t, ctx, cos, sin,
                                            attn_backend="int8"))
    report_profile(f"one batched-CFG DiT step (batch 2) through B4 at {L} "
                   "tokens", *prof5)
    b4_prof = {key: sum(n for _, n, name in prof5[2] if key in name)
               for key in ("k_prepass_kernel", "int8_attn_kernel")}
    if prof5[1] <= 0.0:
        fail("the profiled int8 DiT step recorded no device events: B4's "
             "kernels cannot be shown")
    if set(b4_prof.values()) != {2 * dcfg.num_layers}:
        fail(f"the profiled int8 DiT step ran B4's kernels {b4_prof} times, "
             f"expected {2 * dcfg.num_layers} each")
    del x, ctx, cos, sin
    torch.cuda.empty_cache()

    # --------------------------------------------------------- 6. training
    log(f"[smoke] phase 6 starts at {time.perf_counter() - t_start:.1f} s")
    tcfg = TrainerConfig(lora_rank=16)
    base = {name: p.detach().clone() for name, p in dit.named_parameters()}
    trainer = CoFTrainer(dit, vae, t5, None, tcfg)
    rng = np.random.default_rng(SEED)

    def triplet():
        return {key: rng.uniform(-1, 1, (3, frames, tcfg.height, tcfg.width)
                                 ).astype(np.float32)
                for key, frames in (("pixel_src", tcfg.source_frames),
                                    ("pixel_ground", tcfg.reasoning_frames),
                                    ("pixel_tgt", tcfg.target_frames))
                } | {"text": prompt}

    # drawn ahead, as a data loader would prefetch them: the steps time the
    # trainer, not numpy
    samples = iter([triplet() for _ in range(TRAIN_STEPS + 1)])
    train_stages = []
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_walls = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        trainer.train(samples, total_steps=1, timings=train_stages)
        step_walls.append(time.perf_counter() - t0)
        if step == 0:
            moved = max(lin.up.detach().abs().max().item()
                        for block in trainer.state.adapters.blocks
                        for mod in ADAPTER_TARGETS for lin in block[mod].values())
            log(f"[train] after step 1: max |up| {moved:.3e}")
            if not moved > 0.0:
                fail("no adapter moved in the first training step")
    train_launches = launch_counts()
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    attentions = 2 * dcfg.num_layers            # self + cross per block
    want_train = {**dict.fromkeys(names8, 0), "flash_attention_fwd": 0,
                  "flash_attention_fwd_lse": 2 * attentions * TRAIN_STEPS,
                  "flash_attention_bwd": attentions * TRAIN_STEPS}
    losses = trainer.losses
    log(f"[train] losses {losses}")
    for i, (st, w) in enumerate(zip(train_stages, step_walls)):
        log(f"[train] step {i + 1}{' (warm-up)' if i == 0 else ''}: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in st.items())
            + f"; wall {w:.3f} s")
    log(f"[train] seconds per step {statistics.median(step_walls[1:]):.3f} "
        f"(median after the warm-up); peak device memory {train_peak_gb:.2f} "
        f"GB; launches {train_launches} (expected {want_train})")
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        fail(f"training losses {losses}")
    changed = [name for name, p in dit.named_parameters()
               if not torch.equal(p.detach(), base[name])]
    if changed:
        fail(f"training changed base weights: {changed[:5]}")
    if train_launches != want_train:
        fail(f"training launched {train_launches}, expected {want_train}")
    log("[train] " + json.dumps({
        "card": card, "seconds_per_step": step_walls, "stages_s": train_stages,
        "losses": losses, "peak_memory_gb": train_peak_gb,
        "launches": train_launches}))
    del base
    idle_synthetic = report_profile(
        "one LoRA training step", *profile_kernels(
            lambda: trainer.train(samples, total_steps=1)))

    # ------------------------------------------------ 7. the entry at 1.3B
    log(f"[smoke] phase 7 starts at {time.perf_counter() - t_start:.1f} s")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    read_gbps = round_trip_phase(dit)
    del trainer, dit, vae, t5, samples
    gc.collect()
    torch.cuda.empty_cache()
    counters = (launch_counts, reset_launch_counts)
    entry = entry_phase(card, dcfg, geo, gen, prompt, want_shape,
                        want_launches, counters)
    log("[entry] " + json.dumps(dict(entry, dit_read_gb_per_s=read_gbps)))

    # ------------------------------------------------------ 8. the 14B edit
    log(f"[smoke] phase 8 starts at {time.perf_counter() - t_start:.1f} s")
    launches14, latents14, lora14, dit_launches14 = edit_14b_phase(
        card, WAN21_T2V_14B, geo, gen, video, prompt, want_shape,
        want_launches, counters)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------- 9-12. the long and ragged paths
    log(f"[smoke] phase 9-12 starts at {time.perf_counter() - t_start:.1f} s")
    # on random 1.3B weights drawn by the factory from the seed
    from videocof_torch import factory
    t0 = time.perf_counter()
    with shallow_1_3b(LONG_LAYERS):
        pipe = factory.load_pipeline("", random_init=True, seed=SEED)
    torch.cuda.synchronize()
    log(f"[1.3B] factory.load_pipeline(random_init=True), its first "
        f"{LONG_LAYERS} layers: {time.perf_counter() - t0:.1f} s")
    want_long = dict(want_launches, flash_attention_fwd=(
        2 * LONG_LAYERS * geo.num_inference_steps))
    video4, rec_4x, ref4 = extrapolation_phase(card, pipe, geo, gen, prompt,
                                               counters, want_long)
    rec_ragged, latents0 = ragged_phase(
        card, pipe, geo, prompt, [video, video4[:, :, :RAGGED_FRAMES]],
        counters, want_long)
    del video4
    rec_paired = paired_phase(card, pipe, geo, video, prompt, counters,
                              want_long)
    rec_vae = vae_phase(card, pipe, video, latents0, cond)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------- 13. the standard CLI
    log(f"[smoke] phase 13 starts at {time.perf_counter() - t_start:.1f} s")
    with shallow_1_3b(STD_LAYERS):
        rec_infer = infer_phase(card, geo, prompt, counters)

    # ------------------------------- 14. fp8 and runtime LoRA on the 14B
    log(f"[smoke] phase 14 starts at {time.perf_counter() - t_start:.1f} s")
    rec_fp8 = fp8_14b_phase(card, WAN21_T2V_14B, geo, gen, video, prompt,
                            want_shape, counters, lora14, latents14)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------- 15-16. the Wan2.2 A14B, edit, t2v
    log(f"[smoke] phase 15-16 starts at {time.perf_counter() - t_start:.1f} s")
    pipe, rec_a14b = a14b_edit_phase(card, geo, gen, video, prompt,
                                     want_shape, counters)
    rec_t2v = a14b_t2v_phase(card, pipe, geo, prompt, counters)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------ 17. the TI2V-5B with the Wan2.2 VAE
    log(f"[smoke] phase 17 starts at {time.perf_counter() - t_start:.1f} s")
    rec_5b = ti2v_phase(card, geo, prompt, counters)
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------- 18. the entries on Wan2.2
    log(f"[smoke] phase 18 starts at {time.perf_counter() - t_start:.1f} s")
    rec_entry22 = wan22_entries_phase(card, geo, gen, prompt, counters)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 19. serving
    log(f"[smoke] phase 19 starts at {time.perf_counter() - t_start:.1f} s")
    t_serve = time.perf_counter()
    clip = write_clip("serving", geo)
    cfg_serve = WAN21_T2V_14B.replace(num_layers=SERVE_14B_LAYERS)
    lora_serve, _ = write_lora_files(
        cfg_serve, torch.Generator(device=dev).manual_seed(SEED + 19),
        LORA_DIR / "serve")
    rec_serve = serving_14b_phase(card, cfg_serve, geo, prompt, counters,
                                  lora_serve, clip, out_frames)
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rec_swap = swap_phase(card, dcfg, geo, gen, prompt, counters, clip,
                          out_frames)
    gc.collect()
    torch.cuda.empty_cache()
    rec_entry = serving_entry_phase(card, geo, prompt, clip, out_frames)
    rec_nccl = nccl_phase(card)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    log(f"[serving] phase 19 in {time.perf_counter() - t_serve:.1f} s")

    # --------------------------------------------- 20. training from files
    log(f"[smoke] phase 20 starts at {time.perf_counter() - t_start:.1f} s")
    t_train = time.perf_counter()
    with shallow_1_3b(TRAIN_LAYERS) as tcfg:
        rec_train, train_json, cli_launches = train_files_phase(
            card, tcfg, geo, prompt, video, want_shape, want_launches,
            counters, idle_synthetic)
    gc.collect()
    torch.cuda.empty_cache()
    rec_14b = train_14b_phase(card, WAN21_T2V_14B, geo, train_json,
                              want_launches, counters)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train files] phase 20 in {time.perf_counter() - t_train:.1f} s")

    # ------------------------------------------------------ 21. parallelism
    log(f"[smoke] phase 21 starts at {time.perf_counter() - t_start:.1f} s")
    t_par = time.perf_counter()
    probes = start_probes()           # they run beside the world-1 edits
    with shallow_1_3b(SP_LAYERS):
        rec_sp = sp_edit_phase(card, geo, video, prompt, counters,
                               lambda: finish_probes(probes))
    with shallow_1_3b(LONG_LAYERS):
        rec_ring = sp_ring_phase(card, geo, prompt, ref4, counters)
    del ref4
    with shallow_1_3b(SP_LAYERS):
        rec_sp_train = sp_train_phase(card, geo)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[parallel] phase 21 in {time.perf_counter() - t_par:.1f} s (two "
        f"ranks share the card's SMs: no multi-GPU speed)")

    # -------------------------------------- 22-25. the other Wan variants
    log(f"[smoke] phase 22-25 starts at {time.perf_counter() - t_start:.1f} s")
    t_var = time.perf_counter()
    rec_i2v = i2v_phase(card, geo, gen, prompt, counters)
    with shallow_1_3b(VARIANT_1_3B_LAYERS):
        rec_vace, rec_cam = vace_camera_phase(card, geo, gen, prompt,
                                              counters)
    rec_s2v = s2v_phase(card, geo, gen, prompt, counters)
    log(f"[variants] phases 22-25 in {time.perf_counter() - t_var:.1f} s")

    # ------------------------------------------- 26-28. the other families
    log(f"[smoke] phase 26 starts at {time.perf_counter() - t_start:.1f} s")
    t_fam = time.perf_counter()
    rec_cog = cogvideox_phase(card, gen, counters)
    log(f"[smoke] phase 27 starts at {time.perf_counter() - t_start:.1f} s")
    rec_flux = flux_phase(card, gen, counters)
    log(f"[smoke] phase 28 starts at {time.perf_counter() - t_start:.1f} s")
    rec_qwen = qwenimage_phase(card, gen, counters)
    clip = write_clip("family_serving", geo)
    rec_fam_serve = family_serving_phase(card, geo, prompt, clip, gen,
                                         counters, out_frames)
    rec_fam_sp = family_sp_phase(card, counters)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    log(f"[families] phases 26-28 in {time.perf_counter() - t_fam:.1f} s")

    # ------------------------ 29. tensor, pipeline and expert parallelism
    log(f"[smoke] phase 29 starts at {time.perf_counter() - t_start:.1f} s")
    rec_tp = tp_phase(card, geo, video, rec_sp["probe"])
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 30. report
    log(f"[smoke] phase 30 starts at {time.perf_counter() - t_start:.1f} s")
    sources = {"flash_attention_fwd": "flash_attention_fwd.cu",
               "flash_attention_fwd_lse": "flash_attention_fwd.cu",
               "flash_attention_bwd": "flash_attention_bwd.cu"}
    replaces = {"flash_attention_fwd": ("41", "_flash_kernel, need_lse=False"),
                "flash_attention_fwd_lse": ("41", "_flash_kernel, need_lse=True"
                                            " (lse_ref :96-98)"),
                "flash_attention_bwd": ("201,233",
                                        "_bwd_dq_kernel and _bwd_dkv_kernel")}
    # B2 and B3 on this slice's path: the CLI's training run (phase 20)
    launches = {n: (edit_launches if n == "flash_attention_fwd"
                    else cli_launches)[n] for n in names}
    b1_14b = {"launches_14b": launches14["flash_attention_fwd"],
              "launches_14b_on": "14B edit",
              "launches_serving_14b": [
                  r["launches"]["flash_attention_fwd"]
                  for r in rec_serve["requests"]],
              "launches_serving_14b_on": "each request of the 14B server",
              "launches_14b_fp8": rec_fp8["launches"]["flash_attention_fwd"],
              "launches_a14b_edit": rec_a14b["launches"][
                  "flash_attention_fwd"],
              "heads_40": timing14}
    rows = []
    for kname in names:
        main_shape = timing["self"][kname]
        line, tpu = replaces[kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"videocof_torch/csrc/{sources[kname]}",
            "replaces": f"videocof_tpu/ops/flash_attention.py:{line}",
            "tpu_kernel": tpu,
            "launches": launches[kname],
            "launches_on": "edit" if kname == "flash_attention_fwd"
                           else f"cli.train, {TRAIN_CLI_STEPS} steps",
            **({} if kname == "flash_attention_fwd" else {
                "launches_synthetic": train_launches[kname],
                "launches_synthetic_on": f"{TRAIN_STEPS} training steps "
                                         "(phase 6)",
                "launches_per_remat_policy": {
                    pol: r["launches"][kname]
                    for pol, r in rec_train["remat"].items()}}),
            "max_abs_err": errs[kname][0],
            "max_rel_l2_err": errs[kname][1],
            **({"rel_l2_err_vs_fp32_plain": c1}
               if kname == "flash_attention_bwd" else {}),
            "ms": main_shape["ms"], "tflops": main_shape["tflops"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": main_shape["shape"],
            "cross": timing["cross"][kname],
            **(b1_14b if kname == "flash_attention_fwd" else {}),
        })
    # B2 and B3 at the 14B's 40 heads, with the launches of its LoRA steps
    for kname in names[1:]:
        line, tpu = replaces[kname]
        main_shape = timing14_train["self"][kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"videocof_torch/csrc/{sources[kname]}",
            "replaces": f"videocof_tpu/ops/flash_attention.py:{line}",
            "tpu_kernel": tpu, "launches": rec_14b["launches"][kname],
            "launches_on": f"14B LoRA training, {TRAIN_14B_STEPS} steps",
            "max_abs_err": err14_train["self"][kname][0],
            "max_rel_l2_err": err14_train["self"][kname][1],
            **{key: main_shape[key] for key in (
                "ms", "tflops", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")},
            "cross": dict(timing14_train["cross"][kname],
                          max_abs_err=err14_train["cross"][kname][0],
                          max_rel_l2_err=err14_train["cross"][kname][1]),
        })
    # B1, B2 and B3 on the parallel paths (phase 21), with the launches
    # each rank counted: B1 on the Ulysses edit's shards (self-attention
    # over half the heads, cross-attention over half the tokens), B2 on
    # ring's shard (world 1: the whole 4x sequence), B2 and B3 in the
    # sequence-parallel training step (per rank, both shapes together)
    ul = rec_sp["ulysses"]["ranks"]
    tr = rec_sp_train["seq"]["ranks"]
    for kname, label, on, per_rank in (
            ("flash_attention_fwd", "sp self", "Ulysses edit, seq 2",
             [r["b1"][str((1, L, L, N // SP_DEGREE, False))] for r in ul]),
            ("flash_attention_fwd", "sp cross", "Ulysses edit, seq 2",
             [r["b1"][str((1, L // SP_DEGREE, Lt, N, False))] for r in ul]),
            ("flash_attention_fwd_lse", "ring 4x", "ring 4x edit, world 1",
             [rec_ring["launches"]["flash_attention_fwd_lse"]]),
            ("flash_attention_fwd_lse", "sp self",
             f"cli.train --mesh_seq 2, {SP_TRAIN_STEPS} steps",
             [r["launches"]["flash_attention_fwd_lse"] for r in tr]),
            ("flash_attention_bwd", "sp self",
             f"cli.train --mesh_seq 2, {SP_TRAIN_STEPS} steps",
             [r["launches"]["flash_attention_bwd"] for r in tr])):
        line, tpu = replaces[kname]
        t = timing_sp[label][kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"videocof_torch/csrc/{sources[kname]}",
            "replaces": f"videocof_tpu/ops/flash_attention.py:{line}",
            "tpu_kernel": tpu, "launches": per_rank[0],
            "launches_per_rank": per_rank, "launches_on": on,
            "shape_label": f"parallel {label}",
            "max_abs_err": err_sp[label][kname][0],
            "max_rel_l2_err": err_sp[label][kname][1],
            **{key: t[key] for key in ("ms", "tflops", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "shape")}})
    # B4: its two kernels, with the whole of it (pre-pass and attention)
    # beside the attention kernel's row
    tpu8 = {"int8_quantize_k": "_int8_kernel's K quantization (:68-71) "
                               "and its wrapper's K mean (:130)",
            "int8_attention_fwd": "_int8_kernel"}
    line8 = {"int8_quantize_k": 68, "int8_attention_fwd": 51}
    for kname in names8:
        main_shape = timing8["self"][kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"videocof_torch/csrc/{i8.SOURCE}",
            "replaces": f"videocof_tpu/ops/int8_attention.py:{line8[kname]}",
            "tpu_kernel": tpu8[kname],
            "launches": std_launches[kname],
            "launches_on": "standard edit",
            "max_abs_err": errs[kname][0],
            "max_rel_l2_err": errs[kname][1],
            **{key: main_shape[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "sdpa_unquantized_ms", "b1_ms", "shape") + tuple(
                    key for key in ("tops", "device_ms", "k_mean_ms",
                                    "pair_bound_ms") if key in main_shape)},
            "cross": timing8["cross"][kname],
            **({"b4_whole": dict(
                timing8["self"]["int8_flash_attention"],
                max_abs_err=errs["int8_flash_attention"][0],
                max_rel_l2_err=errs["int8_flash_attention"][1],
                cross=timing8["cross"]["int8_flash_attention"])}
               if kname == "int8_attention_fwd" else {}),
        })
    # B1 at the 4x edit's and the ragged batch's shapes, with the launches
    # at each shape counted on its path (phases 9 and 10)
    for label, (on, rec) in (("4x self", ("4x edit", rec_4x)),
                             ("4x cross", ("4x edit", rec_4x)),
                             ("ragged self", ("ragged batch", rec_ragged))):
        rows.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": f"videocof_torch/csrc/{sources['flash_attention_fwd']}",
            "replaces": "videocof_tpu/ops/flash_attention.py:41",
            "tpu_kernel": replaces["flash_attention_fwd"][1],
            "launches": rec["b1_launches"][label], "launches_on": on,
            "shape_label": label,
            **timing_new[label]})
    # B1 at the Wan2.2 paths' shapes, with the launches counted on them
    # (phases 16 and 17)
    for label, (on, rec) in (("5B self", ("TI2V-5B edit", rec_5b)),
                             ("5B cross", ("TI2V-5B edit", rec_5b)),
                             ("A14B t2v self", ("A14B t2v", rec_t2v)),
                             ("A14B t2v cross", ("A14B t2v", rec_t2v))):
        rows.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": f"videocof_torch/csrc/{sources['flash_attention_fwd']}",
            "replaces": "videocof_tpu/ops/flash_attention.py:41",
            "tpu_kernel": replaces["flash_attention_fwd"][1],
            "launches": rec["b1_launches"][label], "launches_on": on,
            "shape_label": label, **timing22[label]})
    # B1 at the variants' shapes, with the launches counted on them
    # (phases 22 and 25)
    for label, (on, rec) in (("i2v self", ("i2v 14B", rec_i2v)),
                             ("i2v text cross", ("i2v 14B", rec_i2v)),
                             ("i2v image cross", ("i2v 14B", rec_i2v)),
                             ("s2v audio", ("S2V 14B", rec_s2v))):
        rows.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": f"videocof_torch/csrc/{sources['flash_attention_fwd']}",
            "replaces": "videocof_tpu/ops/flash_attention.py:41",
            "tpu_kernel": replaces["flash_attention_fwd"][1],
            "launches": rec["b1_launches"][label], "launches_on": on,
            "shape_label": label, **timing22[label]})
    # B1 at the families' shapes, with the launches counted on their paths
    # (phases 26-28; QwenImage's masked shape is held and timed in phases 2
    # and 3 only: its pipeline passes no text mask, as JAX's)
    for label, (on, launches_fam) in (
            ("cogvideox joint", ("CogVideoX-5B, 4 DDIM steps",
                                 rec_cog["b1_launches"]["cogvideox self"])),
            ("flux joint", ("Flux-dev, 4 steps, bf16 and again fp8",
                            rec_flux["b1_launches"]["flux joint"])),
            ("qwenimage joint", ("QwenImage, 4 steps, true CFG",
                                 rec_qwen["b1_launches"]["qwenimage joint"])),
            ("qwenimage joint, text mask", ("phases 2-3 only", 0))):
        rows.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": f"videocof_torch/csrc/{sources['flash_attention_fwd']}",
            "replaces": "videocof_tpu/ops/flash_attention.py:41",
            "tpu_kernel": replaces["flash_attention_fwd"][1],
            "launches": launches_fam, "launches_on": on,
            "shape_label": label, **timing_fam[label]})
    log("[families] " + json.dumps({"cogvideox": rec_cog, "flux": rec_flux,
                                    "qwenimage": rec_qwen,
                                    "serving": rec_fam_serve,
                                    "sp": rec_fam_sp}, default=str))
    log("[variants] " + json.dumps({"i2v": rec_i2v, "vace": rec_vace,
                                    "camera": rec_cam, "s2v": rec_s2v}))
    log("[wan2.2] " + json.dumps({"fp8_14b": rec_fp8, "a14b_edit": rec_a14b,
                                  "a14b_t2v": rec_t2v, "ti2v_5b": rec_5b,
                                  "entries": rec_entry22}))
    log("[serving] " + json.dumps({"server_14b": rec_serve,
                                   "swap_1.3b": rec_swap,
                                   "entry": rec_entry, "nccl": rec_nccl}))
    log("[train] " + json.dumps({"from_files_1.3b": rec_train,
                                 "lora_14b": rec_14b}, default=str))
    log("[parallel] " + json.dumps({"edits": rec_sp, "ring": rec_ring,
                                    "train": rec_sp_train}, default=str))
    # B1, B2 and B3 at tensor parallelism's head-local shapes (phase 29),
    # with the launches each rank counted: B1 on the 14B edit's and the
    # families' forwards, B2 and B3 in the TP x FSDP step (per rank, its
    # self and cross shapes together); tp 4 of the 1.3B in phases 2-3 only
    tp_launches = {
        "tp 14B self": ("TP edit, tp 2", "flash_attention_fwd", [
            r["b1"][str((1, L, L, N14 // 2, False))]
            for r in rec_tp["edit"]["ranks"]]),
        "tp 14B cross": ("TP edit, tp 2", "flash_attention_fwd", [
            r["b1"][str((1, L, Lt, N14 // 2, False))]
            for r in rec_tp["edit"]["ranks"]]),
        "tp4 1.3B self": ("phases 2-3 only", None, None)}
    for name in ("flux", "qwenimage", "cogvideox"):
        Bf, Lf, Nf, _ = fam[name]
        tp_launches[f"tp {name} joint"] = (
            f"{name} forward, tp 2", "flash_attention_fwd", [
                r["b1"][str((Bf, Lf, Lf, Nf // 2, False))]
                for r in rec_tp["families"][name]["ranks"]])
    for label in ("tp 1.3B self", "tp 1.3B cross"):
        tp_launches[label] = ("TP x FSDP step, data 2 x model 2", "step",
                              None)
    for label, (on, key, per_rank) in tp_launches.items():
        for kname, t in timing_tp[label].items():
            if key == "step":
                counts = [r["launches"][kname]
                          for r in rec_tp["train"]["ranks"]]
            else:
                counts = per_rank or [0]
            line, tpu = replaces[kname]
            rows.append({
                "name": kname, "route": "cuda",
                "source": f"videocof_torch/csrc/{sources[kname]}",
                "replaces": f"videocof_tpu/ops/flash_attention.py:{line}",
                "tpu_kernel": tpu, "launches": counts[0],
                "launches_per_rank": counts, "launches_on": on,
                "shape_label": label, **t})
    log("[tp] " + json.dumps(rec_tp, default=str))
    # the DiT's fused passes at the 14B's and the 1.3B's widths, with the
    # launches counted in the edit at that width: the 14B edit (phase 8)
    # and the 1.3B edit (phase 4)
    dit_edits = {WAN21_T2V_14B.dim: ("14B edit", dit_launches14),
                 dcfg.dim: ("edit", dit_launches)}
    for width, passes in timing_dit.items():
        on, counts = dit_edits[width]
        for pname, t in passes.items():
            if pname in ("block", "profile"):
                continue
            rows.append({
                "name": f"dit {pname}", "route": "cuda",
                "source": "videocof_torch/csrc/dit_fused.cu",
                "replaces": "none: XLA fuses videocof_tpu/models/wan_dit.py's"
                            " wan_block_apply",
                "launches": counts[pname], "launches_on": on,
                "shape_label": f"width {width}", **t})
    log(f"[smoke] phases 1-29 in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-rank"]:     # phase 21's training ranks
        sys.exit(train_rank_main(sys.argv[2], sys.argv[3]))
    sys.exit(main())
