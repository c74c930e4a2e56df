#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`diffusion_spacetime_attn_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py
    python3 chip_smoke.py --compare DIR   # DIR: another checkout (e.g. the parent
                                          # commit); times both trees in turns

Phases, each printed as one JSON object per line; any failure raises and the
script exits non-zero without its final line:

  1. device: the card's name and power limit; TF32 off for the comparisons.
  2. build:  the CUDA kernels from `diffusion_spacetime_attn_tpu_torch/csrc`,
             with nvcc's register / shared-memory / spill report and, per
             kernel function of the built library, its count of wgmma
             (HGMMA) and TMA / bulk-copy (UTMALDG, UBLKCP) instructions from
             `cuobjdump -sass`; the wgmma attention, GEGLU and spacetime
             kernels must have both (the spacetime ones UTMALDG), and ptxas
             must not report serialized wgmma (C7513) or spills (C7512).
  3. kernels: each forward kernel against its plain PyTorch version at every
             shape of the SD v1-4 serving path (flash: the level-0 and level-1
             self-attention sites that pass `flash_ok`), in bfloat16 at one
             prompt (CFG rows = 2) and at the engine's batch of 2 prompts, and
             in float32 at one prompt (tolerances in `utils/testing.py`), with
             times (CUDA events), the plain version's time, the roofline
             bound and, for attention, the time of
             `scaled_dot_product_attention` as a yardstick.  Each kernel must
             give the same bits when launched twice on the same inputs, and
             the comparison must reject planted faults (a skipped key tile,
             a 5 % wrong scale, a skipped inner tile, the flash log-sum-exp
             off by log 2 on one query tile; for the wgmma attention loop,
             one key tile replaced by the previous ring stage's tile; for
             GEGLU, one k-step of h and g served from the previous ring
             stage and the last k-step of the second product skipped; for
             spacetime, object 2's K/V served from object 1's ring stage)
             at every shape; each spacetime kernel must give the same bits
             20 times, and so must the wgmma MHA forward.  Each row names
             its kernel design; every bf16 site of every kernel must run the
             wgmma design (MHA at dh 160 too).  In bf16 each row also carries
             `device_ms`: the kernels' own time through the C entry (CUDA
             events, no wrapper work) for each design the shape can take
             (attention: the wgmma kernels and the mma_sync kernels, same
             inputs, and at MHA's dh 32 and 160 the wgmma kernel in 64-
             and in 128-query blocks, `wgmma_bq64`, `wgmma_bq128`; GEGLU
             and spacetime: wgmma, their only bf16 design); MHA rows also
             `profiled_ms`, the same designs' and SDPA's kernel durations
             from CUPTI, since CUDA events time the host on short calls;
             GEGLU rows carry `composite_ms`, the same function as PyTorch
             calls (cuBLAS products and elementwise kernels), a yardstick.
             Spacetime and MHA bounds take the largest of the FLOP, byte
             and exp floors (`floors_us`; 16 exps a clock per SM).
     kernels_bwd: each backward kernel the same way at every chain shape, in
             bf16 and float32 at 1 and 2 prompts (flash: bf16 at 1 and 2, f32
             at 1), every cotangent (dK/dV included); planted faults: one
             object's blend products zeroed, the last key tile dropped from
             dKc or dK, object 2's K/V served from object 1's ring stage in
             the spacetime dq pass, a skipped inner tile in dx and its stale ring stage
             (and, as a check of the tolerance only, computed without the
             kernel, the last k-step of [dh | dg]·W1 skipped), o zeroed on
             one query tile of the flash backward (di comes from o on the
             card), and for its wgmma passes one key tile (dq pass) or one
             query tile (dK/dV pass) replaced by the previous ring stage's
             tile.  The flash
             backward's yardstick is the backward of
             `scaled_dot_product_attention` under autograd.
     kernel_rdm: MHA and GEGLU forward the same way at the sites of the
             768² RDM UNet (`pipeline/knn2img.py`, RDM_SITES: dims 448,
             896, 1344, 1792, L = 2304, 576, 144, 36, head width 32, so
             14-56 heads) in bf16 at 1 and RDM_PROMPTS = 3 prompts and in
             float32 at 1: every bf16 MHA site and every bf16 GEGLU width
             must run the wgmma design (MHA rows time the 64- and
             128-query blocks too, and the mma_sync loop they replace);
             the MHA faults include a stale 64-key ring stage where L
             holds two, the GEGLU faults the last output column tile (the
             N tail: no RDM width is a multiple of 160) served from the
             tile before it.
  4. unet:   one full-width SD v1-4 UNet evaluation (bfloat16, 4 active
             objects, seeded weights) with the three kernel flags on and off.
     knobs:  the same UNet at the engine's batch with attn_scores_dtype
             "bfloat16" and attn_q_chunk 1024 against the defaults: equal
             bits with the four kernel flags on (the kernels take every
             self-attention site), within phase unet's limit on the plain
             path; the peak memory of the plain evaluation and of one level-0
             self-attention with and without q_chunk.
  5. slice:  the full-width pipeline in float32 (text encoder, controlled
             PLMS with 4 steps, VAE decode), kernels on vs off.
  6. chain:  the optimization's loss and its gradient in the blend weights
             (full-width SD v1-4 and the ViT-B/32 loss CLIP in float32, one
             prompt, 4 objects, PLMS-4 under remat), the four kernel flags
             (use_flash too) on vs off, within 1e-3 relative.
  7. serve:  TextToImageEngine at full SD v1-4 width (UNet, VAE, ViT-L/14 text
             tower), PLMS-50, batch 2, 4 objects per prompt: 3 requests in
             two batches, the second padded; it repeats the first request
             (prompt, seed) beside a pad row, which must give the same bytes.
             Every forward kernel must be launched 816 times per batch (16
             sites x 51 UNet evaluations), all on the wgmma design.
  8. profile: where a serving batch's time goes (host clock per part, and
             device time by kernel family under torch.profiler); no GEGLU
             slice sum may appear.
     http:   the serving front in spatial mode on phase serve's bundle: the
             layout predictor at LayoutConfig() behind
             `PromptRunner.prepare_host`, TextToImageEngine at batch 2, a
             BatchingService (max_wait_s 0.2) behind `serve` on 127.0.0.1.
             A lone request's PNG must be the bytes of
             `engine.generate_batch([p], [s])[0]` (same slot); five
             concurrent requests all 200 in fewer batches than requests; a
             burst into max_queue=1 while a batch runs at least one 503;
             request_timeout_s=0.01 a 504 behind a running batch; 404
             elsewhere.  Seconds per request, the HTTP, PNG and base64
             overhead; MHA, GEGLU and spacetime forward 416 launches per
             batch (PLMS at FRONT_STEPS = 25: phase serve runs PLMS-50),
             nothing else.
     loadtest: `serving/loadtest.run_loadtest` on the vanilla-flag engine
             (phase serve's bundle at PLMS-10, LOADTEST_STEPS, no
             control), batch 2: capacity from 2 warm batches, stages at
             0.5, 1.0 and 2.5 of it, 3 requests each, max_queue 4:
             every accepted request completes, p50 <= p95 <= p99, no
             reject at 0.5 and its p50 at least one batch,
             the JAX artifact's keys; printed on one line with the card's
             name and power limit; MHA and GEGLU 176 per batch.
     serve_cli: `scripts/serve.main(["--mode", "spacetime", "--batch",
             "2", "--soak", "2", "--steps", "10"])` in this process (full
             width, bf16 parameters, PLMS-10 (SERVE_CLI_STEPS, as phase
             optimize), 3 epochs, layout
             predictor, ViT-B/32 loss CLIP): the soak summary, finite
             non-constant images, and per batch (warmup and soak)
             opt_launches(k, 11) of the
             flash and spacetime kernels, forward and backward, GEGLU and
             MHA none.
  9. optimize: SpaceTimeEngine (the paper's temporal optimization) at the
             same width with the ViT-B/32 loss CLIP, bf16, PLMS-10
             (OPTIMIZE_STEPS: 11 UNet evaluations per chain), batch 2,
             4 objects, 3 Adam epochs (the last forward only), use_flash on as
             in the JAX package's spacetime mode: 2 requests, then the first
             again beside a pad row (same bytes).  A forward kernel at n sites
             per evaluation must be launched 2 x 26 x 2 x n + 26 x n times per
             batch (2 training epochs x 26 evaluations x 2 for the remat
             recompute, + the forward-only epoch) and a backward kernel
             2 x 26 x n: n = 16 for spacetime and GEGLU (2080 / 832), 10 for
             flash (1300 / 518: the first self-attention of each chain sees
             only x_T and gets no backward), 6 for MHA (780); losses finite;
             coef moved on active slots, 0 on padded ones; flash, MHA,
             GEGLU and spacetime launches (forward and dq pass) all on the
             wgmma design.
 10. profile_train: one training UNet evaluation (forward, recompute,
             backward) by kernel family, and the plain MHA backward that is
             left (levels 2 and mid).
     remat_policy: generation_loss and its dcoef on phase optimize's engine
             (bf16, PLMS-10, batch 2, four flags) under remat=True, "dots"
             and "dots_nb": launches chain_launches(k, 11) each, loss and
             dcoef within 1e-3 relative of True's (bit equality reported),
             seconds and peak memory per policy.
 11. samplers: DDIM and DPM-Solver++ through the kernels.  `samplers_chain`:
             phase chain's float32 on-vs-off check through a DDIM and a
             DPM-Solver++ chain of SLICE_STEPS steps (S evaluations each, not
             PLMS's S + 1); `samplers_optimize`: one bf16 SpaceTimeEngine
             batch at DPM_STEPS = 20 (bench.py's fast method point), 2
             prompts x 4 objects, 3 epochs, on phase optimize's weights: s
             per batch, peak memory, and every kernel's launches equal to
             opt_launches(k, 20) (spacetime and GEGLU 1600 / 640, flash
             1000 / 398, MHA 600).
     image_in: the image-in paths at SD v1-4 width (`phase_image_in`):
             img2img (strength 0.75: 37 of 50 DDIM evaluations) and inpaint
             (the right half generated; 50), batch 1 under CFG, the VAE
             encode of a 512² image, and the unconditional UNet (attn2 is
             self-attention) under DDIM-50 with eta 1 and under DDPM over a
             DDPM_T = 50-step train schedule (the published 1000 cut),
             batch 4.  float32, SLICE_STEPS steps: kernels on vs off on the
             same weights within 1e-4 + 1e-4·|plain| (the unconditional UNet
             with use_flash too: 20 flash, 12 MHA, 16 GEGLU launches per
             evaluation).  bfloat16 with the entry points' flags: s per
             image, finite output, launches exactly 16 MHA and 16 GEGLU per
             conditional evaluation and 32 MHA and 16 GEGLU per
             unconditional one, and `scripts/img2img.main` /
             `scripts/sample_diffusion.main` giving the library's bytes on
             the same key (a repeat at the same slot); img2img's --init is
             the committed Adam7-interlaced palette PNG and inpaint's --mask
             the committed 1-bit TIFF, which the library side reads through
             the CLI's loader.
 12. testbed: the trained testbed weights (`saved/testbed/*.msgpack`, read
             by the port's own msgpack reader: 583 arrays), float32, every
             kernel flag off, TF32 off, cuDNN deterministic.
             `testbed_parity`: the oracle's self-check must be perfect; the
             card against the port on the CPU in this process, on 2 eval
             prompts with the protocol's noise: text embeddings within
             1e-4 + 1e-4·|cpu|, vanilla PLMS-50 images within 1e-3,
             generation_loss through PLMS-10 within 1e-3 relative and its
             dcoef within 1e-2 relative in norm (the CPU's own dcoef moves
             ~3e-3 when the embeddings move by 1e-7, `cpu_floor_*`).
             `testbed_cell`: one cell of the protocol on the card (batch 0 of
             25 prompts, seed 0, PLMS-50, 3 epochs, both arms) through the
             entry point's `run_cell`: recall, relation, CLIP means and the
             seconds per arm; a vanilla recall below 0.5 fails (random or
             mis-loaded weights give gray images).
 13. layout: the layout predictor at LayoutConfig() (RoBERTa-base, 768
             wide, 12 layers, vocabulary 50,265, max_len 128; seeded random
             weights, float32, TF32 off) through `LayoutInference` with the
             relation-aware decode, on LAYOUT_CAPTIONS (the README golden
             sentence, the five prompts of tests/test_batch_runner.py, two
             captions with relations): the card against the port on the CPU
             with the same weights, every center within 1e-4 and the same
             decoded GMM components; parameters, bytes, ms per caption, and
             the golden sentence in the README's format.
     slot:   one full-width UNet evaluation whose two prompts are the same
             input (bf16 kernels on and off, f32 off): how far the two rows
             differ (a measurement; bf16 rounds a row differently per slot).
 14. runner: the dataset sweep entry point (`scripts/run_dataset.main`, in
             this process) at SD v1-4 width, seeded random weights, bf16,
             seed 1, on a temporary mscoco.txt of RUNNER_CAPTIONS (index 2
             repeats index 0, index 3 has no COCO object): vanilla and
             spatial at batch 1 and PLMS-25 (RUNNER_STEPS), spacetime
             through BatchedRunner at batch 2 with 3 epochs and PLMS-10
             (RUNNER_SPACETIME_STEPS, as phase optimize).  Per mode: the files
             final2_s1_index_{0,1,2}.png and no index 3, the manifest, a
             --resume call that makes and launches nothing, the same PNG
             bytes for the repeated (prompt, seed), and launches of exactly
             the mode's kernels (RUNNER_MODES: vanilla and spatial 416 per
             prompt; spacetime opt_launches(k, 11) per batch, MHA off);
             s per prompt and peak memory.
 15. eval:   the port's CLIP grid detector (ViT-B/32 width, seeded random
             weights) and the protocol's scoring over the spacetime images,
             the ground truth extracted from RUNNER_CAPTIONS by the front
             end: finite scores, recall and relation accuracy in [0, 1], s
             per image, weights' provenance "random"; on the first image's
             grid of crops, the card's crop scores against the port on the
             CPU within 1e-3.
 16. ingest: the published-weights path at SD v1-4 width on seeded
             synthetic files in the published key layouts
             (`utils/testing.compvis_shapes`, `openai_clip_shapes`,
             `rel2bbox_shapes`; ~7 GB in a temporary directory): a float32
             CompVis `.ckpt` (with `model_ema.*`, `position_ids` and a
             pickled object of a module that cannot be imported) and the
             same weights as a float16 `.safetensors`, each loaded by
             `load_stable_diffusion` in a child process (the two side by
             side) from a cold page cache and held parameter-exact against
             its generating arrays
             (sizes, read / convert / upload s, peak RSS, card memory; the
             reader must hand over the file's dtype: float16 stays float16
             to the card and is cast there);
             `txt2img --ckpt` on the `.safetensors`; the drill
             (`scripts/ingest_weights.main`, bf16, PLMS at DRILL_STEPS = 10,
             3 epochs, as phase optimize) on the
             `.ckpt`, an OpenAI ViT-B/32 file and a fairseq Rel2Bbox file:
             JAX's report keys, every weight "checkpoint", finite CLIP
             scores, both PNGs and exactly each mode's launches, with its
             seconds; the g++-built BPE core against the Python one.
 17. train: the LDM training path at SD v1-4 width, built with the chain's
             kernel flags (use_flash, use_fused_ff; no control), whose step
             launches the GEGLU forward and dx at the 16 transformer blocks
             and the flash forward and backward at the 10 level-0/1
             self-attention sites (TRAIN_SITES).  `train_f32`: one step in
             float32 at batch 1 from the same weights and keys, kernels on vs
             off: loss within 1e-5 relative, every gradient within 1e-3
             relative in norm, the AdamW-updated weights within 1e-5 +
             1e-5·|plain|, launches exactly TRAIN_SITES.  `train_bench`:
             `scripts/bench_train.py`'s `bench_ldm` (bf16 compute, float32
             parameters, batch 4, AdamW + EMA, no remat; one warm-up and
             TRAIN_STEPS timed steps): s per step (min, median), peak memory,
             launches per step exactly TRAIN_SITES, EMA apart from the
             weights, save -> restore equal bits, the next step after the
             restore equal to the uninterrupted one bit for bit (cuDNN
             deterministic).  `train_cli`: `train_ldm --synthetic --steps 3`
             (3 × TRAIN_SITES launches), `train_vae --synthetic --steps 2
             --disc-start 0` (KL-f8, 256², batch 4, random LPIPS, the
             discriminator and its adaptive weight), `train_testbed` with every
             stage at 20 steps (chunks of 10, 512 scenes) into a temporary
             directory, then `load_bundle` of it and one vanilla PLMS-10
             image, finite; s per step and per stage.
 18. knn2img: retrieval-augmented diffusion at the 768² RDM's width.
             `knn2img_f32`: the RDM in float32, DDIM-4, 10 neighbours,
             kernels on vs off within 1e-4 + 1e-4·|plain| (latents and
             images), exactly 16 MHA and 16 GEGLU launches per evaluation.
             `knn2img` (bf16): a 1,000,000 x 768 float32 database on the
             card (3 queries, k = 10: the CPU's indices, ms), `train_searcher
             --synthetic 256` through the ViT-L/14 vision tower, then
             `scripts/knn2img.main` with neighbours at DDIM-50, batch 3:
             three 768² PNGs equal to the library's bytes, exactly 800 MHA
             and 800 GEGLU launches, s per batch, peak memory, the decode's
             share; one batch without neighbours at 10 steps.
 19. safety: diffusers' safety checker from a synthetic ViT-L/14 state
             dict (17 + 3 concepts) on the three knn2img images, card vs
             CPU (scores within 1e-3, equal flags), one image flagged and
             black.
 20. train_layout: `bench_train --what layout` (RoBERTa-base, batch 64:
             s per step, min and median of 5), `train_layout --synthetic
             512 --epochs 2` into a temporary run dir, and
             `load_layout_predictor` of it against the in-memory params.
 21. image_io: the port's PIL-free image I/O on this machine (no PIL
             here): the C++ JPEG codec built by g++ at first use; its bytes
             for a seeded 640x480 image at quality 75, its decode and the
             bicubic resize to 512² must have the SHA-256 of PIL's
             (JPEG_SHA256, DECODE_SHA256, RESIZE_SHA256, checked against PIL
             by tests/test_torch_image_io.py); ms per encode, decode, resize.
     formats: what a JAX user has on disk, read without orbax,
             tensorstore or PIL (none is on this machine): the zstd, WebP,
             LZW, CCITT and BCn decoders built by g++ side by side (build_s, and
             each library's seconds, library_build_s; lzw_source: g++ on
             native/lzw.cpp alone, as phase image_in has loaded the LZW
             decoders already), ccitt_decode_ms per
             fax-coded fixture; the committed JAX
             `LDMTrainer.save` state (`tests/fixtures/port_formats/ldm/`,
             zstd-compressed OCDBT) restored, every array's SHA-256 equal to
             orbax's (`digests.json`); its EMA weights loaded through
             `sample_diffusion.restore_unet` (what `--ckpt-dir` calls) into
             the UNet at the fixture's config on the card and one DDIM-2
             sample, finite; each fixture image (progressive, CMYK and
             RGB-coded JPEG and the other JPEG codings, BMP, WebP lossy,
             lossless and alpha, PNG palettes, 2- and 16-bit and Adam7 PNGs,
             GIFs, TIFFs in every compression, layout and photometric the
             port reads: JPEG, CCITT, LZMA, Zstandard, ThunderScan, BigTIFF,
             fill order 2, orientation 2-8, 16-bit RGB(A), signed, 32-bit
             and float samples, palette + alpha; a subsampled lossless
             JPEG; the raster formats Pillow decodes itself: Netpbm, Targa,
             QOI, ICO, CUR, DIB, PCX, DCX, SGI, Sun raster, PSD, XBM, XPM,
             FITS; the block-compressed textures: DDS in BC1-BC7, masked
             RGB, L, LA, P and R8G8B8A8, BLP1 and BLP2, FTEX) decoded to
             Pillow's mode, shape, pixel and RGB digests; ms per decode
             (median of 5), raster_decode_ms for the 512x512 RLE Targa, QOI
             and PackBits PSD, bcn_decode_ms for 512x512 BC1, BC6H and BC7
             DDS files made from seeds (BLOCKS_512), held to their digests.
 22. train_data: training from image folders at SD v1-4 width, bf16,
             batch 2: `train_ldm --data-dir` over 8 640x480 JPEGs, all of
             them replaced by fixtures (FORMAT_SLOTS): a 16-bit PPM, the
             progressive JPEG, a DXT5 DDS and an RLE Targa named .jpg (in
             the synset tree .JPEG, so the extension-filtered loader reads
             them), the BMP, the WebP, GIF and LZW TIFF, with captions.jsonl (3
             steps), over a synset tree with
             class conditioning (2 steps) and `--conditioning superres
             --synthetic` (2 steps, BSRGAN-light rows): launches exactly
             GEGLU 16 / 16 and flash 10 / 10 per step (superres, the
             unconditional UNet: flash 20 / 20), finite losses, s per step
             and host ms per batch; `train_vae --paths-txt` at 256² (2
             steps, then one with `--lpips-ckpt` on a seeded file in
             taming's `vgg.pth` + torchvision's VGG16 layout, loaded
             parameter-exact); `train_searcher --image-dir` on the folder
             (its .jpg files, the DDS and the Targa among them, and the
             WebP: JAX's script lists no .ppm, .bmp, .gif or .tif).
 23. legacy_vg: `infer_vg_msdn` at LayoutConfig() width on the card vs
             the same model on the CPU (centers within 1e-4, the same
             files), and 3 steps of each legacy trainer (LegacyConfig(),
             batch 8) on the card: finite losses, s per step.
 24. mesh:   the data mesh over a one-rank NCCL group in this process:
             the SD v1-4 UNet training step in float32 through the GEGLU and
             flash kernels, data-parallel and then FSDP (`fully_shard`), each
             against the one-device step from the same weights and keys
             (train_f32's limits; launches exactly TRAIN_SITES per step);
             TextToImageEngine(mesh=) and Retriever(mesh=) equal to the same
             without a mesh (bytes, top-10).
     mesh2:  two processes on cuda:0 over gloo (`--mesh2-rank`; NCCL
             refuses two ranks on one card), one spawn: the float32 training step of the
             SD v1-4 UNet at one residual block per level (MESH2_RES_BLOCKS:
             SD's widths, levels and attention sites, MESH2_SITES launches),
             data-parallel at a global batch of 4 (2 rows per rank)
             against the one-process step on that batch (the loss, the
             averaged gradients, the updated weights and EMA), the same
             under FSDP over the two ranks but the gradients (state and
             allocated bytes per rank), `sharded_search` over a 1,000,000 x 768 database split
             over the ranks against `exact_search` (the same top-10), and
             TextToImageEngine(mesh=) at batch 2 (one row per rank),
             PLMS-10, float32, within one uint8 level of one process; part
             tp, the model axis: the same ranks as Mesh(data=1, model=2),
             the full-depth UNet tensor-parallel (4 heads and half of each
             GEGLU per rank), one controlled evaluation f32 with its
             gradient (loss 1e-5, gradients and dcoef 1e-3 relative in norm
             against one rank) and bf16 (phase unet's limit, GEGLU and
             spacetime on wgmma), launches per rank exactly MESH2_TP_SITES,
             the all-reduces counted, and SpaceTimeEngine over it (f32,
             PLMS-3, one training epoch) within one uint8 level of the
             engine in this process.  A rank that fails makes the script
             fail.
     trace:  `scripts/profiler.py` in vanilla and spacetime mode (SD v1-4,
             bf16, PLMS-5 (TRACE_STEPS), batch 2, one traced call) and
             `scripts/analyze_trace.py --json`: each kernel's device
             functions counted in the table equal to its wrapper's launches
             (MHA and GEGLU in vanilla mode, flash forward and backward in
             spacetime mode), device events only, the device total.
     flops:  `scripts/flops_model.py`'s five counts on the meta device (run
             in the background from the start) equal to FLOPS_SD, then
             `dpm20_b8_final_fwd` timed on the card as `--time` times it: TF/s
             and % of the H100's 989 TF/s bf16 peak with the card's name and
             power limit.
 25. the wall time, then the `kernels` summary line (times per UNet
     evaluation at the engine's
     batch; launches of the optimization run, of the DPM-Solver++ batch, of
     the dataset sweep, of phases http, loadtest and serve_cli, of phase
     image_in, of phase ingest, of phase train_bench, of phase knn2img, of
     phase train_data's train_ldm runs and of phases mesh and mesh2; each
     kernel's design and, for the attention kernels, launches by design),
     the nvidia-smi line, and the final {"ok": true, ...} line.

With `--compare DIR` the script runs only phases device, build, kernels,
kernels_bwd, profile and profile_train, and `geglu_host` and
`spacetime_host` (the host work per bf16 GEGLU and spacetime call; this
script's phases run on either tree's package), in
four fresh processes: DIR, this tree, this tree, DIR (each tree builds its
own kernels), and prints their lines tagged with turn and tree, then one
`compare` summary line per turn.

The SD v1-4, CLIP and layout weights are random (no such checkpoint is in
the repository): N(0, 0.02²) per parameter from a seed, as the JAX
package's bench does (the layout predictor: flax's initializers'
distributions); phase ingest writes them into the published checkpoint
formats and reads them back.  Phase testbed loads the committed trained
testbed weights.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

# peak rates of one H100 SXM (NVIDIA data sheet, dense): the roofline bound;
# exps: 16 a clock per SM (the SFU's ex2), 132 SMs at the 1.98 GHz boost clock
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
PEAK_EXPS = 16 * 132 * 1.98e9

# one prompt's sites per UNet evaluation: (level, Lq, inner, count)
SITES = [("level0", 4096, 320, 5), ("level1", 1024, 640, 5),
         ("level2", 256, 1280, 5), ("mid", 64, 1280, 1)]
FLASH_LEVELS = ("level0", "level1")    # the self-attention sites that pass flash_ok
HEADS, OBJECTS, CONTEXT_LEN = 8, 4, 77
SERVE_PROMPTS = 2               # the engine's batch size
LAUNCHES_PER_BATCH = 16 * 51
SLICE_STEPS = 4                 # PLMS steps of the float32 on-vs-off checks
# sites per UNet evaluation of each kernel with the four flags on: flash
# takes the self-attention of levels 0 and 1, MHA that of level 2 and mid
SITES_PER_EVAL = {"spacetime_fwd": 16, "spacetime_bwd": 16, "geglu_fwd": 16, "geglu_bwd": 16,
                  "flash_fwd": 10, "flash_bwd": 10, "mha_fwd": 6}
# the RDM UNet's sites (`pipeline/knn2img.py` rdm_unet_config: 448 channels,
# mult 1/2/3/4, attention at downsample 1, 2 and 4 and in the mid block,
# head width 32; 48² latents): (level, L, inner, count), 16 blocks
RDM_SITES = [("level0", 2304, 448, 5), ("level1", 576, 896, 5),
             ("level2", 144, 1344, 5), ("mid", 36, 1792, 1)]
RDM_HEAD_WIDTH = 32
RDM_PROMPTS = 3                 # knn2img's --n-samples
# dh 32 is a wgmma head width of the MHA forward (`ops/cuda_mha.py`
# WGMMA_DH): every bf16 RDM attention site runs it; GEGLU runs wgmma at
# every width
RDM_DESIGNS = {("mha", "bfloat16"): "wgmma", ("geglu", "bfloat16"): "wgmma",
               ("mha", "float32"): "simt", ("geglu", "float32"): "simt"}
# backward sites per chain that get no gradient: the first self-attention of
# the first evaluation sees only x_T and the timestep, so autograd records no
# backward there; every other site depends on the blend weights
NO_GRAD_SITES = {"flash_bwd": 1}


# phase image_io: the codec's and the resize's bytes on the card's machine
# (no PIL there) are held to PIL's, whose SHA-256 are these constants
# (`tests/test_torch_image_io.py` checks them against PIL)
CODEC_QUALITY = 75
JPEG_SHA256 = "cdd160828b4cabbfc31a2b1cb11ad68f048514f82df11fb01a65513e6aa44a3a"
DECODE_SHA256 = "e4dc05cb6d7690946a3fd023eb5f20cf2994ee22a411cd15876a655a8fc029f7"
RESIZE_SHA256 = "752fcb85a65ae4cfb968441617023db3013b4c21aa21c6add79f034d89b91eba"
# phase formats and train_data: the committed files a JAX user's disk holds
# (`tests/helpers/port_formats.py` writes them and their digests with JAX,
# orbax and Pillow); the DATA_IMAGES slots the fixture images take
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                        "port_formats")
FORMAT_SLOTS = {0: "rgb16.ppm", 1: "progressive.jpg", 2: "dxt5_texture.jpg", 3: "rgb24.bmp",
                4: "tga_rle.jpg", 5: "lossy.webp", 6: "frame.gif", 7: "lzw.tif"}
# phase formats: the 512x512 fixtures whose decode times it reports apart
RASTER_FIXTURES = ("tga_rle.jpg", "blocks.qoi", "blocks.psd")
# phase formats: 512x512 block-compressed DDS files made from a seed (BCn,
# DXGI format or None for FOURCC DXT1, seed), the same bytes as
# `tests/helpers/port_formats.block_file_512`; Pillow's digests of them are
# digests.json["generated"]
BLOCKS_512 = {"bc1_512.dds": (1, None, 51), "bc6h_512.dds": (6, 95, 52),
              "bc7_512.dds": (7, 98, 53)}
# phase image_in's bf16 --init (an Adam7 palette PNG) and --mask (a 1-bit TIFF)
INIT_FIXTURE, MASK_FIXTURE = "adam7_palette.png", "mask.tif"


def codec_image(h: int = 480, w: int = 640, seed: int = 14):
    """The seeded 640x480 RGB image of phase image_io: integer gradients
    plus RandomState noise (no floating-point functions, so every numpy
    gives the same bytes)."""
    import numpy as np

    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (3 + c) + yy * (2 + 2 * c) + 40 * c) % 256 for c in range(3)], -1)
    return np.clip(base + r.randint(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)


# scripts/flops_model.py's five programs at SD v1-4 width, counted on the meta
# device: (matmul, conv) FLOPs.  tests/test_torch_flops.py holds them against
# the JAX package's count_flops with the strided-conv and context-projection gaps
FLOPS_SD = {
    "vanilla_plms50_b8": (293485982777344, 382101296775168),
    "dpm20_b8_epoch": (393909331034112, 465584087105536),
    "dpm20_b8_final_fwd": (119440611999744, 161904027762688),
    "plms50_b4_epoch": (502194973966336, 563064542855168),
    "plms50_b4_final_fwd": (152073749921792, 191050648387584),
}


def chain_launches(kernel: str, evals: int) -> int:
    """Launches of one chain of `evals` UNet evaluations under remat, forward
    (run again by the recompute) and backward."""
    n = SITES_PER_EVAL[kernel]
    if kernel.endswith("bwd"):
        return n * evals - NO_GRAD_SITES.get(kernel, 0)
    return 2 * n * evals


def chain_evals(sampler: str, steps: int) -> int:
    """UNet evaluations of one chain: PLMS S + 1 (its first step evaluates
    twice), DDIM and DPM-Solver++ S."""
    return steps + 1 if sampler == "plms" else steps


def opt_launches(kernel: str, evals: int) -> int:
    """Launches per optimization batch whose chain has `evals` UNet
    evaluations: 2 training epochs, then the forward-only epoch."""
    return 2 * chain_launches(kernel, evals) + (0 if kernel.endswith("bwd")
                                                else evals * SITES_PER_EVAL[kernel])


# rows the planted "stale ring stage" faults of the backward passes replace
# (`csrc/flash_bwd.cu` DQ_TILE, DKV_TILE); the forward's: `fwd_stage_keys`
WGMMA_BWD_TILE = 64
# the wgmma kernel functions of the built library (`cuobjdump -sass`)
WGMMA_FUNCTIONS = ("flash_fwd_wgmma_kernel", "mha_fwd_wgmma_kernel",
                   "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                   "geglu_gate_wgmma_kernel", "geglu_out_wgmma_kernel",
                   "geglu_dgate_wgmma_kernel", "geglu_dx_out_wgmma_kernel",
                   "spacetime_fwd_wgmma_kernel", "spacetime_bwd_dq_wgmma_kernel")
# of those, the kernels fed by tensor-map copies only (UTMALDG, not UBLKCP)
TMA_TILE_FUNCTIONS = ("spacetime_fwd_wgmma_kernel", "spacetime_bwd_dq_wgmma_kernel",
                      "mha_fwd_wgmma_kernel")
# the MHA forward's wgmma instantiations (head width, queries per block),
# each of which the build must hold (`csrc/mha_fwd.cu`)
MHA_WGMMA_INSTANCES = ((32, 64), (32, 128), (40, 128), (64, 128), (80, 128), (128, 128),
                       (160, 64), (160, 128))
# repeats per site of each spacetime kernel and of the wgmma MHA forward
# that must give the same bits
REPEATS = 20
# ptxas warnings that undo a wgmma design: wgmma serialized, registers spilled
PTXAS_FAULTS = ("C7513", "C7512")


def fwd_stage_keys(dh: int) -> int:
    """Keys per ring stage of the wgmma attention forward at head width dh
    (`csrc/attn_fwd.cuh` FwdWgmma::BK)."""
    return 64 if dh <= 48 or dh > 128 else 128


BWD_NAMES = ("dq_c", "dg_u", "dkc", "dvc", "dlk", "dlv", "dmasks", "dcoef")
SPLASH = "jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py"

KERNELS = {
    "spacetime_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/spacetime_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_spacetime.py:44", design="wgmma"),
    "spacetime_bwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/spacetime_bwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_spacetime.py:152", design="wgmma"),
    "geglu_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/geglu_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_geglu.py:126", design="wgmma"),
    "geglu_bwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/geglu_bwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_geglu.py:244", design="wgmma"),
    "mha_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/mha_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_mha.py:79"),
    "flash_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/flash_fwd.cu",
        replaces=f"diffusion_spacetime_attn_tpu/ops/attention.py:194 "
                 f"({SPLASH}:696 flash_attention_kernel)"),
    "flash_bwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/flash_bwd.cu",
        replaces=f"diffusion_spacetime_attn_tpu/ops/attention.py:194 "
                 f"({SPLASH}:1307 _flash_attention_dq_kernel, "
                 f":1669 _flash_attention_dkv_kernel)"),
}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with `t`: the seconds since the script started (each
    phase's share of the wall time)."""
    print(json.dumps({**obj, "t": round(time.perf_counter() - _T0, 2)}), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms over `iters` warm launches."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _design_device_ms(kind: str, args, heads: int = HEADS, cupti: bool = False) -> dict:
    """{design: ms per call} of a bf16 attention call straight through the C
    entry (CUDA events over 20 back-to-back calls, the host ahead of the
    card: the kernels' own time, without the wrapper's host work or PyTorch
    ops), for each design this shape can take: the wgmma kernels and the
    synchronous mma_sync loop they replace, on the same inputs; where the
    MHA forward has two block heights (dh 32 and 160), each of them too
    (`wgmma_bq64`, `wgmma_bq128`; "wgmma" is the one `mha_wide` picks).
    With `cupti` (the MHA forward): each design's kernel durations from one
    torch.profiler session instead, which the events cannot give where the
    host issues a call slower than the card runs it (the short sequences);
    the designs' kernels are told apart by name."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_flash, cuda_lib, cuda_mha

    lib, code = cuda_lib.library(), cuda_mha.DESIGN_CODES
    q, k, v = args[:3]
    B, L, inner = q.shape
    dh = inner // heads
    designs = ["mma_sync"]
    if cuda_mha.attention_design("mha" if kind == "mha" else "flash", q.dtype, dh) == "wgmma":
        designs.append("wgmma")
    if kind == "mha" and dh in (32, 160):
        designs += ["wgmma_bq64", "wgmma_bq128"]
    code = {**code, "wgmma_bq64": 2, "wgmma_bq128": 3}
    qs = cuda_flash.scaled_query(q, k, heads)
    out = torch.empty_like(q)
    if kind == "mha":
        entry, ptrs, rest = "dsta_mha_fwd", (q, k, v, out), (dh ** -0.5,)
    elif kind == "flash":
        lse = torch.empty((B * heads, L), dtype=torch.float32, device="cuda")
        entry, ptrs, rest = "dsta_flash_fwd", (qs, k, v, out, lse), ()
    else:
        o, lse, g = args[3:]
        rows = -(-L // cuda_flash.SCRATCH_ROWS) * cuda_flash.SCRATCH_ROWS
        scratch = torch.empty(2 * B * heads * rows, dtype=torch.float32, device="cuda")
        entry, ptrs, rest = ("dsta_flash_bwd", (qs, k, v, g, o, lse, scratch, out,
                                                torch.empty_like(k), torch.empty_like(v)),
                             (cuda_flash.query_scale(q, heads),))
    fn = getattr(lib, entry)

    def launch(design):
        c_args = (1, code[design], *(t.data_ptr() for t in ptrs), B, L, L, heads, dh, *rest,
                  cuda_lib.stream_ptr(q))
        return lambda: cuda_lib.check(fn(*c_args), entry)

    if not cupti:
        return {d: cuda_ms(launch(d), 20) for d in designs}
    names = {"mma_sync": "mha_fwd_mma_kernel", "wgmma": "mha_fwd_wgmma_kernel",
             "wgmma_bq64": f"mha_fwd_wgmma_kernel<{dh}, 64>",
             "wgmma_bq128": f"mha_fwd_wgmma_kernel<{dh}, 128>"}
    if "wgmma_bq64" in designs:      # "wgmma" runs one of the two
        designs.remove("wgmma")
    return profiled_ms({d: (launch(d), names[d]) for d in designs}, n=10)


def _geglu_device_ms(args, dx: bool) -> dict:
    """{"wgmma": ms per call} of a bf16 GEGLU forward (args: x, w1, b1, w2,
    b2, res) or dx (x, w1, b1, w2, dy) straight through the C entry (CUDA
    events over 20 back-to-back calls, scratch allocated once): the kernels'
    own time, without the wrapper's host work."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_geglu, cuda_lib

    lib = cuda_lib.library()
    x, w1, b1, w2 = args[:4]
    (M, dim), inner = x.shape, w2.shape[1]
    out = torch.empty_like(x)
    scratch = cuda_geglu._scratch("wgmma", M, dim, inner, (2 if dx else 1) * inner, x.device)
    if dx:
        fn, name = lib.dsta_geglu_dx, "dsta_geglu_dx"
        ptrs = (x, w1, b1, w2, args[4], scratch, out)
    else:
        fn, name = lib.dsta_geglu_fwd, "dsta_geglu_fwd"
        ptrs = (x, w1, b1, w2, args[4], args[5], scratch, out)
    c_args = (1, *(t.data_ptr() for t in ptrs), M, dim, inner, cuda_lib.stream_ptr(x))
    return {"wgmma": cuda_ms(lambda: cuda_lib.check(fn(*c_args), name), 20)}


def _spacetime_device_ms(args, bwd: bool) -> dict:
    """{"wgmma": ms per call} of a bf16 spacetime forward (args: q_c, g_u,
    kc, vc, lk, lv, masks, coef) or dq pass (args + ḡ; no dK/dV) straight
    through the C entry (CUDA events over 20 back-to-back calls, outputs and
    the masks in q's dtype made once): the kernel's own time, without the
    wrapper's host work."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_lib

    lib = cuda_lib.library()
    q, g_u, kc, vc, lk, lv, masks, coef = args[:8]
    (B, Lq, inner), (N, Lk) = q.shape, lk.shape[1:3]
    m, c = masks.to(q.dtype).contiguous(), coef.float().contiguous()
    dh = inner // HEADS
    ins = (q, g_u, kc, vc, lk, lv, m, c)
    if bwd:
        f32 = dict(dtype=torch.float32, device=q.device)
        dq, t = torch.empty((B, Lq, inner), **f32), torch.empty((B, HEADS, N, Lq), **f32)
        fn, name = lib.dsta_spacetime_bwd, "dsta_spacetime_bwd"
        ptrs = [x.data_ptr() for x in ins + (args[8], dq, t)] + [None] * 4
    else:
        out = torch.empty_like(q)
        fn, name = lib.dsta_spacetime_fwd, "dsta_spacetime_fwd"
        ptrs = [x.data_ptr() for x in ins + (out,)]
    c_args = (1, *ptrs, B, N, Lq, Lk, HEADS, dh, dh ** -0.5, cuda_lib.stream_ptr(q))
    return {"wgmma": cuda_ms(lambda: cuda_lib.check(fn(*c_args), name), 20)}


def profiled_ms(runs: dict, n: int = 20) -> dict:
    """{name: device ms per call} from one torch.profiler (CUPTI) session
    that runs each of `runs` ({name: (fn, a part of the names of its kernels
    and of no other's)}) n times: the kernels' own durations, which the
    card's clock gives even where the host issues slower than the kernels
    run (there CUDA events over back-to-back calls time the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn, _ in runs.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn, _ in runs.values():
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {name: sum(getattr(e, "self_device_time_total", 0.0) for e in events if part in e.key)
            / 1e3 / n for name, (_, part) in runs.items()}


def _geglu_composite(args, dx: bool):
    """The same function as a chain of PyTorch calls in x's dtype (cuBLAS
    products and elementwise kernels): F.linear -> h·gelu(g) -> F.linear, or
    for dx, h, g and du -> dh, dg -> [dh | dg]·W1.  A yardstick only: the
    port never calls it."""
    import torch
    import torch.nn.functional as F

    x, w1, b1, w2 = args[:4]
    h, g = F.linear(x, w1, b1).chunk(2, dim=-1)
    if not dx:
        return F.linear(h * F.gelu(g), w2, args[4]) + args[5]
    du = args[4] @ w2
    c = 0.5 * (1.0 + torch.erf(g * 2.0 ** -0.5))
    phi = torch.exp(-0.5 * g * g) * (2.0 * math.pi) ** -0.5
    return torch.cat([du * (g * c), du * (h * (c + g * phi))], dim=-1) @ w1


def bound_ms(flops: float, nbytes: float, dtype: str, exps: float = 0.0):
    """The least time of a call in ms, the largest of its FLOP, byte and exp
    floors, and what bounds it (exps count as operations)."""
    t_ops = max(flops / PEAK_FLOPS[dtype], exps / PEAK_EXPS)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _exps(kind: str, args, heads: int = HEADS) -> int:
    """Exponentials a call needs where they can bound it: the spacetime
    forward and dq pass and the MHA forward (one per score), else 0."""
    if kind == "mha":
        B, Lq, _ = args[0].shape
        return B * heads * Lq * args[1].shape[1]
    if kind != "spacetime":
        return 0
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_spacetime

    return cuda_spacetime.spacetime_exps(args[0].shape[0], OBJECTS, args[0].shape[1],
                                         CONTEXT_LEN, HEADS)


def _floors_us(flops: float, nbytes: float, exps: float, dtype: str) -> dict:
    return {"flops": 1e6 * flops / PEAK_FLOPS[dtype], "bytes": 1e6 * nbytes / PEAK_BYTES,
            "exps": 1e6 * exps / PEAK_EXPS}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    info = cuda_lib.build()
    cuda_lib.library()
    keep = [ln.strip() for ln in info["ptxas"].splitlines()
            if ln.startswith("==") or "registers" in ln or "spill" in ln
            or "Compiling entry" in ln or "arning" in ln]
    sass = sass_counts(info["path"])
    mha = {f"{dh}x{bq}": _ptxas_function(info["ptxas"], dh, bq) for dh, bq in MHA_WGMMA_INSTANCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "path": info["path"],
          "ptxas": keep, "sass": sass, "mha_wgmma_ptxas": mha})
    bad = [ln for ln in keep if any(code in ln for code in PTXAS_FAULTS)]
    if bad:
        fail(f"build: ptxas serialized wgmma or spilled: {bad}")
    for dh, bq in MHA_WGMMA_INSTANCES:
        found = {k: c for k, c in sass.items() if _is_mha_instance(k, dh, bq)}
        if len(found) != 1 or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in found.values()):
            fail(f"build: the MHA wgmma kernel at dh {dh}, {bq} queries per block: {found}")
    for fn in WGMMA_FUNCTIONS:
        found = {k: v for k, v in sass.items() if fn in k}
        if not found:
            fail(f"build: no kernel function {fn} in the library")
        for name, c in found.items():
            if c["HGMMA"] == 0 or c["UTMALDG"] + c["UBLKCP"] == 0:
                fail(f"build: {name} has {c}: no wgmma or no TMA copy")
            if fn in TMA_TILE_FUNCTIONS and c["UTMALDG"] == 0:
                fail(f"build: {name} has {c}: no tensor-map copy")


def _is_mha_instance(name: str, dh: int, bq: int) -> bool:
    """Whether a kernel function's name, mangled or not, is
    `mha_fwd_wgmma_kernel<dh, bq>`."""
    return (f"mha_fwd_wgmma_kernelILi{dh}ELi{bq}E" in name
            or f"mha_fwd_wgmma_kernel<{dh}, {bq}>" in name)


def _ptxas_function(report: str, dh: int, bq: int) -> list:
    """ptxas's register and spill lines of `mha_fwd_wgmma_kernel<dh, bq>`."""
    lines, mine = [], False
    for ln in report.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            mine = _is_mha_instance(ln, dh, bq)
        elif mine and ("registers" in ln or "spill" in ln):
            lines.append(ln.strip())
    return lines


def sass_counts(lib_path: str) -> dict:
    """{kernel function: counts of HGMMA, UTMALDG and UBLKCP instructions}
    from `cuobjdump -sass` of the built library."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] = {"HGMMA": 0, "UTMALDG": 0, "UBLKCP": 0}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG", "UBLKCP"):
                if op in ln:
                    counts[fn][op] += 1
    return {k: v for k, v in counts.items() if sum(v.values()) or "wgmma" in k}


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def _stale_tile(t, tile: int):
    """t [B, L, ...] with rows [tile, 2·tile) replaced by rows [0, tile): what
    a ring that served the previous stage's tile in place of the second
    would compute on."""
    t = t.clone()
    t[:, tile:2 * tile] = t[:, :tile]
    return t


def _stale_cols(t, tile: int = 64):
    """t [R, C] with columns [tile, 2·tile) replaced by columns [0, tile): the
    GEGLU kernels' second k-step over dim served from the first one's ring
    stage."""
    t = t.clone()
    t[:, tile:2 * tile] = t[:, :tile]
    return t


def _planted_faults(kind: str, args, kern, heads: int = HEADS):
    """Outputs of the kernel with a planted fault, which the comparison with
    the plain version must reject: a skipped key tile (the last 64 keys; 32
    at L = 64) or a 5 % wrong softmax scale for attention, the log-sum-exp
    off by log 2 on the first query tile for flash, the second ring stage's
    keys (`fwd_stage_keys`: 64 or 128) replaced by the first's (a stale ring
    stage) where the wgmma loop runs and L holds two stages; for
    GEGLU a skipped 64-wide inner tile, the second 64-deep k-step of h and g
    replaced by the first (a stale ring stage) and the last k-step of the
    second product skipped, and the last output column tile (the N tail where
    dim is not a multiple of the tile) served from the tile before it; and
    for the spacetime blend only the first 64 of the 77 context keys, and
    object 2's K/V served from object 1's ring stage."""
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_mha

    if kind in ("mha", "flash"):
        q, k, v = args
        L = k.shape[1]
        keep = L - (64 if L > 64 else 32)
        faults = {"skip_key_tile": kern((q, k[:, :keep].contiguous(), v[:, :keep].contiguous()))}
        if kind == "mha":
            faults["scale_x1.05"] = kern(((q.float() * 1.05).to(q.dtype), k, v))
        else:
            o, lse = kern(args)
            lse = lse.clone()
            lse[:, :64] += math.log(2.0)
            faults["lse_off_by_log2_on_one_query_tile"] = (o, lse)
        dh = q.shape[2] // heads
        tile = fwd_stage_keys(dh)
        if cuda_mha.attention_design(kind, q.dtype, dh) == "wgmma" and L >= 2 * tile:
            faults["stale_ring_stage_for_one_key_tile"] = kern(
                (q, _stale_tile(k, tile), _stale_tile(v, tile)))
        return faults
    if kind == "geglu":
        x, w1, b1, w2 = args[:4]
        skip, last = w2.clone(), w2.clone()
        skip[:, :64] = 0
        last[:, -64:] = 0
        return {"skip_inner_tile": kern(args[:3] + (skip,) + args[4:]),
                "stale_ring_stage_for_one_k_tile_of_h_g": kern(
                    (_stale_cols(x), _stale_cols(w1), b1, w2) + args[4:]),
                "last_k_tile_of_second_product_skipped": kern(args[:3] + (last,) + args[4:]),
                "stale_last_column_tile": _stale_last_cols(kern(args))}
    ctx = tuple(t[..., :64, :].contiguous() for t in args[2:6])
    return {"first_key_tile_only": kern(args[:2] + ctx + args[6:]),
            "stale_ring_stage_for_object_2": kern(args[:4] + _stale_object(*args[4:6])
                                                  + args[6:])}


def _stale_last_cols(out):
    """out [M, dim] with its last output column tile (dim mod the tile
    width, or a whole tile) replaced by the same columns of the tile before:
    what a store of the wrong tile into the N tail would leave."""
    from diffusion_spacetime_attn_tpu_torch.ops.cuda_geglu import out_tile_width

    M, dim = out.shape
    bn = out_tile_width(M, dim)
    start = (dim - 1) // bn * bn
    out = out.clone()
    out[:, start:] = out[:, start - bn:dim - bn]
    return out


def _stale_object(lk, lv):
    """Object 2's K and V replaced by object 1's: what the spacetime kernels
    compute when a ring stage serves the previous context's copy."""
    lk, lv = lk.clone(), lv.clone()
    lk[:, 1], lv[:, 1] = lk[:, 0], lv[:, 0]
    return lk, lv


def _inputs(kind: str, prompts: int, Lq: int, inner: int, dtype, gen):
    """Kernel inputs at one site for `prompts` prompts (2·prompts CFG rows),
    on the card, from a seeded generator."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops.masks import flat_circular_mask

    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    rows = 2 * prompts
    if kind in ("mha", "flash"):
        return (randn(rows, Lq, inner), randn(rows, Lq, inner), randn(rows, Lq, inner))
    if kind == "geglu":
        M, dim, hid = rows * Lq, inner, 4 * inner
        return (randn(M, dim), randn(2 * hid, dim, scale=dim ** -0.5), randn(2 * hid, scale=0.1),
                randn(dim, hid, scale=hid ** -0.5), randn(dim, scale=0.1), randn(M, dim))
    B = prompts
    centers = torch.rand((B, OBJECTS, 2), generator=gen, device=dev)
    masks = flat_circular_mask(centers, int(round(Lq ** 0.5)), 0.2,
                               torch.ones(B, OBJECTS, device=dev))
    return (randn(B, Lq, inner), randn(B, Lq, inner), randn(B, CONTEXT_LEN, inner),
            randn(B, CONTEXT_LEN, inner), randn(B, OBJECTS, CONTEXT_LEN, inner),
            randn(B, OBJECTS, CONTEXT_LEN, inner), masks,
            torch.full((B, OBJECTS), 1.25, device=dev))


def _sites(kind: str):
    """The main-path sites of a kernel kind: flash takes levels 0 and 1."""
    return [s for s in SITES if not kind.startswith("flash") or s[0] in FLASH_LEVELS]


def _design_counter(kind: str):
    """The launches-by-design counter of a kernel kind."""
    from diffusion_spacetime_attn_tpu_torch.ops import (
        cuda_flash,
        cuda_geglu,
        cuda_mha,
        cuda_spacetime,
    )

    return {"mha": cuda_mha.mha_attention, "flash": cuda_flash.flash_attention,
            "flash_bwd": cuda_flash.flash_bwd, "geglu": cuda_geglu.geglu_ff,
            "geglu_bwd": cuda_geglu.geglu_dx,
            "spacetime": cuda_spacetime.fused_spacetime_attention,
            "spacetime_bwd": cuda_spacetime.spacetime_bwd}[kind].launches_by_design


def _design_ran(name: str, counter, before):
    """The one design whose count moved since `before`."""
    ran = [d for d, n in counter.items() if n != before[d]]
    if len(ran) != 1:
        fail(f"{name}: one launch moved the design counts {before} -> {counter}")
    return ran[0]


def phase_kernels(sites=None, prompts: int = SERVE_PROMPTS, head_width=None,
                  phase: str = "kernel", designs=None, kinds=("mha", "flash", "geglu", "spacetime")):
    """Every kernel vs its plain version at every main-path shape: in bf16 at
    one prompt (CFG rows = 2) and at `prompts` prompts, and in f32 at one
    prompt.  Returns per-kernel aggregates over one UNet evaluation at
    `prompts` prompts (bf16 sites x counts).  The defaults are the SD v1-4
    serving path (8 heads); `sites`, `head_width` (heads = inner / width)
    and `designs` ({(kind, dtype): the design every site must run}) give
    another model's."""
    import torch
    import torch.nn.functional as F

    from diffusion_spacetime_attn_tpu_torch.ops import (
        cuda_flash,
        cuda_geglu,
        cuda_mha,
        cuda_spacetime,
    )
    from diffusion_spacetime_attn_tpu_torch.utils.testing import compare

    def nh(a):
        return HEADS if head_width is None else a[0].shape[-1] // head_width

    impl = {
        "mha": ("mha_fwd", lambda a: cuda_mha.mha_attention(*a, nh(a)),
                lambda a: cuda_mha.mha_attention_plain(*a, nh(a)),
                lambda a, it: cuda_mha.mha_cost(a[0].shape[0], a[0].shape[1], a[1].shape[1],
                                                a[0].shape[2], it)),
        "flash": ("flash_fwd", lambda a: cuda_flash.flash_fwd(*a, HEADS),
                  lambda a: cuda_flash.flash_attention_plain(*a, HEADS),
                  lambda a, it: cuda_flash.flash_cost(a[0].shape[0], a[0].shape[1],
                                                      a[1].shape[1], a[0].shape[2], HEADS, it)),
        "geglu": ("geglu_fwd", lambda a: cuda_geglu.geglu_ff(*a),
                  lambda a: cuda_geglu.geglu_plain(*a),
                  lambda a, it: cuda_geglu.geglu_cost(a[0].shape[0], a[0].shape[1],
                                                      a[3].shape[1], it)),
        "spacetime": ("spacetime_fwd",
                      lambda a: cuda_spacetime.fused_spacetime_attention(*a, HEADS),
                      lambda a: cuda_spacetime.spacetime_plain(*a, HEADS),
                      lambda a, it: cuda_spacetime.spacetime_cost(
                          a[0].shape[0], OBJECTS, a[0].shape[1], CONTEXT_LEN, a[0].shape[2],
                          it)),
    }
    impl = {k: impl[k] for k in kinds}
    cases = [("bfloat16", 1), ("bfloat16", prompts), ("float32", 1)]
    agg = {}
    gen = torch.Generator(device="cuda")
    case = 0
    for kind, (name, kern, plain, cost) in impl.items():
        a_ = agg.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                   "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0,
                                   "exps_ms": 0.0, "library_ms": None})
        for dtype_name, n_prompts in cases:
            dtype = getattr(torch, dtype_name)
            for level, Lq, inner, count in (_sites(kind) if sites is None else sites):
                case += 1
                gen.manual_seed(case)
                args = _inputs(kind, n_prompts, Lq, inner, dtype, gen)
                counter = _design_counter(kind)
                before = dict(counter)
                got = _outs(kern(args))
                design = _design_ran(name, counter, before)
                must = (designs or {}).get((kind, dtype_name))
                if must is not None and design != must:
                    fail(f"{name} {level} {dtype_name}: ran the {design} design, not {must}")
                if sites is None and dtype_name == "bfloat16" and design != "wgmma":
                    fail(f"{name} {level}: a bf16 main-path site ran the {design} kernel")
                repeats = REPEATS if kind == "spacetime" or (kind, design) == ("mha", "wgmma") \
                    else 1
                agains = [_outs(kern(args)) for _ in range(repeats)]
                want = _outs(plain(args))
                torch.cuda.synchronize()
                cmps = [compare(g_, w_, kind) for g_, w_ in zip(got, want)]
                if not all(c["ok"] for c in cmps):
                    fail(f"{name} {level} {dtype_name} {n_prompts} prompt(s): {cmps}")
                if not all(torch.equal(g_, a2) for again in agains for g_, a2 in zip(got, again)):
                    fail(f"{name} {level} {dtype_name}: launches on the same inputs differ")
                faults = {}
                for fault, outs in _planted_faults(kind, args, kern, nh(args)).items():
                    fc = [compare(o, w_, kind) for o, w_ in zip(_outs(outs), want)]
                    if all(c["ok"] for c in fc):
                        fail(f"{name} {level} {dtype_name}: planted fault {fault} passes {fc}")
                    faults[fault] = {"rel_norm": max(c["rel_norm"] for c in fc),
                                     "max_abs_err": max(c["max_abs_err"] for c in fc)}
                cmp = cmps[0]
                max_err = max(c["max_abs_err"] for c in cmps)
                ms = cuda_ms(lambda: kern(args), 20)
                plain_ms = cuda_ms(lambda: plain(args), 5)
                flops, nbytes = cost(args, args[0].element_size())
                exps = _exps(kind, args, nh(args))
                b_ms, b_by = bound_ms(flops, nbytes, dtype_name, exps)
                lib_ms = None
                if kind in ("mha", "flash"):
                    B, L, _ = args[0].shape
                    qh, kh, vh = (t.view(B, L, nh(args), -1).transpose(1, 2) for t in args)
                    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)
                row = {"phase": phase, "name": name, "site": level, "dtype": dtype_name,
                       "prompts": n_prompts, "Lq": Lq, "inner": inner, "design": design,
                       "max_abs_err": max_err,
                       "rel_norm": cmp["rel_norm"], "atol": cmp["atol"], "rtol": cmp["rtol"],
                       "rel_norm_limit": cmp["rel_norm_limit"], "deterministic": True,
                       "planted_faults_rejected": faults, "kernel_ms": ms, "plain_ms": plain_ms,
                       "bound_us": 1e3 * b_ms, "bound_by": b_by, "flops": flops,
                       "bytes": nbytes, "library_ms": lib_ms,
                       "fraction_of_bound": b_ms / ms,
                       "repeats_equal": repeats}
                if exps:
                    row["exps"] = exps
                    row["floors_us"] = _floors_us(flops, nbytes, exps, dtype_name)
                if kind == "flash":
                    row["lse_max_abs_err"] = cmps[1]["max_abs_err"]
                if kind in ("mha", "flash") and dtype_name == "bfloat16":
                    row["device_ms"] = _design_device_ms(kind, args, nh(args))
                    if kind == "mha":     # CUPTI: SDPA's kernels, whatever their names
                        row["profiled_ms"] = {
                            **_design_device_ms(kind, args, nh(args), cupti=True),
                            **profiled_ms({"sdpa": (
                                lambda: F.scaled_dot_product_attention(qh, kh, vh), "")}, n=10)}
                if kind == "geglu" and dtype_name == "bfloat16":
                    row["device_ms"] = _geglu_device_ms(args, dx=False)
                    row["composite_ms"] = cuda_ms(lambda: _geglu_composite(args, dx=False), 20)
                if kind == "spacetime" and dtype_name == "bfloat16":
                    row["device_ms"] = _spacetime_device_ms(args, bwd=False)
                    row["profiled_ms"] = profiled_ms(
                        {"wgmma": (lambda: kern(args), "spacetime_fwd_wgmma")})
                emit(row)
                a_["max_abs_err"] = max(a_["max_abs_err"], max_err)
                if (dtype_name, n_prompts) == ("bfloat16", prompts):  # the serving shapes
                    a_["ms"] += count * ms
                    a_["plain_ms"] += count * plain_ms
                    a_["bound_ms"] += count * b_ms
                    a_["flops_ms"] += count * 1e3 * flops / PEAK_FLOPS[dtype_name]
                    a_["bytes_ms"] += count * 1e3 * nbytes / PEAK_BYTES
                    a_["exps_ms"] += count * 1e3 * exps / PEAK_EXPS
                    if lib_ms is not None:
                        a_["library_ms"] = (a_["library_ms"] or 0.0) + count * lib_ms
    return agg


def _bwd_planted_faults(kind: str, args, heads: int = HEADS):
    """Backward outputs with a planted fault, which the comparison with the
    plain version must reject: one object's blend products t zeroed, the
    last key tile (keys 64-76) dropped from dKc, or object 2's K/V served
    from object 1's ring stage (the dq pass; dK/dV as computed), for the
    spacetime backward;
    a skipped 64-wide inner tile and the second k-step of h, g and du
    replaced by the first (a stale ring stage) for the GEGLU dx, and the last
    k-step of [dh | dg]·W1 skipped (the plain formulas, not the kernel: a
    check of the tolerance only); the last key tile dropped from dK, or the
    forward's output o (and with it di) zeroed on the first query tile, for
    the flash backward, and where its wgmma passes run, the
    second 64-key tile of the dq pass or the second 64-query tile of the
    dK/dV pass replaced by the first (a stale ring stage)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_flash, cuda_geglu, cuda_mha, cuda_spacetime

    if kind == "flash":
        q, k, v, o, lse, g = args
        dq, dk, dv = cuda_flash.flash_bwd(q, k, v, o, lse, g, heads)
        cut = dk.clone()
        cut[:, -64:] = 0
        o0 = o.clone()
        o0[:, :64] = 0
        faults = {"last_key_tile_dropped_from_dk": (dq, cut, dv),
                  "o_zeroed_on_one_query_tile": cuda_flash.flash_bwd(q, k, v, o0, lse, g, heads)}
        if cuda_mha.attention_design("flash", q.dtype, q.shape[2] // heads) == "wgmma":
            T = WGMMA_BWD_TILE
            faults["stale_ring_stage_for_one_key_tile_dq_pass"] = cuda_flash.flash_bwd(
                q, _stale_tile(k, T), _stale_tile(v, T), o, lse, g, heads)
            faults["stale_ring_stage_for_one_query_tile_dkv_pass"] = cuda_flash.flash_bwd(
                _stale_tile(q, T), k, v, o, lse, _stale_tile(g, T), heads)
        return faults
    if kind == "geglu":
        x, w1, b1, w2, dy = args
        skip = w2.clone()
        skip[:, :64] = 0
        stale_w2 = w2.clone()      # W2 [dim, inner]: the k-step over dim runs down its rows
        stale_w2[64:128] = stale_w2[:64]
        # a check of the tolerance only, computed from the plain formulas
        # without the kernel: W1 feeds both products of dx, so no input
        # drops a k-step of [dh | dg]·W1 alone.  [dh | dg] rounded as the
        # kernel rounds them, its last 64 columns dropped from the product.
        inner = w2.shape[1]
        h, g = cuda_geglu._h_g(x, w1, b1, inner)
        dh, dg = cuda_geglu._dh_dg(h, g, dy.float() @ w2.float())
        dhg = torch.cat([dh, dg], dim=-1).to(x.dtype).float()
        dhg[:, -64:] = 0
        return {"skip_inner_tile": (cuda_geglu.geglu_dx(x, w1, b1, skip, dy),),
                "stale_ring_stage_for_one_k_tile_of_h_g_du": (cuda_geglu.geglu_dx(
                    _stale_cols(x), _stale_cols(w1), b1, stale_w2, _stale_cols(dy)),),
                "tolerance_only_last_k_tile_of_second_product_skipped": (
                    (dhg @ w1.float()).to(x.dtype),)}
    q_c, g_u, kc, vc, lk, lv, masks, coef, g = args
    dq, t, dkc, dvc, dlk, dlv = cuda_spacetime.spacetime_bwd_raw(
        q_c, g_u, kc, vc, lk, lv, masks, coef, heads, g)

    def cotangents(t_, dkc_):
        dg_u, dmasks, dcoef = cuda_spacetime._blend_cotangents(t_, masks, coef, g, g_u)
        return (dq.to(q_c.dtype), dg_u, dkc_.to(kc.dtype), dvc.to(vc.dtype), dlk.to(lk.dtype),
                dlv.to(lv.dtype), dmasks, dcoef)

    t0, cut = t.clone(), dkc.clone()
    t0[:, :, 0] = 0
    cut[:, 64:] = 0
    stale = cuda_spacetime.spacetime_bwd(q_c, g_u, kc, vc, *_stale_object(lk, lv), masks, coef,
                                         heads, g, need_kv=False)
    return {"object0_t_zeroed": cotangents(t0, dkc),
            "last_key_tile_dropped_from_dkc": cotangents(t, cut),
            "stale_ring_stage_for_object_2": stale[:2] + cotangents(t, dkc)[2:6] + stale[6:]}


def phase_kernels_bwd():
    """Each backward kernel vs its plain version at every chain shape, in
    bf16 and f32 at 1 and 2 prompts (flash: bf16 at 1 and 2, f32 at 1),
    every cotangent compared (dK/dV too); planted faults must fail and a
    repeat must give the same bits.  Returns per-kernel aggregates over one
    UNet evaluation's backward at the optimization batch (2 prompts, bf16,
    the chain's form: no spacetime dK/dV); emits the plain MHA backward's
    time per evaluation at that batch beside them.

    The flash backward's V has mean 1: with zero-mean random V the softmax
    averages V away, the output o and with it di = rowsum(o ⊙ ḡ) are near
    zero, and the comparison could not see di.  Its `library_ms` is the
    backward of `scaled_dot_product_attention` under autograd, timed alone."""
    import torch
    import torch.nn.functional as F

    from diffusion_spacetime_attn_tpu_torch.ops import (
        cuda_flash,
        cuda_geglu,
        cuda_mha,
        cuda_spacetime,
    )
    from diffusion_spacetime_attn_tpu_torch.utils.testing import compare

    def st_bwd(a, need_kv=True):
        return cuda_spacetime.spacetime_bwd(*a[:8], HEADS, a[8], need_kv=need_kv)

    impl = {
        "spacetime": ("spacetime_bwd", "spacetime_bwd", st_bwd,
                      lambda a: cuda_spacetime.spacetime_bwd_plain(*a[:8], HEADS, a[8]),
                      lambda a, it: cuda_spacetime.spacetime_bwd_cost(
                          a[0].shape[0], OBJECTS, a[0].shape[1], CONTEXT_LEN, a[0].shape[2],
                          HEADS, it, need_kv=False)),
        "geglu": ("geglu_bwd", "geglu", lambda a, need_kv=True: (cuda_geglu.geglu_dx(*a),),
                  lambda a: (cuda_geglu.geglu_dx_plain(*a),),
                  lambda a, it: cuda_geglu.geglu_dx_cost(a[0].shape[0], a[0].shape[1],
                                                         a[3].shape[1], it)),
        "flash": ("flash_bwd", "flash",
                  lambda a, need_kv=True: cuda_flash.flash_bwd(*a, HEADS),
                  lambda a: cuda_flash.flash_bwd_plain(*a, HEADS),
                  lambda a, it: cuda_flash.flash_bwd_cost(a[0].shape[0], a[0].shape[1],
                                                          a[1].shape[1], a[0].shape[2], HEADS,
                                                          it)),
    }
    cases = [("bfloat16", 1), ("bfloat16", SERVE_PROMPTS), ("float32", 1),
             ("float32", SERVE_PROMPTS)]
    names_of = {"spacetime": BWD_NAMES, "geglu": ("dx",), "flash": ("dq", "dk", "dv")}
    agg, mha_bwd_ms = {}, 0.0
    gen = torch.Generator(device="cuda")
    case = 1000
    for kind, (name, cmp_kind, kern, plain, cost) in impl.items():
        a_ = agg.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                   "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0,
                                   "exps_ms": 0.0, "library_ms": None})
        for dtype_name, prompts in cases[:3] if kind == "flash" else cases:
            dtype = getattr(torch, dtype_name)
            for level, Lq, inner, count in _sites(kind):
                case += 1
                gen.manual_seed(case)
                fwd = _inputs(kind, prompts, Lq, inner, dtype, gen)
                cot = (torch.randn(fwd[0].shape, generator=gen, device="cuda")).to(dtype)
                if kind == "flash":
                    q, k, v = fwd[0], fwd[1], (fwd[2].float() + 1.0).to(dtype)
                    args = (q, k, v) + cuda_flash.flash_attention_plain(q, k, v, HEADS) + (cot,)
                elif kind == "geglu":
                    args = fwd[:4] + (cot,)
                else:
                    args = fwd + (cot,)
                counter = _design_counter(kind + "_bwd")
                before = dict(counter)
                got = kern(args)
                design = _design_ran(name, counter, before)
                if design == "mma_sync":
                    fail(f"{name} {level} {dtype_name}: a main-path site ran the mma_sync kernels")
                if kind == "spacetime" and dtype_name == "bfloat16" and design != "wgmma":
                    fail(f"{name} {level}: a bf16 main-path site ran the {design} dq pass")
                repeats = REPEATS if kind == "spacetime" else 1
                agains, want = [kern(args) for _ in range(repeats)], plain(args)
                torch.cuda.synchronize()
                names = names_of[kind]
                errs = {}
                for i_, (n_, g_, w_) in enumerate(zip(names, got, want)):
                    cmp = compare(g_, w_, cmp_kind)
                    if not cmp["ok"]:
                        fail(f"{name} {level} {dtype_name} {prompts} prompt(s) {n_}: {cmp}")
                    if not all(torch.equal(g_, again[i_]) for again in agains):
                        fail(f"{name} {level} {dtype_name} {n_}: launches differ")
                    errs[n_] = {"max_abs_err": cmp["max_abs_err"], "rel_norm": cmp["rel_norm"]}
                faults = {}
                for fault, outs in _bwd_planted_faults(kind, args).items():
                    fc = [compare(o, w_, cmp_kind) for o, w_ in zip(outs, want)]
                    if all(c["ok"] for c in fc):
                        fail(f"{name} {level} {dtype_name}: planted fault {fault} passes")
                    faults[fault] = max(c["rel_norm"] for c in fc)
                max_err = max(e["max_abs_err"] for e in errs.values())
                ms = cuda_ms(lambda: kern(args, need_kv=False), 10)
                kv_ms = cuda_ms(lambda: kern(args, need_kv=True), 5) if kind == "spacetime" \
                    else None
                plain_ms = cuda_ms(lambda: plain(args), 3)
                flops, nbytes = cost(args, args[0].element_size())
                exps = _exps(kind, args)
                b_ms, b_by = bound_ms(flops, nbytes, dtype_name, exps)
                lib_ms = None
                if kind == "flash":
                    B, L, _ = args[0].shape
                    qh, kh, vh = (t.view(B, L, HEADS, -1).transpose(1, 2).detach()
                                  .requires_grad_(True) for t in args[:3])
                    oh = F.scaled_dot_product_attention(qh, kh, vh)
                    gh = args[5].view(B, L, HEADS, -1).transpose(1, 2)
                    lib_ms = cuda_ms(lambda: torch.autograd.grad(oh, (qh, kh, vh), gh,
                                                                 retain_graph=True), 10)
                    del oh
                row = {"phase": "kernel_bwd", "name": name, "site": level, "dtype": dtype_name,
                       "prompts": prompts, "Lq": Lq, "inner": inner, "design": design,
                       "errors": errs,
                       "max_abs_err": max_err, "deterministic": True,
                       "planted_faults_rejected_rel_norm": faults, "kernel_ms": ms,
                       "kernel_ms_with_dkv": kv_ms, "plain_ms": plain_ms,
                       "bound_us": 1e3 * b_ms, "bound_by": b_by, "flops": flops,
                       "bytes": nbytes, "library_ms": lib_ms, "fraction_of_bound": b_ms / ms,
                       "repeats_equal": repeats}
                if exps:
                    row["exps"] = exps
                    row["floors_us"] = _floors_us(flops, nbytes, exps, dtype_name)
                if kind == "flash" and dtype_name == "bfloat16":
                    row["device_ms"] = _design_device_ms("flash_bwd", args)
                if kind == "geglu" and dtype_name == "bfloat16":
                    row["device_ms"] = _geglu_device_ms(args, dx=True)
                    row["composite_ms"] = cuda_ms(lambda: _geglu_composite(args, dx=True), 10)
                if kind == "spacetime" and dtype_name == "bfloat16":
                    row["device_ms"] = _spacetime_device_ms(args, bwd=True)
                    row["profiled_ms"] = profiled_ms(
                        {"wgmma": (lambda: kern(args, need_kv=False), "spacetime_bwd_dq_wgmma")})
                    # the chain's self-attention backward at this level: plain
                    # PyTorch (`_mha_bh_bwd` numerics), timed as the yardstick
                    # of what a hand-written flash backward would replace
                    rows = 2 * prompts
                    q, k, v, g = (torch.randn((rows, Lq, inner), generator=gen,
                                              device="cuda").to(dtype) for _ in range(4))
                    row["mha_bwd_plain_ms"] = cuda_ms(
                        lambda: cuda_mha.mha_bwd_plain(q, k, v, g, HEADS), 3)
                    if prompts == SERVE_PROMPTS:
                        mha_bwd_ms += count * row["mha_bwd_plain_ms"]
                emit(row)
                a_["max_abs_err"] = max(a_["max_abs_err"], max_err)
                if (dtype_name, prompts) == ("bfloat16", SERVE_PROMPTS):
                    a_["ms"] += count * ms
                    a_["plain_ms"] += count * plain_ms
                    a_["bound_ms"] += count * b_ms
                    a_["flops_ms"] += count * 1e3 * flops / PEAK_FLOPS[dtype_name]
                    a_["bytes_ms"] += count * 1e3 * nbytes / PEAK_BYTES
                    a_["exps_ms"] += count * 1e3 * exps / PEAK_EXPS
                    if lib_ms is not None:
                        a_["library_ms"] = (a_["library_ms"] or 0.0) + count * lib_ms
    emit({"phase": "kernels_bwd", "per_unet_eval_ms": {k: v["ms"] for k, v in agg.items()},
          "mha_bwd_plain_ms_per_unet_eval": mha_bwd_ms})
    return agg


def _control(B, dev, gen, width=768):
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops.attention import SpatialControl

    return SpatialControl(
        local_contexts=torch.randn((B, OBJECTS, CONTEXT_LEN, width), generator=gen,
                                   device=dev),
        centers=torch.rand((B, OBJECTS, 2), generator=gen, device=dev),
        coef=torch.full((B, OBJECTS), 5.0 / OBJECTS, device=dev),
        active=torch.ones((B, OBJECTS), device=dev))


def phase_unet():
    """One full-width SD v1-4 UNet eval, kernels on vs off (same weights)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import UNetConfig
    from diffusion_spacetime_attn_tpu_torch.models.layers import cast_matmul_weights
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_

    dev = torch.device("cuda")
    on = UNetConfig(dtype="bfloat16", use_mha=True, use_fused_ff=True, use_fused_control=True)
    off = UNetConfig(dtype="bfloat16")
    with torch.device(dev):
        u_on, u_off = UNet(on), UNet(off)
    randomize_(u_on, seed=1)
    u_off.load_state_dict(u_on.state_dict())
    for u in (u_on, u_off):
        cast_matmul_weights(u).eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
    t = torch.full((2,), 981, dtype=torch.int32, device=dev)
    ctx = torch.randn((2, CONTEXT_LEN, 768), generator=gen, device=dev)
    ctl = _control(1, dev, gen)
    with torch.inference_mode():
        e_on = u_on(x, t, ctx, ctl)
        e_off = u_off(x, t, ctx, ctl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u_on(x, t, ctx, ctl)
        torch.cuda.synchronize()
        s_on = time.perf_counter() - t0
        t0 = time.perf_counter()
        u_off(x, t, ctx, ctl)
        torch.cuda.synchronize()
        s_off = time.perf_counter() - t0
    diff = float((e_on - e_off).abs().max())
    scale = float(e_off.abs().max())
    # bf16: the kernels round once where the plain path rounds at every
    # intermediate; the difference propagates through 16 transformer blocks
    tol = 5e-2 * scale + 1e-3
    emit({"phase": "unet", "shape": list(x.shape), "max_abs_diff": diff, "max_abs_eps": scale,
          "tol": tol, "eval_s_kernels": s_on, "eval_s_plain": s_off})
    if not (torch.isfinite(e_on).all() and diff <= tol and scale > 0):
        fail(f"UNet kernels-on vs off: max diff {diff} > {tol} (max |eps| {scale})")
    del u_on, u_off
    torch.cuda.empty_cache()


def phase_slice():
    """The slice's output against its plain path: the full-width SD v1-4
    bundle in float32, one prompt with 4 objects, encode_text -> PLMS with
    SLICE_STEPS steps from one x_T -> decode, kernels on vs off (the same
    seeded weights)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import (
        PipelineConfig,
        SpaceTimeConfig,
        UNetConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_geglu, cuda_mha, cuda_spacetime
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    ctl = _control(1, dev, gen)
    x_T = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
    tok = make_clip_tokenizer()
    ids = [[tok.pad_to(tok.encode(t), CONTEXT_LEN)] for t in ("a cat beside a dog", "")]
    wrappers = (cuda_spacetime.fused_spacetime_attention, cuda_geglu.geglu_ff,
                cuda_mha.mha_attention)
    out = {}
    for on in (True, False):
        cfg = PipelineConfig(unet=UNetConfig(use_mha=on, use_fused_ff=on, use_fused_control=on),
                             spacetime=SpaceTimeConfig(num_steps=SLICE_STEPS))
        sd = StableDiffusion.create(cfg, seed=0, device=dev)
        before = [w.launches for w in wrappers]
        with torch.inference_mode():
            eps = sd.make_eps_fn(sd.encode_text(ids[0]), sd.encode_text(ids[1]), 7.5, ctl)
            z = sd.sample_from(eps, x_T)
            out[on] = (z, sd.decode_latents(z))
        torch.cuda.synchronize()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        if launched != [16 * (SLICE_STEPS + 1) if on else 0] * 3:
            fail(f"slice kernels {'on' if on else 'off'}: launches {launched}")
        del sd
        torch.cuda.empty_cache()
    # float32: the kernels and the plain path differ in summation order only
    errs = {}
    for k, (got, want) in zip(("latents", "image"), zip(out[True], out[False])):
        errs[k] = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and torch.allclose(got, want, atol=1e-4, rtol=1e-4)):
            fail(f"slice {k}: kernels on vs off max diff {errs[k]} over 1e-4 + 1e-4·|plain|")
    emit({"phase": "slice", "dtype": "float32", "steps": SLICE_STEPS,
          "max_abs_diff": errs, "tol": [1e-4, 1e-4],
          "latent_moved": float((out[False][0] - x_T).abs().max())})


def phase_serve():
    """Three requests through TextToImageEngine at full SD v1-4 width."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import PipelineConfig, UNetConfig, VAEConfig
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_geglu, cuda_mha, cuda_spacetime
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.serving.server import TextToImageEngine
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

    cfg = PipelineConfig(
        unet=UNetConfig(dtype="bfloat16", use_mha=True, use_fused_ff=True,
                        use_fused_control=True),
        vae=VAEConfig(dtype="bfloat16"))
    t0 = time.perf_counter()
    sd = StableDiffusion.create(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tok = make_clip_tokenizer(max_len=cfg.text_encoder.max_len)
    objects = ["cat", "dog", "tree", "car"]
    centers = np.array([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]], np.float32)

    def prepare_host(prompt):
        return {"centers": centers, "active": np.ones(OBJECTS, np.float32),
                "local_texts": [f"a photo of {o}" for o in objects]}

    engine = TextToImageEngine(sd=sd, tokenize=lambda t: tok.pad_to(tok.encode(t), 77),
                               batch_size=SERVE_PROMPTS, prepare_host=prepare_host)
    finite = []
    hook = sd.vae.decoder.register_forward_hook(
        lambda m, i, out: finite.append(bool(torch.isfinite(out).all())))
    wrappers = {"spacetime_fwd": cuda_spacetime.fused_spacetime_attention,
                "geglu_fwd": cuda_geglu.geglu_ff, "mha_fwd": cuda_mha.mha_attention}
    requests = [["a cat and a dog near a tree and a car", "a dog left of a car"],
                ["a cat and a dog near a tree and a car"]]
    seeds = [[11, 12], [11]]
    images = []
    launches = {k: 0 for k in wrappers}
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    by_design = {}
    for prompts, sds in zip(requests, seeds):
        _reset_counts(wrappers.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = engine.generate_batch(prompts, sds)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        images.append(imgs)
        counts = {k: w.launches for k, w in wrappers.items()}
        for k, n in counts.items():
            launches[k] += n
            if n != LAUNCHES_PER_BATCH:
                fail(f"{k}: {n} launches in a batch, expected {LAUNCHES_PER_BATCH}")
        # MHA: every site on the wgmma loop (dh 40 and 80 at levels 0 and 1,
        # 160 at level 2 and mid)
        mha = dict(cuda_mha.mha_attention.launches_by_design)
        if mha != {"wgmma": LAUNCHES_PER_BATCH, "mma_sync": 0, "simt": 0}:
            fail(f"serve: MHA launches by design {mha}")
        geglu = dict(cuda_geglu.geglu_ff.launches_by_design)
        if geglu != {"wgmma": LAUNCHES_PER_BATCH, "simt": 0}:
            fail(f"serve: GEGLU launches by design {geglu}")
        st = dict(cuda_spacetime.fused_spacetime_attention.launches_by_design)
        if st != {"wgmma": LAUNCHES_PER_BATCH, "simt": 0}:
            fail(f"serve: spacetime launches by design {st}")
        _add_counts(by_design, {"mha_fwd": mha, "geglu_fwd": geglu, "spacetime_fwd": st})
        if imgs.shape != (len(prompts), 512, 512, 3) or imgs.dtype != np.uint8:
            fail(f"engine output {imgs.shape} {imgs.dtype}")
        if float(imgs.std()) == 0.0:
            fail("engine output is constant")
        emit({"phase": "serve_batch", "prompts": len(prompts),
              "pad_rows": SERVE_PROMPTS - len(prompts),
              "seconds": batch_s[-1], "launches": counts, "image_mean": float(imgs.mean()),
              "image_std": float(imgs.std())})
    hook.remove()
    if len(finite) != len(requests) or not all(finite):
        fail(f"decoded images not finite: {finite}")
    # the same (prompt, seed) in another batch, beside a pad row: the same bytes
    repeat_equal = bool(np.array_equal(images[0][0], images[1][0]))
    if not repeat_equal:
        diff = np.abs(images[0][0].astype(int) - images[1][0].astype(int))
        fail(f"request (prompt, seed 11) served twice differs: {int((diff > 0).sum())} bytes, "
             f"max {int(diff.max())}")
    emit({"phase": "serve", "requests": sum(map(len, requests)), "batches": len(requests),
          "batch_size": SERVE_PROMPTS, "steps": 50, "repeat_request_same_bytes": repeat_equal,
          "setup_s": setup_s, "s_per_batch": batch_s,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_by_design": by_design})
    return launches, by_design, sd


def _reset_counts(wrappers):
    """Every launch count to 0, by design too."""
    for w in wrappers:
        w.launches = 0
        for d in getattr(w, "launches_by_design", {}):
            w.launches_by_design[d] = 0


def _sum_launches(total: dict, counts: dict):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def _add_counts(total: dict, counts: dict):
    for name, by in counts.items():
        for d, n in by.items():
            total.setdefault(name, {}).setdefault(d, 0)
            total[name][d] += n


def _wrappers():
    """{kernel name: its wrapper, which carries the launch count}."""
    from diffusion_spacetime_attn_tpu_torch.ops.cuda_lib import kernel_wrappers

    return kernel_wrappers()


OBJECT_NAMES = ["cat", "dog", "tree", "car"]
OBJECT_CENTERS = [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]]


def _spacetime_engine(sd, clip_loss, batch_size, sampler="plms"):
    """SpaceTimeEngine over a PromptRunner whose host stage places the four
    OBJECT_NAMES at OBJECT_CENTERS for every prompt (the runner's record
    format; no layout predictor)."""
    import numpy as np

    from diffusion_spacetime_attn_tpu_torch.pipeline.runners import PromptRunner
    from diffusion_spacetime_attn_tpu_torch.serving.server import SpaceTimeEngine
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

    tok = make_clip_tokenizer(max_len=CONTEXT_LEN)

    def tokenize(t):
        return tok.pad_to(tok.encode(t), CONTEXT_LEN)

    class FixedLayoutRunner(PromptRunner):
        def prepare_host(self, prompt):
            return dict(centers=np.array(OBJECT_CENTERS, np.float32),
                        active=np.ones(OBJECTS, np.float32),
                        local_texts=[f"a photo of {o}" for o in OBJECT_NAMES],
                        obj_tokens=np.stack([np.asarray(tokenize(f"A photo of {o}"), np.int32)
                                             for o in OBJECT_NAMES]),
                        caption_tokens=np.asarray(tokenize(prompt), np.int32), prompt=prompt)

    runner = FixedLayoutRunner(sd=sd, clip_loss=clip_loss, layout=None, clip_tokenize=tokenize,
                               text_tokenize=tokenize, cfg=sd.cfg.spacetime, mode="spacetime",
                               sampler=sampler)
    return SpaceTimeEngine(runner=runner, batch_size=batch_size)


def phase_chain(samplers=("plms",), phase="chain"):
    """The optimization's gradient against its plain path: the full-width
    SD v1-4 bundle and the ViT-B/32 loss CLIP in float32, one prompt with 4
    objects, generation_loss through each sampler's chain with SLICE_STEPS
    steps (remat on) and its gradient in the blend weights, kernels on (the
    four flags, flash at levels 0 and 1, MHA at level 2 and mid) vs off.
    One line per sampler; each chain's launches are counted from 0."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import (
        CLIPConfig,
        PipelineConfig,
        SpaceTimeConfig,
        UNetConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.pipeline.spacetime import generation_loss, init_coef

    dev = torch.device("cuda")
    clip_loss = DCLIPLoss.create(CLIPConfig(), seed=4, device=dev)
    wrappers = _wrappers()
    out = {sampler: {} for sampler in samplers}
    for on in (True, False):
        cfg = PipelineConfig(unet=UNetConfig(use_flash=on, use_mha=on, use_fused_ff=on,
                                             use_fused_control=on),
                             spacetime=SpaceTimeConfig(num_steps=SLICE_STEPS))
        sd = StableDiffusion.create(cfg, seed=0, device=dev)
        with torch.no_grad():
            inputs = _spacetime_engine(sd, clip_loss, 1)._inputs(["a cat and a dog near a tree"],
                                                                 [21])
        for sampler in samplers:
            evals = chain_evals(sampler, SLICE_STEPS)
            coef = init_coef(inputs.active, SLICE_STEPS, cfg.spacetime.init_coef).requires_grad_()
            _reset_counts(wrappers.values())
            t0 = time.perf_counter()
            loss, images = generation_loss(coef, sd, clip_loss, inputs, cfg.spacetime, sampler)
            loss.backward()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = {k: w.launches for k, w in wrappers.items()}
            want = {k: (chain_launches(k, evals) if on else 0) for k in wrappers}
            tag = f"{phase} {sampler} kernels {'on' if on else 'off'}"
            if launched != want:
                fail(f"{tag}: launches {launched}, expected {want}")
            if not (torch.isfinite(loss) and torch.isfinite(coef.grad).all()):
                fail(f"{tag}: loss or gradient not finite")
            out[sampler][on] = (loss.detach(), coef.grad.clone(), seconds, launched)
            del loss, images
        del sd
        torch.cuda.empty_cache()
    for sampler in samplers:
        (l1, g1, s1, launched), (l0, g0, s0, _) = out[sampler][True], out[sampler][False]
        loss_rel = float((l1 - l0).abs() / l0.abs())
        grad_rel = float(torch.linalg.vector_norm(g1 - g0) / torch.linalg.vector_norm(g0))
        emit({"phase": phase, "sampler": sampler, "dtype": "float32", "steps": SLICE_STEPS,
              "evals": chain_evals(sampler, SLICE_STEPS), "objects": OBJECTS,
              "loss": float(l1), "loss_rel_diff": loss_rel, "dcoef_rel_norm": grad_rel,
              "limit": 1e-3, "dcoef_norm": float(torch.linalg.vector_norm(g0)),
              "launches": launched,
              "s_kernels": s1, "s_plain": s0})
        if not (loss_rel <= 1e-3 and grad_rel <= 1e-3 and float(g0.abs().max()) > 0):
            fail(f"{phase} {sampler}: kernels on vs off, loss rel {loss_rel}, "
                 f"dcoef rel norm {grad_rel} > 1e-3")


def _optimize_batch(engine, wrappers, prompts, sds, evals: int):
    """One SpaceTimeEngine batch (bf16, four flags) with its checks: every
    kernel launched `opt_launches(k, evals)` times, all on the wgmma design
    (MHA at dh 160: levels 2 and mid), losses and
    images finite, every active object's weights moved and no padded one.
    Returns (the batch's line, its uint8 images)."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.pipeline.spacetime import init_coef

    sd, sampler = engine.runner.sd, engine.runner.sampler
    _reset_counts(wrappers.values())
    marks = []

    def on_epoch(e, imgs):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs, coef, losses = engine.optimize_batch(prompts, sds, on_epoch=on_epoch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    for k, n in counts.items():
        want = opt_launches(k, evals)
        if n != want:
            fail(f"optimize ({sampler}) {k}: {n} launches in a batch, expected {want}")
    checks = (("flash_fwd", "wgmma"), ("flash_bwd", "wgmma"), ("mha_fwd", "wgmma"),
              ("geglu_fwd", "wgmma"), ("geglu_bwd", "wgmma"), ("spacetime_fwd", "wgmma"),
              ("spacetime_bwd", "wgmma"))
    designs = {k: dict(wrappers[k].launches_by_design) for k, _ in checks}
    for k, d in checks:
        if designs[k][d] != counts[k]:
            fail(f"optimize {k}: launches by design {designs[k]}, all expected on {d}")
    if not bool(torch.isfinite(losses).all()) or not bool(torch.isfinite(imgs).all()):
        fail(f"optimize: losses {losses.tolist()} or images not finite")
    B = engine.batch_size
    active = torch.zeros(B, OBJECTS, device=coef.device)
    active[:len(prompts)] = 1.0
    init = init_coef(active, sd.schedule.num_steps, sd.cfg.spacetime.init_coef)
    # random N(0, 0.02²) weights give gradients of ~1e-10 (phase chain), so
    # Adam's eps (1e-8) dominates and an entry whose gradient is below
    # ~1e-13 moves less than one f32 ulp of 1.25: every active object must
    # move at some step, every padded one nowhere
    moved = (coef - init).abs()
    obj_moved = moved.amax(dim=-1)                      # [B, N]
    min_obj_moved = float(obj_moved[active > 0].min())
    moved_share = float((moved[active > 0] > 0).float().mean())
    pad_max = float(coef[active == 0].abs().max()) if bool((active == 0).any()) else 0.0
    stats = {"coef_min_object_moved": min_obj_moved, "coef_moved_share": moved_share,
             "coef_max_moved": float(moved.max()), "coef_max_padded": pad_max}
    if not (min_obj_moved > 0 and pad_max == 0.0):
        fail(f"optimize: coef did not move as expected: {stats}")
    u8 = engine.to_uint8(imgs[:len(prompts)])
    size = sd.cfg.spacetime.image_size
    if u8.shape != (len(prompts), size, size, 3) or float(u8.std()) == 0.0:
        fail(f"optimize: output {u8.shape}, std {float(u8.std())}")
    line = {"sampler": sampler, "steps": sd.schedule.num_steps, "evals": evals,
            "prompts": len(prompts), "pad_rows": B - len(prompts), "seconds": seconds,
            "s_per_epoch": np.diff([t0] + marks).tolist(), "losses": losses.tolist(),
            "launches": counts, "launches_by_design": designs,
            **stats, "coef_range": [float(coef.min()), float(coef.max())],
            "image_mean": float(u8.mean()), "image_std": float(u8.std())}
    return line, u8


OPTIMIZE_STEPS = 10             # phase optimize's PLMS steps (cut from 50 to hold the time budget)


def phase_optimize():
    """SpaceTimeEngine at full SD v1-4 width (UNet, VAE, ViT-L/14 text
    tower; ViT-B/32 loss CLIP), bf16, PLMS-10 (OPTIMIZE_STEPS), batch 2, 4 objects, 3 epochs
    with the last forward only, the four kernel flags on (use_flash, as the
    JAX package's spacetime mode sets it): two requests, then the first
    (prompt, seed) again beside a pad row, which must give the same bytes."""
    import dataclasses

    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import (
        CLIPConfig,
        CLIPVisionConfig,
        PipelineConfig,
        UNetConfig,
        VAEConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion

    cfg = PipelineConfig(
        unet=UNetConfig(dtype="bfloat16", use_flash=True, use_mha=True, use_fused_ff=True,
                        use_fused_control=True),
        vae=VAEConfig(dtype="bfloat16"))
    cfg = dataclasses.replace(cfg, spacetime=dataclasses.replace(cfg.spacetime,
                                                                 num_steps=OPTIMIZE_STEPS))
    clip_cfg = CLIPConfig(vision=CLIPVisionConfig(dtype="bfloat16"),
                          text=dataclasses.replace(CLIPConfig().text, dtype="bfloat16"))
    t0 = time.perf_counter()
    sd = StableDiffusion.create(cfg, seed=0, device="cuda")
    engine = _spacetime_engine(sd, DCLIPLoss.create(clip_cfg, seed=4, device="cuda"),
                               SERVE_PROMPTS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wrappers = _wrappers()
    requests = [["a cat and a dog near a tree and a car", "a dog left of a car"],
                ["a cat and a dog near a tree and a car"]]
    seeds = [[11, 12], [11]]
    images, launches, batch_s, by_design = [], {k: 0 for k in wrappers}, [], {}
    torch.cuda.reset_peak_memory_stats()
    for prompts, sds in zip(requests, seeds):
        line, u8 = _optimize_batch(engine, wrappers, prompts, sds,
                                   chain_evals("plms", OPTIMIZE_STEPS))
        for k, n in line["launches"].items():
            launches[k] += n
        _add_counts(by_design, line["launches_by_design"])
        batch_s.append(line["seconds"])
        images.append(u8)
        emit({"phase": "optimize_batch", **line})
    repeat_equal = bool(np.array_equal(images[0][0], images[1][0]))
    if not repeat_equal:
        diff = np.abs(images[0][0].astype(int) - images[1][0].astype(int))
        fail(f"optimize: request (prompt, seed 11) served twice differs: "
             f"{int((diff > 0).sum())} bytes, max {int(diff.max())}")
    emit({"phase": "optimize", "requests": sum(map(len, requests)), "batches": len(requests),
          "batch_size": SERVE_PROMPTS, "steps": OPTIMIZE_STEPS, "epochs": sd.cfg.spacetime.epochs,
          "repeat_request_same_bytes": repeat_equal, "setup_s": setup_s,
          "s_per_batch": batch_s, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_by_design": by_design})
    return launches, by_design, engine


DPM_STEPS = 20                  # bench.py's fast method point: DPM-Solver++ at 20 steps


def phase_samplers(engine):
    """DDIM and DPM-Solver++ through the kernels: the float32 chain check
    of phase `chain` for both samplers, then one bf16 optimization batch of
    `engine` (phase `optimize`'s weights and CLIP) through a DPM-Solver++
    chain of DPM_STEPS steps, 3 epochs, 2 prompts x 4 objects, each kernel
    launched opt_launches(k, DPM_STEPS) times."""
    import torch

    phase_chain(("ddim", "dpm"), phase="samplers_chain")
    sd = with_steps(engine.runner.sd, DPM_STEPS)
    dpm = _spacetime_engine(sd, engine.runner.clip_loss, SERVE_PROMPTS, sampler="dpm")
    wrappers = _wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    line, _ = _optimize_batch(dpm, wrappers, ["a cat and a dog near a tree and a car",
                                              "a dog left of a car"], [11, 12],
                              chain_evals("dpm", DPM_STEPS))
    line["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    line["launches_formula"] = {k: opt_launches(k, DPM_STEPS) for k in wrappers}
    emit({"phase": "samplers_optimize", **line})
    return line["launches"]


IMAGE_STRENGTH = 0.75           # img2img: 37 of the 50 DDIM evaluations
UNCOND_BATCH = 4                # the unconditional samples per batch (sample_diffusion's)
DDPM_T = 50                     # the DDPM chain's train schedule, cut from the published 1000
IMAGE_PROMPT = "a red car parked in front of a house"


def _kernels_off(module):
    """Every kernel flag of a built UNet off in place (attention plain,
    feed-forward plain): the same weights through the plain path."""
    from diffusion_spacetime_attn_tpu_torch.models.layers import CrossAttention, GEGLUFeedForward

    for m in module.modules():
        if isinstance(m, CrossAttention):
            m.mha = m.flash = False
        elif isinstance(m, GEGLUFeedForward):
            m.fused = False


def _init_image(size: int = 512):
    """[1, size, size, 3] in [-1, 1]: smooth colour ramps and a square, a
    deterministic stand-in for a photograph."""
    import numpy as np

    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    img = np.stack([x, y, 0.5 + 0.5 * np.sin(6.0 * (x + y))], axis=-1)
    img[size // 4:size // 2, size // 4:size // 2] = (0.9, 0.1, 0.1)
    return img[None] * 2.0 - 1.0


def phase_image_in(root: str, smi: str) -> dict:
    """The image-in paths at SD v1-4 width: img2img (strength 0.75) and
    inpaint (the right half generated), batch 1 under CFG, the VAE encode of
    a 512² image, and the unconditional UNet under DDIM-50 with eta 1 and a
    DDPM chain over a DDPM_T-step train schedule, batch 4.
      1. float32, SLICE_STEPS steps (DDPM: a SLICE_STEPS-step schedule), the
         kernels on vs off on the same weights (the flags turned off in
         place): within 1e-4 + 1e-4·|plain|, launches exactly 16 MHA and 16
         GEGLU per conditional evaluation; the unconditional UNet with
         use_flash too: per evaluation 20 flash (attn1 and attn2 at levels 0
         and 1), 12 MHA (level 2 and mid), 16 GEGLU;
      2. bfloat16 with the entry points' flags (use_mha, use_fused_ff), the
         init image the committed Adam7 palette PNG INIT_FIXTURE and the mask
         the committed 1-bit TIFF MASK_FIXTURE, both read through the CLI's
         loader (`scripts/img2img.read_square`): the
         encode (s per image, equal bytes on a repeat), img2img and inpaint
         through `pipeline/img2img.py` (s per image, launches 16·37 and
         16·50 of MHA and GEGLU, nothing else), then `scripts/img2img.main`
         for each, whose PNG must be the library's image in bytes (same
         seed, same slot); `sample_diffusion.sample_batch` for DDIM-50 (32
         MHA and 16 GEGLU sites per evaluation) and DDPM, then
         `sample_diffusion.main`, whose samples.npz must equal the library
         batch on the script's first key.
    Returns {kernel: launches} over the bf16 runs."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import (
        PipelineConfig,
        ScheduleConfig,
        SpaceTimeConfig,
        UNetConfig,
        VAEConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.pipeline import img2img as i2i
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.scripts import img2img as img2img_cli
    from diffusion_spacetime_attn_tpu_torch.scripts import sample_diffusion as sd_cli
    from diffusion_spacetime_attn_tpu_torch.utils import prng
    from diffusion_spacetime_attn_tpu_torch.utils.cudnn import deterministic
    from diffusion_spacetime_attn_tpu_torch.utils.png import read_png
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer, padded

    dev = torch.device("cuda")
    wrappers = _wrappers()
    total = {k: 0 for k in wrappers}
    init = _init_image()
    mask = np.zeros((1, 512, 512, 1), np.float32)
    mask[:, :, :256] = 1.0                              # keep the left half
    init_t, mask_t = torch.from_numpy(init).to(dev), torch.from_numpy(mask).to(dev)

    def counted(fn, record=False):
        torch.cuda.synchronize()
        _reset_counts(wrappers.values())
        t0 = time.perf_counter()
        with deterministic():
            out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        if record:
            for k, n in counts.items():
                total[k] += n
        return out, counts, seconds

    def want(mha=0, geglu=0, flash=0):
        return {k: {"mha_fwd": mha, "geglu_fwd": geglu, "flash_fwd": flash}.get(k, 0)
                for k in wrappers}

    def check(tag, counts, expected):
        if counts != expected:
            fail(f"image_in {tag}: launches {counts}, expected {expected}")

    def texts(sd):
        """(cond, uncond) embeddings as the CLI tokenizes them."""
        L = sd.cfg.text_encoder.max_len
        tok = padded(make_clip_tokenizer(None, max_len=L), L)
        with torch.inference_mode():
            return tuple(sd.encode_text(np.asarray(tok(t), np.int32)[None])
                         for t in (IMAGE_PROMPT, ""))

    # 1. float32: kernels on vs off, the same weights
    S, key = SLICE_STEPS, prng.PRNGKey(1)
    run = int(IMAGE_STRENGTH * S)          # img2img evaluations: S - start_step
    sd = StableDiffusion.create(PipelineConfig(
        unet=UNetConfig(use_mha=True, use_fused_ff=True),
        spacetime=SpaceTimeConfig(num_steps=S)), seed=0, device=dev)
    cond, uncond = texts(sd)
    f32 = {}
    for on in (True, False):
        if not on:
            _kernels_off(sd.unet)
        a, ca, sa = counted(lambda: i2i.img2img(sd, init_t, cond, uncond, key, IMAGE_STRENGTH))
        b, cb, sb = counted(lambda: i2i.inpaint(sd, init_t, mask_t, cond, uncond, key))
        check(f"f32 img2img {on}", ca, want(16 * run, 16 * run) if on else want())
        check(f"f32 inpaint {on}", cb, want(16 * S, 16 * S) if on else want())
        f32[on] = {"img2img": a, "inpaint": b}
    del sd, cond, uncond
    torch.cuda.empty_cache()
    unet, vae = sd_cli.build_models(UNetConfig(dtype="float32", use_mha=True, use_fused_ff=True,
                                               use_flash=True), VAEConfig(dtype="float32"), dev)
    for on in (True, False):
        if not on:
            _kernels_off(unet)
        c, cc, _ = counted(lambda: sd_cli.sample_batch(unet, vae, key, UNCOND_BATCH, 64,
                                                       ScheduleConfig(), S, 1.0))
        d, cd, _ = counted(lambda: sd_cli.sample_batch(
            unet, vae, key, UNCOND_BATCH, 64, ScheduleConfig(num_train_timesteps=S),
            vanilla=True))
        for tag, counts in (("uncond ddim", cc), ("uncond ddpm", cd)):
            check(f"f32 {tag} {on}", counts, want(12 * S, 16 * S, 20 * S) if on else want())
        f32[on].update({"uncond_ddim": c, "uncond_ddpm": d})
    del unet, vae
    torch.cuda.empty_cache()
    errs = {}
    for k, want_img in f32[False].items():
        got = f32[True][k]
        errs[k] = float((got - want_img).abs().max())
        if not (torch.isfinite(got).all()
                and torch.allclose(got, want_img, atol=1e-4, rtol=1e-4)):
            fail(f"image_in f32 {k}: kernels on vs off max diff {errs[k]} "
                 "over 1e-4 + 1e-4·|plain|")
    emit({"phase": "image_in_f32", "steps": S, "img2img_evals": run,
          "batch": {"img2img": 1, "inpaint": 1, "uncond": UNCOND_BATCH},
          "max_abs_diff": errs, "tol": [1e-4, 1e-4],
          "image_std": {k: float(v.std()) for k, v in f32[False].items()}})
    del f32

    # 2. bfloat16 with the entry points' flags, on the committed init and
    # mask files, which the library takes through the CLI's own loader
    init_png = os.path.join(FIXTURES, INIT_FIXTURE)
    mask_tif = os.path.join(FIXTURES, MASK_FIXTURE)
    base = ["--init", init_png, "--prompt", IMAGE_PROMPT, "--outdir", root]
    args = img2img_cli.parse_args(base)
    cfg = img2img_cli.pipeline_config(args)
    init_t = torch.from_numpy(img2img_cli.read_square(init_png, args.size).astype(np.float32)
                              [None] / 127.5 - 1.0).to(dev)
    mask_t = torch.from_numpy(img2img_cli.read_square(mask_tif, args.size, grey=True)
                              .astype(np.float32)[None, :, :, None] / 255.0).to(dev)
    S = cfg.spacetime.num_steps
    run = int(IMAGE_STRENGTH * S)          # img2img evaluations: S - start_step
    sd = StableDiffusion.create(cfg, seed=0, device=dev)
    cond, uncond = texts(sd)
    key = prng.PRNGKey(1)                    # the CLI's default --seed
    line = {"phase": "image_in", "dtype": "bfloat16", "steps": S, "img2img_evals": run,
            "init": INIT_FIXTURE, "mask": MASK_FIXTURE,
            "mask_kept": float(mask_t.mean()), "nvidia_smi": smi}
    enc = [counted(lambda: sd.encode_images(init_t, key)) for _ in range(4)]
    z = [e[0] for e in enc]
    check("encode", enc[-1][1], want())
    line["encode_s_per_image"] = [e[2] for e in enc[1:]]
    if not (torch.isfinite(z[0].float()).all() and torch.equal(z[0], z[1])):
        fail("image_in encode: not finite or not the same bytes on a repeat")
    for mode in ("img2img", "inpaint"):
        if mode == "img2img":
            out, counts, s = counted(lambda: i2i.img2img(sd, init_t, cond, uncond, key,
                                                         IMAGE_STRENGTH), record=True)
            evals, argv = run, base
        else:
            out, counts, s = counted(lambda: i2i.inpaint(sd, init_t, mask_t, cond, uncond, key),
                                     record=True)
            evals, argv = S, base + ["--mask", mask_tif]
        check(f"bf16 {mode}", counts, want(16 * evals, 16 * evals))
        img = (out[0].float().cpu().numpy() * 255.0 + 0.5).astype(np.uint8)
        path, cli_counts, cli_s = counted(lambda: img2img_cli.main(argv), record=True)
        check(f"bf16 {mode} cli", cli_counts, want(16 * evals, 16 * evals))
        same = bool(np.array_equal(read_png(path), img))
        line[mode] = {"s_per_image": s, "cli_s": cli_s, "evals": evals, "launches": counts,
                      "finite": bool(torch.isfinite(out).all()), "image_std": float(img.std()),
                      "cli_png_equal": same}
        if not (line[mode]["finite"] and same and img.std() > 0):
            fail(f"image_in {mode}: {line[mode]}")
    del sd, cond, uncond
    torch.cuda.empty_cache()

    logdir = os.path.join(root, "uncond")
    sargv = ["-n", str(UNCOND_BATCH), "--batch-size", str(UNCOND_BATCH), "--npz", "-l", logdir]
    ucfg, vcfg, hw, scfg = sd_cli.configs(sd_cli.parse_args(sargv))
    unet, vae = sd_cli.build_models(ucfg, vcfg, dev)
    rng = prng.split(prng.PRNGKey(42), 3)[2]      # the script's key tree, first batch
    _, k = prng.split(rng)
    steps = 50
    (ddim, counts, s) = counted(lambda: sd_cli.sample_batch(unet, vae, k, UNCOND_BATCH, hw,
                                                            scfg, steps, 1.0), record=True)
    check("bf16 uncond ddim", counts, want(32 * steps, 16 * steps))
    ddpm_cfg = ScheduleConfig(num_train_timesteps=DDPM_T)
    (ddpm, dcounts, ds) = counted(lambda: sd_cli.sample_batch(unet, vae, k, UNCOND_BATCH, hw,
                                                              ddpm_cfg, vanilla=True),
                                  record=True)
    check("bf16 uncond ddpm", dcounts, want(32 * DDPM_T, 16 * DDPM_T))
    del unet, vae
    torch.cuda.empty_cache()
    res, ccounts, cs = counted(lambda: sd_cli.main(sargv), record=True)
    check("bf16 sample_diffusion cli", ccounts, want(32 * steps, 16 * steps))
    npz = np.load(os.path.join(logdir, "samples.npz"))["arr_0"]
    lib8 = (ddim.float().cpu().numpy() * 255.0 + 0.5).clip(0, 255).astype(np.uint8)
    line["uncond"] = {"batch": UNCOND_BATCH, "ddim_steps": steps, "eta": 1.0,
                      "ddim_s_per_image": s / UNCOND_BATCH, "ddim_launches": counts,
                      "ddpm_train_steps": DDPM_T, "ddpm_s_per_image": ds / UNCOND_BATCH,
                      "ddpm_launches": dcounts, "cli_s": cs,
                      "cli_npz_equal": bool(np.array_equal(npz, lib8)),
                      "finite": bool(torch.isfinite(ddim).all() and torch.isfinite(ddpm).all()),
                      "image_std": float(lib8.std()),
                      "files": sorted(os.listdir(logdir))}
    emit(line)
    u = line["uncond"]
    if not (u["cli_npz_equal"] and u["finite"] and u["image_std"] > 0
            and u["files"] == [f"{i:06}.png" for i in range(UNCOND_BATCH)]
            + ["samples.npz", "sampling_config.json"]):
        fail(f"image_in uncond: {u}")
    return total


TESTBED_ARRAYS = 583            # ext-1 arrays in saved/testbed/{unet,vae,clip}.msgpack


def _within(got, want, atol: float, rtol: float) -> float:
    """max |got − want| / (atol + rtol·|want|) over the elements (≤ 1 holds)."""
    import torch

    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def phase_testbed():
    """The closed-loop testbed on the committed trained weights (float32,
    every kernel flag off, as the JAX testbed run; TF32 off): the trees read
    by the port's msgpack reader, the oracle's self-check, the card against
    the port on the CPU in this process (text embeddings; vanilla PLMS-50
    images; generation_loss and its dcoef through PLMS-10), and one protocol
    cell on the card (batch 0 of 25 prompts, seed 0, PLMS-50, 3 epochs, both
    arms), whose vanilla recall must reach 0.5 (r05's is 0.922)."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.pipeline.spacetime import generation_loss, init_coef
    from diffusion_spacetime_attn_tpu_torch.scripts import method_eval_testbed as tme
    from diffusion_spacetime_attn_tpu_torch.testbed import oracle, scenes
    from diffusion_spacetime_attn_tpu_torch.testbed.bundle import load_bundle, load_trees
    from diffusion_spacetime_attn_tpu_torch.utils.cudnn import deterministic

    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "saved", "testbed")
    t0 = time.perf_counter()
    trees = load_trees(ckpt)
    read_s = time.perf_counter() - t0
    n_arrays = sum(len(t) for t in trees.values())
    n_bytes = sum(int(a.nbytes) for t in trees.values() for a in t.values())
    if n_arrays != TESTBED_ARRAYS:
        fail(f"testbed: {n_arrays} arrays read, expected {TESTBED_ARRAYS}")
    check = oracle.oracle_self_check()
    if check != {"n_scenes": 50, "recall": 1.0, "precision": 1.0}:
        fail(f"testbed: oracle self-check {check}")
    t0 = time.perf_counter()
    card = {n: load_bundle(ckpt, num_steps=n, device="cuda") for n in (50, 10)}
    torch.cuda.synchronize()
    bundle_s = time.perf_counter() - t0
    cpu = {n: load_bundle(ckpt, num_steps=n, device="cpu") for n in (50, 10)}
    prompts = scenes.make_eval_prompts(2, seed=777)
    gs = card[50].sd.cfg.spacetime.guidance_scale
    def loss_and_grad(b, inputs):
        st = b.sd.cfg.spacetime
        coef = init_coef(inputs.active, st.num_steps, st.init_coef).requires_grad_()
        with deterministic():
            loss, _ = generation_loss(coef, b.sd, b.clip_loss, inputs, st)
            loss.backward()
        return loss.detach().cpu(), coef.grad.cpu()

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    errs, out = {}, {}
    for name, b in (("card", card), ("cpu", cpu)):
        dev = b[50].sd.device
        inputs = tme.embed_batch(b[50], prompts, tme.initial_noise(0, 0, 2, 16, dev))
        with deterministic():
            images = tme.vanilla_images(b[50], inputs, gs, "plms")
        out[name] = (inputs, images.cpu()) + loss_and_grad(b[10], inputs)
    (ci, cimg, closs, cg), (pi, pimg, ploss, pg) = out["card"], out["cpu"]
    # the CPU's own floor: the same loss and gradient with the caption
    # embeddings moved by 1e-7 relative (a few f32 roundings)
    noise = torch.randn(pi.cond.shape, generator=torch.Generator().manual_seed(0))
    floor_loss, floor_g = loss_and_grad(cpu[10], pi._replace(cond=pi.cond * (1 + 1e-7 * noise)))
    for k in ("cond", "uncond", "local_contexts"):
        errs[f"{k}_ratio"] = _within(getattr(ci, k), getattr(pi, k), 1e-4, 1e-4)
    errs["images_max_abs"] = float((cimg - pimg).abs().max())
    errs["loss_rel"] = float((closs - ploss).abs() / ploss.abs())
    errs["dcoef_rel_norm"] = rel(cg, pg)
    finite = bool(torch.isfinite(cimg).all() and torch.isfinite(cg).all())
    # dcoef through the 10-step chain moves by ~3e-3 (relative norm) on the
    # CPU itself when the embeddings move by 1e-7 (`cpu_floor_*`), so its
    # limit is 1e-2, not the chain phase's 1e-3; TF32 convolutions gave 0.80
    limits = {"cond_ratio": 1.0, "uncond_ratio": 1.0, "local_contexts_ratio": 1.0,
              "images_max_abs": 1e-3, "loss_rel": 1e-3, "dcoef_rel_norm": 1e-2}
    emit({"phase": "testbed_parity", "prompts": len(prompts), "arrays": n_arrays,
          "bytes": n_bytes, "read_s": read_s, "bundle_s": bundle_s, "oracle_self_check": check,
          "limits": {**limits, "embeddings": "|card - cpu| <= 1e-4 + 1e-4·|cpu| (ratio <= 1)"},
          **errs, "cpu_floor_loss_rel": float((floor_loss - ploss).abs() / ploss.abs()),
          "cpu_floor_dcoef_rel_norm": rel(floor_g, pg),
          "loss": float(ploss), "dcoef_norm": float(torch.linalg.vector_norm(pg)),
          "finite": finite})
    if not finite:
        fail("testbed: non-finite card images or gradient")
    bad = [k for k in limits if not errs[k] <= limits[k]]
    if bad:
        fail(f"testbed: card vs CPU over the limit: {[(k, errs[k]) for k in bad]}")
    del cpu, out
    # one protocol cell on the card: batch 0, seed 0
    bp = scenes.make_eval_prompts(100, seed=777)[:25]
    torch.cuda.reset_peak_memory_stats()
    cell = tme.run_cell(card[50], card[50].sd.cfg.spacetime, bp, len(bp), 0, 0)
    if not all(bool(torch.isfinite(cell[k]).all()) for k in ("vanilla", "method", "losses")):
        fail("testbed: the protocol cell gave non-finite images or losses")
    means = {f"{arm}_{k}": float(np.mean([r[arm][k] for r in cell["rows"]]))
             for arm in ("vanilla", "method") for k in ("recall", "relation", "clip")}
    emit({"phase": "testbed_cell", "batch": 0, "seed": 0, "prompts": len(bp),
          "steps": card[50].sd.schedule.num_steps, "epochs": card[50].sd.cfg.spacetime.epochs,
          **means, "vanilla_s": cell["vanilla_s"], "method_s": cell["method_s"],
          "losses": cell["losses"].tolist(),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    if means["vanilla_recall"] < 0.5:
        fail(f"testbed: vanilla recall {means['vanilla_recall']} < 0.5 (weights mis-loaded?)")


GOLDEN = "The silver bed was situated to the right of the white couch."
# phase layout: the README golden sentence, the five prompts of
# tests/test_batch_runner.py (one without a COCO object), two with relations
LAYOUT_CAPTIONS = [GOLDEN, "a dog to the left of a cat", "a car above a bench",
                   "no objects here at all", "the bird sits on a chair",
                   "a cup next to a laptop",
                   "The cup is left of the fork and the fork is left of the bowl.",
                   "A blue boat was parked between a car to its right and a bicycle to its left."]
# phase runner's mscoco.txt: index 2 repeats index 0 (the same seed: the
# same PNG bytes; at batch 2 it is in the same slot of the next batch, since
# a bf16 UNet row differs by an ulp between slots, phase slot), index 3 has
# no COCO object (skipped)
RUNNER_CAPTIONS = [GOLDEN, "a dog to the left of a cat", GOLDEN, "no objects here at all"]
RUNNER_FILES = [f"final2_s1_index_{i}.png" for i in (0, 1, 2)]
RUNNER_SPACETIME_STEPS = 10     # the spacetime sweep's PLMS steps
RUNNER_STEPS = 25               # the vanilla and spatial sweeps' PLMS steps (cut from 50)
# kernels each sweep mode runs (run_dataset's per-mode flags): MHA and GEGLU
# everywhere outside spacetime mode, the spacetime forward where there is
# control, flash and every backward in spacetime mode (MHA off there)
RUNNER_MODES = {
    "vanilla": ("geglu_fwd", "mha_fwd"),
    "spatial": ("geglu_fwd", "mha_fwd", "spacetime_fwd"),
    "spacetime": ("spacetime_fwd", "spacetime_bwd", "geglu_fwd", "geglu_bwd", "flash_fwd",
                  "flash_bwd"),
}


def _components(raw, tok_idx, centers):
    """The GMM component each decoded center is the mean of, per mention."""
    import numpy as np

    k = raw.shape[-1] // 6
    return [int(np.argmin(np.abs(raw[t, k:2 * k] - c[0]) + np.abs(raw[t, 2 * k:3 * k] - c[1])))
            for t, c in zip(tok_idx, centers)]


def phase_layout():
    """The layout predictor at LayoutConfig() (RoBERTa-base: 768 wide, 12
    layers, vocabulary 50,265, max_len 128), seeded random weights, float32,
    TF32 off, through LayoutInference with the relation-aware decode, on the
    card against the port on the CPU with the same weights: every center
    within 1e-4 and the same decoded components; ms per caption on the card."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig
    from diffusion_spacetime_attn_tpu_torch.models.layout.model import (
        LayoutPredictor,
        create_layout_predictor,
    )
    from diffusion_spacetime_attn_tpu_torch.pipeline import frontend
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_roberta_tokenizer

    cfg = LayoutConfig()
    t0 = time.perf_counter()
    card = create_layout_predictor(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cpu = LayoutPredictor(cfg).eval().requires_grad_(False)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    n_params = sum(p.numel() for p in card.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in card.parameters())
    tok = make_roberta_tokenizer()
    infer = {"card": frontend.LayoutInference(card, tok),
             "cpu": frontend.LayoutInference(cpu, tok)}
    raws = {}
    for name, inf in infer.items():      # keep each forward's raw output for the decode check
        fwd = inf._forward

        def keep(tokens, object_pos, _fwd=fwd, _name=name):
            xy, raw = _fwd(tokens, object_pos)
            raws[_name] = raw
            return xy, raw

        inf._forward = keep
    worst, n_objects, n_relations, rows = 0.0, 0, 0, []
    for s in LAYOUT_CAPTIONS:
        got, want = infer["card"](s), infer["cpu"](s)
        if (got is None) != (want is None) or (got and list(got) != list(want)):
            fail(f"layout: card {got} vs cpu {want} for {s!r}")
        if got is None:
            rows.append({"caption": s, "objects": 0})
            continue
        words, mentions = frontend.extract_objects(s)
        rels = frontend.extract_relations(words, mentions)
        align = tok.encode_with_alignment(words)[1]
        tok_idx = [align[m.word_index] for m in mentions]
        res = {"card": got, "cpu": want}
        comps = {n: _components(raws[n], tok_idx, [res[n][m.phrase] for m in mentions])
                 for n in res}
        if comps["card"] != comps["cpu"]:
            fail(f"layout: components {comps} differ for {s!r}")
        err = max(abs(a - b) for k in got for a, b in zip(got[k], want[k]))
        worst = max(worst, err)
        n_objects += len(mentions)
        n_relations += len(rels)
        rows.append({"caption": s, "objects": len(mentions), "relations": len(rels),
                     "components": comps["card"], "max_abs_err": err})
    if worst > 1e-4:
        fail(f"layout: card vs cpu centers {worst} > 1e-4")
    if n_relations < 3:
        fail(f"layout: only {n_relations} relations decoded")
    inf = infer["card"]
    inf(LAYOUT_CAPTIONS[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        for s in LAYOUT_CAPTIONS:
            inf(s)
    per_caption_ms = 1e3 * (time.perf_counter() - t0) / (reps * len(LAYOUT_CAPTIONS))
    with torch.inference_mode():
        ids = torch.ones((1, cfg.max_len), dtype=torch.int64, device="cuda")
        opos = torch.zeros((1, cfg.max_len), device="cuda")
        forward_ms = cuda_ms(lambda: card(ids, opos), 20)
    golden = infer["card"](GOLDEN)
    print(f"Sentence: {GOLDEN}", flush=True)
    for phrase, (x, y) in golden.items():
        print(f"{phrase} position: ({x:.3f}, {y:.3f})", flush=True)
    emit({"phase": "layout", "config": "LayoutConfig()", "params": n_params, "bytes": n_bytes,
          "setup_s": setup_s, "captions": len(LAYOUT_CAPTIONS), "objects": n_objects,
          "relations": n_relations, "max_abs_err": worst, "limit": 1e-4,
          "ms_per_caption": per_caption_ms, "forward_ms": forward_ms, "rows": rows})
    del card, cpu, infer
    torch.cuda.empty_cache()


def phase_runner(root: str):
    """The sweep entry point (`run_dataset.main`, in this process) at SD
    v1-4 width with seeded random weights, bf16, seed 1, on a `mscoco.txt`
    of RUNNER_CAPTIONS: vanilla and spatial at batch 1 and PLMS-RUNNER_STEPS,
    spacetime through BatchedRunner at batch 2 with 3 epochs and
    PLMS-RUNNER_SPACETIME_STEPS.
    Per mode: the expected PNGs (the skipped prompt absent), the manifest, a
    `--resume` call that makes nothing, equal PNG bytes for the repeated
    (prompt, seed), and launches of exactly RUNNER_MODES[mode] (spacetime:
    each opt_launches(k, 11) per batch; vanilla and spatial 416 per prompt).
    Returns ({kernel: launches over the modes}, the spacetime outdir)."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.scripts import run_dataset
    from diffusion_spacetime_attn_tpu_torch.utils.png import read_png

    data = os.path.join(root, "data")
    os.makedirs(data, exist_ok=True)
    with open(os.path.join(data, "mscoco.txt"), "w") as f:
        f.write("\n".join(RUNNER_CAPTIONS) + "\n")
    wrappers = _wrappers()
    total = {k: 0 for k in wrappers}
    for mode, kernels in RUNNER_MODES.items():
        out = os.path.join(root, mode)
        batch = 2 if mode == "spacetime" else 1
        steps = RUNNER_SPACETIME_STEPS if mode == "spacetime" else RUNNER_STEPS
        evals = chain_evals("plms", steps)
        args = ["--dataset", "mscoco", "--data-root", data, "--mode", mode, "--seed", "1",
                "--outdir", out, "--batch-size", str(batch), "--steps", str(steps)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(wrappers.values())
        t0 = time.perf_counter()
        summary = run_dataset.main(args)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        produced = summary["produced"]
        if mode == "spacetime":
            batches = -(-len(RUNNER_CAPTIONS) // batch)
            want = {k: batches * opt_launches(k, evals) if k in kernels else 0 for k in wrappers}
        else:
            want = {k: produced * 16 * evals if k in kernels else 0 for k in wrappers}
        if counts != want:
            fail(f"runner {mode}: launches {counts}, expected {want}")
        files = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        if files != RUNNER_FILES or produced != len(RUNNER_FILES):
            fail(f"runner {mode}: files {files}, produced {produced}")
        with open(os.path.join(out, "manifest_mscoco.json")) as f:
            manifest = json.load(f)
        if manifest != {"done": list(range(len(RUNNER_CAPTIONS)))}:
            fail(f"runner {mode}: manifest {manifest}")
        with open(os.path.join(out, RUNNER_FILES[0]), "rb") as f0, \
                open(os.path.join(out, RUNNER_FILES[2]), "rb") as f2:
            repeat_equal = f0.read() == f2.read()
        if not repeat_equal:
            fail(f"runner {mode}: the repeated (prompt, seed) gave other PNG bytes")
        imgs = [read_png(os.path.join(out, f)) for f in files]
        if any(im.shape != (512, 512, 3) or float(im.std()) == 0.0 for im in imgs):
            fail(f"runner {mode}: images {[(im.shape, float(im.std())) for im in imgs]}")
        _reset_counts(wrappers.values())
        t0 = time.perf_counter()
        again = run_dataset.main(args + ["--resume"])
        resume_s = time.perf_counter() - t0
        relaunched = {k: w.launches for k, w in wrappers.items() if w.launches}
        if again["produced"] != 0 or relaunched:
            fail(f"runner {mode}: --resume produced {again['produced']}, launched {relaunched}")
        for k, n in counts.items():
            total[k] += n
        emit({"phase": "runner", "mode": mode, "batch_size": batch, "steps": steps,
              "prompts": len(RUNNER_CAPTIONS), "produced": produced, "files": files,
              "sweep_s": summary["seconds"], "call_s": call_s,
              "s_per_prompt": summary["seconds"] / produced, "resume_s": resume_s,
              "repeat_same_png_bytes": repeat_equal, "launches": counts,
              "max_memory_allocated_bytes": peak,
              "image_mean": float(np.mean([im.mean() for im in imgs]))})
    return total, os.path.join(root, "spacetime")


def phase_eval(root: str, results: str):
    """The port's CLIP grid detector (ViT-B/32 width, seeded random
    weights, float32) and the protocol's scoring over phase runner's
    spacetime images, with the ground truth the front end extracts from
    RUNNER_CAPTIONS (an mscoco.pkl): finite scores, recall and relation
    accuracy in [0, 1], seconds per image; and on the first image's first
    scoring batch (its grid of crops) the card's crop scores (cosine
    similarity to each category's text) against the port on the CPU with
    the same weights, within 1e-3."""
    import pickle

    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import CLIPConfig
    from diffusion_spacetime_attn_tpu_torch.eval import clip_detector, protocol
    from diffusion_spacetime_attn_tpu_torch.models.clip import CLIP
    from diffusion_spacetime_attn_tpu_torch.pipeline import frontend

    data = os.path.join(root, "data")
    rows = []
    for s in RUNNER_CAPTIONS:
        words, mentions = frontend.extract_objects(s)
        first = {}
        for m in mentions:
            first.setdefault(m.category, m.word_index)
        rels = [[first[a], first[b], r] for a, b, r in frontend.extract_relations(words, mentions)]
        rows.append([s, words, [m.word_index for m in mentions], rels,
                     [m.phrase for m in mentions]])
    with open(os.path.join(data, "mscoco.pkl"), "wb") as f:
        pickle.dump(rows, f)
    files = protocol.list_result_files(results, (0, len(RUNNER_CAPTIONS)), epoch=2, seed=1)
    if files != RUNNER_FILES:
        fail(f"eval: result files {files}")
    t0 = time.perf_counter()
    det, provenance = protocol.build_clip_detector(cfg=CLIPConfig(), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # card vs CPU: the first scoring batch of the first image
    im = protocol.read_image01(os.path.join(results, files[0]))
    size = im.shape[0]
    boxes = clip_detector._grid_boxes(size, det.scales)
    cpu_clip = CLIP(CLIPConfig()).eval().requires_grad_(False)
    cpu_clip.load_state_dict({k: v.cpu() for k, v in det.clip.state_dict().items()})
    cpu_det = clip_detector.CLIPDetector(cpu_clip, protocol._clip_tokenize(CLIPConfig(), None),
                                         categories=det.categories)
    sims_err = float(np.abs(det._sims(im, boxes) - cpu_det._sims(im, boxes)).max())
    if not sims_err <= 1e-3:
        fail(f"eval: card vs cpu crop scores differ by {sims_err} > 1e-3")
    del cpu_det, cpu_clip
    calls = det.embed_calls
    t0 = time.perf_counter()
    detections = protocol.detect_folder(results, det, files)
    detect_s = time.perf_counter() - t0
    scores = protocol.score_results(results, "mscoco", data, detections,
                                    prompt_range=(0, len(RUNNER_CAPTIONS)), epoch=2, seed=1)
    clip_loss, tokenize, cs_prov = protocol.build_clip_loss(cfg=CLIPConfig(), device="cuda")
    cs = protocol.clip_score_results(results, "mscoco", data, clip_loss, tokenize,
                                     prompt_range=(0, len(RUNNER_CAPTIONS)), epoch=2, seed=1)
    det_scores = [r[5] for rs in detections.values() for r in rs]
    ok = (all(np.isfinite(det_scores)) and all(0.0 <= s <= 1.0 for s in det_scores)
          and 0.0 <= scores["object_recall"] <= 1.0 and 0.0 <= scores["relation_accuracy"] <= 1.0
          and scores["n_images"] == len(files) and cs["mean_clip_score"] is not None
          and np.isfinite(cs["mean_clip_score"]))
    emit({"phase": "eval", "images": len(files), "image_size": size, "grid_boxes": len(boxes),
          "setup_s": setup_s, "detect_s": detect_s, "s_per_image": detect_s / len(files),
          "embed_calls": det.embed_calls - calls, "card_vs_cpu_crop_score_err": sims_err,
          "limit": 1e-3, **scores, **cs,
          "sd_weights": "random", "layout_weights": "random", "detector_weights": provenance,
          "clip_score_weights": cs_prov, "detections": sum(map(len, detections.values()))})
    if not ok:
        fail(f"eval: scores out of range: {scores}, {cs}")


# phase ingest: seeded synthetic checkpoints in the published layouts
INGEST_SEED = 2026
INGEST_PROMPT = "a black cat sitting on a desk next to a laptop"
# the JAX drill's report keys (scripts/ingest_weights.py)
DRILL_KEYS = ["prompt", "steps", "epochs", "seed", "sampler", "sd_weights", "layout_weights",
              "clip_weights", "vanilla_clip_score", "vanilla_image", "method_clip_score",
              "method_image"]
# the drill's PLMS steps (DRILL_STEPS + 1 UNet evaluations, one prompt); its
# UNet flags are flash, GEGLU and the spacetime kernel (MHA off)
DRILL_STEPS = 10
DRILL_METHOD = ("spacetime_fwd", "spacetime_bwd", "geglu_fwd", "geglu_bwd", "flash_fwd",
                "flash_bwd")


def _pmap(fn, items, workers: int = 8) -> list:
    """fn over items in threads (numpy's generators and torch's ops release
    the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


def _fstype(path: str) -> str:
    """The file system holding `path` (its longest mount point)."""
    best = ("", "unknown")
    with open("/proc/self/mounts") as f:
        for line in f:
            mnt, fstype = line.split()[1:3]
            inside = os.path.abspath(path).startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) > len(best[0]):
                best = (mnt, fstype)
    return best[1]


def _drill_want(mode: str, wrappers) -> dict:
    evals = chain_evals("plms", DRILL_STEPS)
    if mode == "vanilla":
        want = {"geglu_fwd": 16 * evals, "flash_fwd": 10 * evals}
    else:
        want = {k: opt_launches(k, evals) for k in DRILL_METHOD}
    return {k: want.get(k, 0) for k in wrappers}


def _write_f16_safetensors(path: str, arrays: dict) -> None:
    """The safetensors format by hand: header length, JSON header, float16
    bytes in order."""
    import struct

    import numpy as np

    header, pos = {}, 0
    for k, v in arrays.items():
        n = 2 * v.size
        header[k] = {"dtype": "F16", "shape": list(v.shape), "data_offsets": [pos, pos + n]}
        pos += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for v in arrays.values():
            v.astype(np.float16).tofile(f)


def _write_ingest_files(root: str) -> dict:
    """(a) a CompVis `.ckpt` at the v1-inference widths in float32, with
    `model_ema.*` entries, the text tower's `position_ids` and a callback
    object of a module that cannot be imported; (b) the same weights as a
    float16 `.safetensors`; (c) an OpenAI ViT-B/32 state dict; (d) a fairseq
    Rel2Bbox `.pth` at LayoutConfig().  Every float N(0, 0.02²) from
    `utils/testing.seeded_normal`.  Returns {name: path} and the seconds."""
    import types

    import torch

    from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig, PipelineConfig
    from diffusion_spacetime_attn_tpu_torch.utils import testing

    cfg = PipelineConfig()
    paths = {k: os.path.join(root, n) for k, n in (
        ("ckpt", "sd-v1-4.ckpt"), ("safetensors", "sd-v1-4-fp16.safetensors"),
        ("clip", "ViT-B-32.pt"), ("layout", "checkpoint_90_0.0.pth"))}
    t0 = time.perf_counter()
    sd = testing.seeded_state_dict(testing.compvis_shapes(cfg), INGEST_SEED)
    gen_s = time.perf_counter() - t0
    state = {k: torch.from_numpy(v) for k, v in sd.items()}
    state["model_ema.decay"] = torch.tensor(0.9999)
    state["model_ema.num_updates"] = torch.tensor(470000, dtype=torch.int32)
    state["cond_stage_model.transformer.text_model.embeddings.position_ids"] = \
        torch.arange(CONTEXT_LEN)[None]
    mod = types.ModuleType("dsta_uninstalled_callbacks")
    mod.ModelCheckpoint = type("ModelCheckpoint", (), {"__module__": mod.__name__})
    sys.modules[mod.__name__] = mod
    try:
        callback = mod.ModelCheckpoint()
        callback.best_model_path = "last.ckpt"
        torch.save({"state_dict": state, "global_step": 470000,
                    "callbacks": {"ModelCheckpoint": callback}}, paths["ckpt"])
    finally:
        del sys.modules[mod.__name__]
    _write_f16_safetensors(paths["safetensors"], sd)
    del state, sd
    clip = testing.seeded_state_dict(testing.openai_clip_shapes(cfg.loss_clip), INGEST_SEED + 1)
    torch.save({k: torch.from_numpy(v) for k, v in clip.items()}, paths["clip"])
    lay = testing.seeded_state_dict(testing.rel2bbox_shapes(LayoutConfig()), INGEST_SEED + 2)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in lay.items()}, "log": {},
                "n_steps": 0}, paths["layout"])
    for path in paths.values():     # on disk, so that a reader can drop them from the cache
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    return paths, gen_s, time.perf_counter() - t0


def ingest_load_child(path: str) -> None:
    """Run in a process of its own (`python3 -c`), so that its peak RSS is the
    load's (VmRSS sampled every 5 ms from before the load to its end;
    getrusage's ru_maxrss, also printed, carries the parent's peak over
    fork and exec): `load_stable_diffusion(PipelineConfig(), path)` onto
    the card in float32, the file first dropped from the page cache
    (`posix_fadvise(DONTNEED)` after the writer's fsync), timed by part
    (`read`: the reader, memory-mapped for a zip archive, so its bytes are
    paged in during `upload`; `convert`: the converters and flattening;
    `upload`: building the modules on the card and copying each weight once),
    then every parameter held against its generating array: matched by shape
    and its first 8 values (drawn alone) to exactly one published key, then
    equal to the whole array (after the float16 rounding for a
    .safetensors).  Prints one JSON line."""
    import resource

    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import PipelineConfig
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.utils import convert, loader, testing

    def rss_bytes():
        with open("/proc/self/status") as f:
            return int(next(ln for ln in f if ln.startswith("VmRSS:")).split()[1]) * 1024

    torch.zeros(1, device="cuda")
    fd = os.open(path, os.O_RDONLY)     # read from the disk, not the page cache
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    # the load's peak RSS, sampled: getrusage's ru_maxrss (also printed)
    # carries the parent's peak over fork and exec
    rss_before, peak, stop = rss_bytes(), [0], threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], rss_bytes())
            stop.wait(0.005)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    times = {}
    read, from_flat = convert.load_torch_checkpoint, StableDiffusion.from_flat.__func__

    def timed_read(p):
        t = time.perf_counter()
        out = read(p)
        times["read_s"] = time.perf_counter() - t
        times["read_dtypes"] = sorted({str(v.dtype) for v in out.values()})
        return out

    def timed_upload(cls, *a, **k):
        t = time.perf_counter()
        out = from_flat(cls, *a, **k)
        torch.cuda.synchronize()
        times["upload_s"] = time.perf_counter() - t
        return out

    convert.load_torch_checkpoint = timed_read
    StableDiffusion.from_flat = classmethod(timed_upload)
    cfg = PipelineConfig()
    t0 = time.perf_counter()
    sd = loader.load_stable_diffusion(cfg, path, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    stop.set()
    sampler.join()
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    card = torch.cuda.memory_allocated()
    f16 = path.endswith(".safetensors")

    def want(key, shape):
        a = testing.seeded_normal(INGEST_SEED, key, shape)
        return a.astype(np.float16).astype(np.float32) if f16 else a

    t1 = time.perf_counter()
    shapes = testing.compvis_shapes(cfg)
    index = {(s, want(k, (min(8, math.prod(s)),)).tobytes()): k for k, s in shapes.items()}
    params = [(f"{mname}.{pname}", p.detach().cpu())
              for mname, m in (("unet", sd.unet), ("vae", sd.vae), ("text", sd.text_encoder))
              for pname, p in m.state_dict().items()]

    def check(item):
        name, host = item
        key = index.get((tuple(host.shape), host.reshape(-1)[:8].numpy().tobytes()))
        ok = (key is not None and host.dtype == torch.float32
              and torch.equal(host, torch.from_numpy(want(key, shapes[key]))))
        return name, key, ok

    matched, bad = {}, []
    for name, key, ok in _pmap(check, params):
        if not ok or key in matched:
            bad.append(name)
        else:
            matched[key] = name
    print(json.dumps({
        "file": os.path.basename(path), "bytes": os.path.getsize(path), "load_s": total,
        "read_s": times["read_s"], "read_dtypes": times["read_dtypes"],
        "upload_s": times["upload_s"],
        "convert_s": total - times["read_s"] - times["upload_s"],
        "peak_rss_bytes": peak[0], "rss_before_load_bytes": rss_before,
        "getrusage_maxrss_bytes": maxrss,
        "card_memory_allocated_bytes": card, "params": len(matched),
        "published_keys": len(shapes), "unmatched_params": bad[:10], "n_unmatched": len(bad),
        "keys_without_param": sorted(set(shapes) - set(matched))[:10],
        "exact": not bad and len(matched) == len(shapes), "verify_s": time.perf_counter() - t1}),
        flush=True)


def _start_ingest_load(path: str):
    """`ingest_load_child(path)` in a process of its own, started now."""
    return subprocess.Popen([sys.executable, "-c",
                             "import sys, chip_smoke; chip_smoke.ingest_load_child(sys.argv[1])",
                             path], cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_ingest_load(proc, path: str, smi: str) -> dict:
    """Wait for a `_start_ingest_load` process and check its line."""
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        fail(f"ingest: loading {path} failed:\n{stderr[-4000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    emit({"phase": "ingest_load", **out, "nvidia_smi": smi})
    if not out["exact"]:
        fail(f"ingest: {out['file']} did not load parameter-exact: {out}")
    # the reader keeps a .safetensors file's float16 to the card (the casts run there)
    want = ["float16"] if path.endswith(".safetensors") else ["float32"]
    if out["read_dtypes"] != want:
        fail(f"ingest: {out['file']} read as {out['read_dtypes']}, expected {want}")
    return out


def _toy_bpe(root: str):
    """RoBERTa-format vocab.json (the byte symbols, then one id per merge)
    and merges.txt."""
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import _bytes_to_unicode

    merges = [("t", "h"), ("th", "e"), ("Ġ", "c"), ("Ġc", "a"), ("Ġca", "t"), ("Ġ", "d"),
              ("Ġd", "o"), ("Ġdo", "g"), ("o", "n"), ("Ġ", "t"), ("Ġt", "he"), ("a", "n")]
    vocab = {u: i for i, u in enumerate(_bytes_to_unicode().values())}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vp, mp = os.path.join(root, "vocab.json"), os.path.join(root, "merges.txt")
    with open(vp, "w") as f:
        json.dump(vocab, f)
    with open(mp, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return vp, mp


def _ingest_run(root: str, paths: dict, smi: str) -> dict:
    """Phase ingest's steps 2-3 (txt2img on the .safetensors, the drill on
    the .ckpt) in this process; returns {kernel: launches} over both."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.pipeline import runners
    from diffusion_spacetime_attn_tpu_torch.scripts import ingest_weights, txt2img
    from diffusion_spacetime_attn_tpu_torch.utils.png import read_png

    wrappers = _wrappers()
    total = {k: 0 for k in wrappers}
    out = os.path.join(root, "txt2img")
    torch.cuda.empty_cache()
    _reset_counts(wrappers.values())
    t0 = time.perf_counter()
    png = txt2img.main(["--ckpt", paths["safetensors"], "--prompt", INGEST_PROMPT,
                        "--outdir", out])
    torch.cuda.synchronize()
    t2i_s = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    want = {k: 16 * 51 if k in ("mha_fwd", "geglu_fwd") else 0 for k in wrappers}
    img = read_png(png)
    emit({"phase": "ingest_txt2img", "file": os.path.basename(paths["safetensors"]),
          "seconds": t2i_s, "launches": counts, "image_std": float(img.std())})
    if counts != want or float(img.std()) == 0.0:
        fail(f"ingest txt2img: launches {counts} (expected {want}), image std {img.std()}")
    for k, n in counts.items():
        total[k] += n

    per_mode, real = {}, runners.PromptRunner.run_one

    def counted(self, *a, **k):
        torch.cuda.synchronize()
        _reset_counts(wrappers.values())
        t = time.perf_counter()
        img = real(self, *a, **k)
        torch.cuda.synchronize()
        per_mode[self.mode] = ({n: w.launches for n, w in wrappers.items()},
                               time.perf_counter() - t)
        return img

    out = os.path.join(root, "drill")
    torch.cuda.empty_cache()
    runners.PromptRunner.run_one = counted
    try:
        t0 = time.perf_counter()
        report = ingest_weights.main(["--sd-ckpt", paths["ckpt"], "--clip-ckpt", paths["clip"],
                                      "--layout-ckpt", paths["layout"], "--outdir", out,
                                      "--prompt", INGEST_PROMPT, "--steps", str(DRILL_STEPS)])
        drill_s = time.perf_counter() - t0
    finally:
        runners.PromptRunner.run_one = real
    pngs = {m: sorted(os.listdir(os.path.join(out, m))) for m in ("vanilla", "method")
            if os.path.isdir(os.path.join(out, m))}
    emit({"phase": "ingest_drill", "report": report, "pngs": pngs, "drill_s": drill_s,
          "vanilla_s": per_mode.get("vanilla", (None, None))[1],
          "method_s": per_mode.get("spacetime", (None, None))[1],
          "launches": {m: c for m, (c, _) in per_mode.items()}, "nvidia_smi": smi})
    problems = []
    if list(report) != DRILL_KEYS:
        problems.append(f"report keys {list(report)}")
    if any(report[k] != "checkpoint" for k in ("sd_weights", "layout_weights", "clip_weights")):
        problems.append("weights not all from the checkpoints")
    if not all(isinstance(report[k], float) and np.isfinite(report[k])
               for k in ("vanilla_clip_score", "method_clip_score")):
        problems.append("CLIP scores not finite")
    if pngs != {"vanilla": ["final2_s1_index_0.png"], "method": ["final2_s1_index_0.png"]}:
        problems.append(f"PNGs {pngs}")
    for mode, name in (("vanilla", "vanilla"), ("spacetime", "method")):
        got = per_mode.get(mode, ({}, 0))[0]
        if got != _drill_want(mode, wrappers):
            problems.append(f"{name} launches {got}, expected {_drill_want(mode, wrappers)}")
        for k, n in got.items():
            total[k] += n
    if problems:
        fail(f"ingest drill: {problems}")
    return total


def phase_ingest(root: str, smi: str) -> dict:
    """The real-weights ingestion path at full SD v1-4 width on synthetic
    files in the published layouts (`_write_ingest_files`):
      1. (a) and (b) through `load_stable_diffusion` onto the card, each in
         a process of its own from a cold page cache, the two side by side:
         parameter-exact, with sizes, seconds, peak RSS and card memory
         (`ingest_load_child`; a swap of two same-shape tensors is what the
         CPU tests catch, bit for bit against JAX's converters);
      2. `txt2img.main(["--ckpt", (b), ...])` (bf16, PLMS-50, vanilla:
         MHA and GEGLU 816 launches each);
      3. `ingest_weights.main` on (a), (c) and (d) (bf16, PLMS at
         DRILL_STEPS, 3 epochs, one prompt): JAX's report keys, every weight
         "checkpoint", finite CLIP scores, both PNGs, and per mode exactly
         the launches of its kernels (vanilla: GEGLU and flash forward
         16 / 10 per evaluation; method: opt_launches(k, DRILL_STEPS + 1)
         of the spacetime, GEGLU and flash
         kernels, forward and backward), with each mode's seconds;
      4. the native BPE core built with g++ here, against the Python core
         on small synthetic vocab files.
    Returns {kernel: launches} over the drill and txt2img."""
    from diffusion_spacetime_attn_tpu_torch.utils import native_bpe, tokenizer

    paths, gen_s, write_s = _write_ingest_files(root)
    emit({"phase": "ingest_files", "generate_s": gen_s, "write_s": write_s,
          "file_system": _fstype(root),
          "bytes": {k: os.path.getsize(p) for k, p in paths.items()}})
    loads = {key: _start_ingest_load(paths[key]) for key in ("ckpt", "safetensors")}
    try:
        for key, proc in loads.items():
            _finish_ingest_load(proc, paths[key], smi)
    finally:
        for proc in loads.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    total = _ingest_run(root, paths, smi)

    vp, mp = _toy_bpe(root)
    for old in native_bpe.BUILD_DIR.glob("libbpe_*.so"):    # compile it here, now
        old.unlink()
    t0 = time.perf_counter()
    lib = native_bpe.build()
    build_s = time.perf_counter() - t0
    nat = tokenizer.make_roberta_tokenizer(vp, mp)
    py = tokenizer.GPT2Tokenizer(vp, mp)
    texts = [INGEST_PROMPT, GOLDEN, "the cat and the dog", "a, b; c! 'll don't 123 x42y",
             "multiple   spaces\tand\nnewlines"]
    same = [nat.encode(t) == py.encode(t)
            and nat.encode_with_alignment(t.split()) == py.encode_with_alignment(t.split())
            for t in texts]
    emit({"phase": "ingest_bpe", "library": os.path.basename(str(lib)), "build_s": build_s,
          "core": nat.core, "texts": len(texts), "equal": same})
    if nat.core != "native" or not all(same):
        fail(f"ingest bpe: core {nat.core}, equal {same}")
    return total


def phase_slot():
    """Whether a row's result depends on its batch slot: one full-width
    SD v1-4 UNet evaluation (t = 981, 2 prompts = 4 CFG rows, 4 objects)
    whose two prompts are the same input, bf16 with the four kernel flags
    on and off, and float32 with them off; the rows of each pair are
    compared (a measurement: nothing here fails)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import PipelineConfig, UNetConfig, VAEConfig
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.utils.cudnn import deterministic

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((1, 64, 64, 4), generator=gen, device=dev).repeat(2, 1, 1, 1)
    ctx = torch.randn((2, 1, CONTEXT_LEN, 768), generator=gen, device=dev).repeat(1, 2, 1, 1)
    ctl = _control(1, dev, gen)
    ctl = ctl._replace(**{k: getattr(ctl, k).repeat(2, *[1] * (getattr(ctl, k).ndim - 1))
                          for k in ctl._fields})
    t = torch.full((4,), 981, dtype=torch.int32, device=dev)
    rows = {}
    for name, dtype, on in (("bf16_kernels_on", "bfloat16", True),
                            ("bf16_kernels_off", "bfloat16", False),
                            ("f32_kernels_off", "float32", False)):
        cfg = PipelineConfig(unet=UNetConfig(dtype=dtype, use_flash=on, use_mha=False,
                                             use_fused_ff=on, use_fused_control=on),
                             vae=VAEConfig(dtype=dtype))
        sd = StableDiffusion.create(cfg, seed=0, device=dev)
        with torch.inference_mode(), deterministic():
            eps = sd.unet(torch.cat([x, x]), t, ctx.reshape(4, CONTEXT_LEN, 768), ctl).float()
        pairs = [(eps[0], eps[1]), (eps[2], eps[3])]
        rows[name] = {"max_abs": max(float((a - b).abs().max()) for a, b in pairs),
                      "share_differing": sum(float((a != b).float().mean()) for a, b in pairs) / 2,
                      "max_abs_eps": float(eps.abs().max())}
        del sd
        torch.cuda.empty_cache()
    emit({"phase": "slot", "unet_eval_rows_same_input": rows})


def phase_profile_train(sd):
    """Where a training UNet evaluation's time goes at the optimization's
    shapes (batch 2 = 4 CFG rows): one checkpointed evaluation, forward,
    recompute and backward into x and the blend weights, on the host clock
    and under torch.profiler by kernel family (flash forward and backward at
    levels 0 and 1; the plain MHA backward left at level 2 and mid)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import checkpoint

    from diffusion_spacetime_attn_tpu_torch.utils.cudnn import deterministic

    dev, B = sd.device, SERVE_PROMPTS
    gen = torch.Generator(device=dev).manual_seed(6)
    x0 = torch.randn((2 * B, 64, 64, 4), generator=gen, device=dev)
    t = torch.full((2 * B,), 981, dtype=torch.int32, device=dev)
    ctx = torch.randn((2 * B, CONTEXT_LEN, 768), generator=gen, device=dev)
    ctl = _control(B, dev, gen)
    w = torch.randn((2 * B, 64, 64, 4), generator=gen, device=dev)

    def step():
        x = x0.clone().requires_grad_(True)
        coef = ctl.coef.clone().requires_grad_(True)
        eps = checkpoint(lambda x_: sd.unet(x_, t, ctx, ctl._replace(coef=coef)), x,
                         use_reentrant=False)
        (eps * w).sum().backward()

    # as SpaceTimeEngine runs it: cuDNN's deterministic algorithms
    with deterministic():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        host_s = (time.perf_counter() - t0) / 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    groups, kernels = _families(prof)
    busy = sum(v for k, v in groups.items() if not k.startswith("("))
    _no_slices("profile_train", groups)
    emit({"phase": "profile_train", "train_eval_s": host_s, "device_ms_by_family": groups or None,
          "device_busy_ms": busy if groups else None, "device_kernels": kernels,
          "device_idle_share": (1.0 - busy / (1e3 * host_s)) if groups else None})


# launches per LDM training step at SD v1-4 width (latents 64², batch any):
# GEGLU forward and dx at the 16 transformer blocks, flash forward and
# backward at the 10 self-attention sites of levels 0 and 1 (4096 and 1024
# tokens pass flash_ok; level 2 and mid take the plain attention: use_mha is
# off); every site gets a backward, each block's input depending on the weights
TRAIN_SITES = {"geglu_fwd": 16, "geglu_bwd": 16, "flash_fwd": 10, "flash_bwd": 10}
TRAIN_STEPS = 5                 # bench_train's timed steps (after one warm-up)


def train_launches(kernel: str, steps: int) -> int:
    return steps * TRAIN_SITES.get(kernel, 0)


def _train_parts(unet, batch: int, seed: int, ctx_shape=(CONTEXT_LEN, 768),
                 ctx_scale: float = 0.02):
    """(loss, {name: grad}, {name: updated param}) of one AdamW step from the
    unet's current weights, with kernels as its flags say, on a context of
    [batch, *ctx_shape] N(0, ctx_scale²); the weights are left updated."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import LDMTrainConfig, ScheduleConfig
    from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
    from diffusion_spacetime_attn_tpu_torch.training import ldm_trainer as tldm
    from diffusion_spacetime_attn_tpu_torch.utils import prng
    from diffusion_spacetime_attn_tpu_torch.utils.cudnn import deterministic

    dev = next(unet.parameters()).device
    cfg = LDMTrainConfig(batch_size=batch, use_ema=False)
    sched_cfg = ScheduleConfig()
    state = tldm.init_state(cfg, sched_cfg, unet, tldm.scaled_lr(cfg, batch, 1))
    k1, k2 = prng.split(prng.PRNGKey(seed))
    x0 = torch.from_numpy(prng.normal(k1, (batch, 64, 64, 4))).to(dev)
    ctx = torch.from_numpy(prng.normal(k2, (batch, *ctx_shape))).to(dev) * ctx_scale
    lvlb = torch.from_numpy(tldm.lvlb_weights(sched_cfg)).to(dev)
    with deterministic():
        loss, _ = tldm.p_losses(cfg, make_schedule(sched_cfg, 50, device=dev), lvlb, unet,
                                state.logvar, x0, ctx, prng.PRNGKey(seed + 1))
        loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in unet.named_parameters()}
    state.opt_state.update()
    unet.zero_grad(set_to_none=True)
    return loss.detach(), grads, {k: p.detach().clone() for k, p in unet.named_parameters()}


def _train_on_off(unet, batch: int, seed: int, sites: dict, phase: str, **ctx):
    """One float32 AdamW step of `unet` from the same weights and keys with
    its kernels on and off: the loss within 1e-5 relative, every gradient
    within 1e-3 relative in norm (the chain's limit), the updated parameters
    within 1e-5 + 1e-5·|plain|, and the launches of the step exactly
    `sites` (none with the kernels off)."""
    import torch

    wrappers = _wrappers()
    start = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    torch.cuda.synchronize()
    _reset_counts(wrappers.values())
    t0 = time.perf_counter()
    loss_on, g_on, p_on = _train_parts(unet, batch, seed, **ctx)
    torch.cuda.synchronize()
    on_s = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    expected = {k: sites.get(k, 0) for k in wrappers}
    with torch.no_grad():
        unet.load_state_dict(start)
    del start
    _kernels_off(unet)
    _reset_counts(wrappers.values())
    t0 = time.perf_counter()
    loss_off, g_off, p_off = _train_parts(unet, batch, seed, **ctx)
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    off_counts = {k: w.launches for k, w in wrappers.items()}
    loss_rel = float((loss_on - loss_off).abs() / loss_off.abs())
    grad_rel = {k: float(torch.linalg.vector_norm(g_on[k] - g_off[k])
                         / torch.linalg.vector_norm(g_off[k]).clamp_min(1e-30)) for k in g_off}
    worst = max(grad_rel, key=grad_rel.get)
    param_ratio = max(float(((p_on[k] - p_off[k]).abs() / (1e-5 + 1e-5 * p_off[k].abs())).max())
                      for k in p_off)
    emit({"phase": phase, "batch": batch, "loss_on": float(loss_on),
          "loss_off": float(loss_off), "loss_rel": loss_rel,
          "grad_rel_norm_max": grad_rel[worst], "grad_worst": worst,
          "param_ratio_max": param_ratio, "launches": counts, "off_launches": off_counts,
          "step_on_s": on_s, "step_off_s": off_s,
          "limits": {"loss_rel": 1e-5, "grad_rel_norm": 1e-3,
                     "params": "|on - off| <= 1e-5 + 1e-5·|off| (ratio <= 1)"}})
    if counts != expected or any(off_counts.values()):
        fail(f"{phase}: launches {counts} (off {off_counts}), expected {expected}")
    if not (loss_rel <= 1e-5 and grad_rel[worst] <= 1e-3 and param_ratio <= 1.0):
        fail(f"{phase}: kernels on vs off over the limit: loss {loss_rel}, "
             f"{worst} {grad_rel[worst]}, params {param_ratio}")


def phase_train_check():
    """(a) One full-width SD v1-4 LDM training step in float32, AdamW, with
    the kernels on vs off (`_train_on_off`): the conditional UNet at batch 1,
    launches exactly TRAIN_SITES ("train_f32"); and the superres model of
    `train_ldm --conditioning superres` (7 input channels, unconditional,
    attn2 as self-attention through flash) at batch 2 on a [2, 64, 64, 3]
    low-resolution context, launches exactly UNCOND_TRAIN_SITES
    ("train_f32_superres")."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import UNetConfig
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.scripts.train_ldm import SuperRes
    from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_

    with torch.device("cuda"):
        unet = UNet(UNetConfig(use_flash=True, use_fused_ff=True), radius=0.2)
    randomize_(unet, 1)
    _train_on_off(unet, 1, 21, TRAIN_SITES, "train_f32")
    del unet
    torch.cuda.empty_cache()
    with torch.device("cuda"):
        model = SuperRes(UNet(UNetConfig(use_flash=True, use_fused_ff=True, in_channels=7),
                              radius=0.2, conditional=False))
    randomize_(model, 2)
    _train_on_off(model, 2, 22, UNCOND_TRAIN_SITES, "train_f32_superres",
                  ctx_shape=(64, 64, 3), ctx_scale=0.5)
    del model
    torch.cuda.empty_cache()


def phase_train_bench(root: str, smi: str) -> dict:
    """(b) `scripts/bench_train.py --what ldm`'s operating point through its
    `bench_ldm`: SD v1-4 UNet, float32 parameters and bf16 compute, batch 4,
    AdamW with EMA, no remat; one warm-up and TRAIN_STEPS timed steps.  s
    per step (min, median), peak device memory and launches per step by
    kernel (exactly TRAIN_SITES); the loss finite; EMA apart from the
    parameters; `LDMTrainer.save` -> `restore` giving equal bits; and a step
    after `restore` equal, bit for bit, to the step the run took without
    it; then one more step under torch.profiler (device ms by kernel family,
    busy vs the step's host clock).  Returns {kernel: launches} of the
    warm-up and timed steps."""
    import argparse
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffusion_spacetime_attn_tpu_torch.scripts import bench_train
    from diffusion_spacetime_attn_tpu_torch.utils import prng
    from diffusion_spacetime_attn_tpu_torch.utils.cudnn import deterministic

    wrappers = _wrappers()
    args = argparse.Namespace(what="ldm", batch_size=4, iters=TRAIN_STEPS, dtype="bfloat16",
                              no_ema=False, tiny=False, mesh="none", profile=False)
    per_step = []

    def on_step(i):
        per_step.append({k: w.launches for k, w in wrappers.items()})
        _reset_counts(wrappers.values())

    torch.cuda.synchronize()
    _reset_counts(wrappers.values())
    line, trainer, state, batch_for = bench_train.bench_ldm(args, torch.device("cuda"), on_step)
    launches = {k: sum(c[k] for c in per_step) for k in wrappers}
    expected = {k: train_launches(k, 1) for k in wrappers}
    bad = [c for c in per_step if c != expected]
    params = dict(state.params.named_parameters())
    ema_apart = sum(int(not torch.equal(state.ema_params[k], params[k].detach())) for k in params)
    finite = all(math.isfinite(v) for v in line["losses"])

    # save -> restore -> one more step, against the same step without the round trip
    trainer.ckpt_dir = root
    n = state.step
    t0 = time.perf_counter()
    trainer.save(state, n)
    save_s = time.perf_counter() - t0
    saved = {k: v.detach().clone() for k, v in state.params.state_dict().items()}
    key, (x0, ctx) = prng.fold_in(prng.PRNGKey(42), n), batch_for(n)
    with deterministic():
        state, _ = trainer.train_step(state, x0, ctx, key)
    on_run = {k: v.detach().clone() for k, v in state.params.state_dict().items()}
    on_ema = {k: v.clone() for k, v in state.ema_params.items()}
    t0 = time.perf_counter()
    state = trainer.restore(n, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_equal = all(torch.equal(v, saved[k]) for k, v in state.params.state_dict().items())
    del saved
    with deterministic():
        state, _ = trainer.train_step(state, x0, ctx, key)
    resumed_equal = (all(torch.equal(v, on_run[k]) for k, v in state.params.state_dict().items())
                     and all(torch.equal(v, on_ema[k]) for k, v in state.ema_params.items()))
    os.remove(os.path.join(root, f"step_{n}.pt"))
    del on_run, on_ema
    # where one step's time goes: device time by kernel family under the
    # profiler, against the step's host clock
    x0, ctx = batch_for(n + 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, x0, ctx, prng.fold_in(prng.PRNGKey(42), n + 1))
        torch.cuda.synchronize()
        prof_step_s = time.perf_counter() - t0
    groups, kernels = _families(prof)
    busy = sum(v for k, v in groups.items() if not k.startswith("("))
    _no_slices("train_bench", groups)
    # the optimizer's byte floor: AdamW reads p, g, m, v and writes p, m, v;
    # EMA's lerp reads the EMA copy and p and writes the copy (f32 each)
    n_params = sum(p.numel() for p in params.values())
    opt_bytes = 4 * n_params * (7 + 3)
    emit({"phase": "train_bench", "metric": line["metric"], "nvidia_smi": smi,
          "s_per_step_min": line["s_per_step"], "s_per_step_median": statistics.median(line["times"]),
          "times": line["times"], "first_step_s": line["compile_s"],
          "peak_bytes": line["peak_bytes"], "losses": line["losses"],
          "launches_per_step": per_step[-1], "ema_apart_params": ema_apart,
          "params": len(params), "save_s": save_s, "restore_s": restore_s,
          "restore_equal": restored_equal, "resume_bit_equal": resumed_equal,
          "n_params": n_params, "optimizer_bytes": opt_bytes,
          "optimizer_bound_ms": 1e3 * opt_bytes / PEAK_BYTES,
          "profiled_step_s": prof_step_s, "device_ms_by_family": groups or None,
          "device_busy_ms": busy if groups else None, "device_kernels": kernels,
          "device_idle_share": (1.0 - busy / (1e3 * prof_step_s)) if groups else None})
    if bad or len(per_step) != TRAIN_STEPS + 1:
        fail(f"train_bench: launches per step {per_step}, expected {expected}")
    if not (finite and ema_apart == len(params) and restored_equal and resumed_equal):
        fail(f"train_bench: finite {finite}, EMA apart {ema_apart}/{len(params)}, "
             f"restore {restored_equal}, resume {resumed_equal}")
    del state, trainer
    torch.cuda.empty_cache()
    return launches


def phase_train_cli(root: str) -> dict:
    """(c) the entry points: `train_ldm --synthetic --steps 3` at SD v1-4
    width (launches exactly 3 × TRAIN_SITES; its final ~14 GB checkpoint
    left out, `LDMTrainer.save` patched: phase train_bench saves and
    restores one), `train_vae --synthetic --steps
    2 --disc-start 0` at KL-f8 width on 256² images (the discriminator and
    the adaptive weight with random LPIPS), and `train_testbed` with every
    stage at a few steps into a directory that the port's `load_bundle`
    then reads, one vanilla testbed image from it finite.  s per step and
    per stage; returns {kernel: launches} of train_ldm."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.scripts import train_ldm, train_testbed, train_vae
    from diffusion_spacetime_attn_tpu_torch.testbed import scenes
    from diffusion_spacetime_attn_tpu_torch.training import ldm_trainer
    from diffusion_spacetime_attn_tpu_torch.testbed.bundle import load_bundle
    from diffusion_spacetime_attn_tpu_torch.utils import prng

    wrappers = _wrappers()
    torch.cuda.synchronize()
    _reset_counts(wrappers.values())
    with mock.patch.object(ldm_trainer.LDMTrainer, "save", lambda self, state, step: None):
        ldm = train_ldm.main(["--synthetic", "--steps", "3", "--ckpt-dir",
                              os.path.join(root, "ldm"), "--log-every", "1", "--ckpt-every", "0"])
    launches = {k: w.launches for k, w in wrappers.items()}
    expected = {k: train_launches(k, 3) for k in wrappers}
    ldm_ok = launches == expected and all(math.isfinite(m["loss"]) for m in ldm["metrics"])
    shutil.rmtree(os.path.join(root, "ldm"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vae = train_vae.main(["--synthetic", "--steps", "2", "--disc-start", "0", "--log-every", "1",
                          "--ckpt-dir", os.path.join(root, "vae"), "--ckpt-every", "0"])
    vae_peak = torch.cuda.max_memory_allocated()
    vae_ok = all(math.isfinite(v) for m in vae["metrics"] for v in m.values()) and \
        all(m["d_weight"] > 0 for m in vae["metrics"])
    torch.cuda.empty_cache()
    tb_dir = os.path.join(root, "testbed")
    tb = train_testbed.main(["--ckpt-dir", tb_dir, "--data-cache", os.path.join(root, "s.npz"),
                             "--scenes", "512", "--vae-steps", "20", "--clip-steps", "20",
                             "--ldm-steps", "20", "--chunk", "10"])
    bundle = load_bundle(tb_dir, num_steps=10, device="cuda")
    caption = scenes.make_eval_prompts(1, seed=777)[0].caption
    with torch.inference_mode():
        cond = bundle.encode_captions([caption])
        img = bundle.sd.txt2img(cond, bundle.encode_captions([""]), prng.PRNGKey(3))
    tb_ok = bool(torch.isfinite(img).all()) and tuple(img.shape) == (1, 64, 64, 3) and \
        all(k in bundle.meta for k in ("scale_factor", "guidance_scale", "ldm_loss_simple"))
    emit({"phase": "train_cli", "train_ldm_step_s": ldm["step_s"],
          "train_ldm_losses": [m["loss"] for m in ldm["metrics"]], "train_ldm_launches": launches,
          "train_vae_step_s": vae["step_s"],
          "train_vae_metrics": vae["metrics"], "train_vae_peak_bytes": vae_peak,
          "train_testbed_s": tb["seconds"], "train_testbed_meta": tb["meta"],
          "testbed_image_mean": float(img.mean()), "testbed_caption": caption})
    if not (ldm_ok and vae_ok and tb_ok):
        fail(f"train_cli: train_ldm {ldm_ok} (launches {launches}, expected {expected}), "
             f"train_vae {vae_ok}, train_testbed {tb_ok}")
    del bundle
    torch.cuda.empty_cache()
    return launches


RDM_STEPS = 50                  # knn2img's --ddim-steps
RDM_F32_STEPS = 4               # DDIM steps of the float32 on-vs-off check
RDM_KNN = 10                    # knn2img's --knn
RDM_DB_ROWS = 1_000_000         # the retrieval database's rows (768 wide, f32: 3.07 GB)
RDM_NO_NEIGHBOR_STEPS = 10      # the batch without neighbours
RDM_KERNELS = ("mha_fwd", "geglu_fwd")
RDM_SEARCHER_IMAGES = 256       # train_searcher --synthetic
LAYOUT_TRAIN_EXAMPLES = 512     # train_layout --synthetic


def _rdm_want(wrappers, evals: int) -> dict:
    """Launches of `evals` RDM UNet evaluations: MHA and GEGLU at its 16
    transformer blocks, nothing else."""
    return {k: 16 * evals if k in RDM_KERNELS else 0 for k in wrappers}


def _random_database(rows: int, gen):
    """A Retriever of `rows` seeded random unit rows, 768 wide, made on the
    card (no host copy)."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.pipeline.retrieval import Retriever

    emb = torch.randn((rows, 768), generator=gen, device="cuda")
    emb /= torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8
    return Retriever(embedding=emb, img_id=np.arange(rows),
                     patch_coords=np.zeros((rows, 4), np.float32))


def phase_knn2img_f32():
    """The full-width RDM (`pipeline/knn2img.py`: 448-channel UNet, f16 VAE,
    768²) in float32, seeded weights, one prompt with RDM_KNN neighbours
    from a 4096-row random database, DDIM at RDM_F32_STEPS, the MHA and
    GEGLU kernels on vs off on the same weights: latents and images within
    1e-4 + 1e-4·|plain|, launches exactly 16 MHA and 16 GEGLU per UNet
    evaluation (none with the kernels off)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.pipeline.knn2img import RetrievalAugmentedDiffusion
    from diffusion_spacetime_attn_tpu_torch.utils import prng

    t0 = time.perf_counter()
    rdm = RetrievalAugmentedDiffusion.create(seed=0, steps=RDM_F32_STEPS, dtype="float32",
                                             device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    db = _random_database(4096, gen)
    cond = rdm.build_conditioning(torch.randn((1, 768), generator=gen, device="cuda"), db, RDM_KNN)
    key = prng.PRNGKey(3)
    wrappers = _wrappers()
    runs = {}
    for name in ("on", "off"):
        if name == "off":
            _kernels_off(rdm.unet)
        _reset_counts(wrappers.values())
        z = rdm.sample_latents(cond, key)
        img = rdm.decode(z)
        torch.cuda.synchronize()
        runs[name] = (z, img, {k: w.launches for k, w in wrappers.items()})
    (z_on, img_on, on), (z_off, img_off, off) = runs["on"], runs["off"]
    z_err, img_err = _within(z_on, z_off, 1e-4, 1e-4), _within(img_on, img_off, 1e-4, 1e-4)
    want = _rdm_want(wrappers, RDM_F32_STEPS)
    emit({"phase": "knn2img_f32", "steps": RDM_F32_STEPS, "context_len": cond.shape[1],
          "latent_shape": list(z_on.shape), "image_shape": list(img_on.shape),
          "latents_within": z_err, "images_within": img_err,
          "latents_max_abs_diff": float((z_on - z_off).abs().max()),
          "images_max_abs_diff": float((img_on - img_off).abs().max()),
          "launches_on": on, "launches_off": off, "seconds": time.perf_counter() - t0})
    if not (torch.isfinite(z_on).all() and torch.isfinite(img_on).all()):
        fail("knn2img_f32: non-finite output")
    if z_err > 1 or img_err > 1:
        fail(f"knn2img_f32: kernels on vs off {z_err}, {img_err} (> 1 = outside 1e-4 + 1e-4·|x|)")
    if on != want or any(off.values()):
        fail(f"knn2img_f32: launches on {on} (expected {want}), off {off}")
    del rdm, db
    torch.cuda.empty_cache()


def phase_knn2img(root: str, smi: str):
    """Retrieval-augmented diffusion at the 768² RDM's full width, bf16:
      1. a Retriever over RDM_DB_ROWS x 768 float32 rows made on the card
         from a seeded generator; 3 queries at k = RDM_KNN: the indices equal
         `exact_search` on a host copy (the CPU), the search's ms (CUDA
         events) beside its byte bound;
      2. `train_searcher.main(["--synthetic", "256", ...])`: 256 images
         through the ViT-L/14 vision tower into a database npz; seconds;
      3. `knn2img.main(["--use-neighbors", "--database", <it>, "--knn",
         "10", "--n-samples", "3", "--ddim-steps", "50"])` on seeded weights
         (RDM and ViT-L/14 text tower): three 768x768x3 PNGs, exactly 800
         MHA and 800 GEGLU launches per batch (16 blocks x 50 evaluations),
         nothing else, and the PNG bytes of `RetrievalAugmentedDiffusion.
         sample` on the same key and weights (finite images); s per batch,
         peak memory (the 1 M database resident), the decode's share;
      4. one batch without neighbours (context length 1) at
         RDM_NO_NEIGHBOR_STEPS steps: 3 PNGs, 16 x 10 launches each.
    Returns (the main run's launches, the library's images [3, 768, 768, 3])."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.pipeline import knn2img as knn
    from diffusion_spacetime_attn_tpu_torch.pipeline import retrieval
    from diffusion_spacetime_attn_tpu_torch.pipeline.runners import save_image
    from diffusion_spacetime_attn_tpu_torch.scripts import knn2img as knn2img_cli
    from diffusion_spacetime_attn_tpu_torch.scripts import train_searcher
    from diffusion_spacetime_attn_tpu_torch.utils import prng
    from diffusion_spacetime_attn_tpu_torch.utils.png import read_png

    wrappers = _wrappers()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(2027)
    t0 = time.perf_counter()
    big = _random_database(RDM_DB_ROWS, gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q = torch.randn((RDM_PROMPTS, 768), generator=gen, device="cuda")
    found = big.search(q, RDM_KNN)
    search_ms = cuda_ms(lambda: retrieval.exact_search(big.embedding, q, RDM_KNN), 20)
    host = big.embedding.cpu()
    cpu_scores, cpu_idx = retrieval.exact_search(host, q.cpu(), RDM_KNN)
    del host
    same_idx = torch.equal(cpu_idx, found["nns"].cpu())
    score_err = float((cpu_scores - found["scores"].cpu()).abs().max())
    nbytes = 4 * (RDM_DB_ROWS * 768 + RDM_PROMPTS * 768) + 12 * RDM_PROMPTS * RDM_KNN
    flops = 2 * RDM_PROMPTS * 768 * RDM_DB_ROWS
    b_ms, b_by = bound_ms(flops, nbytes, "float32")
    emit({"phase": "knn2img_search", "rows": RDM_DB_ROWS, "dim": 768, "queries": RDM_PROMPTS,
          "k": RDM_KNN, "build_s": build_s, "search_ms": search_ms, "bound_ms": b_ms,
          "bound_by": b_by, "fraction_of_bound": b_ms / search_ms,
          "indices_equal_cpu": same_idx, "scores_max_abs_diff_cpu": score_err,
          "nvidia_smi": smi})
    if not same_idx or score_err > 1e-5:
        fail(f"knn2img search: indices equal {same_idx}, scores {score_err} from the CPU's")

    db_path = os.path.join(root, "database.npz")
    searcher = train_searcher.main(["--synthetic", str(RDM_SEARCHER_IMAGES), "--out", db_path])
    emit({"phase": "knn2img_searcher", **searcher})
    if (searcher["rows"], searcher["dim"]) != (RDM_SEARCHER_IMAGES, 768):
        fail(f"train_searcher: {searcher}")

    t0 = time.perf_counter()
    rdm = knn.RetrievalAugmentedDiffusion.create(seed=0, steps=RDM_STEPS, dtype="bfloat16",
                                                 device="cuda")
    clip = train_searcher.build_clip(False, "cuda", seed=4)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    out = os.path.join(root, "knn2img")
    _reset_counts(wrappers.values())
    summary = knn2img_cli.main(["--use-neighbors", "--database", db_path, "--knn", str(RDM_KNN),
                                "--n-samples", str(RDM_PROMPTS), "--ddim-steps", str(RDM_STEPS),
                                "--outdir", out], models=(rdm, clip))
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    mha_designs = dict(wrappers["mha_fwd"].launches_by_design)
    peak = torch.cuda.max_memory_allocated()
    shapes = [list(read_png(p).shape) for p in summary["paths"]]

    # the library on the same key and weights, timed by part
    retr = retrieval.Retriever.from_npz(db_path, device="cuda")
    tokenize = knn2img_cli.padded(knn2img_cli.make_clip_tokenizer(), 77)
    parser = knn2img_cli.parse_args([])
    ids = torch.as_tensor(np.tile(np.asarray(tokenize(parser.prompt))[None], (RDM_PROMPTS, 1)),
                          device="cuda")
    with torch.inference_mode():
        cond = rdm.build_conditioning(clip.encode_text(ids), retr, RDM_KNN)
    key = prng.split(prng.PRNGKey(parser.seed))[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = rdm.sample_latents(cond, key, guidance_scale=parser.scale)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = rdm.decode(z)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = []
    for i, path in enumerate(summary["paths"]):
        lib = os.path.join(root, f"lib_{i}.png")
        save_image(images[i].float().cpu().numpy(), lib)
        with open(path, "rb") as a, open(lib, "rb") as b:
            same.append(a.read() == b.read())
    want = _rdm_want(wrappers, RDM_STEPS)
    line = {"phase": "knn2img", "dtype": "bfloat16", "steps": RDM_STEPS, "batch": RDM_PROMPTS,
            "knn": RDM_KNN, "context_len": summary["context_len"], "png_shapes": shapes,
            "s_per_batch": summary["s_per_batch"], "setup_s": setup_s,
            "library_chain_s": t1 - t0, "library_decode_s": t2 - t1,
            "decode_share": (t2 - t1) / (t2 - t0),
            "max_memory_allocated_bytes": peak, "launches": counts,
            "launches_per_batch": summary["launches"], "mha_launches_by_design": mha_designs,
            "png_bytes_equal_library": same,
            "finite": bool(torch.isfinite(images).all()),
            "image_std": float(images.float().std()), "nvidia_smi": smi}
    emit(line)
    problems = []
    if shapes != [[768, 768, 3]] * RDM_PROMPTS:
        problems.append(f"PNG shapes {shapes}")
    if not line["finite"] or line["image_std"] == 0.0:
        problems.append("images not finite or constant")
    if counts != want or summary["launches"] != [{k: want[k] for k in RDM_KERNELS}]:
        problems.append(f"launches {counts} / {summary['launches']}, expected {want}")
    if mha_designs != {"wgmma": counts["mha_fwd"], "mma_sync": 0, "simt": 0}:
        problems.append(f"MHA launches by design {mha_designs}, all expected on wgmma")
    if summary["context_len"] != 1 + RDM_KNN:
        problems.append(f"context length {summary['context_len']}")
    if not all(same):
        problems.append(f"PNG bytes equal to the library's: {same}")

    _reset_counts(wrappers.values())
    short = knn2img_cli.main(["--n-samples", str(RDM_PROMPTS), "--ddim-steps",
                              str(RDM_NO_NEIGHBOR_STEPS), "--outdir", os.path.join(root, "plain")],
                             models=(rdm, clip))
    short_counts = {k: w.launches for k, w in wrappers.items()}
    emit({"phase": "knn2img_no_neighbors", "steps": RDM_NO_NEIGHBOR_STEPS,
          "context_len": short["context_len"], "s_per_batch": short["s_per_batch"],
          "launches": short_counts, "pngs": len(short["paths"])})
    if (short["context_len"] != 1 or len(short["paths"]) != RDM_PROMPTS
            or short_counts != _rdm_want(wrappers, RDM_NO_NEIGHBOR_STEPS)):
        problems.append(f"without neighbours: {short}, launches {short_counts}")
    if problems:
        fail(f"knn2img: {problems}")
    del big, rdm, clip, retr
    torch.cuda.empty_cache()
    return counts, images


def phase_safety(images, smi: str):
    """diffusers' safety checker (`pipeline/safety.DiffusersSafetyChecker`)
    from a seeded synthetic state dict in diffusers' key layout
    (`utils/testing.safety_checker_shapes`: a ViT-L/14 tower at 224², 17
    concept and 3 special-care embeddings; the tower's dims inferred from
    the state dict) on phase knn2img's three images, the card against the
    port on the CPU: concept scores within 1e-3 and equal flags; then the
    concept weights raised to the midpoint of the two highest image scores,
    so that exactly one image is flagged, on both: that image's output is
    exactly 0 and the others are the input."""
    import dataclasses

    import torch

    from diffusion_spacetime_attn_tpu_torch.config import VIT_L14_JOINT_CLIP
    from diffusion_spacetime_attn_tpu_torch.pipeline.safety import DiffusersSafetyChecker
    from diffusion_spacetime_attn_tpu_torch.utils.testing import (
        safety_checker_shapes,
        seeded_state_dict,
    )

    t0 = time.perf_counter()
    state = seeded_state_dict(safety_checker_shapes(VIT_L14_JOINT_CLIP.vision), 2028)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = DiffusersSafetyChecker.from_checkpoint(state, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cpu = DiffusersSafetyChecker.from_checkpoint(state, device="cpu")
    if card.vision.cfg != dataclasses.replace(VIT_L14_JOINT_CLIP.vision, projection_dim=512):
        fail(f"safety: inferred tower {card.vision.cfg}")
    images = images.float()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_card = card.scores(images)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    s_cpu = cpu.scores(images.cpu())
    err = float((s_card.cpu() - s_cpu).abs().max())
    flags_card = (s_card > 0).any(-1).cpu().tolist()
    flags_cpu = (s_cpu > 0).any(-1).tolist()
    top = sorted(s_card.max(-1).values.tolist(), reverse=True)
    shift = 0.5 * (top[0] + top[1])
    for c in (card, cpu):
        c.concept_w += shift
    out, flagged = card(images)
    out_cpu, flagged_cpu = cpu(images.cpu())
    i = int(flagged.argmax())
    line = {"phase": "safety", "tower": dataclasses.asdict(card.vision.cfg),
            "concepts": tuple(card.concepts.shape), "special": tuple(card.specials.shape),
            "generate_s": gen_s, "load_s": load_s, "score_s": score_s,
            "scores_max_abs_diff_cpu": err, "flags_card": flags_card, "flags_cpu": flags_cpu,
            "threshold_shift": shift, "flagged": flagged.tolist(),
            "flagged_cpu": flagged_cpu.tolist(), "nvidia_smi": smi}
    emit(line)
    if err > 1e-3 or flags_card != flags_cpu:
        fail(f"safety: card vs cpu scores {err}, flags {flags_card} / {flags_cpu}")
    if flagged.sum() != 1 or flagged.tolist() != flagged_cpu.tolist():
        fail(f"safety: threshold flags {flagged} / {flagged_cpu}")
    keep = [j for j in range(len(flagged)) if j != i]
    if float(out[i].abs().max()) != 0.0 or not torch.equal(out[keep], images[keep]):
        fail("safety: the flagged image is not black, or a clean one changed")
    del card, cpu, state


def phase_train_layout(root: str, smi: str):
    """The layout trainer at LayoutConfig() (RoBERTa-base, float32): (a)
    `bench_train --what layout` at its point (batch 64, JAX's 512 synthetic
    sentences, one step then 5 timed): s per step, min and median, peak
    memory; (b) `train_layout --synthetic 512 --epochs 2` into a temporary
    run dir: JAX's run-dir files, finite losses; (c)
    `load_layout_predictor(run_dir)` on the card against the in-memory best
    params: the same greedy centers on 4 captions (LayoutInference)."""
    import statistics

    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig
    from diffusion_spacetime_attn_tpu_torch.models.layout.model import LayoutPredictor
    from diffusion_spacetime_attn_tpu_torch.pipeline.frontend import LayoutInference
    from diffusion_spacetime_attn_tpu_torch.scripts import bench_train, train_layout
    from diffusion_spacetime_attn_tpu_torch.utils import loader
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_roberta_tokenizer

    args = bench_train.parse_args(["--what", "layout"])
    line = bench_train.bench_layout(args, torch.device("cuda"))
    times = line["times"]
    emit({"phase": "train_layout_bench", **line, "s_per_step_min": min(times),
          "s_per_step_median": statistics.median(times), "nvidia_smi": smi})
    if line["metric"] != "layout_pretrain_step_b64_synthetic" or len(times) != args.iters:
        fail(f"bench_train --what layout: {line}")
    torch.cuda.empty_cache()

    run = os.path.join(root, "layout_run")
    out = train_layout.main(["--synthetic", str(LAYOUT_TRAIN_EXAMPLES), "--epochs", "2",
                             "--ckpt-dir", run])
    files = sorted(os.listdir(run))
    model = loader.load_layout_predictor(LayoutConfig(), run, device="cuda")
    mem = LayoutPredictor(model.cfg).to("cuda").eval().requires_grad_(False)
    mem.load_state_dict(out["best_params"])
    tok = make_roberta_tokenizer()
    got = [LayoutInference(model, tok)(s) for s in LAYOUT_CAPTIONS[:4]]
    want = [LayoutInference(mem, tok)(s) for s in LAYOUT_CAPTIONS[:4]]
    emit({"phase": "train_layout", "argv": f"--synthetic {LAYOUT_TRAIN_EXAMPLES} --epochs 2",
          "steps": out["steps"], "seconds": out["seconds"], "files": files,
          "first_loss": out["train_losses"][0], "last_loss": out["train_losses"][-1],
          "best": out["best"], "centers": got, "centers_equal_in_memory": got == want})
    n_train = LAYOUT_TRAIN_EXAMPLES - int(LAYOUT_TRAIN_EXAMPLES * 0.1)
    if out["steps"] != 2 * (n_train // 64) or not np.isfinite(out["train_losses"]).all():
        fail(f"train_layout: {out['steps']} steps, losses {out['train_losses']}")
    if not {"config.json", "best.json", "best_params.pt", "train_log.jsonl"} <= set(files):
        fail(f"train_layout: run dir {files}")
    if got != want or not any(got):
        fail(f"train_layout: loaded centers {got} vs in-memory {want}")


DATA_IMAGES = 8                 # phase train_data: port-written 640x480 JPEGs
# train_ldm runs of phase train_data: (conditioning, steps); per step the
# conditional UNet launches TRAIN_SITES, the unconditional one (superres:
# 7 input channels, no context) runs its second attention as self-attention,
# so its flash sites double (levels 0 and 1: 20 forward, 20 backward)
DATA_RUNS = (("text", 3), ("class", 2), ("superres", 2))
UNCOND_TRAIN_SITES = {**TRAIN_SITES, "flash_fwd": 20, "flash_bwd": 20}
LEGACY_STEPS = 3


def _time_ms(fn, n: int = 5) -> float:
    """Median wall ms of n calls (host work, no card)."""
    import statistics

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def block_file_512(name: str) -> bytes:
    """One BLOCKS_512 file: a DDS header and seeded random blocks."""
    import numpy as np

    n, dxgi, seed = BLOCKS_512[name]
    size = 8 if n == 1 else 16
    blocks = np.random.RandomState(seed).randint(0, 256, 128 * 128 * size).astype(np.uint8)
    head = struct.pack("<4s7I44x", b"DDS ", 124, 0x1007, 512, 512, 0, 0, 1)
    head += struct.pack("<II4sI4I", 32, 0x4, b"DXT1" if dxgi is None else b"DX10", 0, 0, 0, 0, 0)
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + blocks.tobytes()


def phase_image_io(smi: str):
    """The port's image I/O on the card's machine (no PIL there): the JPEG
    codec built by g++ at first use; its bytes for the seeded 640x480 image
    at quality CODEC_QUALITY, its decode of them and the bicubic resize to
    512² must have the SHA-256 of PIL's (constants above, checked against
    PIL by the CPU tests); ms per encode, decode and resize (median of 5)."""
    import hashlib

    from diffusion_spacetime_attn_tpu_torch.utils import jpeg
    from diffusion_spacetime_attn_tpu_torch.utils.resample import resize

    t0 = time.perf_counter()
    jpeg.load_library()
    build_s = time.perf_counter() - t0
    img = codec_image()
    data = jpeg.encode_jpeg(img, CODEC_QUALITY)
    dec = jpeg.decode_jpeg(data)
    out = resize(img, (512, 512))
    digests = {"encode": hashlib.sha256(data).hexdigest() == JPEG_SHA256,
               "decode": hashlib.sha256(dec.tobytes()).hexdigest() == DECODE_SHA256,
               "resize": hashlib.sha256(out.tobytes()).hexdigest() == RESIZE_SHA256}
    emit({"phase": "image_io", "build_s": build_s, "jpeg_bytes": len(data),
          "digests_equal_pil": digests,
          "encode_ms": _time_ms(lambda: jpeg.encode_jpeg(img, CODEC_QUALITY)),
          "decode_ms": _time_ms(lambda: jpeg.decode_jpeg(data)),
          "resize_bicubic_640x480_to_512_ms": _time_ms(lambda: resize(img, (512, 512))),
          "phase_s": time.perf_counter() - t0, "nvidia_smi": smi})
    if not all(digests.values()):
        fail(f"image_io: bytes differ from PIL's: {digests}")


def _tree_digests(tree, at=()) -> dict:
    """{path: SHA-256 of the leaf's bytes} of a restored orbax tree, as
    `tests/helpers/port_formats.tree_digests` computes them (bfloat16 as its
    16-bit words, None and empty containers skipped)."""
    import hashlib

    import numpy as np
    import torch

    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_tree_digests(tree[k], at + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_tree_digests(v, at + (str(i),)))
    elif tree is not None:
        if isinstance(tree, torch.Tensor):
            a = (tree.view(torch.int16) if tree.dtype == torch.bfloat16 else tree).numpy()
        else:
            a = np.ascontiguousarray(np.asarray(tree))
        out["/".join(at)] = hashlib.sha256(a.tobytes()).hexdigest()
    return out


def phase_formats(smi: str):
    """Checkpoints and images a JAX user has on disk, read on the card's
    machine, which has no orbax, tensorstore or PIL (module docstring)."""
    import hashlib
    import shutil as _shutil

    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import (
        ScheduleConfig,
        UNetConfig,
        VAEConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.models.vae import AutoencoderKL
    from diffusion_spacetime_attn_tpu_torch.scripts import sample_diffusion
    from diffusion_spacetime_attn_tpu_torch.utils import (
        bcn,
        ccitt,
        image_io,
        lzw,
        native_bpe,
        orbax,
        prng,
        webp,
        zstd,
    )
    from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_

    t_phase = time.perf_counter()
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        want = json.load(f)
    libs = {"zstd": zstd, "webp": webp, "lzw": lzw, "ccitt": ccitt, "bcn": bcn}
    built_s = {}

    def build(name):
        t0 = time.perf_counter()
        libs[name].load_library()
        built_s[name] = time.perf_counter() - t0

    def build_lzw_source():
        # phase image_in's mask TIFF has loaded the LZW decoders by now: time
        # g++ on their source (the raster formats' loops too) into a scratch dir
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            subprocess.run(["g++", *native_bpe.FLAGS, "-o", os.path.join(d, "liblzw.so"),
                            str(lzw.SOURCE)], check=True, capture_output=True, timeout=300)
            built_s["lzw_source"] = time.perf_counter() - t0

    builds = [threading.Thread(target=build, args=(name,)) for name in libs]
    builds.append(threading.Thread(target=build_lzw_source))
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    for lib in libs.values():                      # raises here if a build failed
        lib.load_library()
    if "lzw_source" not in built_s:
        fail("formats: g++ failed on native/lzw.cpp")
    build_s = time.perf_counter() - t_phase
    ldm = os.path.join(FIXTURES, "ldm")
    t0 = time.perf_counter()
    tree = orbax.restore(os.path.join(ldm, "step_2"))
    restore_s = time.perf_counter() - t0
    got = _tree_digests(tree)
    state_equal = got == want["state"]
    with open(os.path.join(ldm, "config.json")) as f:
        cfg = json.load(f)
    ucfg = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["unet"].items()})
    with torch.device("cuda"):
        unet = UNet(ucfg, radius=0.2, conditional=False).eval().requires_grad_(False)
        vae = AutoencoderKL(VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)).eval()
    randomize_(vae, 2, 0.02)
    with tempfile.TemporaryDirectory() as d:        # the --ckpt-dir layout: step_<n>/
        _shutil.copytree(os.path.join(ldm, "step_2"), os.path.join(d, "step_2"))
        step, kind = sample_diffusion.restore_unet(unet, d)
    ema_equal = all(torch.equal(p.detach().cpu(), q) for p, q in zip(
        unet.parameters(), _ema_like(unet, tree["ema_params"])))
    img = sample_diffusion.sample_batch(unet, vae, prng.PRNGKey(0), 1, cfg["latent"],
                                        ScheduleConfig(), custom_steps=2, eta=0.0)
    sample = {"step": step, "kind": kind, "shape": list(img.shape),
              "finite": bool(torch.isfinite(img).all()), "ema_loaded_exactly": ema_equal}
    images, ms = {}, {}
    for name, d in sorted(want["images"].items()):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        pic = image_io.read_image(data, name)
        rgb = image_io.convert(pic, "RGB")
        images[name] = (pic.mode == d["mode"] and list(pic.pixels.shape) == d["shape"]
                        and hashlib.sha256(pic.pixels.tobytes()).hexdigest() == d["pixels"]
                        and hashlib.sha256(rgb.tobytes()).hexdigest() == d["rgb"])
        ms[name] = _time_ms(lambda: image_io.read_image(data, name))
    fax = {k: v for k, v in ms.items() if k.startswith("fax_")}
    generated, bcn_ms = {}, {}
    for name, d in sorted(want["generated"].items()):   # the 512x512 BCn files
        data = block_file_512(name)
        pic = image_io.read_image(data, name)
        rgb = image_io.convert(pic, "RGB")
        generated[name] = (hashlib.sha256(data).hexdigest() == d["file"]
                           and pic.mode == d["mode"] and list(pic.pixels.shape) == d["shape"]
                           and hashlib.sha256(pic.pixels.tobytes()).hexdigest() == d["pixels"]
                           and hashlib.sha256(rgb.tobytes()).hexdigest() == d["rgb"])
        bcn_ms[name] = _time_ms(lambda: image_io.read_image(data, name))
    images.update(generated)
    emit({"phase": "formats", "build_s": build_s, "library_build_s": built_s,
          "ccitt_decode_ms": fax, "raster_decode_ms": {k: ms[k] for k in RASTER_FIXTURES},
          "bcn_decode_ms": bcn_ms,
          "restore_s": restore_s, "arrays": len(got),
          "state_digests_equal_orbax": state_equal, "ema_sample": sample,
          "digests_equal_pil": images, "decode_ms": ms,
          "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
    if not (state_equal and step == 2 and kind == "ema" and ema_equal and sample["finite"]
            and all(images.values())):
        bad = sorted(k for k in set(got) | set(want["state"]) if got.get(k) != want["state"].get(k))
        fail(f"formats: state {state_equal} ({bad[:5]}), sample {sample}, images {images}")
    del unet, vae
    torch.cuda.empty_cache()


def _ema_like(unet, ema_tree):
    """The fixture's EMA tree as the UNet's parameters (the weight bridge)."""
    from diffusion_spacetime_attn_tpu_torch.utils import orbax
    from diffusion_spacetime_attn_tpu_torch.utils.weights import bridge, flatten_tree

    sd = bridge(flatten_tree(orbax.to_float32(ema_tree)), unet)
    return [sd[n].float() for n, _ in unet.named_parameters()]


def _write_jpeg_folder(root: str) -> dict:
    """DATA_IMAGES 640x480 images with captions.jsonl, an LSUN-style split of
    them and a two-synset tree of the same files: port-written JPEGs, but
    the FORMAT_SLOTS, which hold fixture files (the tree lists what JAX's
    `imagenet_tree` lists: no PPM, GIF or TIFF; the DDS and the Targa named
    .jpg go in as .JPEG)."""
    from diffusion_spacetime_attn_tpu_torch.utils.jpeg import encode_jpeg

    d = os.path.join(root, "jpegs")
    os.makedirs(d)
    rows = []
    for i in range(DATA_IMAGES):
        if i in FORMAT_SLOTS:
            ext = os.path.splitext(FORMAT_SLOTS[i])[1]
            with open(os.path.join(FIXTURES, FORMAT_SLOTS[i]), "rb") as f:
                data = f.read()
        else:
            ext, data = ".jpg", encode_jpeg(codec_image(seed=100 + i), CODEC_QUALITY)
        name = f"img{i}{ext}"
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)
        syn = os.path.join(root, "tree", f"n0{i % 2}")
        os.makedirs(syn, exist_ok=True)
        with open(os.path.join(syn, f"{i}{'.JPEG' if ext == '.jpg' else ext}"), "wb") as f:
            f.write(data)
        rows.append({"file": name, "text": OBJECT_NAMES[i % 4] + " " + LAYOUT_CAPTIONS[i % 4]})
    with open(os.path.join(d, "captions.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    with open(os.path.join(d, "paths.txt"), "w") as f:
        f.write("\n".join(r["file"] for r in rows) + "\n")
    return {"jpegs": d, "tree": os.path.join(root, "tree")}


def phase_train_data(root: str, smi: str) -> dict:
    """Training from image folders at SD v1-4 width, bf16, batch 2 (the
    checkpoint each train_ldm run writes at its end is left out by patching
    `LDMTrainer.save` for the phase's runs only: phase train_cli times one): `train_ldm --data-dir` over DATA_IMAGES
    port-written JPEGs with captions.jsonl (3 steps), over the synset tree
    with class conditioning (2 steps) and `--conditioning superres
    --synthetic` (2 steps, BSRGAN-light rows): launches exactly TRAIN_SITES
    per step (superres: UNCOND_TRAIN_SITES), finite losses, s per step and
    host ms per batch; `train_vae --paths-txt` at 256² for 2 steps and one
    step with `--lpips-ckpt` on a seeded file in taming's `vgg.pth` +
    torchvision's VGG16 `features.*` layout (loaded parameter-exact);
    `train_searcher --image-dir` on the JPEGs (ViT-L/14).  Returns
    {kernel: launches over the train_ldm runs}."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.scripts import train_ldm, train_searcher, train_vae
    from diffusion_spacetime_attn_tpu_torch.training import ldm_trainer
    from diffusion_spacetime_attn_tpu_torch.utils import convert
    from diffusion_spacetime_attn_tpu_torch.utils.testing import lpips_shapes, seeded_state_dict

    t_phase = time.perf_counter()
    dirs = _write_jpeg_folder(root)
    wrappers = _wrappers()
    total = {k: 0 for k in wrappers}
    # each run's final checkpoint (float32 weights, AdamW moments and EMA,
    # about 14 GB) is left out: JAX's script has no flag for that, and
    # phase train_cli writes and times one
    with mock.patch.object(ldm_trainer.LDMTrainer, "save", lambda self, state, step: None):
        for cond, steps in DATA_RUNS:
            argv = ["--steps", str(steps), "--batch-size", "2", "--log-every", "1",
                    "--ckpt-every", "0", "--ckpt-dir", os.path.join(root, f"ldm_{cond}"),
                    "--conditioning", cond]
            argv += (["--synthetic"] if cond == "superres" else
                     ["--data-dir", dirs["tree"], "--num-classes", "2"] if cond == "class" else
                     ["--data-dir", dirs["jpegs"]])
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            _reset_counts(wrappers.values())
            out = train_ldm.main(argv)
            counts = {k: w.launches for k, w in wrappers.items()}
            sites = UNCOND_TRAIN_SITES if cond == "superres" else TRAIN_SITES
            want = {k: steps * sites.get(k, 0) for k in wrappers}
            losses = [m["loss"] for m in out["metrics"]]
            x0, ctx = out["first_batch"]
            emit({"phase": "train_data", "run": f"train_ldm {cond}", "steps": steps,
                  "batch": 2, "s_per_step": out["step_s"],
                  "host_ms_per_batch": [t * 1e3 for t in out["host_s"]], "losses": losses,
                  "latents": list(x0.shape), "context": list(ctx.shape), "launches": counts})
            if counts != want or not all(math.isfinite(v) for v in losses):
                fail(f"train_data {cond}: launches {counts}, expected {want}, losses {losses}")
            for k, n in counts.items():
                total[k] += n
            del out, x0, ctx
    torch.cuda.empty_cache()
    vae_argv = ["--data-dir", dirs["jpegs"], "--paths-txt",
                os.path.join(dirs["jpegs"], "paths.txt"), "--batch-size", "2",
                "--disc-start", "0", "--log-every", "1", "--ckpt-every", "0",
                "--ckpt-dir", os.path.join(root, "vae")]
    vae = train_vae.main(vae_argv + ["--steps", "2"])
    sd = seeded_state_dict(lpips_shapes(), seed=5, scale=0.05)
    lpips_path = os.path.join(root, "lpips.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, lpips_path)
    loaded = {k: v.cpu().numpy() for k, v in train_vae.load_lpips(lpips_path, "cuda")
              .state_dict().items()}
    exact = all(np.array_equal(loaded[f"vgg.conv_{j}.{p}"], sd[f"features.{i}.{p}"])
                for j, i in enumerate(convert._VGG16_CONV_IDX) for p in ("weight", "bias")) and \
        all(np.array_equal(loaded[f"lin_{j}.weight"], sd[f"lin{j}.model.1.weight"])
            for j in range(5))
    vae_lp = train_vae.main(vae_argv + ["--steps", "1", "--lpips-ckpt", lpips_path])
    metrics = vae["metrics"] + vae_lp["metrics"]
    torch.cuda.empty_cache()
    searcher = train_searcher.main(["--image-dir", dirs["jpegs"], "--batch", "8",
                                    "--out", os.path.join(root, "db.npz")])
    emb = np.load(os.path.join(root, "db.npz"))["embedding"]
    emit({"phase": "train_data", "run": "train_vae --paths-txt", "image_size": 256,
          "s_per_step": vae["step_s"] + vae_lp["step_s"],
          "host_ms_per_batch": [t * 1e3 for t in vae["host_s"] + vae_lp["host_s"]],
          "metrics": metrics, "lpips_parameter_exact": exact,
          "searcher_rows": searcher["rows"], "searcher_s": searcher["seconds"],
          "fixture_files": {f"img{i}": name for i, name in FORMAT_SLOTS.items()},
          "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
    # train_searcher lists PNG, JPEG and WebP only (as JAX's script does)
    searched = (".png", ".jpg", ".jpeg", ".webp")
    listed = sum(1 for f in os.listdir(dirs["jpegs"]) if f.lower().endswith(searched))
    unlisted = sum(1 for f in FORMAT_SLOTS.values() if not f.endswith(searched))
    if not (exact and all(math.isfinite(v) for m in metrics for v in m.values())
            and searcher["rows"] == listed == DATA_IMAGES - unlisted and np.isfinite(emb).all()):
        fail(f"train_data: lpips exact {exact}, vae metrics {metrics}, searcher {searcher}")
    torch.cuda.empty_cache()
    return total


def _legacy_batch(cfg, kind: str, seed: int, B: int = 8, L: int = 32, T: int = 16):
    import numpy as np

    r = np.random.RandomState(seed)
    tokens = r.randint(4, cfg.vocab_size, (B, L))
    tokens[:, L - 4:] = 0
    b = {"tokens": tokens, "obj_ids": r.randint(0, cfg.obj_id_size, (B, L)),
         "segments": r.randint(0, cfg.max_rel_pair, (B, L)),
         "token_types": r.randint(0, 4, (B, L))}
    if kind == "finetune":
        b["labels"] = np.where(r.rand(B, L) < 0.15, tokens, 0)
        b["type_labels"] = r.randint(0, 4, (B, L))
    else:
        b.update(cats=r.randint(1, cfg.cls_size, (B, T)), pos=r.randint(1, cfg.pos_size, (B, T)),
                 shapes=r.randint(1, cfg.shape_size, (B, T)),
                 boxes=r.rand(B, T, 4).astype(np.float32))
    return b


def phase_legacy_vg(root: str, smi: str):
    """`infer_vg_msdn` at LayoutConfig() width on the card (seeded weights)
    against the same model on the CPU: centers within 1e-4, the same files;
    then each legacy trainer (LegacyConfig(): 512 wide, 6 layers) takes
    LEGACY_STEPS steps on the card at batch 8: finite losses, s per step."""
    import copy

    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig
    from diffusion_spacetime_attn_tpu_torch.models.layout.legacy import LegacyConfig
    from diffusion_spacetime_attn_tpu_torch.scripts import infer_vg_msdn
    from diffusion_spacetime_attn_tpu_torch.training import legacy_trainer
    from diffusion_spacetime_attn_tpu_torch.utils.loader import load_layout_predictor

    t_phase = time.perf_counter()
    graphs = [{"id": i, "objects": [{"class": n} for n in OBJECT_NAMES],
               "relationships": [{"sub_id": i % 4, "obj_id": (i + 1) % 4, "predicate": p}
                                 for p in ("left of", "above")[: 1 + i % 2]]}
              for i in range(6)]
    path = os.path.join(root, "sg.json")
    with open(path, "w") as f:
        json.dump(graphs, f)
    model = load_layout_predictor(LayoutConfig(), None, device="cuda")
    cpu = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    card = infer_vg_msdn.main(["--instances", path, "--out", os.path.join(root, "vg_card")],
                              model=model)
    card_s = time.perf_counter() - t0
    host = infer_vg_msdn.main(["--instances", path, "--out", os.path.join(root, "vg_cpu"),
                               "--cpu"], model=cpu)
    err = max(float(np.abs(np.asarray(a["centers"]) - np.asarray(b["centers"])).max())
              for a, b in zip(card, host))
    files = sorted(os.listdir(os.path.join(root, "vg_card")))
    same_files = files == sorted(os.listdir(os.path.join(root, "vg_cpu")))
    line = {"phase": "legacy_vg", "vg_graphs": len(graphs), "vg_card_s": card_s,
            "vg_centers_max_abs_diff_cpu": err, "vg_files": len(files),
            "vg_same_files": same_files}
    del model, cpu
    cfg = LegacyConfig()
    for kind, cls in (("discrete", legacy_trainer.LegacyDiscreteTrainer),
                      ("reg", legacy_trainer.LegacyRegTrainer),
                      ("finetune", legacy_trainer.LegacyFinetuneTrainer)):
        trainer = cls(cfg, device="cuda")
        state = trainer.init_state(seed=0)
        losses, times = [], []
        for i in range(LEGACY_STEPS):
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, _legacy_batch(cfg, kind, i))
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        line[f"{kind}_losses"], line[f"{kind}_s_per_step"] = losses, times
        if not all(math.isfinite(v) for v in losses):
            fail(f"legacy_vg: {kind} losses {losses}")
        del trainer, state
    line["phase_s"], line["nvidia_smi"] = time.perf_counter() - t_phase, smi
    emit(line)
    torch.cuda.empty_cache()
    if err > 1e-4 or not same_files or sum("png" in r for r in card) != len(graphs):
        fail(f"legacy_vg: centers differ by {err} from the CPU's, files {files}")


def _no_slices(phase: str, groups: dict):
    """The bf16 GEGLU kernels (wgmma) write no f32 slices: fail if the
    profile holds a slice sum."""
    if groups.get("geglu_sum_slices"):
        fail(f"{phase}: the bf16 path summed GEGLU slices ({groups['geglu_sum_slices']} ms)")


def _families(prof):
    """Device ms by kernel family, and the number of device kernels.  The
    device time under the `mha_bwd_plain` range (the plain self-attention
    backward, whose kernels also sit in matmul / softmax / other) is added
    as its own key."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.utils.profiling import kernel_family

    groups, kernels = {}, 0
    for e in prof.key_averages():
        if e.key == "mha_bwd_plain":
            groups["(of which mha_bwd_plain)"] = getattr(e, "device_time_total", 0.0) / 1e3
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        fam = kernel_family(e.key)
        groups[fam] = groups.get(fam, 0.0) + us / 1e3
        kernels += e.count
    return groups, kernels


def phase_profile(sd):
    """Where a serving batch's time goes: host-clock times of its parts at
    the engine's shapes (batch 2 = 4 CFG rows), and one UNet evaluation under
    torch.profiler with device time grouped by kernel family."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev, B, L = sd.device, 2, CONTEXT_LEN
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2 * B, 64, 64, 4), generator=gen, device=dev)
    t = torch.full((2 * B,), 981, dtype=torch.int32, device=dev)
    ctx = torch.randn((2 * B, L, 768), generator=gen, device=dev)
    ctl = _control(B, dev, gen)
    z = torch.randn((B, 64, 64, 4), generator=gen, device=dev)
    ids_cond = np.zeros((B + B * OBJECTS, L), np.int32)   # captions + local contexts
    ids_uncond = np.zeros((B, L), np.int32)

    def host_s(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    with torch.inference_mode():
        unet_s = host_s(lambda: sd.unet(x, t, ctx, ctl))
        decode_s = host_s(lambda: sd.decode_latents(z))
        text_s = host_s(lambda: (sd.encode_text(ids_cond), sd.encode_text(ids_uncond)))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sd.unet(x, t, ctx, ctl)
            torch.cuda.synchronize()
    groups, launches = _families(prof)
    busy = sum(v for k, v in groups.items() if not k.startswith("("))
    _no_slices("profile", groups)
    evals = sd.schedule.num_steps + 1  # two at step 0, then one per step
    emit({"phase": "profile", "unet_eval_s": unet_s, "decode_s": decode_s, "text_s": text_s,
          "evals_per_batch": evals, "device_ms_by_family": groups or None,
          "device_busy_ms": busy if groups else None, "device_kernels": launches,
          "device_idle_share": (1.0 - busy / (1e3 * unet_s)) if groups else None})


# phase http: captions the layout predictor lays out (each has COCO objects)
HTTP_PROMPTS = ["a dog to the left of a cat", GOLDEN, "a car above a bench",
                "the bird sits on a chair", "a cup next to a laptop"]
HTTP_SEED = 2 ** 31 + 5         # past int32: the engines take it as JAX's uint32 cast does
SPATIAL_KERNELS = ("mha_fwd", "geglu_fwd", "spacetime_fwd")
VANILLA_KERNELS = ("mha_fwd", "geglu_fwd")
# serve --mode spacetime: use_flash only (and the controlled cross-attention)
SERVE_CLI_STEPS = 10            # phase serve_cli's PLMS steps
CLI_KERNELS = ("flash_fwd", "flash_bwd", "spacetime_fwd", "spacetime_bwd")
# the JAX package's load-test artifact (`serving/loadtest.py`): its keys
LOADTEST_KEYS = {"capacity_req_per_s", "stage_requests", "batch_size", "max_wait_s", "max_queue",
                 "request_timeout_s", "stages", "saturation_req_per_s"}
STAGE_KEYS = {"offered_req_per_s": None, "capacity_fraction": None, "submitted": None,
              "completed": None, "rejected": None, "timed_out": None,
              "latency_s": {"p50", "p95", "p99", "mean", "max"}, "queue_depth": {"mean", "max"}}


def _http(port: int, path: str, body=None, timeout: float = 600.0):
    """(status, JSON body, seconds) of one request to the local front."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def _post_from_thread(port: int, body):
    """Posts `body` to /txt2img from a thread now; returns a function that
    joins it and gives its (status, body, seconds)."""
    import threading

    out = []
    t = threading.Thread(target=lambda: out.append(_http(port, "/txt2img", body)))
    t.start()

    def join():
        t.join(timeout=900)
        if not out:
            fail("http: a client thread did not finish")
        return out[0]

    return join


def _concurrent(port: int, bodies, gap: float = 0.0):
    """Posts each body from its own thread, `gap` seconds apart; returns the
    (status, body, seconds) of each, in order."""
    joins = []
    for body in bodies:
        joins.append(_post_from_thread(port, body))
        time.sleep(gap)
    return [join() for join in joins]


def _serve_front(engine, **kw):
    """A BatchingService (max_wait_s 0.2) behind `serve` on 127.0.0.1 at a
    free port: (service, server, port)."""
    from diffusion_spacetime_attn_tpu_torch.serving import BatchingService, serve

    svc = BatchingService(engine, max_wait_s=0.2, **kw).start()
    httpd = serve(svc, "127.0.0.1", 0, block=False)
    return svc, httpd, httpd.server_address[1]


# the PLMS steps of phases http and loadtest: functional checks of the
# serving front and the ramp, at fewer steps than phase serve's 50 to keep
# the whole script inside its 600 s budget; a batch must still outlast
# phase http's 0.5 s sleeps (its 503 and 504 checks)
FRONT_STEPS = 25                # phase http (cut from 50); http's burst
                                # and timeout checks need a batch longer than their 0.5 s wait
FRONT_LAUNCHES = 16 * (FRONT_STEPS + 1)     # per batch of each forward kernel on the path
LOADTEST_STEPS = 10             # phase loadtest's PLMS steps (a functional check)
LOADTEST_LAUNCHES = 16 * (LOADTEST_STEPS + 1)


def with_steps(sd, steps: int):
    """The bundle `sd` (same modules) with a chain of `steps` steps."""
    import dataclasses

    from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule

    st = dataclasses.replace(sd.cfg.spacetime, num_steps=steps)
    return dataclasses.replace(sd, cfg=dataclasses.replace(sd.cfg, spacetime=st),
                               schedule=make_schedule(sd.cfg.schedule, steps, device=sd.device))


def phase_http(sd):
    """The HTTP front in spatial mode at full SD v1-4 width (phase serve's
    bundle at PLMS-FRONT_STEPS: bf16, MHA, GEGLU and spacetime kernels), batch 2, the
    layout predictor at LayoutConfig() behind `PromptRunner.prepare_host`,
    a BatchingService (max_wait_s 0.2) behind `serve` on 127.0.0.1.  A lone
    request must return the PNG of `engine.generate_batch([p], [s])[0]`
    byte for byte (the same slot: bf16 rounds by slot); five concurrent
    requests must all get 200 in fewer batches than requests; a service with
    max_queue=1 hit by a burst while a batch runs must answer 503; one with
    request_timeout_s=0.01 must answer 504 for a request queued behind a
    running batch.  Every batch launches the MHA, GEGLU and spacetime
    forward kernels 16 x (FRONT_STEPS + 1) times each and nothing else."""
    import base64

    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig
    from diffusion_spacetime_attn_tpu_torch.pipeline.frontend import LayoutInference
    from diffusion_spacetime_attn_tpu_torch.pipeline.runners import PromptRunner
    from diffusion_spacetime_attn_tpu_torch.serving import TextToImageEngine
    from diffusion_spacetime_attn_tpu_torch.utils.loader import load_layout_predictor
    from diffusion_spacetime_attn_tpu_torch.utils.png import decode_png, encode_png
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import (
        make_clip_tokenizer,
        make_roberta_tokenizer,
    )

    sd = with_steps(sd, FRONT_STEPS)
    L = sd.cfg.text_encoder.max_len
    tok = make_clip_tokenizer(max_len=L)

    def tokenize(t):
        return tok.pad_to(tok.encode(t), L)

    t0 = time.perf_counter()
    layout = LayoutInference(load_layout_predictor(LayoutConfig(), None, device="cuda"),
                             make_roberta_tokenizer())
    runner = PromptRunner(sd=sd, clip_loss=None, layout=layout, clip_tokenize=tokenize,
                          text_tokenize=tokenize, cfg=sd.cfg.spacetime, mode="spatial")
    engine = TextToImageEngine(sd=sd, tokenize=tokenize, batch_size=SERVE_PROMPTS,
                               prepare_host=runner.prepare_host)
    laid_out = [runner.prepare_host(p) is not None for p in HTTP_PROMPTS]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if not all(laid_out):
        fail(f"http: the layout failed on {[p for p, ok in zip(HTTP_PROMPTS, laid_out) if not ok]}")
    wrappers = _wrappers()
    _reset_counts(wrappers.values())
    fronts, direct = [], 0
    try:
        svc, httpd, port = _serve_front(engine)
        fronts.append((svc, httpd))
        # a lone request, and the engine's own batch of it
        code, out, lone_s = _http(port, "/txt2img", {"prompt": HTTP_PROMPTS[0], "seed": HTTP_SEED})
        if code != 200:
            fail(f"http: lone request answered {code}: {out}")
        img = decode_png(base64.b64decode(out["image"]))
        t0 = time.perf_counter()
        want = engine.generate_batch(HTTP_PROMPTS[:1], [HTTP_SEED])[0]
        batch_s = time.perf_counter() - t0
        direct += 1
        size = sd.cfg.spacetime.image_size
        if out["shape"] != [size, size, 3] or not np.array_equal(img, want):
            diff = np.abs(img.astype(int) - want.astype(int))
            fail(f"http: the PNG of {out['shape']} differs from the engine's image in "
                 f"{int((diff > 0).sum())} bytes")
        if float(img.std()) == 0.0:
            fail("http: the image is constant")
        t0 = time.perf_counter()
        for _ in range(5):
            b64 = base64.b64encode(encode_png(want))
        png_b64_ms = 1e3 * (time.perf_counter() - t0) / 5
        # five requests at once
        h0 = _http(port, "/healthz")[1]
        many = _concurrent(port, [{"prompt": p, "seed": 100 + i}
                                  for i, p in enumerate(HTTP_PROMPTS)])
        h1 = _http(port, "/healthz")[1]
        codes_many = [c for c, _, _ in many]
        batches_many = h1["batches"] - h0["batches"]
        if codes_many != [200] * len(HTTP_PROMPTS) or not batches_many < len(HTTP_PROMPTS) \
                or not h1["batched_rows"] / h1["batches"] > 1:
            fail(f"http: concurrent requests {codes_many} in {batches_many} batches, {h1}")
        # a burst into a queue of 1 while a batch runs
        svc503, httpd503, port503 = _serve_front(engine, max_queue=1)
        fronts.append((svc503, httpd503))
        first = _post_from_thread(port503, {"prompt": HTTP_PROMPTS[0], "seed": 7})
        time.sleep(0.5)                           # the worker has taken it and runs its batch
        burst = _concurrent(port503, [{"prompt": p, "seed": 8} for p in HTTP_PROMPTS[1:4]],
                            gap=0.02)
        codes_503 = [first()[0]] + [c for c, _, _ in burst]
        if 503 not in codes_503 or set(codes_503) - {200, 503}:
            fail(f"http: burst into max_queue=1 answered {codes_503}")
        retry = [b.get("retry_after_s") for c, b, _ in burst if c == 503]
        # a request queued behind a running batch, past request_timeout_s
        svc504, httpd504, port504 = _serve_front(engine, request_timeout_s=0.01)
        fronts.append((svc504, httpd504))
        first = _post_from_thread(port504, {"prompt": HTTP_PROMPTS[1], "seed": 9})
        time.sleep(0.5)
        code_504, body_504, _ = _http(port504, "/txt2img", {"prompt": HTTP_PROMPTS[2], "seed": 9})
        codes_504 = [first()[0], code_504]
        if codes_504 != [200, 504]:
            fail(f"http: request_timeout_s=0.01 answered {codes_504}: {body_504}")
        health = _http(port, "/healthz")[1]
        code_404 = _http(port, "/nope")[0]
        if code_404 != 404:
            fail(f"http: GET /nope answered {code_404}")
    finally:
        for svc, httpd in fronts:
            httpd.shutdown()
            httpd.server_close()
            svc.stop()
    counts = {k: w.launches for k, w in wrappers.items()}
    batches = direct + sum(svc.stats["batches"] for svc, _ in fronts)
    expect = {k: batches * FRONT_LAUNCHES if k in SPATIAL_KERNELS else 0 for k in wrappers}
    if counts != expect:
        fail(f"http: launches {counts} over {batches} batches, expected {expect}")
    emit({"phase": "http", "mode": "spatial", "batch_size": SERVE_PROMPTS, "steps": FRONT_STEPS,
          "setup_s": setup_s, "lone_request_s": lone_s, "lone_batch_s": batch_s,
          "http_overhead_s": lone_s - batch_s, "png_b64_ms": png_b64_ms,
          "png_b64_bytes": len(b64), "lone_same_bytes": True,
          "concurrent_s": [t for _, _, t in many], "concurrent_batches": batches_many,
          "codes": {"concurrent": codes_many, "burst_max_queue_1": codes_503,
                    "request_timeout_0.01": codes_504, "unknown_path": code_404},
          "retry_after_s": retry, "healthz": health, "batches": batches, "launches": counts})
    return counts


# requests per stage of phase loadtest: few, to keep the whole script inside
# its 600 s budget (a functional check; scripts/measure_loadtest.py measures)
LOADTEST_REQUESTS = 3


def phase_loadtest(sd, smi: str):
    """`run_loadtest` on the vanilla-flag engine at full SD v1-4 width (phase
    serve's bundle, no control: MHA and GEGLU kernels), bf16, PLMS-LOADTEST_STEPS, batch
    2: capacity from 2 warm batches, then stages at 0.5, 1.0 and 2.5 of it,
    LOADTEST_REQUESTS (3) requests each, max_queue 4, max_wait_s 0.2.  A
    functional check, not a measurement (percentiles of 3 samples;
    `scripts/measure_loadtest.py`
    measures): every accepted request must complete, p50 <= p95 <= p99, the
    0.5 stage must reject nothing, its p50 be at least the wall time of the
    fastest batch it ran (a request waits for its own batch) and its load,
    offered rate × its median batch time / batch size, stay below 1 (else
    the capacity batches ran more than twice as fast as the stage's, and
    "0.5" was not below saturation); the artifact must have the JAX
    package's keys, and every batch launches MHA and GEGLU LOADTEST_LAUNCHES times."""
    from diffusion_spacetime_attn_tpu_torch.scripts.measure_loadtest import (
        TimedEngine,
        ramp_record,
    )
    from diffusion_spacetime_attn_tpu_torch.serving import TextToImageEngine
    from diffusion_spacetime_attn_tpu_torch.serving.loadtest import run_loadtest
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

    sd = with_steps(sd, LOADTEST_STEPS)
    L = sd.cfg.text_encoder.max_len
    tok = make_clip_tokenizer(max_len=L)
    engine = TimedEngine(TextToImageEngine(
        sd=sd, tokenize=lambda t: tok.pad_to(tok.encode(t), L), batch_size=SERVE_PROMPTS))
    wrappers = _wrappers()
    _reset_counts(wrappers.values())
    t0 = time.perf_counter()
    art = run_loadtest(engine, capacity_fractions=(0.5, 1.0, 2.5),
                       stage_requests=LOADTEST_REQUESTS, max_wait_s=0.2, max_queue=4)
    seconds = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    batches = len(engine.rows)
    expect = {k: batches * LOADTEST_LAUNCHES if k in VANILLA_KERNELS else 0 for k in wrappers}
    emit({"phase": "loadtest", "nvidia_smi": smi, "mode": "vanilla", "steps": LOADTEST_STEPS,
          "functional_check": f"{LOADTEST_REQUESTS} requests per stage: not a measurement",
          "seconds": seconds, "batches": batches, "launches": counts,
          "batch_rows": [n for n, _ in engine.rows], "artifact": art})
    if counts != expect:
        fail(f"loadtest: launches {counts} over {batches} batches, expected {expect}")
    keys_ok = set(art) == LOADTEST_KEYS and all(
        set(st) == set(STAGE_KEYS) and all(set(st[k]) == v for k, v in STAGE_KEYS.items() if v)
        for st in art["stages"])
    if not keys_ok:
        fail(f"loadtest: artifact keys {sorted(art)} / {[sorted(st) for st in art['stages']]}")
    for st in art["stages"]:
        lat = st["latency_s"]
        if st["timed_out"] or st["completed"] != st["submitted"] - st["rejected"]:
            fail(f"loadtest: stage {st['capacity_fraction']}: accepted requests lost: {st}")
        if st["completed"] and not lat["p50"] <= lat["p95"] <= lat["p99"]:
            fail(f"loadtest: stage {st['capacity_fraction']}: percentiles {lat}")
    try:
        rec = ramp_record(art, engine.rows, 2)
    except RuntimeError as e:
        fail(f"loadtest: batches do not add up to the stages: {e}")
    emit({"phase": "loadtest_batches", "capacity_batch_s": rec["capacity_batch_s"],
          "stage_batches": rec["stage_batches"]})
    half, hb = art["stages"][0], rec["stage_batches"][0]
    # p50 is rounded to 1e-3 s in the artifact
    if half["rejected"] or not hb["batch_s"] or \
            not half["latency_s"]["p50"] >= min(hb["batch_s"]) - 1e-3 or not hb["load"] < 1.0:
        fail(f"loadtest: the 0.5 stage rejected {half['rejected']}, p50 "
             f"{half['latency_s']['p50']} s, load {hb['load']}, its batches {hb['batch_s']} s, "
             f"the capacity batches {rec['capacity_batch_s']} s")
    return counts


def phase_serve_cli():
    """The serving entry point in spacetime mode, in this process:
    `scripts/serve.main(["--mode", "spacetime", "--batch", "2", "--soak",
    "2", "--steps", "10"])` (full SD v1-4 width, bf16 parameters by
    default, PLMS at SERVE_CLI_STEPS, 3 epochs, the layout predictor at
    LayoutConfig(), a ViT-B/32 loss CLIP): its summary line, finite and
    non-constant images and losses, and per batch (the warmup's and the
    soak's) opt_launches(k, SERVE_CLI_STEPS + 1) launches of the
    flash and spacetime kernels, forward and backward, and none of GEGLU or
    MHA (the JAX script's spacetime flags)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.scripts import serve as serve_cli
    from diffusion_spacetime_attn_tpu_torch.serving.server import SpaceTimeEngine

    batches = []
    optimize = SpaceTimeEngine.optimize_batch

    def recorded(self, prompts, seeds, on_epoch=None):
        t0 = time.perf_counter()
        images, coef, losses = optimize(self, prompts, seeds, on_epoch)
        torch.cuda.synchronize()
        batches.append({"prompts": len(prompts), "seconds": time.perf_counter() - t0,
                        "finite": bool(torch.isfinite(images).all()
                                       and torch.isfinite(losses).all()),
                        "image_std": float(images[:len(prompts)].float().std()),
                        "losses": losses.tolist()})
        return images, coef, losses

    wrappers = _wrappers()
    _reset_counts(wrappers.values())
    torch.cuda.reset_peak_memory_stats()
    SpaceTimeEngine.optimize_batch = recorded
    t0 = time.perf_counter()
    try:
        summary = serve_cli.main(["--mode", "spacetime", "--batch", "2", "--soak", "2",
                                  "--steps", str(SERVE_CLI_STEPS)])
    finally:
        SpaceTimeEngine.optimize_batch = optimize
    seconds = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    evals = chain_evals("plms", SERVE_CLI_STEPS)
    expect = {k: len(batches) * opt_launches(k, evals) if k in CLI_KERNELS else 0
              for k in wrappers}
    emit({"phase": "serve_cli", "argv": f"--mode spacetime --batch 2 --soak 2 --steps "
          f"{SERVE_CLI_STEPS}", "seconds": seconds,
          "summary": summary, "warmup_s": batches[0]["seconds"] if batches else None,
          "soak_batch_s": [b["seconds"] for b in batches[1:]], "batches": batches,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "launches": counts})
    if not (summary["soak_ok"] is True and summary["requests"] == 2 and summary["batches"] == 1
            and summary["params_dtype"] == "bfloat16"):
        fail(f"serve_cli: summary {summary}")
    if len(batches) != 2 or not all(b["finite"] and b["image_std"] > 0 for b in batches):
        fail(f"serve_cli: batches {batches}")
    if counts != expect:
        fail(f"serve_cli: launches {counts} over {len(batches)} batches, expected {expect}")
    return counts


def _host_row(call, n: int, match: str = "") -> dict:
    """Host work of one bf16 call (see `phase_geglu_host`): issue time,
    wrapper time (CUDA events), device time (torch.profiler), and their
    difference; with `match`, also the device time of the kernels whose
    names contain it (`kernel_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        wrapper_ms = cuda_ms(call, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        host_us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
    dev = [(e.key, getattr(e, "self_device_time_total", 0.0)) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(us for _, us in dev) / 1e3 / n
    row = {"host_us": host_us, "wrapper_ms": wrapper_ms, "device_ms": device_ms,
           "host_gap_ms": wrapper_ms - device_ms}
    if match:
        row["kernel_ms"] = sum(us for key, us in dev if match in key) / 1e3 / n
    return row


def phase_spacetime_host():
    """Host work per bf16 spacetime call at each SD site (2 prompts, 4
    objects): the forward through `fused_spacetime_attention` (inference
    mode) and the backward through `spacetime_bwd` without dK/dV (the
    chain's form; its device time includes the plain reductions into dg_u,
    dmasks and dcoef).  The fields are those of `phase_geglu_host`, and
    `kernel_ms`, the spacetime kernels' own device time.  Only
    the wrappers' public signatures are used, so `--compare` runs this phase
    on the other tree's package too."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_spacetime

    n = 50
    for level, Lq, inner, _ in SITES:
        gen = torch.Generator(device="cuda").manual_seed(Lq + inner + 1)
        args = _inputs("spacetime", SERVE_PROMPTS, Lq, inner, torch.bfloat16, gen)
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(torch.bfloat16)
        emit({"phase": "spacetime_host", "site": level, "Lq": Lq, "inner": inner,
              "fwd": _host_row(lambda: cuda_spacetime.fused_spacetime_attention(*args, HEADS), n,
                               "spacetime_fwd"),
              "bwd": _host_row(lambda: cuda_spacetime.spacetime_bwd(*args, HEADS, g,
                                                                    need_kv=False), n,
                               "spacetime_bwd")})


def phase_geglu_host():
    """Host work per bf16 GEGLU call at each SD site (2 prompts): the
    forward through `geglu_ff` (inference mode) and `geglu_dx`.  Per call:
    `host_us`, the host's time to issue it (50 calls that queue on the card
    without a wait); `wrapper_ms`, CUDA events over the same calls back to
    back; `device_ms`, the kernels' device time under torch.profiler; and
    `host_gap_ms` = wrapper_ms - device_ms, what the wrapper adds to the
    card's time.  Only the wrappers' public signatures are used, so
    `--compare` runs this phase on the other tree's package too."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_geglu

    n = 50
    for level, Lq, dim, _ in SITES:
        gen = torch.Generator(device="cuda").manual_seed(Lq + dim)
        x, w1, b1, w2, b2, res = _inputs("geglu", SERVE_PROMPTS, Lq, dim, torch.bfloat16, gen)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        emit({"phase": "geglu_host", "site": level, "M": x.shape[0], "dim": dim,
              "fwd": _host_row(lambda: cuda_geglu.geglu_ff(x, w1, b1, w2, b2, res), n),
              "dx": _host_row(lambda: cuda_geglu.geglu_dx(x, w1, b1, w2, dy), n)})


# one turn of `--compare`: phases that both trees have, in a fresh process
COMPARE_TURN = """
import json, sys
sys.path.insert(0, '.')
import torch
import chip_smoke as c
from diffusion_spacetime_attn_tpu_torch.config import PipelineConfig, UNetConfig, VAEConfig
from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion

def bundle(**flags):
    cfg = PipelineConfig(unet=UNetConfig(dtype='bfloat16', use_mha=True, use_fused_ff=True,
                                         use_fused_control=True, **flags),
                         vae=VAEConfig(dtype='bfloat16'))
    return StableDiffusion.create(cfg, seed=0, device='cuda')

c.phase_device()
c.phase_build()
agg = c.phase_kernels()
agg.update(c.phase_kernels_bwd())
print(json.dumps({'phase': 'agg', 'agg': agg}), flush=True)
sd = bundle()
c.phase_profile(sd)
del sd
torch.cuda.empty_cache()
c.phase_profile_train(bundle(use_flash=True))
# this script's host-work phase, run on the package of the tree in the cwd
import importlib.util
spec = importlib.util.spec_from_file_location('this_smoke', sys.argv[1])
this = importlib.util.module_from_spec(spec)
spec.loader.exec_module(this)
this.phase_geglu_host()
this.phase_spacetime_host()
"""


def compare_trees(other: str) -> int:
    """Phases device, build, kernels, kernels_bwd, profile and profile_train
    of `other` and of this tree in turns (other, this, this, other), each in
    a fresh process; prints every line of each turn tagged with the turn and
    the tree, then a summary per turn."""
    here = os.path.dirname(os.path.abspath(__file__))
    summary = []
    for turn, tree in enumerate([other, here, here, other], 1):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", COMPARE_TURN, os.path.abspath(__file__)],
                             cwd=tree, capture_output=True, text=True)
        lines = [json.loads(ln) for ln in run.stdout.splitlines() if ln.startswith("{")]
        for ln in lines:
            emit({"turn": turn, "tree": tree, **ln})
        if run.returncode != 0:
            print(run.stdout[-3000:], run.stderr[-3000:], flush=True)
            fail(f"compare turn {turn} ({tree}) exited with {run.returncode}")
        by = {ln["phase"]: ln for ln in lines if ln["phase"] in ("agg", "profile",
                                                                  "profile_train")}
        host = {ln["site"]: {k: ln[k] for k in ("fwd", "dx")} for ln in lines
                if ln["phase"] == "geglu_host"}
        st_host = {ln["site"]: {k: ln[k] for k in ("fwd", "bwd")} for ln in lines
                   if ln["phase"] == "spacetime_host"}
        sites = {f"{ln['name']} {ln['site']}": ln["kernel_ms"] for ln in lines
                 if ln["phase"] in ("kernel", "kernel_bwd") and ln["dtype"] == "bfloat16"
                 and ln["prompts"] == SERVE_PROMPTS}
        summary.append({"phase": "compare", "turn": turn, "tree": tree,
                        "seconds": time.perf_counter() - t0,
                        "per_unet_eval_ms": {k: v["ms"] for k, v in by["agg"]["agg"].items()},
                        "site_ms": sites,
                        "serve_eval_busy_ms": by["profile"]["device_busy_ms"],
                        "serve_eval_family_ms": by["profile"]["device_ms_by_family"],
                        "train_eval_s": by["profile_train"]["train_eval_s"],
                        "train_eval_busy_ms": by["profile_train"]["device_busy_ms"],
                        "train_eval_family_ms": by["profile_train"]["device_ms_by_family"],
                        "geglu_host": host, "spacetime_host": st_host})
    for row in summary:
        emit(row)
    return 0


# ---------------------------------------------------------------- the mesh phases

MESH2_RANKS = 2                 # phase mesh2: processes on cuda:0 over gloo
MESH2_ROWS = 2                  # rows per rank of phase mesh2's training steps (global 4)
MESH2_TIMEOUT_S = 480           # the parent's join of the two ranks
# mesh2's training steps: SD v1-4's widths, levels and attention at one
# residual block per level (579 M parameters, 860 M at SD's two): gloo moves
# every gradient and FSDP gather through the host, so depth is its cost;
# phase mesh runs the full depth over one NCCL rank
MESH2_RES_BLOCKS = 1
MESH2_SITES = {"geglu_fwd": 10, "geglu_bwd": 10, "flash_fwd": 6, "flash_bwd": 6}
MESH_ENGINE_STEPS = 10          # the engines' PLMS steps in phases mesh and mesh2
MESH_DB_ROWS = 1_000_000        # phase knn2img's database size, split over mesh2's ranks
MESH_KNN = 10
# train_f32's limits (`_train_on_off`)
MESH_LIMITS = {"loss_rel": 1e-5, "grad_rel_norm": 1e-3,
               "params": "|mesh - one| <= 1e-5 + 1e-5·|one| (ratio <= 1)"}
# mesh2's part tp: the model axis over the two ranks, Mesh(data=1, model=2).
# One controlled evaluation of the SD v1-4 UNet at full depth (2 residual
# blocks per level fit: both ranks' f32 UNets and gradients with the one-rank
# reference are ~25 GB per rank of the 80), 1 prompt x 4 objects, the chain's
# kernel flags; launches per rank per evaluation with its gradient:
MESH2_TP_SITES = {"spacetime_fwd": 16, "spacetime_bwd": 16, "geglu_fwd": 16, "geglu_bwd": 16,
                  "flash_fwd": 10, "flash_bwd": 10}
MESH2_TP_RES_BLOCKS = 2
MESH2_TP_STEPS, MESH2_TP_EPOCHS = 3, 2     # the TP engine: PLMS-3, one training epoch
MESH2_TP_REQUEST = (["a cat and a dog near a tree and a car"], [21])
MESH2_TP_LIMITS = {"f32": "loss 1e-5 relative, every gradient and dcoef 1e-3 relative in norm",
                   "bf16": "|tp - one| <= 5e-2·max|eps| + 1e-3 (phase unet's)",
                   "engine": "within one uint8 level of one process (f32)"}


def _mesh_unet(dtype: str = "float32", num_res_blocks: int = 2):
    """The SD v1-4 UNet (`num_res_blocks` per level: 2 is SD's depth) with
    the training kernel flags (use_flash, use_fused_ff), seeded N(0, 0.02²)
    weights, on the card."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import UNetConfig
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_

    with torch.device("cuda"):
        unet = UNet(UNetConfig(dtype=dtype, use_flash=True, use_fused_ff=True,
                               num_res_blocks=num_res_blocks), radius=0.2)
    return randomize_(unet, 1)


def _mesh_batch(B: int, seed: int):
    """(x0 [B, 64, 64, 4], context [B, 77, 768]) from JAX keys, on the card."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.utils import prng

    k1, k2 = prng.split(prng.PRNGKey(seed))
    return (torch.from_numpy(prng.normal(k1, (B, 64, 64, 4))).cuda(),
            torch.from_numpy(prng.normal(k2, (B, CONTEXT_LEN, 768))).cuda() * 0.02)


def _ldm_mesh_step(unet, mesh, fsdp: bool, x0, ctx, seed: int, grads: bool = True) -> dict:
    """One `LDMTrainer` step (AdamW, EMA) of `unet` from its weights over
    `mesh` (None: one device; x0 and ctx are this rank's rows), with the
    step's own keys: the loss, the whole gradients (taken inside the step,
    before its update), the whole updated weights and EMA, the step's launches
    (counted around `train_step` only), seconds, the state's bytes on this
    rank and the card's allocated bytes after `init`."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import LDMTrainConfig, ScheduleConfig
    from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import barrier
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import (
        full,
        full_tree,
        moments,
        state_bytes,
    )
    from diffusion_spacetime_attn_tpu_torch.training.ldm_trainer import LDMTrainer
    from diffusion_spacetime_attn_tpu_torch.utils import prng
    from diffusion_spacetime_attn_tpu_torch.utils.cudnn import deterministic

    cfg = LDMTrainConfig(batch_size=x0.shape[0], use_ema=True)
    sched = ScheduleConfig()
    tr = LDMTrainer(cfg, sched, make_schedule(sched, 50, device=x0.device), unet, mesh=mesh,
                    fsdp=fsdp)
    state = tr.init()
    torch.cuda.synchronize()
    out = {"allocated_after_init": torch.cuda.memory_allocated(), "lr": tr.lr}
    key = prng.PRNGKey(seed)
    wrappers = _wrappers()
    if grads:     # the step's own reduced gradients, taken just before its update
        opt, update = state.opt_state, state.opt_state.update

        def snapshot_then_update():
            out["grads"] = {k: full(p.grad).clone() for k, p in unet.named_parameters()}
            return update()

        opt.update = snapshot_then_update
    try:
        with deterministic():
            torch.cuda.synchronize()
            barrier(mesh)                 # the ranks start the timed step together
            _reset_counts(wrappers.values())
            t0 = time.perf_counter()
            state, m = tr.train_step(state, x0, ctx, key)
            loss = float(m["loss"])
            torch.cuda.synchronize()
    finally:
        if grads:     # no cycle through the wrapper: the state is freed on return
            del opt.update
    out["step_s"] = time.perf_counter() - t0
    out["launches"] = {k: w.launches for k, w in wrappers.items()}
    opt = state.opt_state
    pairs = moments(opt.adamw, opt.params, opt.views)       # AdamW's m and v, this rank's
    tensors = list(unet.parameters()) + list(state.ema_params.values())
    out.update(loss=loss, state_bytes=state_bytes(tensors + [m for _, m in pairs]),
               replicated_bytes=sum(t.numel() * t.element_size()
                                    for t in tensors + [p for p, _ in pairs]),
               params={k: v.detach().clone()
                       for k, v in full_tree(dict(unet.named_parameters())).items()},
               ema={k: v.detach().clone() for k, v in full_tree(state.ema_params).items()})
    return out


def _mesh_compare(tag: str, got: dict, ref: dict, sites=None) -> dict:
    """train_f32's limits: the loss, every gradient (when both have them),
    every updated weight and EMA copy of a mesh step against the one-device
    step; launches exactly `sites` (TRAIN_SITES by default).  Fails over a
    limit."""
    import torch

    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_rel = {}
    if "grads" in got and "grads" in ref:
        grad_rel = {k: float(torch.linalg.vector_norm(got["grads"][k] - g)
                             / torch.linalg.vector_norm(g).clamp_min(1e-30))
                    for k, g in ref["grads"].items()}
    ratio = max(float(((got[part][k] - w).abs() / (1e-5 + 1e-5 * w.abs())).max())
                for part in ("params", "ema") for k, w in ref[part].items())
    worst = max(grad_rel, key=grad_rel.get) if grad_rel else None
    line = {"loss": got["loss"], "loss_one": ref["loss"], "loss_rel": loss_rel,
            "grad_rel_norm_max": grad_rel.get(worst, 0.0), "grad_worst": worst,
            "param_ema_ratio_max": ratio, "launches": got["launches"],
            "limits": MESH_LIMITS}
    expected = {k: (sites or TRAIN_SITES).get(k, 0) for k in got["launches"]}
    if got["launches"] != expected:
        fail(f"{tag}: launches {got['launches']}, expected {expected}")
    if not (loss_rel <= 1e-5 and line["grad_rel_norm_max"] <= 1e-3 and ratio <= 1.0):
        fail(f"{tag}: against the one-device step: {line}")
    return line


def _mesh_engines(mesh, dtype: str, prompts, seeds, one_rank: bool):
    """TextToImageEngine at SD v1-4 width (serving flags, PLMS at
    MESH_ENGINE_STEPS, batch 2) over `mesh` and, on rank 0 or with
    `one_rank`, without: (mesh images, one-device images or None, the mesh
    run's launches, seconds)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import (
        PipelineConfig,
        SpaceTimeConfig,
        UNetConfig,
        VAEConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.serving.server import TextToImageEngine
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

    cfg = PipelineConfig(unet=UNetConfig(dtype=dtype, use_mha=True, use_fused_ff=True),
                         vae=VAEConfig(dtype=dtype),
                         spacetime=SpaceTimeConfig(num_steps=MESH_ENGINE_STEPS))
    sd = StableDiffusion.create(cfg, seed=0, device="cuda")
    tok = make_clip_tokenizer(max_len=CONTEXT_LEN)

    def tokenize(t):
        return tok.pad_to(tok.encode(t), CONTEXT_LEN)

    wrappers = _wrappers()
    eng = TextToImageEngine(sd=sd, tokenize=tokenize, batch_size=2, mesh=mesh)
    one = None
    if one_rank or mesh.rank == 0:
        one = TextToImageEngine(sd=sd, tokenize=tokenize, batch_size=2).generate_batch(
            prompts, seeds)
    torch.cuda.synchronize()
    _reset_counts(wrappers.values())
    t0 = time.perf_counter()
    got = eng.generate_batch(prompts, seeds)
    seconds = time.perf_counter() - t0
    return got, one, {k: w.launches for k, w in wrappers.items()}, seconds


def phase_mesh(smi: str) -> dict:
    """The mesh over a one-rank NCCL group in this process (the real
    backend's code path): the SD v1-4 UNet training step in float32 through
    the GEGLU and flash kernels, data-parallel and then FSDP, each against
    the one-device step from the same weights and keys (train_f32's limits,
    launches exactly TRAIN_SITES per step); TextToImageEngine(mesh=) (bf16,
    PLMS-10, batch 2) and Retriever(mesh=) (a 100,000 x 768 database, 3
    queries, k 10) against the same without a mesh: equal bytes, equal
    top-10.  Returns the mesh runs' launches."""
    import torch
    import torch.distributed as dist

    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:      # the store lives as long as the group
        mesh = make_mesh(backend="nccl", device=torch.device("cuda", 0),
                         store=dist.FileStore(os.path.join(d, "store"), 1), rank=0,
                         world_size=1, timeout_s=600)
        try:
            total = _mesh_checks(mesh)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit({"phase": "mesh", "seconds": time.perf_counter() - t_phase, "launches": total,
          "nvidia_smi": smi})
    return total


def _mesh_checks(mesh) -> dict:
    """Phase mesh's checks over `mesh`; returns the mesh runs' launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from diffusion_spacetime_attn_tpu_torch.pipeline.retrieval import Retriever, shard_database

    emit({"phase": "mesh_group", "backend": dist.get_backend(), "world": mesh.data,
          "device": torch.cuda.get_device_name(0)})
    total = {k: 0 for k in KERNELS}
    unet = _mesh_unet()
    start = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    x0, ctx = _mesh_batch(1, 31)
    ref = _ldm_mesh_step(unet, None, False, x0, ctx, 32)
    for fsdp in (False, True):
        with torch.no_grad():
            unet.load_state_dict(start)
        got = _ldm_mesh_step(unet, mesh, fsdp, x0, ctx, 32)
        tag = "mesh_fsdp" if fsdp else "mesh_dp"
        line = _mesh_compare(tag, got, ref)
        _sum_launches(total, got["launches"])
        emit({"phase": tag, "backend": "nccl", "ranks": 1, "batch": 1, "dtype": "float32",
              **line, "s_per_step": got["step_s"], "s_per_step_one": ref["step_s"],
              "state_bytes": got["state_bytes"], "replicated_bytes": got["replicated_bytes"],
              "allocated_after_init": got["allocated_after_init"]})
        del got
    del unet, start, ref
    torch.cuda.empty_cache()
    prompts, seeds = ["a cat above a dog", "a red car on a road"], [3, 4]
    got, one, launches, seconds = _mesh_engines(mesh, "bfloat16", prompts, seeds, True)
    _sum_launches(total, launches)
    if not np.array_equal(got, one):
        fail(f"mesh_engine: the one-rank mesh's images differ from the engine's: "
             f"max {int(np.abs(got.astype(int) - one.astype(int)).max())}")
    emit({"phase": "mesh_engine", "backend": "nccl", "steps": MESH_ENGINE_STEPS,
          "same_bytes": True, "seconds": seconds, "launches": launches})
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(15)
    db = _random_database(100_000, gen)
    q = torch.randn((3, 768), generator=gen, device="cuda")
    want = db.search(q, MESH_KNN)
    sharded = Retriever(embedding=shard_database(db.embedding, mesh), img_id=db.img_id,
                        patch_coords=db.patch_coords, mesh=mesh, rows=db.embedding.shape[0])
    got = sharded.search(q, MESH_KNN)
    if not (torch.equal(got["nns"], want["nns"]) and torch.equal(got["scores"], want["scores"])
            and torch.equal(got["nn_embeddings"], want["nn_embeddings"])):
        fail("mesh_retriever: the one-rank mesh's top-10 differs from the Retriever's")
    emit({"phase": "mesh_retriever", "backend": "nccl", "rows": db.embedding.shape[0],
          "k": MESH_KNN, "same_top_k": True})
    return total


def mesh2_rank(rank: int, d: str) -> None:
    """One of phase mesh2's processes (`chip_smoke.py --mesh2-rank R DIR`):
    the group over gloo on cuda:0 through a FileStore in DIR; writes
    `<DIR>/rank<R>.json`.  A failed check or collective raises, and the
    process exits non-zero."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import make_mesh, rows
    from diffusion_spacetime_attn_tpu_torch.pipeline.retrieval import (
        exact_search,
        shard_database,
        sharded_search,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(backend="gloo", device=torch.device("cuda", 0),
                     store=dist.FileStore(os.path.join(d, "store"), MESH2_RANKS), rank=rank,
                     world_size=MESH2_RANKS, timeout_s=MESH2_TIMEOUT_S)
    out = {"rank": rank, "device": torch.cuda.get_device_name(0), "backend": dist.get_backend(),
           "launches": {k: 0 for k in KERNELS}, "t_starts": {}}
    B = MESH2_ROWS * MESH2_RANKS
    mine = rows(mesh, B)
    x0, ctx = _mesh_batch(B, 41)
    # (a) the data-parallel f32 step against the one-process step on the global batch
    emit({"mesh2_rank": rank, "starts": "dp"})
    out["t_starts"]["dp"] = round(time.perf_counter() - _T0, 1)
    unet = _mesh_unet(num_res_blocks=MESH2_RES_BLOCKS)
    start = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    dp = _ldm_mesh_step(unet, mesh, False, x0[mine], ctx[mine], 42)
    _sum_launches(out["launches"], dp["launches"])
    check = float(sum(p.double().sum() for p in dp["params"].values()))
    sums = [torch.zeros(1, dtype=torch.float64, device="cuda") for _ in range(MESH2_RANKS)]
    dist.all_gather(sums, torch.tensor([check], dtype=torch.float64, device="cuda"))
    if len({float(s) for s in sums}) != 1:
        fail(f"mesh2_dp: the ranks' weights differ after the step: {[float(s) for s in sums]}")
    out["dp"] = {"s_per_step": dp["step_s"], "launches": dp["launches"],
                 "state_bytes": dp["state_bytes"],
                 "allocated_after_init": dp["allocated_after_init"], "lr": dp["lr"]}
    ref = None
    if rank == 0:     # the one-process step after the mesh's: its state is freed by then
        with torch.no_grad():
            unet.load_state_dict(start)
        ref = _ldm_mesh_step(unet, None, False, x0, ctx, 42)
        out["dp"].update(_mesh_compare("mesh2_dp", dp, ref, MESH2_SITES),
                         s_per_step_one=ref["step_s"])
        ref = {k: ref[k] for k in ("loss", "params", "ema")}
    del dp
    torch.cuda.empty_cache()
    # (b) FSDP over the two ranks (gloo carries reduce_scatter / all_gather on CUDA tensors)
    emit({"mesh2_rank": rank, "starts": "fsdp"})
    out["t_starts"]["fsdp"] = round(time.perf_counter() - _T0, 1)
    with torch.no_grad():
        unet.load_state_dict(start)
    del start
    torch.cuda.empty_cache()
    fs = _ldm_mesh_step(unet, mesh, True, x0[mine], ctx[mine], 42, grads=False)
    _sum_launches(out["launches"], fs["launches"])
    out["fsdp"] = {"s_per_step": fs["step_s"], "launches": fs["launches"],
                   "state_bytes": fs["state_bytes"], "replicated_bytes": fs["replicated_bytes"],
                   "allocated_after_init": fs["allocated_after_init"]}
    if rank == 0:
        out["fsdp"].update(_mesh_compare("mesh2_fsdp", fs, ref, MESH2_SITES))
    del fs, unet, ref
    torch.cuda.empty_cache()
    # (c) the sharded search over phase knn2img's database size
    emit({"mesh2_rank": rank, "starts": "search"})
    out["t_starts"]["search"] = round(time.perf_counter() - _T0, 1)
    gen = torch.Generator(device="cuda").manual_seed(13)
    db = _random_database(MESH_DB_ROWS, gen).embedding
    q = torch.randn((3, 768), generator=gen, device="cuda")
    want = exact_search(db, q, MESH_KNN) if rank == 0 else None
    shard = shard_database(db, mesh).clone()
    del db
    torch.cuda.empty_cache()
    sharded_search(shard, q, MESH_KNN, mesh, MESH_DB_ROWS)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, i = sharded_search(shard, q, MESH_KNN, mesh, MESH_DB_ROWS)
    torch.cuda.synchronize()
    out["search"] = {"ms": 1e3 * (time.perf_counter() - t0), "shard_rows": shard.shape[0]}
    if rank == 0:
        score_diff = float((s - want[0]).abs().max())
        if not torch.equal(i, want[1]) or score_diff > 1e-6:
            fail(f"mesh2_search: top-{MESH_KNN} {i.tolist()} vs {want[1].tolist()}, "
                 f"scores {score_diff}")
        out["search"].update(same_top_k=True, max_score_diff=score_diff)
    del shard
    torch.cuda.empty_cache()
    # (d) TextToImageEngine over the two ranks, float32, one row each
    emit({"mesh2_rank": rank, "starts": "engine"})
    out["t_starts"]["engine"] = round(time.perf_counter() - _T0, 1)
    prompts, seeds = ["a cat above a dog", "a red car on a road"], [3, 4]
    got, one, launches, seconds = _mesh_engines(mesh, "float32", prompts, seeds, False)
    _sum_launches(out["launches"], launches)
    out["engine"] = {"seconds": seconds, "launches": launches, "shape": list(got.shape)}
    if rank == 0:
        diff = int(np.abs(got.astype(int) - one.astype(int)).max())
        if diff > 1:
            fail(f"mesh2_engine: {diff} uint8 levels from the one-process engine")
        out["engine"]["max_uint8_diff"] = diff
    # (e) the model axis: tensor parallelism over the same two ranks
    emit({"mesh2_rank": rank, "starts": "tp"})
    out["t_starts"]["tp"] = round(time.perf_counter() - _T0, 1)
    out["tp"] = _mesh2_tp(rank, d)
    out["t_starts"]["end"] = round(time.perf_counter() - _T0, 1)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _tp_eval(unet, x, t, ctx, ctl, grads: bool) -> dict:
    """One controlled evaluation of `unet` (sharded or not) and, with
    `grads`, the gradient of Σ eps² for coef and the parameters: eps, loss,
    dcoef, the launches and designs counted around it, the model
    all-reduces (`parallel/tensor.STATS`), seconds."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.parallel import tensor as tp

    wrappers = _wrappers()
    coef = ctl.coef.clone().requires_grad_(grads)
    for p in unet.parameters():
        p.grad = None
    torch.cuda.synchronize()
    _reset_counts(wrappers.values())
    tp.reset_stats()
    t0 = time.perf_counter()
    with torch.set_grad_enabled(grads):
        eps = unet(x, t, ctx, ctl._replace(coef=coef))
        loss = (eps.float() ** 2).sum()
        if grads:
            loss.backward()
    torch.cuda.synchronize()
    return {"eps": eps.detach(), "loss": float(loss), "seconds": time.perf_counter() - t0,
            "dcoef": None if coef.grad is None else coef.grad.clone(),
            "launches": {k: w.launches for k, w in wrappers.items()},
            "by_design": {k: dict(w.launches_by_design) for k, w in wrappers.items()
                          if hasattr(w, "launches_by_design")},
            "allreduce": dict(tp.STATS)}


def _tp_engine(tp, dtype: str):
    """SpaceTimeEngine at SD v1-4 width over `tp` (None: one process),
    MESH2_TP_STEPS PLMS steps, MESH2_TP_EPOCHS epochs, batch 1 with phase
    optimize's four objects, the four kernel flags; seeded weights."""
    import dataclasses

    from diffusion_spacetime_attn_tpu_torch.config import (
        CLIPConfig,
        CLIPVisionConfig,
        PipelineConfig,
        UNetConfig,
        VAEConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.serving.server import SpaceTimeEngine

    cfg = PipelineConfig(unet=UNetConfig(dtype=dtype, use_flash=True, use_mha=True,
                                         use_fused_ff=True, use_fused_control=True),
                         vae=VAEConfig(dtype=dtype))
    cfg = dataclasses.replace(cfg, spacetime=dataclasses.replace(
        cfg.spacetime, num_steps=MESH2_TP_STEPS, epochs=MESH2_TP_EPOCHS))
    clip_cfg = CLIPConfig(vision=CLIPVisionConfig(dtype=dtype),
                          text=dataclasses.replace(CLIPConfig().text, dtype=dtype))
    sd = StableDiffusion.create(cfg, seed=0, device="cuda")
    runner = _spacetime_engine(sd, DCLIPLoss.create(clip_cfg, seed=4, device="cuda"), 1).runner
    return SpaceTimeEngine(runner=runner, batch_size=1, mesh=tp)


def _mesh2_tp(rank: int, d: str) -> dict:
    """Part tp of phase mesh2: a Mesh(data=1, model=2) over the two gloo
    ranks on cuda:0.  The SD v1-4 UNet at full width and MESH2_TP_RES_BLOCKS
    residual blocks per level, sharded (`shard_params`: each rank 4 of the
    8 heads, half of every GEGLU's features), one controlled evaluation (1
    prompt, 4 objects) with its gradient for coef and the parameters, float32,
    against the same evaluation unsharded on this rank (each rank holds its
    shard of the reference's gradients to MESH2_TP_LIMITS); the bf16 forward
    likewise at phase unet's limit, every GEGLU and spacetime launch on
    wgmma; the launches per rank exactly MESH2_TP_SITES; each evaluation's
    one-rank time taken on rank 0 while rank 1 waits.  Then SpaceTimeEngine
    over the mesh (f32, PLMS-3, one training epoch, MESH2_TP_REQUEST; its
    launches per rank exactly one device's per batch), its images written
    to `<d>/tp_engine<rank>.npy` for phase_mesh2.  Returns
    the part's figures."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from diffusion_spacetime_attn_tpu_torch.config import UNetConfig
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.parallel import tensor as tpt
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import make_mesh
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import model_shard, shard_params
    from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_

    t_part = time.perf_counter()
    tp = make_mesh(data=1, model=MESH2_RANKS, backend="gloo", device=torch.device("cuda", 0))
    out = {"mesh": [tp.data, tp.model], "coords": [tp.data_index, tp.model_index],
           "res_blocks": MESH2_TP_RES_BLOCKS,
           "depth": "full (SD's two residual blocks per level fit on the card)",
           "limits": MESH2_TP_LIMITS}
    gen = torch.Generator(device="cuda").manual_seed(51)
    x = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((2,), 981, dtype=torch.int32, device="cuda")
    ctx = torch.randn((2, CONTEXT_LEN, 768), generator=gen, device="cuda")
    ctl = _control(1, torch.device("cuda"), gen)
    launches = {}
    for dtype in ("float32", "bfloat16"):
        grads = dtype == "float32"
        with torch.device("cuda"):
            cfg = UNetConfig(dtype=dtype, use_flash=True, use_fused_ff=True,
                             use_fused_control=True, num_res_blocks=MESH2_TP_RES_BLOCKS)
            ref, unet = UNet(cfg, radius=0.2), UNet(cfg, radius=0.2)
        randomize_(ref, 1)
        unet.load_state_dict(ref.state_dict())
        shard_params(unet, tp)
        one = _tp_eval(ref, x, t, ctx, ctl, grads)
        got = _tp_eval(unet, x, t, ctx, ctl, grads)
        tag = "f32" if grads else "bf16"
        line = {"s_per_eval": got["seconds"], "allreduce": got["allreduce"],
                "launches": got["launches"]}
        if grads:
            loss_rel = abs(got["loss"] - one["loss"]) / abs(one["loss"])
            grad_rel = {}
            for k, p in unet.named_parameters():
                w = model_shard(unet, k, dict(ref.named_parameters())[k].grad)
                grad_rel[k] = float(torch.linalg.vector_norm(p.grad - w)
                                    / torch.linalg.vector_norm(w).clamp_min(1e-30))
            dcoef_rel = float(torch.linalg.vector_norm(got["dcoef"] - one["dcoef"])
                              / torch.linalg.vector_norm(one["dcoef"]).clamp_min(1e-30))
            worst = max(grad_rel, key=grad_rel.get)
            line.update(loss=got["loss"], loss_one=one["loss"], loss_rel=loss_rel,
                        grad_rel_norm_max=grad_rel[worst], grad_worst=worst,
                        dcoef_rel_norm=dcoef_rel, dcoef=got["dcoef"].tolist())
            if not (loss_rel <= 1e-5 and grad_rel[worst] <= 1e-3 and dcoef_rel <= 1e-3):
                fail(f"mesh2_tp f32: against one rank: {line}")
            expected = {k: MESH2_TP_SITES.get(k, 0) for k in got["launches"]}
        else:
            diff = float((got["eps"].float() - one["eps"].float()).abs().max())
            scale = float(one["eps"].float().abs().max())
            line.update(max_abs_diff=diff, max_abs_eps=scale, tol=5e-2 * scale + 1e-3,
                        by_design={k: got["by_design"][k] for k in ("geglu_fwd",
                                                                     "spacetime_fwd")})
            if not (torch.isfinite(got["eps"]).all() and diff <= line["tol"] and scale > 0):
                fail(f"mesh2_tp bf16: against one rank: {line}")
            off = {k: n for k in ("geglu_fwd", "spacetime_fwd")
                   for d, n in got["by_design"][k].items() if d != "wgmma" and n}
            if off:
                fail(f"mesh2_tp bf16: launches off the wgmma designs: {off}")
            expected = {k: MESH2_TP_SITES.get(k, 0) if k.endswith("fwd") else 0
                        for k in got["launches"]}
        if got["launches"] != expected:
            fail(f"mesh2_tp {tag}: launches {got['launches']}, expected {expected}")
        _sum_launches(launches, got["launches"])
        if rank == 0:       # one rank's evaluation with the card to itself (rank 1 waits)
            line["s_per_eval_one"] = _tp_eval(ref, x, t, ctx, ctl, grads)["seconds"]
        dist.barrier()
        out[tag] = line
        del ref, unet, one, got
        torch.cuda.empty_cache()
    # the engine over the model axis (f32: the sums over the ranks
    # reassociate, so bf16 would round apart); phase_mesh2 holds its images
    # against one process's, made meanwhile in the parent
    eng = _tp_engine(tp, "float32")
    wrappers = _wrappers()
    torch.cuda.synchronize()
    _reset_counts(wrappers.values())
    tpt.reset_stats()
    t0 = time.perf_counter()
    images, coef, _ = eng.optimize_batch(*MESH2_TP_REQUEST)
    np.save(os.path.join(d, f"tp_engine{rank}.npy"), eng.to_uint8(images))
    seconds = time.perf_counter() - t0
    eng_launches = {k: w.launches for k, w in wrappers.items()}
    evals = chain_evals("plms", MESH2_TP_STEPS)
    expected = {k: (MESH2_TP_EPOCHS - 1) * chain_launches(k, evals)
                + (0 if k.endswith("bwd") else evals * SITES_PER_EVAL[k]) for k in eng_launches}
    if eng_launches != expected:     # one device's per batch, on each rank
        fail(f"mesh2_tp engine: launches {eng_launches}, expected {expected}")
    _sum_launches(launches, eng_launches)
    out["engine"] = {"seconds": seconds, "steps": MESH2_TP_STEPS, "epochs": MESH2_TP_EPOCHS,
                     "launches": eng_launches, "allreduce": dict(tpt.STATS),
                     "coef": coef.tolist()}
    del eng
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_part
    return out


def phase_mesh2(smi: str):
    """Two processes on cuda:0 over gloo (NCCL refuses two ranks on one
    card), one spawn for all of it (`mesh2_rank`): the SD v1-4 UNet at MESH2_RES_BLOCKS residual
    blocks per level, its data-parallel f32 step at a global batch of 4
    (2 rows per rank) against
    the one-process step on the same batch (train_f32's limits: the loss,
    the gradients averaged over the ranks, the updated weights and EMA), the
    same under FSDP over the two ranks but the gradients (state bytes and
    allocated bytes per rank), `sharded_search` over a 1,000,000 x 768 database split over the
    ranks against `exact_search`, TextToImageEngine(mesh=) at batch 2
    (one row per rank), PLMS-10, float32, within one uint8 level of the
    one-process engine, and part tp (`_mesh2_tp`: the model axis over the
    same ranks), whose engine images must be within one uint8 level of the
    same engine in this process, run while the ranks start (the ranks'
    dp and fsdp steps share the card with it).  A rank that fails exits
    non-zero and so does this phase.  Returns the ranks' summed launches
    and part tp's launches per rank."""
    import numpy as np

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh2-rank",
                                   str(r), d], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(MESH2_RANKS)]
        logs = ["" for _ in procs]
        try:
            deadline = time.monotonic() + MESH2_TIMEOUT_S
            # part tp's reference: the engine in this process, while the ranks run
            t_one = time.perf_counter()
            eng = _tp_engine(None, "float32")
            one = eng.generate_batch(*MESH2_TP_REQUEST)
            one_s = time.perf_counter() - t_one
            del eng
            import torch

            torch.cuda.empty_cache()
            for r, p in enumerate(procs):
                logs[r], _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            for r in bad:
                print(f"--- mesh2 rank {r} (exit {procs[r].returncode}):\n{logs[r][-6000:]}",
                      flush=True)
            fail(f"mesh2: ranks {bad} failed or hung")
        outs = []
        for r in range(MESH2_RANKS):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                outs.append(json.load(f))
            got = np.load(os.path.join(d, f"tp_engine{r}.npy"))
            diff = int(np.abs(got.astype(int) - one.astype(int)).max())
            if got.shape != one.shape or diff > 1:
                fail(f"mesh2_tp engine: rank {r} {diff} uint8 levels from one process")
            outs[-1]["tp"]["engine"].update(max_uint8_diff=diff, one_process_s=one_s)
    for o in outs:
        emit({"phase": "mesh2_rank", **{k: o[k] for k in ("rank", "device", "backend",
                                                           "t_starts")}})
    for part in ("dp", "fsdp", "search", "engine", "tp"):
        emit({"phase": f"mesh2_{part}", "backend": "gloo", "ranks": MESH2_RANKS,
              "per_rank": [o[part] for o in outs]})
    tp_launches = [o["tp"]["launches"] for o in outs]
    if any(c != tp_launches[0] for c in tp_launches):
        fail(f"mesh2_tp: the ranks launched differently: {tp_launches}")
    if outs[0]["tp"]["engine"]["coef"] != outs[1]["tp"]["engine"]["coef"]:
        fail("mesh2_tp: the ranks' engines optimized different coefs")
    total = {k: 0 for k in KERNELS}
    for o in outs:
        _sum_launches(total, o["launches"])
    emit({"phase": "mesh2", "seconds": time.perf_counter() - t0, "launches": total,
          "tp_launches_per_rank": tp_launches[0], "nvidia_smi": smi})
    return total, tp_launches[0]


# ---------------------------------------------------------------- the measuring tools

KNOB_Q_CHUNK = 1024             # phase knobs: attn_q_chunk (4 chunks at level 0's 4096 tokens)
POLICY_STEPS = 10               # phase remat_policy's PLMS steps (as phase optimize)
TRACE_STEPS, TRACE_BATCH = 5, 2
# phase trace: per wrapper, the device kernels it launches once per call
# (GEGLU's wgmma design: gate then out; the flash backward's: dq, then dK/dV)
TRACE_KERNELS = {"vanilla": {"mha_fwd": ("mha_fwd_",),
                             "geglu_fwd": ("geglu_gate_wgmma_kernel", "geglu_out_wgmma_kernel")},
                 "spacetime": {"flash_fwd": ("flash_fwd_",),
                               "flash_bwd": ("flash_bwd_dq_", "flash_bwd_dkv_")}}
FLOPS_TIMED = "dpm20_b8_final_fwd"
FLOPS_JOBS = 3                  # the background count's processes (beside the card's phases)


def phase_knobs():
    """UNetConfig's memory knobs at full SD v1-4 width, bf16, the engine's
    batch (2 prompts = 4 CFG rows, 4 objects): attn_scores_dtype="bfloat16"
    with attn_q_chunk=KNOB_Q_CHUNK against the defaults, on the same
    weights.  With the kernels on (flash, MHA, GEGLU, spacetime) every
    self-attention site is a kernel's, which the knobs leave alone: equal
    bits.  On the plain path the knobs move eps within phase unet's bf16
    limit.  Recorded: the peak memory of the plain UNet evaluation and of one
    level-0 self-attention (4096 tokens, 8 heads) with and without q_chunk."""
    import dataclasses

    import torch

    from diffusion_spacetime_attn_tpu_torch.config import UNetConfig
    from diffusion_spacetime_attn_tpu_torch.models.layers import cast_matmul_weights
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.ops.attention import attention
    from diffusion_spacetime_attn_tpu_torch.utils.cudnn import deterministic
    from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_

    dev = torch.device("cuda")
    knobs = dict(attn_scores_dtype="bfloat16", attn_q_chunk=KNOB_Q_CHUNK)
    on = UNetConfig(dtype="bfloat16", use_flash=True, use_mha=True, use_fused_ff=True,
                    use_fused_control=True)
    off = UNetConfig(dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((2 * SERVE_PROMPTS, 64, 64, 4), generator=gen, device=dev)
    t = torch.full((2 * SERVE_PROMPTS,), 981, dtype=torch.int32, device=dev)
    ctx = torch.randn((2 * SERVE_PROMPTS, CONTEXT_LEN, 768), generator=gen, device=dev)
    ctl = _control(SERVE_PROMPTS, dev, gen)
    state, eps, peak, secs = None, {}, {}, {}
    for name, cfg in (("on", on), ("on_knobs", dataclasses.replace(on, **knobs)),
                      ("off", off), ("off_knobs", dataclasses.replace(off, **knobs))):
        with torch.device(dev):
            unet = UNet(cfg)
        if state is None:
            randomize_(unet, seed=1)
            state = {k: v.clone() for k, v in unet.state_dict().items()}
        else:
            unet.load_state_dict(state)
        cast_matmul_weights(unet).eval().requires_grad_(False)
        with torch.inference_mode(), deterministic():
            unet(x, t, ctx, ctl)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            eps[name] = unet(x, t, ctx, ctl)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            peak[name] = torch.cuda.max_memory_allocated() - base
        del unet
        torch.cuda.empty_cache()
    q = torch.randn((2 * SERVE_PROMPTS, 4096, 320), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    level0 = {}
    with torch.inference_mode():
        for chunk in (0, KNOB_Q_CHUNK):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            attention(q, q, q, HEADS, q_chunk=chunk, scores_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            level0[chunk] = torch.cuda.max_memory_allocated() - base
    equal = bool(torch.equal(eps["on"], eps["on_knobs"]))
    diff = float((eps["off_knobs"] - eps["off"]).abs().max())
    scale = float(eps["off"].abs().max())
    tol = 5e-2 * scale + 1e-3
    emit({"phase": "knobs", "knobs": knobs, "rows": 2 * SERVE_PROMPTS,
          "kernels_on_equal_bits": equal, "plain_max_abs_diff": diff, "max_abs_eps": scale,
          "tol": tol, "eval_s": secs, "eval_peak_bytes": peak,
          "level0_attention_peak_bytes": {"q_chunk_0": level0[0],
                                          f"q_chunk_{KNOB_Q_CHUNK}": level0[KNOB_Q_CHUNK]}})
    if not equal:
        fail("knobs: the kernels-on UNet changed with attn_scores_dtype / attn_q_chunk")
    if not (torch.isfinite(eps["off_knobs"]).all() and diff <= tol and scale > 0):
        fail(f"knobs: plain path with the knobs vs without, max diff {diff} > {tol}")
    if not level0[KNOB_Q_CHUNK] < level0[0]:
        fail(f"knobs: q_chunk did not lower the level-0 peak ({level0})")


def phase_remat_policy(engine):
    """`generation_loss` and its gradient in the blend weights at full SD
    v1-4 width, bf16, PLMS at POLICY_STEPS, batch 2, 4 objects, the four
    kernel flags (phase optimize's engine), under remat=True, "dots" and
    "dots_nb": each launches chain_launches(k, POLICY_STEPS + 1) of every
    kernel (the CUDA kernels are no aten ops: the recompute runs them again
    under every policy); loss and dcoef within 1e-3 relative of True's (bit
    equality reported); seconds and peak memory per policy."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.pipeline.spacetime import generation_loss, init_coef

    sd, clip_loss = engine.runner.sd, engine.runner.clip_loss
    if sd.schedule.num_steps != POLICY_STEPS:
        fail(f"remat_policy: the engine runs {sd.schedule.num_steps} steps")
    wrappers = _wrappers()
    evals = chain_evals("plms", POLICY_STEPS)
    want = {k: chain_launches(k, evals) for k in wrappers}
    with torch.no_grad():
        inputs = engine._inputs(["a cat and a dog near a tree and a car", "a dog left of a car"],
                                [11, 12])
    out = {}
    for policy in (True, "dots", "dots_nb"):
        coef = init_coef(inputs.active, POLICY_STEPS,
                         sd.cfg.spacetime.init_coef).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_counts(wrappers.values())
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = generation_loss(coef, sd, clip_loss, inputs, sd.cfg.spacetime, "plms",
                                      remat=policy)
            loss.backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: w.launches for k, w in wrappers.items()}
        out[policy] = (loss.detach().float(), coef.grad.float().clone())
        line = {"phase": "remat_policy", "remat": policy, "steps": POLICY_STEPS,
                "batch": SERVE_PROMPTS, "seconds": seconds,
                "peak_bytes_over_weights": torch.cuda.max_memory_allocated() - base,
                "loss": float(loss.detach()), "launches": launched}
        if policy is not True:
            (l0, g0), (l1, g1) = out[True], out[policy]
            line.update(loss_rel=float((l1 - l0).abs() / l0.abs()),
                        dcoef_rel_norm=float(torch.linalg.vector_norm(g1 - g0)
                                             / torch.linalg.vector_norm(g0)),
                        equal_bits=bool(torch.equal(l0, l1) and torch.equal(g0, g1)))
        emit(line)
        if launched != want:
            fail(f"remat_policy {policy}: launches {launched}, expected {want}")
        if not (torch.isfinite(loss) and torch.isfinite(coef.grad).all()):
            fail(f"remat_policy {policy}: loss or gradient not finite")
        if policy is not True and not (line["loss_rel"] <= 1e-3
                                       and line["dcoef_rel_norm"] <= 1e-3):
            fail(f"remat_policy {policy}: loss rel {line['loss_rel']}, dcoef rel norm "
                 f"{line['dcoef_rel_norm']} against remat=True (> 1e-3)")
        del loss, coef


def phase_trace(root: str):
    """`scripts/profiler.main` in vanilla and spacetime mode (SD v1-4, bf16,
    PLMS at TRACE_STEPS, batch TRACE_BATCH, one traced iteration) and
    `scripts/analyze_trace.main --json` on each trace: for each kernel of
    TRACE_KERNELS, the count of each of its device kernels in the table
    equals its wrapper's launch count over the traced iteration; the table
    holds device events only (no CPU op, runtime call or range); the device
    total per mode is recorded."""
    import contextlib
    import io

    from diffusion_spacetime_attn_tpu_torch.scripts import analyze_trace, profiler

    for mode, kernels in TRACE_KERNELS.items():
        d = os.path.join(root, mode)
        t0 = time.perf_counter()
        line = profiler.main(["--mode", mode, "--batch", str(TRACE_BATCH), "--steps",
                              str(TRACE_STEPS), "--iters", "1", "--trace-dir", d])
        profile_s = time.perf_counter() - t0
        events = analyze_trace.load_events(line["trace"])
        buf = io.StringIO()            # the analyzer's --json on the trace loaded once
        with contextlib.redirect_stdout(buf), \
                mock.patch.object(analyze_trace, "load_events", lambda path: events):
            analyze_trace.main(["--trace-dir", d, "--json", "--top", "1000000"])
        rows = json.loads(buf.getvalue())
        cpu_names = {e.get("name") for e in events
                     if e.get("cat") not in analyze_trace.DEVICE_CATEGORIES}
        counts = {k: {p: sum(r["count"] for r in rows if r["op"].startswith(p)) for p in pre}
                  for k, pre in kernels.items()}
        emit({"phase": "trace", "mode": mode, "steps": TRACE_STEPS, "batch": TRACE_BATCH,
              "seconds": profile_s, "trace_mb": os.path.getsize(line["trace"]) / 2 ** 20,
              "device_total_ms": sum(r["total_ms"] for r in rows), "rows": len(rows),
              "launches": line["launches"], "table_counts": counts,
              "top": [{k: r[k] for k in ("op", "family", "total_ms", "count")}
                      for r in rows[:8]]})
        for k, by in counts.items():
            if line["launches"][k] == 0 or any(n != line["launches"][k] for n in by.values()):
                fail(f"trace {mode}: {k} launched {line['launches'][k]} times, the table "
                     f"counts {by}")
        overlap = cpu_names & {r["op"] for r in rows}
        if not rows or overlap:
            fail(f"trace {mode}: {len(rows)} rows, CPU events in the table: {sorted(overlap)[:5]}")
        os.remove(line["trace"])


def start_flops_count(root: str):
    """`scripts/flops_model.py` counting the five programs on the meta device
    in the background (FLOPS_JOBS processes at the lowest CPU priority, no
    card), beside the card's phases; `phase_flops` reads its artifact."""
    out = os.path.join(root, "mfu_counts.json")
    log = open(os.path.join(root, "flops_model.log"), "w")
    proc = subprocess.Popen(["nice", "-n", "19", sys.executable, "-m",
                             "diffusion_spacetime_attn_tpu_torch.scripts.flops_model",
                             "--jobs", str(FLOPS_JOBS), "--out", out],
                            stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, out, log


def stop_flops_count(count) -> None:
    """Stop the count and its pool's processes (one process group)."""
    import signal

    proc = count[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def phase_flops(count, smi: str):
    """The background count's five programs must equal FLOPS_SD (matmul and
    conv, exactly); then FLOPS_TIMED runs on the card as `flops_model.py
    --time` runs it (kernels on, bf16, one call, then the median of 3): its
    TF/s and % of the H100's 989 TF/s bf16 peak, beside the card's name and
    power limit."""
    from diffusion_spacetime_attn_tpu_torch.scripts import flops_model

    proc, path, log = count
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=600)
    finally:
        log.close()
    waited_s = time.perf_counter() - t0
    if rc != 0:
        with open(log.name) as f:
            print(f.read()[-3000:], flush=True)
        fail(f"flops: flops_model.py exited with {rc}")
    with open(path) as f:
        art = json.load(f)
    counts = {n: (r["matmul_flops"], r["conv_flops"]) for n, r in art["programs"].items()}
    if counts != {n: tuple(map(float, v)) for n, v in FLOPS_SD.items()}:
        fail(f"flops: meta-device counts {counts} differ from FLOPS_SD")
    s = flops_model.time_program(FLOPS_TIMED, iters=3)
    mm, conv = counts[FLOPS_TIMED]
    row = flops_model.mfu_row({"matmul": mm, "conv": conv, "total": mm + conv},
                              {"s_per_call": s, "nvidia_smi": smi})
    emit({"phase": "flops", "count_device": art["count_device"], "count_s": art["count_s"],
          "waited_s": waited_s, "counts": counts,
          "pflops_per_call": {n: r["pflops_per_call"] for n, r in art["programs"].items()},
          "timed": FLOPS_TIMED, **row, "peak_tfs": flops_model.H100_PEAK_TFS_BF16})


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        return compare_trees(os.path.abspath(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh2-rank":
        import faulthandler

        faulthandler.enable()             # a crash in native code still shows where
        try:
            mesh2_rank(int(sys.argv[2]), sys.argv[3])
        except BaseException:
            # exit at once: the other rank's next collective then fails
            # instead of waiting out its timeout
            import traceback

            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
        return 0
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    flops_root = tempfile.mkdtemp()
    count = start_flops_count(flops_root)
    try:
        agg = phase_kernels()
        agg.update(phase_kernels_bwd())
        phase_kernels(RDM_SITES, RDM_PROMPTS, RDM_HEAD_WIDTH, "kernel_rdm", RDM_DESIGNS,
                      ("mha", "geglu"))
        phase_unet()
        phase_knobs()
        phase_slice()
        phase_chain()
        import torch

        serve_launches, serve_designs, sd = phase_serve()
        phase_profile(sd)
        http_launches = phase_http(sd)
        loadtest_launches = phase_loadtest(sd, smi)
        del sd
        torch.cuda.empty_cache()
        cli_launches = phase_serve_cli()
        torch.cuda.empty_cache()
        launches, opt_designs, engine = phase_optimize()
        phase_profile_train(engine.runner.sd)
        phase_remat_policy(engine)
        dpm_launches = phase_samplers(engine)
        del engine
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as root:
            image_launches = phase_image_in(root, smi)
        torch.cuda.empty_cache()
        phase_testbed()
        phase_layout()
        phase_slot()
        with tempfile.TemporaryDirectory() as root:
            runner_launches, results = phase_runner(root)
            phase_eval(root, results)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as root:
            ingest_launches = phase_ingest(root, smi)
        torch.cuda.empty_cache()
        phase_train_check()
        with tempfile.TemporaryDirectory() as root:
            train_counts = phase_train_bench(root, smi)
            phase_train_cli(root)
        torch.cuda.empty_cache()
        phase_knn2img_f32()
        with tempfile.TemporaryDirectory() as root:
            knn2img_launches, knn2img_images = phase_knn2img(root, smi)
        phase_safety(knn2img_images, smi)
        del knn2img_images
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as root:
            phase_train_layout(root, smi)
        torch.cuda.empty_cache()
        phase_image_io(smi)
        phase_formats(smi)
        with tempfile.TemporaryDirectory() as root:
            data_launches = phase_train_data(root, smi)
        with tempfile.TemporaryDirectory() as root:
            phase_legacy_vg(root, smi)
        torch.cuda.empty_cache()
        mesh_launches = phase_mesh(smi)
        mesh2_launches, tp_launches = phase_mesh2(smi)
        _sum_launches(mesh_launches, mesh2_launches)
        with tempfile.TemporaryDirectory() as root:
            phase_trace(root)
        torch.cuda.empty_cache()
        phase_flops(count, smi)
        missing = [k for k in ("geglu_fwd", "geglu_bwd", "flash_fwd", "flash_bwd", "mha_fwd")
                   if mesh_launches.get(k, 0) == 0]
        if missing:
            fail(f"kernels never launched on the mesh path: {missing}")
        for path, counts in (("optimization", launches), ("DPM-Solver++ optimization", dpm_launches),
                             ("dataset sweep", runner_launches), ("ingestion", ingest_launches)):
            missing = [k for k in KERNELS if counts.get(k, 0) == 0]
            if missing:
                fail(f"kernels never launched on the {path} path: {missing}")
        by_design = {}
        for counts in (serve_designs, opt_designs):
            _add_counts(by_design, counts)

        rows = []
        for kname, meta in KERNELS.items():
            a = agg[kname]
            row = {"name": kname, **meta, "launches": launches[kname],
                   "serve_launches": serve_launches.get(kname, 0),
                   "dpm_launches": dpm_launches[kname],
                   "runner_launches": runner_launches[kname],
                   "http_launches": http_launches[kname],
                   "loadtest_launches": loadtest_launches[kname],
                   "cli_launches": cli_launches[kname],
                   "ingest_launches": ingest_launches[kname],
                   "image_in_launches": image_launches[kname],
                   "train_launches": train_counts[kname],
                   "knn2img_launches": knn2img_launches[kname],
                   "data_train_launches": data_launches[kname],
                   "mesh_launches": mesh_launches.get(kname, 0),
                   "tp_launches": tp_launches.get(kname, 0),
                   "max_abs_err": a["max_abs_err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
                   "bound_ms": a["bound_ms"],
                   "bound_by": ("operations" if max(a["flops_ms"], a["exps_ms"]) >= a["bytes_ms"]
                                else "bytes"),
                   "library_ms": a["library_ms"]}
            if kname in by_design:   # the designs the serving and optimization runs took
                row["design"] = "+".join(d for d, n in sorted(by_design[kname].items()) if n)
                row["launches_by_design"] = by_design[kname]
            rows.append(row)
        # times: per UNet evaluation at the engine's batch of 2 prompts (each
        # kernel's sites: 16, flash 10 at levels 0 and 1, MHA timed at all 16;
        # bfloat16; the spacetime backward without dK/dV); launches: the
        # optimization run (2 batches), serve_launches: the serving run,
        # dpm_launches: the DPM-Solver++ optimization batch (phase samplers),
        # runner_launches: the dataset sweep's three modes (phase runner);
        # http_launches, loadtest_launches, cli_launches: phases http (spatial),
        # loadtest (vanilla) and serve_cli (spacetime); ingest_launches: phase
        # ingest's drill (both modes) and txt2img; image_in_launches: phase
        # image_in's bf16 runs (img2img, inpaint, the unconditional DDIM and DDPM,
        # each through the library and the entry point but DDPM); train_launches:
        # phase train_bench's bf16 training steps (bench_train's warm-up and
        # TRAIN_STEPS timed steps at batch 4; GEGLU and flash only);
        # knn2img_launches: phase knn2img's entry-point batch (RDM, DDIM-50,
        # 3 prompts; MHA and GEGLU only); data_train_launches: phase train_data's
        # train_ldm runs from image folders (text, class, superres; GEGLU and
        # flash only); mesh_launches: phases mesh and mesh2 (the training
        # steps over the mesh, counted around train_step, and the engines over
        # it, both ranks of mesh2 summed); tp_launches: mesh2's part tp per
        # rank (the model axis, M = 2: the f32 evaluation with its gradient,
        # the bf16 forward, the engine); launches_by_design: the serving and
        # optimization runs
    finally:
        stop_flops_count(count)         # a no-op unless a phase failed first
        shutil.rmtree(flops_root, ignore_errors=True)
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
