#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render, training and video-diffusion
paths, its exact-softmax attention and its exp2-attention and row-gather
probes once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 22    # phases 1, 2 and 22 only
    python3 chip_smoke.py --phase 25    # (or 23, 24, 26, 27, 30, 31) likewise

Phases (any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print nvidia-smi's name and power limit;
  2. build: compile langscenex_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version at the slice's shapes,
     with CUDA-event times of both after warmup: K4 sort on a 2^19 pair
     stream and on 100k depth keys with ties and +inf rows, timed on the
     device queued behind a spin beside torch.sort(stable=True), and on
     all-equal keys, a constant top digit, the int32 extremes, 2^20 keys
     and lengths around its 2,048-key tile (all exact), K3
     compaction on the render scene's enumerated stream (exact; timed
     queued behind a spin and paced by the host beside
     torch.nonzero_static's index map, with its needed-bytes bound; one
     device kernel a call, counted from a torch.profiler trace, and its
     cuobjdump resources, no spill), K1 blend
     forward and K2 blend backward (random upstream gradients, 14
     channels and the abs hook) on the render scene's identity-view tile
     lists (stated tolerances), timed in turns, each with its bound (the
     largest of its bytes, FP32 and SFU terms, the operations counted
     from the pairs each pixel walks), and their cuobjdump resources (no
     spill);
  4. render path: a 100k-splat SH-3 scene (random, seed 0) packed into a
     GaussianState, written to a PLY and read back onto the GPU, then
     render_all_views over 4 views at 720x480 with the exact raster
     config (32x32 tiles, 14 blended channels + plane depth); no overflow
     flag, finite outputs, one view held against the plain path on the
     card, and K1/K15/K4's launch counters > 0 for that run;
  5. render profile: host wall time, device busy time and idle share of
     the identity view (torch.profiler);
  6. training path, configuration field-200k-720x480: create_from_points
     on 200,000 random points (capacity 2^18, SH 3), supervised by phase
     4's renders (images, language maps, instance maps quantised to
     segment ids, written as *_f.npy / *_s.npy), trained through
     GaussianFieldTrainer.train in four windows of the phase schedule
     (1-20 image + pose, 599-601 single + multi-view with densification
     at 600, 1299-1301 language with grouping and obj3d, 1999-2001
     semantic-only); every step free of overflow flags with a finite loss
     and finite parameters, the loss falling over the first window, and
     every kernel's launch counter > 0 for the phase;
  7. one geometry + multi-view train step through the kernels and
     through the plain path (_build.plain()) on the same state, batch
     and draws: loss and per-group gradients within stated bounds (the
     pose row against the plain step on the kernels' rendered values);
     then K1 and K2 against their plain versions on that step's real inputs
     (its first view's lists, means, conics, opacities and 8 channels,
     and the loss's upstream gradients), timed and bounded as in phase 3
     (the kernels line's field_* keys), and K15 + K4 bit for bit
     against the plain path on every list the step builds; K3 (which the
     step no longer runs) on its first view's broadcast stream, timed as
     in phase 3;
  8. train profile: host wall time, device busy time and idle share of
     that step;
  9. configuration trimap-dit-5b-49x480x720 (the JAX package's full-scale
     TransformerConfig, VAEConfig and PipelineConfig; build_pipeline's
     random bf16 weights from seed 42): build_pipeline on the card, then
     K5 and K8 against
     their plain versions on the real layer-0 inputs (q, k, v
     [2, 17776, 48, 64], x [2, 17776, 3072]), with CUDA-event times of
     kernel, plain and (K5) scaled_dot_product_attention, and K5's tensor
     and SFU terms;
 10. the full-width DiT through the kernels and through the plain path on
     the same weights and inputs: the residual stream after 2 blocks and
     the 42-layer noise prediction, within stated bounds;
 11. the request: two random 480x720 keyframes and the stub prompts
     through InterpolationPipeline with 2 DDIM steps and the tiled decode;
     a finite [1, 49, 3, 480, 720] video, exactly 84 K5 and 168 K8
     launches, the times of encode, each step and decode, peak memory;
 12. profile of one denoise step (host wall, device busy, idle share, top
     device ops);
 13. configuration lora-5b-49x480x720 (experiments/lora_step_real.py: the
     full-scale TransformerConfig(remat=True), bf16 base with random
     weights from seed 42, B=1, 17,776 tokens, rank-16 adapters): K7
     against its plain version on layer-0 q, k, v [1, 17776, 48, 64] and a
     seeded output gradient (largest error, relative RMS and their bounds
     for dq, dk, dv; K7's registers, stack and local memory from cuobjdump,
     no spill allowed; CUDA-event times of the kernel alone, the wrapper as
     a whole, plain and the backward of scaled_dot_product_attention), and
     K8 in f32 at [1, 17776, 3072];
 14. the adapter gradients through the kernels and through the plain path
     on a 2-block cut at full width, then 4 LoRA train steps: wall time,
     loss, grad_norm and peak memory per step, the adapters' B still at 0
     after step 1 (learning rate 0) and moved after step 2, and exactly
     84 K5, 42 K7 and 168 K8 launches per step;
 15. profile of one LoRA step (host wall, device busy, idle share, top
     device ops);
 16. configuration dit-ft-8L-49x480x720: the full fine-tune step with f32
     parameters and latents (DiTTrainConfig defaults, remat, 8 of 42
     layers), 3 steps with time, peak memory, finite loss and grad_norm,
     and exactly 16 K5, 8 K7 and 32 K8 (f32) launches per step;
 17. K6, the [B, H, T, D] bounded attention forward, on seeded unit-normal
     q, k, v: against K5 on the same tensors at the request's
     [2, 48, 17776, 64] (one device function: bit-identical o and l2),
     against its plain version at a TP=2 shard's [2, 24, 17776, 64] and at
     1,000 queries over 17,776 keys (K5's bounds), CUDA-event times of K6,
     the plain version and scaled_dot_product_attention with the bound
     and K6's tensor and SFU terms;
     and K7 reading [B, H, T, D] views of a LoRA shard [1, 24, 17776, 64]
     against its plain version, with its time;
 18. configuration trimap-dit-5b-49x480x720-tp2: two ranks on cuda:0 over
     gloo, a (data=1, model=2) mesh, each building its shard of the seed-42
     DiT layer by layer (parallel.mesh.materialize_sharded_dit); a 2-step
     DDIM loop through dit_sharded_apply from phase 9's DiT inputs, each
     DiT call of the CFG pair (the first at t = 999; each later one also
     on the single process's inputs of that call) and its latents against
     the single-process ones that phases 9-12 saved: exactly 42 K6, 0 K5 and
     84 K8 launches per rank per DiT call, per-rank times and peak memory;
 19. configuration lora-5b-49x480x720-tp2, in the same two ranks: the
     2-block adapter gradients of phase 14's inputs, gathered from the
     ranks, against the single-process ones, then 1 TP LoRA step at 42
     layers (loss against phase 14's), exactly 84 K6, 42 K7, 168 K8 and
     0 K5 launches per rank per step, per-rank times and peak memory.
     Every TP time is of two ranks on one card over gloo, not a TP speed.
 20. the cell attention-exact-48x17776x64, the exact-softmax attention op
     at the DiT's shape on seeded unit-normal q, k, v: first the path
     through its entry points, flash_attention(bounded_logits=False)
     forward and backward at [1, 48, 17776, 64] with Tk = 17,776 and with
     the 17,550 video keys, attention_auto(bounded_logits=False) and
     flash_attention_h2, with exactly 3 K9, 2 K7 and 1 K11 launches and no
     other; then K9
     against its plain version at its 128-key tile at
     [2, 48, 17776, 64], [1, 48, 17776, 64] and Tk = 17,550 (K5's bounds),
     the gap to JAX's 1024-key block, a x20-logit input where the bounded
     softmax overflows, K9 against K6 on LayerNormed q, k, K7's gradients
     on K9's (o, l2) against the plain backward at both key lengths (K7's
     bounds), K11 against its plain version at its 128-key tile and
     against K9; CUDA-event times of K9, K11 and K7 on K9's l2 beside their
     plain versions, scaled_dot_product_attention and the bound, the wgmma
     forward's cuobjdump resources in each of its five modes (no spill),
     K11's tensor and SFU terms and the K/V bytes it reads from L2; and the
     ported
     experiments ab_attention and ab_attention4 through their main.
 21. the cells attention-exp2-48x18432x64 and gather-640k-w24, the probes
     of K13 through the ported experiments' entry points on seeded
     inputs: flash_exp2 (K13a) at [1, 48, 17776, 64] (a masked key tail)
     and [1, 48, 18432, 64], flash_exp2_bf16 (K13b) at 18,432 and its
     refusal at 17,776, gather_rows (K13c) of 640,000 rows of a
     [100008, 24] table in f32 and bf16, with exactly 2 K13a, 1 K13b and
     2 K13c launches and no other; K13b's packed exp alone on every bf16
     input of [-126, 0] (within one bf16 ulp); K13a and K13b against
     their plain versions at the kernels' 128-key tile (K5's
     bounds, and for K13b the packed exp's) and the gap to JAX's 1024-key
     block, K13a against K9, K13b against K13a; K13c bit for bit against
     torch.index_select; CUDA-event times of K9, K13a, K11 and K13b in
     turns at [1, 48, 18432, 64], the per-score ratios K13b / K11 and
     K9 / K13a of the wgmma forwards with their tensor and SFU terms and
     L2 bytes, the
     plain versions, scaled_dot_product_attention and the bound, and of
     K13c queued behind a spin and paced by the host,
     beside index_select; then ab_attention2 and ab_gather2 through their
     main.
 22. configuration field-e2e-200k-720x480, the field stage through its
     CLI (entry_point) on the card with PIL blocked in sys.modules: a
     CUT3R-contract scene of a room, 200,000 seeded points on four walls
     with a relief around four views that each face one wall
     (input/000N.png, the port's renders of those splats, through
     utils/png; camera/000N.npz; points3D.ply; lang_features_dim3/*_f.npy
     and *_s.npy as phase 6 makes them); mode=train for 30 iterations
     (snapshots at 10 and 30, a checkpoint at 10, the report at 30), the
     debug collage once, a resume from the iteration-10 checkpoint to 20,
     mode=render (PNGs, language maps, the four TSDF meshes) and
     mode=eval with 20 pose iterations per view; each mode's artifact
     tree, every PNG decoded to its shape, the PLY at 30 equal to the
     trained state, no overflow flag, finite PSNRs, K1/K15/K4 launched in
     every mode and K2 in train and eval; seconds per mode, ms per train
     iteration (with and without outputs), the TSDF fuse, mesh
     extraction and clean-up apart, ms per eval pose iteration and each
     mode's launches per call.
 23. configuration vae-train-c16-9x256x256, the VAE fine-tune at the c16
     preset's full widths (channels 128/256/256/512, 16 latents) with
     Discriminator3D(base=32) and the full-width LPIPS per frame, f32:
     3 VAETrainer steps on a seeded (1, 9, 3, 256, 256) clip with
     disc_start_step 1 (5 frames where 9 do not fit) at the default lr
     1e-4 with logvar in the VAE's Adam (VAE_TRAIN, logvar_in_adam):
     finite losses, D unchanged after step 1 and
     changed after step 2, logvar moved; one step at (1, 5, 3, 64, 64)
     from one state and one eps on the card and on the CPU (losses and
     logvar within VAE_RTOL); ms per step and peak memory;
 24. configuration t5-xxl-encoder-2x226, T5Config() (d_model 4096, 64
     heads, 24 layers, d_ff 10240) in f32 with seeded weights drawn on
     the card: TextEncoder.encode_ids on [2, 226] seeded ids, the second
     row padded after 40 tokens, finite; the first two blocks and the
     final norm against the same weights on the CPU (T5_REL_RMS); ms per
     encode and peak memory;
 25. configuration autoseg-full-random-9x1024, the JAX package's
     --full-random auto-seg stack (SAM1 ViT-H with the thresholds off,
     SAM2 Hiera-L, both normalising their input as the reference does,
     MaskAlignConfig(new_obj_min_area=4, postnms_score off, max_objects
     64), seeded random weights) over 9 720x480 PNG
     frames the port renders from phase 22's room along a 30-degree arc:
     the CLI's frame loader, MaskAligner.run, the id-map resize and
     save_outputs (colors.npy with a black row 0, 9 int32 [480, 720] id
     maps with -1 as background, 2 key PNGs, 1-64 objects, every id
     below the palette); then build_from_checkpoints on the same weights
     torch.saved in the two checkpoints' layouts gives the same
     first-frame embeddings; ms of the generator per keyframe, the SAM2
     image encode and the track step per frame, the whole run, peak
     memory;
 26. configuration vggt-1b-49x518, pose lifting: K9 against its plain
     version at VGGT's two attention shapes, [1, 16, 67326, 64] and
     [49, 16, 1374, 64] (all heads, K5's bounds on o and each l2), with its
     time beside its bound; then VGGTConfig() (VGGT-1B:
     24 + 24 aggregator blocks at 1024, DINOv2 ViT-L, the camera head and
     both DPT heads) with seeded random weights, the aggregator and the
     ViT in bf16 on K9 and the heads in f32, over 49 720x480
     PNG frames the port renders from phase 22's room along phase 25's
     arc, through FieldConstructionPipeline.estimate_poses (camera/*.npz
     and points3D.ply: one forward with 72 K9 launches, the camera
     trunk's 16 SDPA calls and no other, no point head), after a warmup
     at 2 frames; then
     estimate_poses_dense_init on 8 of the frames (the sparse_0/0 COLMAP
     tree, the confidences, pts_num.txt) and generate_normals on the
     first and last frames: finite outputs, the file trees; a 2-block cut
     (2 aggregator and 2 ViT blocks, both heads, 2 frames at 518) on the
     card (bf16) against the CPU (f32) (VGGT_REL_RMS per output); the
     state_dict saved
     with torch.save and read back through the get_normal CLI giving the
     same pose encoding; the forward's seconds, the export's and the
     normals', peak memory;
 27. configuration lang-lift-clip-l14-49x720x480, language lifting:
     FieldConstructionPipeline.extract_language_features over the same
     49 frames with ClipDenseExtractor(CLIPVisionConfig()) (ViT-L/14,
     seeded random weights, max side 672) and seg maps of 64 ids a frame
     (an 8 x 8 grid over each frame), so the scene AE trains on 3,136
     rows for its 400 epochs; then the LSeg + VQ branch (VQConfig(),
     640x480) from checkpoints; then embed_queries ->
     encode_queries_to_lang3 -> relevancy_maps on phase 22's rendered
     language maps: finite outputs, file shapes, the AE's best eval loss
     below its first; one CLIP forward and 4 AE steps on the card against
     the CPU (CLIP_REL_RMS; AE_RTOL_FIRST, AE_RTOL); CLIP seconds a
     frame, the AE fit's seconds, steps and ms a step, LSeg + VQ
     seconds a frame, peak memory. Phases 23-27 add no kernel.
 30. K14, the 3D kNN selection of loss_cls_3d at the cell
     field-sem-720x480's shape (800 sampled slots of a room of 1.5M points
     in 2^21 slots, dead ones at the origin, k = 5) on KNN_SEEDS seeds:
     its slots against the plain version's (_knn_smallest) and its d2 at
     them bit for bit against torch's dense d2, in every row; loss_cls_3d
     on the card with exactly one K14 launch, no host sync and no [S, N]
     allocation (phase 6 holds K14's launches on the training path to its
     obj3d loss calls); CUDA-event
     times of K14, the plain version and torch.cdist + torch.topk (a
     yardstick the port never calls) beside its FP32-issue bound; its
     kernels' cuobjdump resources (no spill).
 31. K15, the pair enumeration of the rank-key path, at the cell
     field-sem-720x480's shape (the benchmark's room: 1.5M splats in 2^21
     slots, 720x480, 32x32 tiles, the default raster config) from
     BIN_VIEWS cameras of its arc: build_tile_lists through K15 + K4 bit
     for bit against the broadcast + K3 + K4 of _build.plain() (all seven
     fields), one K15 and no K3 launch and no broadcast fallback a call;
     CUDA-event times of K15 alone (queued behind a spin), of the
     broadcast enumeration + K3 it replaces and of the whole binning both
     ways, beside K15's bytes bound; its two kernels' cuobjdump resources
     (no spill).
Every kernel's bound is computed from this run's shapes: the larger of
its operations over the bf16 tensor-core peak and its bytes (each input
read once, each output written once) over the HBM rate; K3's reads only
the sids of the valid slots (compact_bound); K1's and K2's the largest of
their bytes, FP32 operations at 67 TFLOP/s and SFU operations at 16 per
clock and SM (blend_bound).
Prints a JSON line of per-kernel results, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from langscenex_tpu_torch import _build
from langscenex_tpu_torch.convert import (gather_lora,
                                         raster_camera_from_numpy,
                                         shard_lora)
from langscenex_tpu_torch.ops import binning
from langscenex_tpu_torch.ops.binning import enumerate_pairs
from langscenex_tpu_torch.models.cogvideox.pipeline import (PipelineConfig,
                                                           denoise_loop,
                                                           guided_prediction)
from langscenex_tpu_torch.models.cogvideox.scheduler import DDIMScheduler
from langscenex_tpu_torch.models.cogvideox.transformer import (
    CogVideoXTransformer, TransformerConfig)
from langscenex_tpu_torch.ops.compaction import (compact_pairs,
                                                 compact_pairs_plain)
from langscenex_tpu_torch.experiments import (ab_attention, ab_attention2,
                                              ab_attention4, ab_gather2,
                                              time_ms)
from langscenex_tpu_torch.ops.flash_attention import (
    WGMMA_BLOCK_K, WGMMA_Q_TILE, attention_auto,
    attention_bthd_backward_kernel,
    attention_bthd_backward_launch, attention_bthd_backward_plain,
    attention_bthd_kernel,
    attention_bthd_plain, flash_attention, flash_attention_backward_kernel,
    flash_attention_backward_plain, flash_attention_exp2_bf16_kernel,
    flash_attention_exp2_bf16_plain, flash_attention_exp2_kernel,
    flash_attention_exp2_plain, flash_attention_h2,
    flash_attention_h2_kernel, flash_attention_h2_plain,
    flash_attention_kernel, flash_attention_online_kernel,
    flash_attention_online_plain, flash_attention_plain, exp2_bf16x2_kernel,
    exp2_bf16x2_plain)
from langscenex_tpu_torch.ops.gather import (gather_rows, gather_rows_kernel,
                                             gather_rows_plain)
from langscenex_tpu_torch.ops.ln_modulate import (ln_modulate,
                                                  ln_modulate_plain)
from langscenex_tpu_torch.ops.rasterize import RasterConfig, prepare_blend
from langscenex_tpu_torch.ops import rasterize as rasterize_mod
from langscenex_tpu_torch.ops import rasterize_cuda
from langscenex_tpu_torch.ops.losses import (_knn_smallest, exact_f32,
                                             knn_select, loss_cls_3d)
from langscenex_tpu_torch.ops.rasterize_cuda import (blend_backward,
                                                     blend_backward_plain,
                                                     blend_forward,
                                                     blend_tiles_plain,
                                                     blend_work)
from langscenex_tpu_torch.ops.sort_engine import (SORT_TILE, sort_pairs,
                                                  sort_pairs_plain)
from langscenex_tpu_torch.ops.projection import preprocess
from langscenex_tpu_torch.ops.transforms import (focal2fov, fov2focal,
                                                projection_matrix)
from langscenex_tpu_torch.parallel import dryrun
from langscenex_tpu_torch.parallel.dryrun import rank_mesh, spawn
from langscenex_tpu_torch.parallel.mesh import (dit_sharded_apply,
                                                lora_kind,
                                                materialize_sharded_dit,
                                                reduce_gradients_)
from langscenex_tpu_torch.scene.cameras import Camera
from langscenex_tpu_torch.scene.gaussians import (GaussianState,
                                                  create_from_points)
from langscenex_tpu_torch.scene.ply_io import load_ply, save_ply
from langscenex_tpu_torch.train.dit import (DiTTrainConfig, _sched_tables,
                                            make_dit_train_step)
from langscenex_tpu_torch.train.field import (GaussianFieldTrainer,
                                              loss_and_grads, phase_flags,
                                              render_view)
from langscenex_tpu_torch.train.lora import (LoRAConfig, init_lora,
                                             lora_loss_and_grads,
                                             make_lora_train_step, n_params)
from langscenex_tpu_torch import entry_point
from langscenex_tpu_torch.scene.dataset_readers import write_ply_points
from langscenex_tpu_torch.train import field as train_field
from langscenex_tpu_torch.train import render_mode
from langscenex_tpu_torch.train.render_mode import render_all_views
from langscenex_tpu_torch.utils import profiling
from langscenex_tpu_torch.utils.png import read_png, write_png
from langscenex_tpu_torch.utils.config import OptimizationConfig
from langscenex_tpu_torch.video_inference import build_pipeline, materialize

P = 100_000
W, H = 720, 480
FOVX = 1.0
# the exact raster config of the JAX package's flagship render entry
EXACT_CFG = RasterConfig(tile_w=32, tile_h=32, max_tiles_per_splat=16,
                         chunk=128, big_splats=64,
                         extra_tiers=((7168, 16), (1536, 32)),
                         rank_key_sort=True, max_pairs=520_000)
# Kernel K1 vs the plain blend: the kernel evaluates dx, dy relative to
# the tile centre and carries log T as a running sum, the plain version
# uses global pixel coordinates and a per-chunk cumsum. Near the T < 1e-4
# sticky stop that rounding can flip one pair's inclusion at a pixel, so
# the bounds are those of the JAX package's dense-occlusion blend test
# (accum 5e-4 + 1e-3 rel, T 1e-4, observe off by <= 2 at < 2% of splats).
BLEND_ATOL, BLEND_RTOL, T_ATOL = 5e-4, 1e-3, 1e-4
OBS_MAX_DIFF, OBS_MAX_FRAC = 2, 0.02
# The same flip at the stop moves one pair's weight (T near 1e-4 times a
# channel) in or out of a pixel's accum: on the field step's real inputs
# (phase 7, 8 channels up to ~16) that can exceed the accum bound. Such a
# pixel ends with T in the stop's rounding band on both sides (the
# excluded pair's T_excl (1 - alpha) rounds to 1e-4 and alpha <= 0.99, so
# T_excl <= 1e-4 / (1 - 0.99)); there at most K1_MAX_FLIPS pixels in
# that band may lie outside the accum bound, and none elsewhere.
T_STOP_BAND = 1e-4 / (1.0 - 0.99)
K1_MAX_FLIPS = 4
# Kernel K2 vs the plain backward, per splat and per gradient column:
# 2e-3 of the column's largest magnitude + 5e-3 relative (the JAX
# package's Pallas-vs-XLA gradient bounds; float atomics sum pairs in a
# varying order). Tile-centre vs global pixel coordinates can flip a pair
# at the 1/255 gate or the T < 1e-4 stop at a pixel (as observe does in
# the forward), so the bound holds for all but 1% of splats.
GRAD_ATOL_FRAC, GRAD_RTOL, K2_MAX_BAD = 2e-3, 5e-3, 0.01
# A whole train step through the kernels vs the plain path: the same
# per-column bound for every parameter group's gradient, for all but 2%
# of rows (the blend-gradient bound of tests/test_torch_grads.py), and
# the loss to 1e-3 relative.
STEP_MAX_BAD, LOSS_RTOL = 0.02, 1e-3
# A pose row's gradient (quaternion w, x, y, z, then t) comes through the
# quaternion's normalisation, whose backward takes out the radial part: a
# difference of terms of the row's size. Near the identity rotation that
# leaves w at ~1e-4 of the row, and its rounding is the row's, not its
# own, so each entry's atol is also at least 2e-5 of its row's largest
# |ref|. Phase 7 prints w, its gap and both over the row's largest: on
# the H100 the gap was under 1e-8 of the row and w ~5e-4 of it, so a
# zeroed or negated w still fails. The pose rows' other entries keep
# their column's bound, as do the other groups (the exposure gradient's
# floor is app_grad_floor's).
# The pose row is held to that bound against the plain step fed the
# kernels' rendered values (kernel_render_values), not against the plain
# step itself: the multi-view term's masks, bilinear cells and weights
# follow the rendered depth, and the plain step's own pose row moves by
# ~1e-3 of the row when the splat means move by one f32 ulp (phase 7
# prints that move), as much as the two renders' rounding moves it.
POSE_ROW_ATOL_FRAC = 2e-5
# the float maps of a RenderOutput
RENDER_MAPS = ("color", "language", "instance", "all_map", "plane_depth",
               "final_T")

# the training configuration field-200k-720x480 (see PERF.md): the JAX
# package's full-width train-rate scene with the pipeline's defaults
FIELD_P = 200_000
FIELD_CAP = 1 << 18
FIELD_EXTENT = 4.0
TRAIN_WINDOWS = ((1, 20), (599, 601), (1299, 1301), (1999, 2001))
N_SEGMENTS = 4

# the configuration trimap-dit-5b-49x480x720 (see PERF.md): the JAX
# package's full-scale defaults with build_pipeline's random weights
# (seed 42); noise and DiT inputs from DIT_SEED; 2 steps
DIT_SEED = 0
DIT_STEPS = 2
PROMPT = "a living room with a grey sofa, a lamp and a window"
# K5 vs its plain version (same rounding points): the f32 sums run in
# another order and exp2 differs in its last bits, which can move a p
# across a bf16 rounding boundary and an output by one bf16 ulp: each o
# within 2^-7 relative + 1e-3. Only outputs next to a rounding midpoint
# move at all, so o's relative RMS difference stays far below the 2^-7.5
# that every output one ulp off would give: within 2^-8. That RMS bound
# fails a kernel that mishandles V or drops a kv tile, which the
# per-element bound can miss where |o| is near 1e-3.
# Each p moves by at most one bf16 ulp (up to 2^-7 of p), so the row's
# normalizer l moves by at most 2^-7 of l, whatever the number of moves,
# and l2 = log2(l) by at most log2(1 + 2^-7) < 1.13e-2. A row where one
# p dominates comes near that (2.15e-3 at p / l of about 0.2 was read on
# an H100), so each l2 is held to 1.13e-2. In all other rows the moved p
# are small and l2 differs by f32 rounding, so the mean |l2| difference
# is held to 1e-4; a dropped or doubled 128-key tile of near-uniform
# attention moves every l2 of its rows by about 128 / 17776 / ln 2 = 1e-2.
ATTN_RTOL, ATTN_ATOL, L2_ATOL, L2_MEAN_ATOL = 2 ** -7, 1e-3, 1.13e-2, 1e-4
ATTN_REL_RMS = 2 ** -8
# K8 vs its plain version: one bf16 ulp (2^-7 relative) + 1e-4
LNZ_RTOL, LNZ_ATOL = 2 ** -7, 1e-4
# the DiT through the kernels vs the plain path: each K5/K8 output may
# differ from the plain one by a bf16 ulp (2^-8 relative), and the
# differences pass on through the linears and the residual stream. After
# 2 blocks (4 kernel calls) the residual stream's relative RMS difference
# stays under 1e-2; over 42 blocks (126 calls) the noise prediction's
# under 5e-2.
DIT2_REL_RMS, DIT_REL_RMS = 1e-2, 5e-2

# the configurations lora-5b-49x480x720 and dit-ft-8L-49x480x720 (see
# PERF.md): experiments/lora_step_real.py's shapes (B=1, 13 latent frames
# of 60x90 with 16 + 16 channels, 226 text tokens: 17,776 tokens) and
# training configuration; base weights from build_pipeline's seed 42, the
# batch from numpy seed 0, t and the noise from a torch generator, seed 2
FT_FRAMES, FT_CH, FT_H, FT_W, FT_TEXT = 13, 16, 60, 90, 226
LORA_STEPS, FT_STEPS, FT_LAYERS = 4, 3, 8
LORA_TRAIN = DiTTrainConfig(lr=1e-4, total_steps=100, warmup_steps=10)
# K7 vs its plain version (same rounding points, same o and l2 from K5):
# the f32 sums run in another order (dq's through atomics, in an order
# that varies from run to run), so an output can land one bf16 ulp away
# (at most 2^-7 relative), and a ds next to a rounding midpoint can round
# the other way, moving its sum by 2^-8 of that term: each gradient within
# 2^-7 relative + 2^-8 of the largest of its kind. Only outputs next to a
# midpoint move, so each relative RMS difference is held to 2^-8: a key
# tile missing from one head's block moves dk, dv and dq by about
# sqrt(64 / (T H)) = 8.7e-3, a query tile missing from every block by
# about sqrt(64 / T) = 0.06.
BWD_RTOL, BWD_ATOL_FRAC, BWD_REL_RMS = 2 ** -7, 2 ** -8, 2 ** -8
# K8 in f32 vs its plain version: the f32 statistics summed in another
# order, and n A + C against (n gamma + beta)(1 + s) + shift, a few f32
# roundings of values of order 10: 1e-5 absolute + 1e-5 relative
LNZ32_RTOL, LNZ32_ATOL = 1e-5, 1e-5
# the LoRA adapters' gradients and the loss through the kernels vs the
# plain path on 2 blocks: each K5, K7 and K8 output may differ from the
# plain one by a bf16 ulp (2^-8 relative), and the 2 blocks' forward,
# recompute and backward pass through 14 kernel calls; the forward alone
# differed by 1.7e-3 relative RMS after 2 blocks (phase 10). Each adapter
# gradient's relative RMS difference within 2e-2, the loss within 1e-2
LORA2_GRAD_REL_RMS, LORA2_LOSS_RTOL = 2e-2, 1e-2
# the configurations trimap-dit-5b-49x480x720-tp2 and lora-5b-49x480x720-tp2
# (see PERF.md): the two cells above on a (data=1, model=2) mesh of two
# ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one device).
# The TP DiT differs from the single-process one only in rounding: K6 is
# bit-identical to K5, and each block's two row-parallel linears sum two
# bf16 partial products (and then the bias) where the single-process GEMM
# rounds once, about one bf16 ulp per output, as K5/K8 against their plain
# versions differ per block. Phase 10 bounds that over 42 layers (126 calls)
# by 5e-2 relative RMS of the noise prediction (DIT_REL_RMS), and the
# 2-block LoRA gradients by the LORA2_* bounds. Every DiT call of the
# 2-step loop is held at DIT_REL_RMS: the first on the loop's own inputs,
# which both sides share; each later one, whose own inputs already differ
# by the earlier guided predictions' difference, also on the single
# process's inputs of that call, with its timestep checked to be the same.
# The guided prediction uncond + 6 (cond - uncond) weighs the branches'
# differences by up to 13, so the latents after the loop are held to a
# constant taken from sound runs: 9.210e-2 and 9.218e-2 relative RMS on
# an H100 (the same inputs and kernels; the single process's cuBLAS
# choices vary a little), with 30% to spare: TP_LATENTS_REL_RMS.
# Cut to stay near 2 minutes: the loop's first call is the compared call,
# and 1 TP LoRA step (a TP DiT call took 29 s and a TP LoRA step 44 s per
# rank in the first whole run, almost all of it gloo's all-reduces)
TP_RANKS, TP_LORA_STEPS, TP_TIMEOUT = 2, 1, 900.0
TP_LATENTS_REL_RMS = 0.12
TP_NOTE = "two ranks on one card over gloo, not a TP speed"
# K6 at the request's full width: 17,776 tokens (13 latent frames of
# 30 x 45 patches and 226 text tokens), 48 heads; a TP=2 shard has 24
K6_T, K6_H, K6_SHORT_T = 13 * 30 * 45 + 226, 48, 1000
# the cell attention-exact-48x17776x64 (phase 20): the exact-softmax
# attention op at the DiT's shape, 48 heads over its 17,776 tokens, B = 2
# as in the request and B = 1 as in experiments/ab_attention4.py, and the
# keys cut to the 17,550 video tokens (the joint sequence is [text;
# video]); a x20-logit input at a small shape. K9 and K11 are held to
# their plain versions at the kernels' 128-key tile (WGMMA_BLOCK_K: the
# same rescale points) with K5's bounds. At JAX's 1024-key block every p
# is rounded at another scale, so it may move by a bf16 ulp (2^-7 of it):
# o is still held per element to K5's bound (2^-7 relative + 1e-3), l2 to
# log2(1 + 2^-7). K9 against K6 on LayerNormed q, k (bounded logits): the
# two round each p at scales 2^-m apart, so each p differs by up to 2^-8
# of it and o by up to 2^-8 of max|v - o|, plus a bf16 rounding of each
# output: |o9 - o6| <= 2^-8 max|v| + 2^-7 |o6|. K11 against K9: K9 folds
# log2 e into q in bf16 (bf16(0.125 log2 e) is 0.18% above it), K11 does
# not, so their logits differ by that factor and by q's rounding at two
# scales, which moves the softmax weights by about 0.2% of |s - mean s|:
# o's relative RMS difference within 2^-6.
EXACT_T, EXACT_TEXT, EXACT_H = 13 * 30 * 45 + 226, 226, 48
X20_SHAPE = (1, 2, 300, 200)          # B, H, T, Tk of the x20-logit input
K9_K6_ULP, K11_K9_REL_RMS = 2 ** -8, 2 ** -6
EXPERIMENT_ITERS = 2
# the cells attention-exp2-48x18432x64 and gather-640k-w24 (phase 21): the
# K13 probes of experiments/ab_attention2.py and ab_gather2.py at their
# shapes, 48 heads at T = 17,776 (the DiT's tokens: a masked key tail) and
# 18,432 (18 whole 1024-key blocks, no mask, the length where the
# packed-bf16 probe runs), and 640,000 rows of width 24 from a table of
# ab_gather2.P + 8 rows. K13a is held to its plain version at the
# kernel's 128-key tile with K5's bounds: it has K9's rounding points but
# for l (the sum of the unrounded p). K13b's packed ex2.approx.ftz.bf16x2
# is measured alone on every bf16 input of [-126, 0] against exp2 rounded
# to bf16 and must stay within one bf16 ulp (2^-7 of p at most); then each
# p of K13b may move by a factor 1 + e, |e| <= 2^-7, against its plain
# version at its 128-key tile, and o = sum p v / sum p by at most 2^-7 / (1 - 2^-7) max|v - o|,
# plus a bf16 rounding of each side's o (2^-7 |o| together). Such moves
# are many and of either sign, so o's relative RMS difference stays near
# their RMS (2^-7 / sqrt(3) at most): within 2^-7, where a dropped 128-key
# tile moves it by about sqrt(128 / 18432) = 0.08. K13a against K9 on the
# same inputs: both form the same q', s, m', bf16(p) and PV product and
# differ only in l, the sum of p against that of bf16(p), by at most 2^-9
# of l, so o by 2^-9 of |o| before its bf16 rounding: K5's bounds again.
# K13b against K13a: bf16(s - m') moves each p by up to 2^-8 ln2 |s - m'|
# of it, in roundings of either sign, so o's relative RMS difference stays
# near their RMS: within 2^-5. K13c moves bits: bit for bit against
# index_select.
K13_TOKENS, K13_H = (17776, 18432), 48
GATHER_A, GATHER_W, GATHER_SHORT_A = 640_000, 24, 160_000
K13_ITERS, GATHER_ITERS = 5, 200
# K14 at field-sem-720x480's shape: KNN_S sampled slots of a room of
# KNN_POINTS points in KNN_N slots, k = KNN_K; its bound is the FP32 issue
# of KNN_ISSUE issue slots a (row, slot) pair (the dot's FMUL and two
# FFMAs, the norm sum's FADD, the -2 dot FFMA and the compare's FSETP; the
# branch is one per four slots and R rows) on 128 FP32 lanes an SM
KNN_S, KNN_POINTS, KNN_N, KNN_K = 800, 1_500_000, 1 << 21, 5
KNN_SEEDS = (0, 1, 2)
KNN_ITERS, KNN_PLAIN_ITERS = 20, 3
KNN_ISSUE, FP32_LANES_PER_SM = 6, 128
# K15 at field-sem-720x480's shape: the benchmark's room from these cameras
# of its arc (seed BIN_SEED); calls per timing. K15's bound is its bytes:
# tiles touched of every slot, BIN_SPLAT_BYTES of each splat that touches
# a tile (rect min and max x, depth rank, mean, conic, cull threshold) and
# 8 bytes a slot of the stream it writes
BIN_VIEWS, BIN_SEED, BIN_ITERS, BIN_PLAIN_ITERS = (0, 24, 48), 5, 50, 5
BIN_SPLAT_BYTES = 40
EXP2_BF16_REL_RMS = 2 ** -5
PACKED_EXP_ULP, K13B_REL_RMS = 2 ** -7, 2 ** -7
# K4: calls per timing, the passes of its LSD sort, and its time at 2^19
# pairs on an H100 before the onesweep design (PERF.md §6)
SORT_ITERS, SORT_PASSES, K4_BEFORE_MS = 50, 4, 0.6311
# K3: device activities (kernels and memsets) one compact_pairs call runs,
# and calls per timing
K3_KERNELS_PER_CALL, K3_ITERS = 1, 50
# K7 at the LoRA shape on an H100 before the wgmma design (PERF.md §6)
K7_BEFORE_MS = 69.6828
# the card's published peaks (H100 SXM): bf16 dense tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# its FP32 rate outside the tensor cores and its SFU rate (16 operations
# per clock and SM)
PEAK_FP32_FLOPS = 67e12
SFU_PER_CLOCK_SM = 16

TPU_KERNELS = {
    "sort_pairs": "langscenex_tpu/ops/sort_engine.py:92 _local_kernel, "
                  "langscenex_tpu/ops/sort_engine.py:104 _cross_kernel",
    "compact_pairs": "langscenex_tpu/ops/compaction.py:121 _compact_kernel",
    "blend_forward": "langscenex_tpu/ops/rasterize_pallas.py:299 _fwd_kernel",
    "blend_backward": "langscenex_tpu/ops/rasterize_pallas.py:447 "
                      "_bwd_kernel",
    "flash_attention": "langscenex_tpu/ops/flash_attention.py:991 "
                       "_attn_kernel_nomax_t4",
    "flash_attention_bhtd": "langscenex_tpu/ops/flash_attention.py:796 "
                            "_attn_kernel_nomax_t (also K10 :82 "
                            "_attn_kernel_nomax, K12 :838 _t2, :873 _t3)",
    "flash_attention_online": "langscenex_tpu/ops/flash_attention.py:32 "
                              "_attn_kernel",
    "flash_attention_h2": "langscenex_tpu/ops/flash_attention.py:676 "
                          "_attn_kernel_h2",
    "flash_attention_backward_split":
        "langscenex_tpu/ops/flash_attention.py:208 _bwd_dq_kernel, :241 "
        "_bwd_dkv_kernel, :281 _bwd_dq_kernel_t, :320 _bwd_dkv_kernel_t "
        "(K12, served by K7's kernel)",
    "ln_modulate": "langscenex_tpu/ops/ln_modulate.py:31 _lnz_kernel",
    "flash_attention_backward": "langscenex_tpu/ops/flash_attention.py:360 "
                                "_bwd_fused_kernel_t",
    "flash_attention_exp2": "experiments/ab_attention2.py:46 _exp2_kernel",
    "flash_attention_exp2_bf16": "experiments/ab_attention2.py:129 "
                                 "_exp2_bf16_kernel",
    "gather_rows": "experiments/ab_gather2.py:63 kern (pallas_gather)",
    "knn_select": "none: langscenex_tpu/ops/losses.py:123-147 loss_cls_3d "
                  "leaves its [S, N] d2 and lax.top_k to XLA; added for the "
                  "port's dense d2, topk and tie sort (ops/losses."
                  "_knn_smallest), the largest layer of a semantic field "
                  "step",
    "bin_pairs": "none: replaces ops/binning._enumerate_two_tier's XLA "
                 "broadcast and K3 on the rank-key path "
                 "(langscenex_tpu/ops/binning.py enumerates the pairs as "
                 "broadcasts and compacts them), the largest block of a "
                 "semantic field step",
}
SOURCES = {
    "sort_pairs": "langscenex_tpu_torch/csrc/sort.cu",
    "compact_pairs": "langscenex_tpu_torch/csrc/compaction.cu",
    "blend_forward": "langscenex_tpu_torch/csrc/blend.cu",
    "blend_backward": "langscenex_tpu_torch/csrc/blend_backward.cu",
    "flash_attention": "langscenex_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_bhtd":
        "langscenex_tpu_torch/csrc/flash_attention_sm90.cu",
    "ln_modulate": "langscenex_tpu_torch/csrc/ln_modulate.cu",
    "flash_attention_backward":
        "langscenex_tpu_torch/csrc/flash_attention_backward.cu",
    "flash_attention_online":
        "langscenex_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_h2": "langscenex_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_backward_split":
        "langscenex_tpu_torch/csrc/flash_attention_backward.cu",
    "flash_attention_exp2":
        "langscenex_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_exp2_bf16":
        "langscenex_tpu_torch/csrc/flash_attention_sm90.cu",
    "gather_rows": "langscenex_tpu_torch/csrc/gather_rows.cu",
    "knn_select": "langscenex_tpu_torch/csrc/knn_select.cu",
    "bin_pairs": "langscenex_tpu_torch/csrc/bin_pairs.cu",
}
RENDER_TRAIN_KERNELS = ("blend_forward", "blend_backward", "bin_pairs",
                        "sort_pairs")
# K3: the card's broadcast fallback of binning (no cell's path runs it)
BIN_FALLBACK_KERNELS = ("compact_pairs",)
DIT_KERNELS = ("flash_attention", "ln_modulate")
TRAIN_DIT_KERNELS = ("flash_attention_backward",)
TP_KERNELS = ("flash_attention_bhtd",)
EXACT_KERNELS = ("flash_attention_online", "flash_attention_h2",
                 "flash_attention_backward_split")
K13_KERNELS = ("flash_attention_exp2", "flash_attention_exp2_bf16",
               "gather_rows")
KNN_KERNELS = ("knn_select",)


def scene(n: int, seed: int = 0):
    """The flagship synthetic scene (same numpy calls as the JAX
    package's render entry): means, scales, unit quats, opacities, SH-3
    coefficients with a random DC, language and instance features."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(2, 10, n)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-4.0, -2.0, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1, 1, (n, 3))
    lang = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    inst = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, shs, lang, inst


def gaussian_state(arrays) -> GaussianState:
    """Pack scene arrays into the raw parameter space (log scales, logit
    opacity, SH dc/rest split) on the CPU."""
    means, scales, quats, opac, shs, lang, inst = arrays
    n = means.shape[0]
    t = torch.from_numpy
    logit = np.log(opac / (1.0 - opac)).astype(np.float32)
    return GaussianState(
        xyz=t(means), knn_f=torch.zeros(n, 6),
        features_dc=t(np.ascontiguousarray(shs[:, :1])),
        features_rest=t(np.ascontiguousarray(shs[:, 1:])),
        scaling=t(np.log(scales).astype(np.float32)), rotation=t(quats),
        opacity=t(logit[:, None]), language_feature=t(lang),
        instance_feature=t(inst), alive=torch.ones(n, dtype=torch.bool))


def _rot(axis: int, deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    R = np.eye(3)
    R[i, i] = R[j, j] = c
    R[i, j], R[j, i] = -s, s
    return R


def cameras() -> list[Camera]:
    """The identity view and three small perturbations: a yaw, a pitch
    and a roll of 1-2 degrees, each with a slight lateral shift and a
    0.15 step back (x_cam = R^T x + T)."""
    fovy = focal2fov(fov2focal(FOVX, W), H)
    poses = [(np.eye(3), np.zeros(3)),
             (_rot(1, 1.5), np.array([0.05, 0.0, 0.15])),
             (_rot(0, -1.0), np.array([0.0, 0.05, 0.15])),
             (_rot(2, 2.0), np.array([-0.05, -0.03, 0.15]))]
    return [Camera(uid=i, colmap_id=i, R=R, T=T, fovx=FOVX, fovy=fovy,
                   width=W, height=H, image_name=f"view{i}")
            for i, (R, T) in enumerate(poses)]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float = 0.0, moved: int = 0) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the HBM rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def pair_err(got, ref) -> float:
    """Max abs difference over the (key, value) streams of two pair
    outputs."""
    return max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1]))


def check_blend(got, ref, what: str, max_flips: int = 0) -> float:
    """Hold (accum, T, observe) against the plain blend's; returns the
    max abs error over accum and T. With ``max_flips`` that many pixels
    may lie outside the accum bound, if each ends with T below
    ``T_STOP_BAND`` in both: pixels where the two round a pair's T across
    the 1e-4 stop differently (their T is printed)."""
    (a, t, o), (ra, rt, ro) = got, ref
    require(bool(torch.isfinite(a).all() and torch.isfinite(t).all()),
            f"{what}: non-finite output")
    torch.testing.assert_close(t, rt, atol=T_ATOL, rtol=0.0)
    bad = ((a - ra).abs() > BLEND_ATOL + BLEND_RTOL * ra.abs()).any(1)
    n_bad = int(bad.sum())
    if n_bad:
        print(f"  {what}: {n_bad} of {bad.numel()} pixels outside the accum "
              f"bound (at most {max_flips} allowed, in the stop's band), "
              f"final T there {t[bad][:4].tolist()} (plain "
              f"{rt[bad][:4].tolist()})")
    in_band = torch.maximum(t, rt) < T_STOP_BAND
    require(n_bad <= max_flips and bool(in_band[bad].all()),
            f"{what}: accum differs beyond bounds")
    od = (o.long() - ro.long()).abs()
    frac = float((od > 0).float().mean())
    print(f"  {what}: max|accum| err {max_abs(a, ra):.3e}, max|T| err "
          f"{max_abs(t, rt):.3e}, observe max diff {int(od.max())} at "
          f"{frac:.4%} of splats")
    require(int(od.max()) <= OBS_MAX_DIFF and frac < OBS_MAX_FRAC,
            f"{what}: observe differs beyond bounds")
    return max(max_abs(a, ra), max_abs(t, rt))


def bad_rows(got: torch.Tensor, ref: torch.Tensor,
             floor: torch.Tensor | None = None) -> float:
    """Share of rows with an entry outside 2e-3 of its column's largest
    |ref| (or of the array's, for a 1-D or per-group tensor) + 5e-3
    relative. With ``floor`` (broadcast against the rows) an entry's atol
    is at least its floor (see POSE_ROW_ATOL_FRAC and app_grad_floor)."""
    got, ref = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    atol = GRAD_ATOL_FRAC * ref.abs().amax(0, keepdim=True).clamp(min=1e-12)
    if floor is not None:
        atol = torch.maximum(atol, floor.reshape(floor.shape[0], -1))
    bad = ((got - ref).abs() > atol + GRAD_RTOL * ref.abs()).any(1)
    return float(bad.float().mean())


def kernel_resources(name: str) -> list[str]:
    """cuobjdump's resource lines (registers, stack, shared and local memory
    per thread), one for each kernel of the built library whose symbol
    holds ``name``."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-res-usage",
                          str(_build.library_path())], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    lines = [out[i + 1].strip() for i, line in enumerate(out[:-1])
             if "Function" in line and name in line]
    require(bool(lines), f"cuobjdump lists no kernel {name}")
    return lines


def resource_field(line: str, field: str) -> int:
    """One numeric field (``REG``, ``STACK``, ``LOCAL``, ...) of a
    cuobjdump resource line such as ``REG:168 STACK:0 SHARED:0 LOCAL:0``."""
    for tok in line.replace(",", " ").split():
        key, _, val = tok.partition(":")
        if key == field:
            return int(val)
    raise RuntimeError(f"cuobjdump line has no {field}: {line!r}")


def require_no_spill(name: str, what: str, count: int = 0) -> None:
    """Print the resources of each built kernel whose symbol holds
    ``name`` and fail if one has local memory or a stack (a spill), or,
    with ``count``, if there are not that many of them (one per mode)."""
    lines = kernel_resources(name)
    require(not count or len(lines) == count, f"{what}: {len(lines)} "
            f"kernels built, expected {count}")
    for line in lines:
        print(f"{what}: {line}")
        require(resource_field(line, "LOCAL") == 0
                and resource_field(line, "STACK") == 0,
                f"{what} spills to local memory: {line}")


def forward_terms(what: str, ms: float, B: int, H: int, T: int, Tk: int,
                  exps: float, dev) -> None:
    """Print a wgmma forward's time beside its tensor term (4 B H T Tk 64
    flops at the bf16 peak) and its SFU term (``exps`` ex2 instructions,
    16 per clock and SM at nvidia-smi's maximum SM clock), and the K and V
    bytes its blocks of WGMMA_Q_TILE queries read from L2 per call with
    the rate they imply at this time."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = sm_clock_mhz()
    tensor_ms = 4.0 * B * H * T * Tk * 64 / PEAK_BF16_FLOPS * 1e3
    sfu_ms = exps / (16 * sms) / (mhz * 1e3)
    kv = B * -(-T // WGMMA_Q_TILE) * H * Tk * 64 * 2 * 2
    print(f"{what} at [{B}, {H}, {T}, 64], Tk {Tk}: {ms:.4f} ms; tensor term "
          f"{tensor_ms:.4f} ms (989 TFLOP/s), SFU term {sfu_ms:.4f} ms "
          f"({exps:.4g} ex2 at 16 per clock on {sms} SMs at {mhz:.0f} MHz); "
          f"K/V read from L2 {kv / 1e9:.3f} GB per call, "
          f"{kv / ms / 1e9:.3f} TB/s at this time")


def sort_edge_cases(rng):
    """(name, int32 keys) of the streams K4's onesweep design is sensitive
    to: every digit the same, a skewed top digit (bitcast positive f32 in
    [2, 10): 0x40 and 0x41), a constant top digit over varying lower digits
    (f32 in [2, 4): 0x40), the int32 extremes with mixed signs, one key,
    one below, at and one above the 2,048-key tile, and 2^20 keys."""
    tile = SORT_TILE
    wide = rng.integers(-2 ** 31, 2 ** 31 - 1, 1 << 20, dtype=np.int64)
    wide[rng.uniform(size=wide.size) < 0.1] = -2 ** 31
    wide[rng.uniform(size=wide.size) < 0.1] = 2 ** 31 - 1
    wide = wide.astype(np.int32)
    depth = rng.uniform(2.0, 10.0, 1 << 19).astype(np.float32)
    top = rng.uniform(2.0, 4.0, 1 << 19).astype(np.float32)
    return [("all keys equal", np.full(100_000, -12345, np.int32)),
            ("skewed top digit (2^19 f32 depths)", depth.view(np.int32)),
            ("constant top digit (2^19 f32 in [2, 4))", top.view(np.int32)),
            ("INT32_MIN/MAX, mixed signs (2^20)", wide),
            ("n = 1", wide[:1]), (f"n = {tile - 1}", wide[:tile - 1]),
            (f"n = {tile}", wide[:tile]), (f"n = {tile + 1}", wide[:tile + 1])]


def render_blend_inputs(dev, s: GaussianState):
    """The render scene's identity view through preprocess and binning
    with the exact raster config: its BlendInputs (14 channels)."""
    rcam = cameras()[0].raster_camera(device=dev)
    opacity = s.get_opacity()[:, 0] * s.alive
    all_map = torch.cat([torch.nn.functional.normalize(s.xyz, dim=-1),
                         torch.ones_like(s.xyz[:, :1]),
                         s.xyz[:, 2:3]], -1)
    return prepare_blend(s.xyz, s.get_scaling(), s.get_rotation(), opacity,
                         rcam, shs=s.get_features(), sh_degree=3,
                         language_feature=s.language_feature,
                         instance_feature=s.instance_feature,
                         all_map=all_map, cfg=EXACT_CFG)


def phase_kernels(dev, state_gpu, results) -> None:
    rng = np.random.default_rng(1)
    # ---- K4 on a 2^19 unique-key pair stream ---------------------------
    n = 1 << 19
    key = torch.from_numpy((rng.permutation(n) * 2741).astype(np.int32)).to(dev)
    val = torch.arange(n, dtype=torch.int32, device=dev)
    got, ref = sort_pairs(key, val), sort_pairs_plain(key, val)
    require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
            "sort_pairs: 2^19 pair stream differs from the stable sort")
    sort_err = pair_err(got, ref)
    # device times queued behind a spin (the host's wrapper and launches
    # take longer than the sort) and, beside them, host-paced times
    ms = time_ms(lambda: sort_pairs(key, val), SORT_ITERS, dev, queued=True)
    lib_ms = time_ms(lambda: torch.sort(key, stable=True), SORT_ITERS, dev,
                     queued=True)
    paced = cuda_ms(lambda: sort_pairs(key, val), SORT_ITERS)
    lib_paced = cuda_ms(lambda: torch.sort(key, stable=True), SORT_ITERS)
    plain_ms = cuda_ms(lambda: sort_pairs_plain(key, val), 20)
    sort_bound = bound(moved=2 * nbytes(key, val))
    lsd = bound(moved=nbytes(key) + SORT_PASSES * 2 * nbytes(key, val))
    print(f"K4 sort_pairs 2^19 pairs: exact; kernel {ms:.4f} ms on the "
          f"device ({paced:.4f} ms host-paced), torch.sort(stable=True) "
          f"{lib_ms:.4f} ms ({lib_paced:.4f} host-paced), plain "
          f"{plain_ms:.4f} ms; bounds {sort_bound['bound_ms']:.4f} ms (one "
          f"read + one write, {sort_bound['bound_by']}) and "
          f"{lsd['bound_ms']:.4f} ms (a 4-pass LSD sort's traffic); "
          f"{K4_BEFORE_MS} ms before the onesweep design")
    # ---- K4 on 100k depth keys with ties and +inf rows ------------------
    depth = rng.uniform(2.0, 10.0, P).astype(np.float32)
    depth[rng.integers(0, P, P // 10)] = np.float32(5.25)
    depth[rng.uniform(size=P) < 0.1] = np.float32(np.inf)
    dkey = torch.from_numpy(depth).to(dev).view(torch.int32)
    sid = torch.arange(P, dtype=torch.int32, device=dev)
    got, ref = sort_pairs(dkey, sid), sort_pairs_plain(dkey, sid)
    require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
            "sort_pairs: depth keys differ from the stable sort")
    sort_err = max(sort_err, pair_err(got, ref))
    dms = time_ms(lambda: sort_pairs(dkey, sid), SORT_ITERS, dev,
                  queued=True)
    dlib = time_ms(lambda: torch.sort(dkey, stable=True), SORT_ITERS, dev,
                   queued=True)
    dplain = cuda_ms(lambda: sort_pairs_plain(dkey, sid), 20)
    print(f"K4 sort_pairs 100k depth keys (ties, +inf): exact; kernel "
          f"{dms:.4f} ms on the device, torch.sort(stable=True) {dlib:.4f} "
          f"ms, plain {dplain:.4f} ms")
    # ---- K4 on the streams the onesweep design is sensitive to ----------
    cases = sort_edge_cases(rng)
    for what, k in cases:
        v = torch.from_numpy(rng.integers(0, 1 << 30, k.size).astype(
            np.int32)).to(dev)
        k = torch.from_numpy(k).to(dev)
        got, ref = sort_pairs(k, v), sort_pairs_plain(k, v)
        require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                f"sort_pairs: {what} differs from the stable sort")
        sort_err = max(sort_err, pair_err(got, ref))
    print(f"K4 sort_pairs edge cases exact: "
          f"{', '.join(w for w, _ in cases)}")
    results["sort_pairs"] = dict(max_abs_err=sort_err, ms=ms,
                                 plain_ms=plain_ms, **sort_bound,
                                 library_ms=lib_ms)

    # ---- slice scene, identity view: the real K3 and K1 inputs ----------
    cfg = EXACT_CFG
    bi = render_blend_inputs(dev, state_gpu)
    proc = bi.proc
    ps = enumerate_pairs(proc, bi.grid_x, bi.grid_y, cfg.max_tiles_per_splat,
                         cfg.max_pairs, cfg.big_splats, bi.cull,
                         cfg.extra_tiers, rank_key=True)
    require(ps.rank_key, "slice scene should take the rank-key path")
    sent = (bi.grid_x * bi.grid_y) << 22
    args = (ps.key, ps.sid, sent, ps.out_len, sent, P)
    results["compact_pairs"] = check_compaction(dev, "render scene", args)
    gs = sort_pairs_plain(*compact_pairs(*args))
    rs = sort_pairs_plain(*compact_pairs_plain(*args))
    require(torch.equal(gs[0], rs[0]) and torch.equal(gs[1], rs[1]),
            "compact_pairs differs after the sort")
    kernels = device_kernels(lambda: compact_pairs(*args))
    print(f"K3 compact_pairs: {len(kernels)} device kernel(s) per call "
          f"(torch.profiler): {kernels}")
    require(len(kernels) == K3_KERNELS_PER_CALL,
            f"compact_pairs launched {len(kernels)} device kernels in one "
            f"call, expected {K3_KERNELS_PER_CALL}")
    results["compact_pairs"]["kernels_per_call"] = len(kernels)
    require_no_spill("compact_pairs", "K3 compact_pairs", count=1)

    # ---- K1 and K2 on the slice scene's lists (14 channels) -------------
    bargs = (bi.lists, proc.mean2d, proc.conic, bi.opacity, bi.channels,
             bi.grid_x, bi.grid_y)
    n_tiles, npx = bi.grid_x * bi.grid_y, cfg.tile_w * cfg.tile_h
    grng = torch.Generator(device=dev).manual_seed(2)
    g_accum = torch.randn((n_tiles, bi.channels.shape[1], npx),
                          generator=grng, device=dev)
    g_T = torch.randn((n_tiles, npx), generator=grng, device=dev)
    k1, k2 = check_blend_kernels(dev, "render scene", bargs, cfg, g_accum,
                                 g_T)
    results["blend_forward"], results["blend_backward"] = k1, k2
    require_no_spill("blend_forward", "K1 blend_forward", count=4)
    require_no_spill("blend_backward", "K2 blend_backward", count=4)


def compact_bound(n: int, n_valid: int, out_len: int) -> dict:
    """K3's bound on this run's stream: the bytes the function needs over
    the HBM rate. It reads every key (4 n), the sids of the valid slots
    only (4 n_valid: an invalid slot's sid never reaches the output) and
    writes both outputs (8 out_len)."""
    terms = {"keys": 4 * n, "valid sids": 4 * n_valid, "outputs": 8 * out_len}
    moved = sum(terms.values())
    return dict(bound_ms=moved / PEAK_HBM_BYTES * 1e3, bound_by="bytes",
                bytes=moved, terms=terms)


def compact_library(key: torch.Tensor, sent_min: int, out_len: int):
    """(name, fn) of one PyTorch call that computes K3's index map: the
    valid slots in order at a static size with a fill (no host sync), or,
    where this build has no CUDA nonzero_static, the valid keys by
    masked_select (which syncs the host for its size). A yardstick only:
    the gather of key and sid through the map is left out."""
    def static():
        return torch.nonzero_static(key < sent_min, size=out_len,
                                    fill_value=-1)
    try:
        static()
    except (NotImplementedError, RuntimeError) as e:
        print(f"nonzero_static does not run here ({type(e).__name__}); "
              f"the yardstick is masked_select, which syncs the host")
        return "torch.masked_select(key, key < sent_min) (host sync)", (
            lambda: torch.masked_select(key, key < sent_min))
    return ("torch.nonzero_static(key < sent_min, size=out_len, "
            "fill_value=-1) (index map only)", static)


def check_compaction(dev, what: str, args) -> dict:
    """K3 bit for bit against its plain version on one stream (``args`` as
    compact_pairs takes them), its time queued behind a spin (the device's)
    and paced by the host, the plain version's, the library yardstick's
    and the needed-bytes bound with its terms. Returns its kernels-line
    entry."""
    key, sid, sent_min, out_len = args[:4]
    got, ref = compact_pairs(*args), compact_pairs_plain(*args)
    require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
            f"compact_pairs ({what}) differs from the argsort reference")
    ms = time_ms(lambda: compact_pairs(*args), K3_ITERS, dev, queued=True)
    paced = cuda_ms(lambda: compact_pairs(*args), K3_ITERS)
    plain_ms = cuda_ms(lambda: compact_pairs_plain(*args), 20)
    lib_name, lib_fn = compact_library(key, sent_min, out_len)
    lib_ms = time_ms(lib_fn, K3_ITERS, dev, queued=True)
    n_valid = int((key < sent_min).sum())
    b = compact_bound(key.numel(), n_valid, out_len)
    print(f"K3 compact_pairs ({what}) {key.numel()} slots -> {out_len} "
          f"({n_valid} valid): exact; kernel {ms:.4f} ms on the device "
          f"({paced:.4f} ms host-paced), plain {plain_ms:.4f} ms, "
          f"{lib_name} {lib_ms:.4f} ms on the device; bound "
          f"{b['bound_ms']:.5f} ms (bytes: " + ", ".join(
              f"{k} {v}" for k, v in b["terms"].items())
          + f", {b['bytes']} B at 3.35 TB/s)")
    return dict(max_abs_err=pair_err(got, ref), ms=ms, host_paced_ms=paced,
                plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by="bytes",
                library_ms=lib_ms, library=lib_name)


def device_kernels(fn) -> list:
    """Names of the device activities (kernels and memsets) that one call
    of ``fn`` runs, after a warm-up call, from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def sm_clock_mhz() -> float:
    """nvidia-smi's maximum SM clock of card 0, in MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def blend_bound(work: dict, n_ch: int, moved: int, backward: bool,
                dev) -> dict:
    """K1's or K2's bound on this run's inputs: the largest of the bytes
    over the HBM rate, the FP32 operations over 67 TFLOP/s and the SFU
    operations over 16 per clock and SM at the maximum SM clock. The
    operations are counted from ``work`` (``blend_work``: the (pair,
    pixel) evaluations each pixel walks before its stop), the same work
    whatever implements the kernel: per walked evaluation the power (12),
    per live one (power <= 0) alpha (2) and an exp, per gated one (alpha
    >= 1/255) log T (2) and a log1p, per included one the weight and the
    channel FMAs (1 + 2C) and the exp of log T. K2 re-walks as K1 and
    adds, per included evaluation, chg, the prefix, suffix and dalpha
    (2C + 10) and its products over pixels (2 (C + 8)): every other (pair,
    pixel) term of those sums is zero."""
    C = n_ch
    fp32 = (12 * work["walked"] + 2 * work["live"] + 2 * work["gated"]
            + (1 + 2 * C) * work["included"])
    if backward:
        fp32 += (2 * C + 10 + 2 * (C + 8)) * work["included"]
    sfu = work["live"] + work["gated"] + work["included"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    terms = dict(bytes=moved / PEAK_HBM_BYTES * 1e3,
                 FP32=fp32 / PEAK_FP32_FLOPS * 1e3,
                 SFU=sfu / (SFU_PER_CLOCK_SM * sms) / (sm_clock_mhz() * 1e3))
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term],
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, terms=terms, fp32=fp32, sfu=sfu)


def check_blend_kernels(dev, what: str, bargs, cfg, g_accum, g_T,
                        max_flips: int = 0):
    """K1 and K2 against their plain versions on one shape's inputs
    (``bargs``: lists, mean2d, conic, opacity, channels, grid_x, grid_y;
    K2 on K1's outputs and the upstream gradients g_accum, g_T; K1's
    accum bound as ``check_blend`` holds it with ``max_flips``), their
    times in turns (K1, K2, K2, K1) beside the plain versions' and their
    bounds with the operations terms. Returns K1's and K2's entries of the
    kernels line."""
    tw, th, chunk = cfg.tile_w, cfg.tile_h, cfg.chunk
    lists, C = bargs[0], bargs[4].shape[1]
    P = bargs[1].shape[0]
    with torch.no_grad():
        got = blend_forward(*bargs, cfg)
        ref = blend_tiles_plain(*bargs, tw, th, chunk)
        err = check_blend(got, ref, f"K1 blend_forward ({what})",
                          max_flips)
        accum, T, _ = got
        k2args = (*bargs[:5], accum, T, g_accum, g_T, *bargs[5:7])
        got2 = blend_backward(*k2args, cfg)
        ref2 = blend_backward_plain(*k2args, tw, th, chunk)
        require(tuple(got2.shape) == (P, 8 + C), "K2 output shape")
        require(bool(torch.isfinite(got2).all()), "K2: non-finite gradient")
        require(bool((got2[:, -2:] >= 0).all()), "K2: negative abs rows")
        bad = bad_rows(got2, ref2)
        err2 = max_abs(got2, ref2)
        print(f"K2 blend_backward ({what}), {C} channels + abs hook: max "
              f"abs err {err2:.3e} (largest |grad| "
              f"{float(ref2.abs().max()):.3e}), {bad:.4%} of splats outside "
              f"the per-column bound")
        require(bad <= K2_MAX_BAD, f"K2 ({what}) differs from the plain "
                "backward beyond bounds")
        turns = {"K1": [], "K2": []}
        for name in ("K1", "K2", "K2", "K1"):
            fn = ((lambda: blend_forward(*bargs, cfg)) if name == "K1" else
                  (lambda: blend_backward(*k2args, cfg)))
            turns[name].append(cuda_ms(fn, 10))
        plain_ms = cuda_ms(lambda: blend_tiles_plain(*bargs, tw, th, chunk),
                           3, warmup=1)
        plain_ms2 = cuda_ms(lambda: blend_backward_plain(*k2args, tw, th,
                                                         chunk), 2, warmup=1)
        work = blend_work(*bargs[:4], *bargs[5:7], tw, th, chunk)
    ins = (lists.point_list, lists.tile_starts, lists.tile_counts,
           *bargs[1:5])
    b1 = blend_bound(work, C, nbytes(*ins, *got), False, dev)
    b2 = blend_bound(work, C, nbytes(*ins, accum, T, g_accum, g_T, got2),
                     True, dev)
    ms, ms2 = (sum(turns[k]) / 2 for k in ("K1", "K2"))
    counts = lists.tile_counts
    print(f"blend ({what}): {bargs[5] * bargs[6]} tiles of {tw}x{th}, "
          f"{int(counts.sum())} pairs (max {int(counts.max())}/tile), "
          f"{C} channels; evaluations {work}")
    for name, t, pms, b in (("K1 blend_forward", turns["K1"], plain_ms, b1),
                            ("K2 blend_backward", turns["K2"], plain_ms2,
                             b2)):
        terms = ", ".join(f"{k} {v:.5f} ms" for k, v in b["terms"].items())
        print(f"{name} ({what}): kernel {' / '.join('%.4f' % x for x in t)} "
              f"ms in turns, plain {pms:.4f} ms; bound {b['bound_ms']:.5f} "
              f"ms ({b['bound_term']}; {terms}; {b['fp32']:.4g} FP32 "
              f"operations, {b['sfu']:.4g} SFU)")
    entry = lambda e, m, pm, b: dict(  # noqa: E731
        max_abs_err=e, ms=m, plain_ms=pm, bound_ms=b["bound_ms"],
        bound_by=b["bound_by"], bound_term=b["bound_term"], library_ms=None)
    return entry(err, ms, plain_ms, b1), entry(err2, ms2, plain_ms2, b2)


def phase_main_path(dev, cams, path) -> dict:
    """Load the PLY onto the card and render every view; returns timing
    and the first view's output for the plain-path comparison."""
    splats = load_ply(path, max_sh_degree=3, capacity=P, device=dev)
    require(int(splats.num_alive) == P, "PLY round trip lost splats")

    def one_pass():
        out = []
        views = render_all_views(splats, cams, EXACT_CFG, sh_degree=3)
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            item = next(views, None)
            torch.cuda.synchronize()
            if item is None:
                return out
            out.append((time.perf_counter() - t0, item[1]))

    one_pass()                                   # warm the allocator
    _build.reset_launch_counts()
    timed = one_pass()
    launches = dict(_build.launch_counts)
    print(f"launch counts over the render-path run: {launches}")
    for name in ("sort_pairs", "bin_pairs", "blend_forward"):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the render path")

    for i, (dt, maps) in enumerate(timed):
        print(f"view {i}: num_pairs {int(maps['num_pairs'])}, "
              f"pairs_overflowed {bool(maps['pairs_overflowed'])}, "
              f"k_overflowed {bool(maps['k_overflowed'])}, "
              f"render {dt * 1e3:.3f} ms")
        require(not bool(maps["pairs_overflowed"]),
                f"view {i}: pair budget overflowed")
        require(not bool(maps["k_overflowed"]),
                f"view {i}: tier register overflowed")
        require(tuple(maps["render"].shape) == (3, H, W), "render shape")
        require(tuple(maps["plane_depth"].shape) == (H, W), "depth shape")
        for k, v in maps.items():
            if v.is_floating_point():
                require(bool(torch.isfinite(v).all()),
                        f"view {i}: non-finite {k}")
    return dict(splats=splats, launches=launches,
                view_ms=[dt * 1e3 for dt, _ in timed],
                maps=[m for _, m in timed])


def compare_plain_view(dev, splats, cam) -> float:
    """Render one view through the kernels and through the plain path on
    the card; returns the max abs error over the blended maps."""
    rcam = cam.raster_camera(device=dev)
    w2c = torch.as_tensor(cam.w2c, device=dev)
    bg = torch.zeros(3, device=dev)
    k = render_view(splats, None, w2c, rcam, bg, 3, True, True, None,
                    EXACT_CFG)
    with _build.plain():
        r = render_view(splats, None, w2c, rcam, bg, 3, True, True, None,
                        EXACT_CFG)
    err = 0.0
    for f in ("color", "language", "instance", "all_map"):
        torch.testing.assert_close(getattr(k, f), getattr(r, f),
                                   atol=BLEND_ATOL, rtol=BLEND_RTOL)
        err = max(err, max_abs(getattr(k, f), getattr(r, f)))
    torch.testing.assert_close(k.final_T, r.final_T, atol=T_ATOL, rtol=0.0)
    # plane depth divides by n . ray, which can be near 0 at a pixel:
    # judge it by the median relative error over covered pixels
    covered = r.all_map[3] > 0.5
    rel = ((k.plane_depth - r.plane_depth).abs()
           / r.plane_depth.abs().clamp(min=1e-3))[covered]
    for f in ("radii", "visible", "pairs_overflowed", "k_overflowed",
              "num_pairs", "num_big"):
        require(torch.equal(getattr(k, f), getattr(r, f)),
                f"plain-path view: {f} differs")
    od = (k.out_observe.long() - r.out_observe.long()).abs()
    print(f"view 0 vs plain path: max|maps| err {err:.3e}, max|T| err "
          f"{max_abs(k.final_T, r.final_T):.3e}, plane depth median rel "
          f"err {float(rel.median()):.3e}, observe max diff {int(od.max())}")
    require(float(rel.median()) < 1e-3, "plane depth differs")
    require(int(od.max()) <= OBS_MAX_DIFF
            and float((od > 0).float().mean()) < OBS_MAX_FRAC,
            "observe differs beyond bounds")
    return err


def profile(fn, n: int, what: str) -> dict:
    """Where the time of ``fn`` goes: host wall time per synchronised call
    (outside the profiler), device busy time per call (the kernels' own
    times as torch.profiler records them over n calls), the device's idle
    share, and the five largest device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    def calls():
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    calls()
    t0 = time.perf_counter()
    calls()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        calls()
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3 / n
    if busy_ms == 0.0:
        print(f"profile ({what}): host wall {wall_ms:.3f} ms; device time "
              f"not measured (the profiler recorded no device events)")
        return dict(wall_ms=wall_ms)
    print(f"profile ({what}): host wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, device idle share "
          f"{1.0 - busy_ms / wall_ms:.1%}")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.4f} ms/call "
              f"x{e.count // n:<4d} {e.key[:70]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms)


def phase_profile(dev, splats, cam, n: int = 5) -> None:
    """The identity view's render profile."""
    rcam = cam.raster_camera(device=dev)
    w2c = torch.as_tensor(cam.w2c, device=dev)
    bg = torch.zeros(3, device=dev)
    profile(lambda: render_view(splats, None, w2c, rcam, bg, 3, True, True,
                                None, EXACT_CFG), n, "render, identity view")


def field_points(n: int):
    """The JAX package's train-rate scene (experiments/train_rate.py
    make_scene): the same numpy calls, seed 0."""
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(2, 10, n)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, cols


def supervise(cams, maps, lang_dir: str) -> None:
    """Training targets from the render path's output: each camera's image
    is its view's render, its language features the rendered language map
    (``<image_name>_f.npy``) and its segments the rendered instance map's
    first channel quantised to N_SEGMENTS ids where alpha > 0.5, -1
    elsewhere (``<image_name>_s.npy``). Each view's nearest view is the
    next one."""
    for i, (cam, m) in enumerate(zip(cams, maps)):
        cam.image = m["render"].clamp(0, 1).cpu().numpy()
        cam.image_gray = None
        cam.nearest_id = [(i + 1) % len(cams)]
        np.save(os.path.join(lang_dir, cam.image_name + "_f.npy"),
                m["language_feature"].cpu().numpy())
        np.save(os.path.join(lang_dir, cam.image_name + "_s.npy"),
                segments(m))


def segments(m) -> np.ndarray:
    """A render's instance map's first channel quantised to N_SEGMENTS ids
    where alpha > 0.5, -1 elsewhere."""
    inst = m["instance_feature"][0]
    seg = torch.clamp(((inst + 1.0) * 0.5 * N_SEGMENTS).long(), 0,
                      N_SEGMENTS - 1)
    return torch.where(m["alpha"] > 0.5, seg, -1).cpu().numpy()


def field_trainer(dev, cams, lang_dir: str) -> GaussianFieldTrainer:
    """field-200k-720x480's trainer on ``cams`` (supervised as
    ``supervise`` left them), before its first step."""
    pts, cols = field_points(FIELD_P)
    splats = create_from_points(pts, cols, max_sh_degree=3,
                                capacity=FIELD_CAP, seed=0, device=dev)
    return GaussianFieldTrainer(cams, splats, OptimizationConfig(),
                                scene_extent=FIELD_EXTENT, sh_degree_max=3,
                                rcfg=RasterConfig(), lang_dir=lang_dir)


@contextlib.contextmanager
def recorded_blend_backward():
    """Record the arguments of every K2 launch inside the block (lists,
    mean2d, conic, opacity, channels, accum, final_T, g_accum, g_T,
    grid_x, grid_y, tile_w, tile_h), detached: the real K1/K2 inputs of a
    step and the upstream gradients of its loss."""
    calls = []
    inner = rasterize_cuda._blend_backward_cuda

    def record(*args):
        calls.append(tuple(a.detach() if torch.is_tensor(a) else a
                           for a in args))
        return inner(*args)
    rasterize_cuda._blend_backward_cuda = record
    try:
        yield calls
    finally:
        rasterize_cuda._blend_backward_cuda = inner


@contextlib.contextmanager
def recorded_binning():
    """Record the arguments (args, kwargs) of every build_tile_lists call
    that the render makes inside the block: the real binning inputs of a
    render or a step."""
    calls = []
    inner = rasterize_mod.build_tile_lists

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)
    rasterize_mod.build_tile_lists = record
    try:
        yield calls
    finally:
        rasterize_mod.build_tile_lists = inner


def kernel_step(tr, it: int = 600) -> tuple:
    """One geometry + multi-view step at iteration ``it`` through the
    kernels: its flags, batch and draws and the arguments of its binning
    calls (``binnings``), loss_and_grads' output, and the K1/K2 inputs of its
    first view as ``check_blend_kernels`` takes them (bargs, cfg, g_accum,
    g_T). Returns (inputs, output, blend)."""
    flags = phase_flags(it, tr.cfg)
    batch = tr._camera_batch(0, flags)
    samples = tr.draw_samples(flags)
    with recorded_blend_backward() as calls, \
            recorded_binning() as binnings:
        out = loss_and_grads(tr.cfg, flags, tr.rcfg, tr.proxy_cam, tr.state,
                             batch, samples, tr.active_sh_degree)
    (lists, mean2d, conic, opacity, channels, _, _, g_accum, g_T, gx, gy,
     tw, th) = calls[0]
    blend = ((lists, mean2d, conic, opacity, channels, gx, gy),
             dataclasses.replace(tr.rcfg, tile_w=tw, tile_h=th), g_accum,
             g_T)
    return (dict(flags=flags, batch=batch, samples=samples,
                 binnings=binnings), out, blend)


def phase_train(dev, cams, lang_dir: str) -> dict:
    """field-200k-720x480 through GaussianFieldTrainer.train in the phase
    windows; every step checked. Returns the trainer and the launch
    counts of the phase."""
    t0 = time.perf_counter()
    tr = field_trainer(dev, cams, lang_dir)
    cfg = tr.cfg
    torch.cuda.synchronize()
    print(f"train set-up: {FIELD_P} points, capacity {FIELD_CAP}, "
          f"max_pairs {tr.rcfg.max_pairs}, {time.perf_counter() - t0:.2f} s")
    steps = []
    clock = [0.0]

    def check(it, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        m = {k: float(v) for k, v in metrics.items()}
        steps.append((it, now - clock[0], m))
        clock[0] = now
        require(m["pair_overflow"] == 0.0 and m["k_overflow"] == 0.0,
                f"step {it}: overflow flag (num_pairs {m['num_pairs']:.0f}, "
                f"num_big {m['num_big']:.0f})")
        require(math.isfinite(m["total"]), f"step {it}: non-finite loss")
        s = state.splats
        for name in ("xyz", "scaling", "rotation", "opacity",
                     "features_dc", "language_feature"):
            require(bool(torch.isfinite(getattr(s, name)).all()),
                    f"step {it}: non-finite {name}")
        require(bool(torch.isfinite(state.poses).all()),
                f"step {it}: non-finite poses")

    _build.reset_launch_counts()
    windows = []
    for first, last in TRAIN_WINDOWS:
        n_before = int(tr.state.splats.num_alive)
        torch.cuda.synchronize()
        clock[0] = time.perf_counter()
        lo = len(steps)
        tr.train(iterations=last, first_iteration=first, callback=check)
        ws = steps[lo:]
        ms = [dt * 1e3 for _, dt, _ in ws]
        windows.append(dict(first=first, last=last, ms=ms))
        print(f"window {first}-{last} ({phase_flags(first, cfg).phase}): "
              f"ms/step {' '.join('%.1f' % t for t in ms)}; num_pairs "
              f"{' '.join('%d' % m['num_pairs'] for _, _, m in ws)}; "
              f"alive {n_before} -> {int(tr.state.splats.num_alive)}")
        print(f"  last step: " + " ".join(
            f"{k}={v:.5g}" for k, v in ws[-1][2].items()))
    launches = dict(_build.launch_counts)
    print(f"launch counts over the training-path run: {launches}")
    for name in RENDER_TRAIN_KERNELS + KNN_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                f"training path")
    # one K14 launch a loss_cls_3d call: the language and instance obj3d
    # losses of the windows that train them
    knn_calls = sum(("obj3d_loss" in m) + ("ins_obj3d_loss" in m)
                    for _, _, m in steps)
    print(f"obj3d loss calls {knn_calls}, K14 launches "
          f"{launches['knn_select']}")
    require(launches["knn_select"] == knn_calls,
            "K14's launches differ from the obj3d loss calls")
    first = [m["total"] for _, _, m in steps[:5]]
    last = [m["total"] for _, _, m in steps[15:20]]
    print(f"window 1-20 loss: first 5 steps mean {np.mean(first):.5f}, "
          f"last 5 steps mean {np.mean(last):.5f}")
    require(np.mean(last) < np.mean(first),
            "the loss did not fall over the first window")
    return dict(trainer=tr, launches=launches, windows=windows)


def app_grad_floor(tr, flags, batch) -> torch.Tensor:
    """The atol floor [Nimg, 2] of the exposure gradient. Its row (a, b)
    of the step's image is (1 - lambda_dssim) times the mean over the
    3·H·W terms of sign(r)·exp(a)·image and of sign(r), r = exp(a)·image
    + b - gt (the L1 term): where the kernels' render and the plain one
    put a residual on either side of 0, a term flips, and a near-median
    b leaves a sum far smaller than its terms. The floor is the most the
    two renders' termwise differences can move each mean (the triangle
    inequality) plus 32 f32 ulps of the largest term for the reductions;
    a gap beyond it is not the renders'. Renders the step's view again
    through both paths, as the step does."""
    pose = tr.state.poses[batch.cam_idx] if flags.optim_pose else None

    def render():
        return render_view(tr.state.splats, pose, batch.w2c, tr.proxy_cam,
                           batch.bg, tr.active_sh_degree, True, True, None,
                           tr.rcfg).color
    with torch.no_grad(), exact_f32():
        imgs = [render()]
        with _build.plain():
            imgs.append(render())
        a, b = tr.state.app_ab[batch.uid]
        terms = []
        for img in imgs:
            sgn = torch.sign(torch.exp(a) * img + b - batch.gt_image)
            terms.append((sgn * torch.exp(a) * img, sgn))
        eps = torch.finfo(torch.float32).eps
        floor = torch.zeros_like(tr.state.app_ab)
        for j in range(2):
            floor[batch.uid, j] = (1 - tr.cfg.lambda_dssim) * (
                (terms[0][j] - terms[1][j]).abs().mean()
                + 32 * eps * terms[0][j].abs().max())
    n_flip = int((terms[0][1] != terms[1][1]).sum())
    print(f"  exposure terms: {n_flip} of {terms[0][1].numel()} residual "
          f"signs differ between the two renders")
    return floor


@contextlib.contextmanager
def kernel_render_values():
    """Inside the block every render of the field step renders through
    the kernels without gradients and through the plain path (inside
    ``_build.plain()``), and returns the plain render's output carrying the
    kernels' values: each float map is its own plus (the kernels' - its
    own), detached. The step then computes its loss on the kernels'
    values, with the kernel step's masks, bilinear cells and weights, and
    takes its gradients back through the plain backward (the blend keeps
    its forward's choice)."""
    inner = train_field.rasterize

    def hybrid(*args, **kw):
        with torch.no_grad():
            k = inner(*args, **dict(kw, mean2d_abs_hook=None))
        with _build.plain():
            p = inner(*args, **kw)
        return p._replace(**{
            f: getattr(p, f) + (getattr(k, f) - getattr(p, f)).detach()
            for f in RENDER_MAPS if getattr(p, f) is not None})
    train_field.rasterize = hybrid
    try:
        yield
    finally:
        train_field.rasterize = inner


def ulp_apart(state, seed: int = 1):
    """``state`` with every splat mean one f32 ulp away, up or down at
    random."""
    xyz = state.splats.xyz
    gen = torch.Generator(device=xyz.device).manual_seed(seed)
    up = torch.rand(xyz.shape, generator=gen, device=xyz.device) < 0.5
    moved = torch.nextafter(xyz, torch.where(up, math.inf, -math.inf))
    return dataclasses.replace(state, splats=dataclasses.replace(
        state.splats, xyz=moved))


def compare_plain_step(tr, it: int = 600) -> dict:
    """One geometry + multi-view step's loss and gradients through the
    kernels and through the plain path, same state, batch and draws; the
    pose row is held against the plain step on the kernels' rendered
    values (POSE_ROW_ATOL_FRAC). Returns the step's inputs and the K1/K2
    inputs of its first view under ``blend``."""
    _build.reset_launch_counts()
    step_in, k, blend = kernel_step(tr, it)
    require(_build.launch_counts["blend_backward"] == 2,
            "the kernel step did not run K2 for both views")
    flags, batch, samples = (step_in[n] for n in ("flags", "batch",
                                                  "samples"))
    require(batch.has_near, "the plain-step view has no near view")
    _build.reset_launch_counts()
    with _build.plain():
        r = loss_and_grads(tr.cfg, flags, tr.rcfg, tr.proxy_cam, tr.state,
                           batch, samples, tr.active_sh_degree)
        require(sum(_build.launch_counts.values()) == 0,
                "the plain step launched a kernel")
        r_ulp = loss_and_grads(tr.cfg, flags, tr.rcfg, tr.proxy_cam,
                               ulp_apart(tr.state), batch, samples,
                               tr.active_sh_degree)
    with kernel_render_values():
        h = loss_and_grads(tr.cfg, flags, tr.rcfg, tr.proxy_cam, tr.state,
                           batch, samples, tr.active_sh_degree)
    lk, lr = float(k[0]), float(r[0])
    refs = dict(r[4], poses=h[4]["poses"])
    floors = {"poses": POSE_ROW_ATOL_FRAC
              * refs["poses"].abs().amax(1, keepdim=True),
              "app_ab": app_grad_floor(tr, flags, batch)}
    worst, bad_groups = 0.0, []
    for name in k[4]:
        bad = bad_rows(k[4][name], refs[name], floors.get(name))
        worst = max(worst, bad)
        if bad > STEP_MAX_BAD:
            bad_groups.append(name)
    print(f"train step vs plain path (it {it}): loss {lk:.6f} vs {lr:.6f} "
          f"(plain on the kernels' renders {float(h[0]):.6f}), worst group "
          f"{worst:.4%} of rows outside the gradient bound")
    pk, ph, pr, pu = (g[4]["poses"][batch.cam_idx] for g in (k, h, r, r_ulp))
    row = float(ph.abs().max())

    def rel(a, b):
        return [f"{x:.3e}" for x in ((a - b).abs() / row).tolist()]
    print(f"  pose gradient of camera {batch.cam_idx}: kernel "
          f"{[f'{x:.6e}' for x in pk.tolist()]}, plain on the kernels' "
          f"renders {[f'{x:.6e}' for x in ph.tolist()]}; w "
          f"{float(ph[0]):.6e} ({float(ph[0]) / row:.3e} of the row), apart "
          f"{float((pk[0] - ph[0]).abs()):.3e} "
          f"({float((pk[0] - ph[0]).abs()) / row:.3e} of the row)")
    print(f"  pose row apart, over its largest: kernel vs plain on the "
          f"kernels' renders {rel(pk, ph)}; kernel vs plain {rel(pk, pr)}; "
          f"plain vs plain with the means one ulp apart {rel(pu, pr)}")
    ak, ar = k[4]["app_ab"][batch.uid], r[4]["app_ab"][batch.uid]
    print(f"  exposure gradient of image {batch.uid} (a, b): kernel "
          f"{[f'{x:.6e}' for x in ak.tolist()]}, plain "
          f"{[f'{x:.6e}' for x in ar.tolist()]}, apart "
          f"{[f'{x:.3e}' for x in (ak - ar).abs().tolist()]}, floor "
          f"{[f'{x:.3e}' for x in floors['app_ab'][batch.uid].tolist()]}")
    require(abs(lk - lr) <= LOSS_RTOL * abs(lr), "step loss differs")
    require(not bad_groups, f"gradients differ: {bad_groups}")
    return dict(step_in, blend=blend)


def phase_field_blend(dev, blend, results) -> None:
    """K1 and K2 against their plain versions on the field step's real
    inputs (phase 7's first view), timed beside the render scene's case:
    their times and bounds join the kernels line as ``field_*``."""
    k1, k2 = check_blend_kernels(dev, "field step, it 600", *blend,
                                 max_flips=K1_MAX_FLIPS)
    for name, e in (("blend_forward", k1), ("blend_backward", k2)):
        results[name].update({f"field_{k}": e[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_term")})


def phase_field_binning(dev, binnings, results) -> None:
    """K15 + K4 bit for bit against the plain path on every list of phase
    7's step; K3 (the card's fallback, which the step no longer runs) on
    the first view's broadcast stream, timed as in phase 3: its entries
    join the kernels line as ``field_*``."""
    require(len(binnings) > 0, "the kernel step built no tile lists")
    for args, kwargs in binnings:
        got = binning.build_tile_lists(*args, **kwargs)
        with _build.plain():
            ref = binning.build_tile_lists(*args, **kwargs)
        require(same_lists(got, ref), "build_tile_lists (field step): K15 "
                "+ K4 differ from the plain path")
    print(f"K15 bin_pairs: the field step's {len(binnings)} tile lists "
          f"bit-identical to the plain path's")
    (proc, gx, gy, K), kw = binnings[0]
    ps = enumerate_pairs(proc, gx, gy, K, kw["max_pairs"], kw["big_splats"],
                         kw["cull"], kw["extra_tiers"],
                         rank_key=kw["rank_key"])
    require(ps.rank_key, "the field step should take the rank-key path")
    sent = (gx * gy) << 22
    e = check_compaction(dev, "field step, it 600", (
        ps.key, ps.sid, sent, ps.out_len, sent, proc.depth.shape[0]))
    results["compact_pairs"].update({f"field_{k}": e[k] for k in (
        "max_abs_err", "ms", "host_paced_ms", "plain_ms", "bound_ms",
        "library_ms")})


def phase_train_profile(tr, step_in: dict, n: int = 3) -> dict:
    """Profile n geometry + multi-view steps (loss, gradients, update)
    on a copy of the trainer's state."""
    from langscenex_tpu_torch.train.field import make_train_step
    step = make_train_step(tr.cfg, step_in["flags"], tr.rcfg, tr.proxy_cam,
                           tr.scene_extent)
    state = [tr.state]

    def one():
        state[0], _ = step(state[0], step_in["batch"], step_in["samples"],
                           tr.active_sh_degree)
    return profile(one, n, "train step, geometry + multi-view")


def ms_list(seconds) -> str:
    return " ".join("%.1f" % (t * 1e3) for t in seconds)


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    """RMS of the difference over the RMS of ``ref``."""
    d = (got.float() - ref.float()).pow(2).mean().sqrt()
    return float(d / ref.float().pow(2).mean().sqrt().clamp(min=1e-30))


def dit_inputs(dev, text, pcfg, dtype):
    """One DiT call of the request's shapes (at full scale [uncond; cond]
    latents [2, 13, 32, 60, 90]: seeded noise and image latents; the stub
    prompts' embeddings [2, 226, 4096]; timestep 999), in ``dtype``."""
    gen = torch.Generator(device=dev).manual_seed(DIT_SEED + 1)
    shape = (1, pcfg.latent_frames, pcfg.latent_channels, pcfg.latent_height,
             pcfg.latent_width)
    lat = torch.randn(shape, generator=gen, device=dev)
    img = 0.5 * torch.randn(shape, generator=gen, device=dev)
    model_in = torch.cat([lat, img], dim=2).expand(2, -1, -1, -1, -1)
    txt = torch.from_numpy(np.concatenate([text.encode([""]),
                                           text.encode([PROMPT])])).to(dev)
    tt = torch.full((2,), 999, dtype=torch.int32, device=dev)
    return model_in.to(dtype).contiguous(), txt.to(dtype), tt


@torch.inference_mode()
def phase_dit_kernels(dev, dit, model_in, txt, tt, results) -> None:
    """K8 and K5 against their plain versions on the real inputs of the
    first block."""
    blk = dit.transformer_blocks[0]
    Tt = txt.shape[1]
    joint, temb, rope = dit.embed(model_in, txt, tt)
    emb = blk.norm1.linear(torch.nn.functional.silu(temb))
    shift, scale, _, t_shift, t_scale, _ = emb.chunk(6, dim=-1)
    mods = [m.contiguous() for m in (scale, shift, t_scale, t_shift)]
    largs = (joint, blk.norm1.norm.weight, blk.norm1.norm.bias, *mods, Tt)
    y, ry = ln_modulate(*largs), ln_modulate_plain(*largs)
    require(bool(torch.isfinite(y.float()).all()), "K8: non-finite output")
    torch.testing.assert_close(y.float(), ry.float(), atol=LNZ_ATOL,
                               rtol=LNZ_RTOL)
    ms = cuda_ms(lambda: ln_modulate(*largs), 20)
    plain_ms = cuda_ms(lambda: ln_modulate_plain(*largs), 5)
    lnz_bound = bound(moved=nbytes(*largs[:7], y))
    print(f"K8 ln_modulate x {list(joint.shape)} {joint.dtype}, text_len "
          f"{Tt}: max abs err {max_abs(y, ry):.3e} (bound {LNZ_RTOL:.3g} "
          f"rel + {LNZ_ATOL:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {lnz_bound['bound_ms']:.4f} ms ({lnz_bound['bound_by']})")
    results["ln_modulate"] = dict(max_abs_err=max_abs(y, ry), ms=ms,
                                  plain_ms=plain_ms, **lnz_bound,
                                  library_ms=None)

    q, k, v = blk.attn1.qkv(y, rope)
    sc = 1.0 / math.sqrt(q.shape[-1])
    o, l2 = attention_bthd_kernel(q, k, v, sc)
    ro, rl2 = attention_bthd_plain(q, k, v, sc)
    o_rms = rel_rms(o, ro)
    l2_mean = float((l2 - rl2).abs().mean())
    print(f"K5 vs plain: max|o| err {max_abs(o, ro):.3e} (max|o| "
          f"{float(ro.float().abs().max()):.3e}, bound {ATTN_RTOL:.3g} rel + "
          f"{ATTN_ATOL:g}), o rel RMS {o_rms:.3e} (RMS|o| "
          f"{float(ro.float().pow(2).mean().sqrt()):.3e}, bound "
          f"{ATTN_REL_RMS:.3g}), max|l2| err {max_abs(l2, rl2):.3e} (bound "
          f"{L2_ATOL:g}), mean|l2| err {l2_mean:.3e} (bound {L2_MEAN_ATOL:g})")
    require(bool(torch.isfinite(o.float()).all()), "K5: non-finite output")
    torch.testing.assert_close(o.float(), ro.float(), atol=ATTN_ATOL,
                               rtol=ATTN_RTOL)
    require(o_rms <= ATTN_REL_RMS, f"K5: o's relative RMS difference "
            f"{o_rms:.3e} above {ATTN_REL_RMS:.3g}")
    torch.testing.assert_close(l2, rl2, atol=L2_ATOL, rtol=0.0)
    require(l2_mean <= L2_MEAN_ATOL, f"K5: mean |l2| difference "
            f"{l2_mean:.3e} above {L2_MEAN_ATOL:g}")
    err = max(max_abs(o, ro), max_abs(l2, rl2))
    ms = cuda_ms(lambda: attention_bthd_kernel(q, k, v, sc), 5)
    plain_ms = cuda_ms(lambda: attention_bthd_plain(q, k, v, sc), 1,
                       warmup=1)
    bhtd = [t.transpose(1, 2) for t in (q, k, v)]
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *bhtd), 5)
    B, T, H, D = q.shape
    attn_bound = bound(flops=4.0 * B * H * T * T * D,
                       moved=nbytes(q, k, v, o, l2))
    print(f"K5 flash_attention q,k,v {list(q.shape)} {q.dtype}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{lib_ms:.4f} ms, bound {attn_bound['bound_ms']:.4f} ms "
          f"({attn_bound['bound_by']}, {4.0 * B * H * T * T * D / 1e12:.3f} "
          f"TFLOP)")
    # the bounded mode: one ex2 per score, none for a rescale
    forward_terms("K5 flash_attention", ms, B, H, T, T, B * H * T * T, dev)
    results["flash_attention"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, **attn_bound,
                                      library_ms=lib_ms)


@torch.inference_mode()
def phase_dit_compare(dit, model_in, txt, tt) -> None:
    """The full-width DiT through the kernels and through the plain path
    on the same weights and inputs."""
    Tt = txt.shape[1]
    joint, temb, rope = dit.embed(model_in, txt, tt)

    def two_blocks():
        x = joint
        for blk in dit.transformer_blocks[:2]:
            x = blk(x, temb, rope, Tt)
        return x

    k2 = two_blocks()
    with _build.plain():
        p2 = two_blocks()
    e2 = rel_rms(k2, p2)
    del k2, p2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kout = dit(model_in, txt, tt)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    with _build.plain():
        pout = dit(model_in, txt, tt)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    require(bool(torch.isfinite(kout.float()).all()
                 and torch.isfinite(pout.float()).all()),
            "DiT: non-finite noise prediction")
    e = rel_rms(kout, pout)
    n_layers = len(dit.transformer_blocks)
    print(f"DiT kernels vs plain path: residual stream after 2 blocks rel "
          f"RMS {e2:.3e} (bound {DIT2_REL_RMS:g}); {n_layers}-layer noise "
          f"prediction {list(kout.shape)} rel RMS {e:.3e} "
          f"(bound {DIT_REL_RMS:g}), max abs {max_abs(kout, pout):.3e} "
          f"(max|ref| {float(pout.float().abs().max()):.3e}); forward "
          f"{t_k * 1e3:.1f} ms through the kernels, {t_p * 1e3:.1f} ms plain "
          f"(host clock, synchronised)")
    require(e2 <= DIT2_REL_RMS, "DiT after 2 blocks differs from the plain "
            "path beyond the bound")
    require(e <= DIT_REL_RMS, "DiT noise prediction differs from the plain "
            "path beyond the bound")


def phase_request(dev, pipe, text, pcfg, n_layers: int) -> dict:
    """One trimap-dit-5b-49x480x720 request through the pipeline, with
    every launch counted."""
    rng = np.random.default_rng(0)
    first, last = (torch.from_numpy(rng.uniform(
        -1, 1, (1, 3, pcfg.height, pcfg.width)).astype(np.float32)).to(dev)
        for _ in range(2))
    cond = torch.from_numpy(text.encode([PROMPT])).to(dev)
    uncond = torch.from_numpy(text.encode([""])).to(dev)
    times = {"encode": [], "step": [], "decode": []}
    clock = [0.0]
    encode, decode = pipe.vae_encode, pipe.vae_decode

    def timed(fn, key):
        def run(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x)
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
            times[key].append(clock[0] - t0)
            return out
        return run

    def step_done(i, t, evaluated, latents):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times["step"].append(now - clock[0])
        clock[0] = now

    pipe.vae_encode = timed(encode, "encode")
    pipe.vae_decode = timed(decode, "decode")
    gen = torch.Generator(device=dev).manual_seed(DIT_SEED)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        video = pipe(first, last, cond, uncond, generator=gen,
                     callback=step_done)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    finally:
        pipe.vae_encode, pipe.vae_decode = encode, decode
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"launch counts over the request: {launches}")
    print(f"request: video {list(video.shape)} {video.dtype}, wall "
          f"{wall:.3f} s; encode {ms_list(times['encode'])} ms; denoise "
          f"steps {ms_list(times['step'])} ms; tiled decode "
          f"{ms_list(times['decode'])} ms; peak allocated "
          f"{peak / 2 ** 30:.3f} GiB; video range "
          f"[{float(video.min()):.4f}, {float(video.max()):.4f}]")
    require(tuple(video.shape) == (1, pcfg.num_frames, 3, pcfg.height,
                                   pcfg.width), "request: video shape")
    require(bool(torch.isfinite(video).all()), "request: non-finite video")
    steps = pcfg.num_inference_steps
    require(launches["flash_attention"] == n_layers * steps,
            f"request: {launches['flash_attention']} K5 launches, expected "
            f"{n_layers * steps}")
    require(launches["ln_modulate"] == 2 * n_layers * steps,
            f"request: {launches['ln_modulate']} K8 launches, expected "
            f"{2 * n_layers * steps}")
    return dict(launches=launches, times=times, wall=wall, peak=peak)


def phase_dit_profile(pipe, model_in, txt) -> dict:
    """Profile one denoise step: the guided DiT call at batch 2 and the
    DDIM update."""
    C = pipe.cfg.latent_channels
    lat = model_in[:1, :, :C].float()
    img = model_in[:1, :, C:].float()
    sched, cfg = pipe.scheduler, pipe.cfg
    ts = sched.timesteps(cfg.num_inference_steps)

    @torch.inference_mode()
    def step():
        pred = guided_prediction(pipe.denoiser_fn, lat, img, txt, ts[0],
                                 sched, cfg)
        sched.step(pred, ts[0], ts[1], lat)
    return profile(step, 1, "one denoise step, trimap-dit-5b-49x480x720")


def ft_dit(dev, cfg: TransformerConfig, dtype) -> CogVideoXTransformer:
    """The DiT of cfg with build_pipeline's random weights (seed 42)."""
    return materialize(CogVideoXTransformer(cfg, device="meta"), dtype, dev,
                       torch.Generator(device=dev).manual_seed(42))


def ft_batch(dev, text_dim: int, dtype) -> dict:
    """experiments/lora_step_real.py's batch: x0, cond [1, 13, 16, 60, 90]
    and text [1, 226, text_dim], standard normals from numpy seed 0."""
    rng = np.random.default_rng(0)
    lat = (1, FT_FRAMES, FT_CH, FT_H, FT_W)
    arrays = {"x0": rng.normal(size=lat), "cond": rng.normal(size=lat),
              "text": rng.normal(size=(1, FT_TEXT, text_dim))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev, dtype)
            for k, v in arrays.items()}


def check_grad(name, got, ref, rtol, atol_frac, rel_bound) -> tuple:
    """Hold one gradient to rtol + atol_frac of the largest |ref| per
    element and to rel_bound in relative RMS; returns (max abs error,
    relative RMS)."""
    got, ref = got.float(), ref.float()
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    biggest = float(ref.abs().max())
    err, rel = max_abs(got, ref), rel_rms(got, ref)
    print(f"  {name}: max abs err {err:.3e} (max|ref| {biggest:.3e}, bound "
          f"{rtol:.3g} rel + {atol_frac:.3g} x max|ref|), rel RMS {rel:.3e} "
          f"(bound {rel_bound:.3g})")
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol_frac * biggest,
                               msg=name)
    require(rel <= rel_bound, f"{name}: relative RMS {rel:.3e} above "
            f"{rel_bound:.3g}")
    return err, rel


def sdpa_backward_ms(q, k, v, do) -> tuple:
    """scaled_dot_product_attention's backward on [B, H, T, D] operands, as
    forward + backward minus forward, and its forward (the library
    yardstick only)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        fwd = cuda_ms(lambda: sdpa(lq, lk, lv), 5)
    both = cuda_ms(lambda: torch.autograd.grad(sdpa(lq, lk, lv), (lq, lk, lv),
                                               do), 5)
    return both - fwd, fwd


def phase_k7(dev, dit, batch, results) -> None:
    """K7 against its plain version on the LoRA cell's layer-0 q, k, v and
    a seeded output gradient; K8 in f32 against its plain version on the
    layer-0 stream."""
    blk = dit.transformer_blocks[0]
    Tt = batch["text"].shape[1]
    with torch.inference_mode():
        model_in = torch.cat([batch["x0"], batch["cond"]], dim=2)
        tt = torch.full((1,), 500, dtype=torch.int32, device=dev)
        joint, temb, rope = dit.embed(model_in, batch["text"], tt)
        n, _, _ = blk.norm1(joint, temb, Tt)
        q, k, v = (t.contiguous() for t in blk.attn1.qkv(n, rope))
        sc = 1.0 / math.sqrt(q.shape[-1])
        o, l2 = attention_bthd_kernel(q, k, v, sc)
        gen = torch.Generator(device=dev).manual_seed(3)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        got = attention_bthd_backward_kernel(q, k, v, o, l2, do, sc)
        ref = attention_bthd_backward_plain(q, k, v, o, l2, do, sc)
    print(f"K7 flash_attention_backward q,k,v,do {list(q.shape)} {q.dtype} "
          f"vs plain (bounds: an output one bf16 ulp away, 2^-7 relative, "
          f"and a ds rounded the other way, 2^-8 of the largest gradient; "
          f"relative RMS 2^-8, below the {math.sqrt(64 / (q.shape[1] * q.shape[2])):.2g} "
          f"of a key tile dropped from one head):")
    err = max(check_grad(f"d{name}", g, r, BWD_RTOL, BWD_ATOL_FRAC,
                         BWD_REL_RMS)[0]
              for name, g, r in zip("qkv", got, ref))
    del got, ref
    # the wrapper as a whole (q', dvec and the padded l2, the zeroed f32
    # dq, the cast of dq), which the kernels line reports as in every
    # earlier run, and the kernel alone on prepared operands
    launch = attention_bthd_backward_launch(q, k, v, o, l2, do, sc)[0]
    kernel_ms = cuda_ms(launch, 5)
    ms = cuda_ms(lambda: attention_bthd_backward_kernel(
        q, k, v, o, l2, do, sc), 5)
    del launch
    plain_ms = cuda_ms(lambda: attention_bthd_backward_plain(
        q, k, v, o, l2, do, sc), 1, warmup=1)
    # the library yardstick: SDPA's backward in the [B, H, T, D] layout
    lib_ms, fwd_ms = sdpa_backward_ms(*(t.transpose(1, 2)
                                        for t in (q, k, v, do)))
    B, T, H, D = q.shape
    flops = 10.0 * B * H * T * T * D          # s, dp, dv, dk, dq products
    k7_bound = bound(flops=flops, moved=nbytes(q, k, v, o, l2, do, q, k, v))
    n_exp = B * H * T * T
    sfu = n_exp / (16 * torch.cuda.get_device_properties(
        dev).multi_processor_count)
    require_no_spill("flash_bwd", "K7 flash_attention_backward")
    print(f"K7 flash_attention_backward: kernel {kernel_ms:.4f} ms alone, "
          f"wrapper {ms:.4f} ms ({K7_BEFORE_MS} ms before the wgmma design), "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention backward "
          f"{lib_ms:.4f} ms (fwd+bwd minus fwd {fwd_ms:.4f}), bound "
          f"{k7_bound['bound_ms']:.4f} ms ({k7_bound['bound_by']}, "
          f"{flops / 1e12:.3f} TFLOP); {n_exp:.4g} exp2 = {sfu:.4g} SFU "
          f"cycles per SM at 16 ex2/clk")
    results["flash_attention_backward"] = dict(
        max_abs_err=err, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
        **k7_bound, library_ms=lib_ms)
    del q, k, v, o, l2, do

    # K8 in f32 on the layer-0 stream and modulation of this cell
    with torch.inference_mode():
        emb = blk.norm1.linear(torch.nn.functional.silu(temb)).float()
        shift, scale, _, t_shift, t_scale, _ = emb.chunk(6, dim=-1)
        largs = (joint.float(), blk.norm1.norm.weight.float(),
                 blk.norm1.norm.bias.float(),
                 *[m.contiguous() for m in (scale, shift, t_scale, t_shift)],
                 Tt)
        y, ry = ln_modulate(*largs), ln_modulate_plain(*largs)
    require(y.dtype == torch.float32 and bool(torch.isfinite(y).all()),
            "K8 f32: output")
    torch.testing.assert_close(y, ry, atol=LNZ32_ATOL, rtol=LNZ32_RTOL)
    ms = cuda_ms(lambda: ln_modulate(*largs), 20)
    plain_ms = cuda_ms(lambda: ln_modulate_plain(*largs), 5)
    b32 = bound(moved=nbytes(*largs[:7], y))
    print(f"K8 ln_modulate x {list(largs[0].shape)} float32: max abs err "
          f"{max_abs(y, ry):.3e} (max|y| {float(ry.abs().max()):.3e}, bound "
          f"{LNZ32_RTOL:g} rel + {LNZ32_ATOL:g}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b32['bound_ms']:.4f} ms "
          f"({b32['bound_by']})")


def compare_lora_grads(dev, dit, batch) -> None:
    """The adapter gradients and the loss of one LoRA step through the
    kernels and through the plain path, on the first 2 blocks at full
    width, with the same adapters (B nonzero, so that A has a gradient),
    t and noise."""
    lcfg = LoRAConfig(rank=16)
    blocks = dit.transformer_blocks
    dit.transformer_blocks = blocks[:2]
    try:
        gen = torch.Generator(device=dev).manual_seed(4)
        ad = init_lora(dit, lcfg, gen)
        for ab in ad.values():
            ab["b"].normal_(0.0, 0.01, generator=gen)
        t = torch.full((1,), 500, device=dev)
        noise = torch.randn(batch["x0"].shape, generator=gen, device=dev,
                            dtype=batch["x0"].dtype)
        tables = _sched_tables(LORA_TRAIN, dev)
        out = {}
        for kernels in (True, False):
            _build.reset_launch_counts()
            with (contextlib.nullcontext() if kernels else _build.plain()):
                out[kernels] = lora_loss_and_grads(dit, ad, lcfg, batch, t,
                                                   noise, tables)
            torch.cuda.synchronize()
            launches = dict(_build.launch_counts)
            want = ({"flash_attention": 4, "flash_attention_backward": 2,
                     "ln_modulate": 8} if kernels else {})
            got = {k: v for k, v in launches.items() if v}
            require(got == want, f"2-block LoRA step (kernels={kernels}): "
                    f"launches {got}, expected {want}")
    finally:
        dit.transformer_blocks = blocks
    (lk, gk), (lp, gp) = out[True], out[False]
    worst = max((rel_rms(gk[s][x], gp[s][x]), f"{s}/{x}")
                for s in gk for x in gk[s])
    print(f"LoRA step on 2 blocks, kernels vs plain path: loss "
          f"{float(lk):.6f} vs {float(lp):.6f}; {len(gk)} adapters, worst "
          f"gradient rel RMS {worst[0]:.3e} at {worst[1]} (bound "
          f"{LORA2_GRAD_REL_RMS:g})")
    require(all(bool(torch.isfinite(g).all()) for ab in gk.values()
                for g in ab.values()), "LoRA: non-finite adapter gradient")
    require(abs(float(lk) - float(lp)) <= LORA2_LOSS_RTOL * abs(float(lp)),
            "LoRA 2-block loss differs from the plain path")
    require(worst[0] <= LORA2_GRAD_REL_RMS,
            "LoRA adapter gradients differ from the plain path")
    return dict(adapters={s: {k: v.cpu().numpy() for k, v in ab.items()}
                          for s, ab in ad.items()},
                t=t.cpu().numpy(), noise=noise.float().cpu().numpy(),
                loss=float(lk), grads={s: {k: v.float().cpu()
                                           for k, v in ab.items()}
                                       for s, ab in gk.items()})


def run_steps(dev, step, state, batch, n: int, gen, per_step: dict,
              what: str, first: int = 1) -> list:
    """n train steps (numbered from ``first``), each timed (host clock,
    synchronised) with its launch counts and peak memory; every step must
    launch exactly ``per_step``. Returns one record per step."""
    recs = []
    for i in range(first - 1, first - 1 + n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in _build.launch_counts.items() if v}
        rec = dict(ms=dt * 1e3, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]), launches=launches,
                   peak=torch.cuda.max_memory_allocated(dev))
        recs.append(rec)
        print(f"{what} step {i + 1}: {rec['ms']:.1f} ms, loss "
              f"{rec['loss']:.6f}, grad_norm {rec['grad_norm']:.6f}, peak "
              f"allocated {rec['peak'] / 2 ** 30:.3f} GiB, launches "
              f"{launches}")
        require(math.isfinite(rec["loss"]) and math.isfinite(
            rec["grad_norm"]), f"{what} step {i + 1}: non-finite metrics")
        require(launches == per_step, f"{what} step {i + 1}: launches "
                f"{launches}, expected {per_step}")
    return recs


def phase_lora(dev, dit, batch) -> dict:
    """lora-5b-49x480x720: 4 train steps of make_lora_train_step."""
    n_layers = len(dit.transformer_blocks)
    init_state, step = make_lora_train_step(dit, LORA_TRAIN,
                                            LoRAConfig(rank=16))
    state = init_state(torch.Generator(device=dev).manual_seed(1))
    print(f"LoRA: {len(state['lora'])} adapters, "
          f"{n_params(state['lora']):,} parameters (rank 16)")
    gen = torch.Generator(device=dev).manual_seed(2)
    per_step = {"flash_attention": 2 * n_layers,
                "flash_attention_backward": n_layers,
                "ln_modulate": 4 * n_layers}
    recs = []
    for i in range(LORA_STEPS):
        recs += run_steps(dev, step, state, batch, 1, gen, per_step, "LoRA",
                          first=i + 1)
        b_max = max(float(ab["b"].abs().max())
                    for ab in state["lora"].values())
        print(f"  max |B| over the adapters after step {i + 1}: {b_max:.4e}")
        if i == 0:
            require(b_max == 0.0, "adapters' B moved at learning rate 0")
        if i == 1:
            require(b_max > 0.0, "adapters' B did not move at step 2")
    return dict(recs=recs, step=step, state=state, gen=gen,
                launches=sum(r["launches"].get("flash_attention_backward", 0)
                             for r in recs))


def phase_ft(dev) -> list:
    """dit-ft-8L-49x480x720: 3 full fine-tune steps with f32 parameters
    and latents."""
    model = ft_dit(dev, TransformerConfig(num_layers=FT_LAYERS, remat=True),
                   torch.float32)
    n = sum(p.numel() for p in model.parameters())
    print(f"full fine-tune DiT: {FT_LAYERS} of 42 layers, {n / 1e9:.3f}B "
          f"f32 parameters ({n * 4 / 1e9:.2f} GB; with gradients and two "
          f"moments {n * 16 / 1e9:.2f} GB)")
    batch = ft_batch(dev, model.cfg.text_embed_dim, torch.float32)
    init_state, step = make_dit_train_step(model, DiTTrainConfig())
    state = init_state()
    gen = torch.Generator(device=dev).manual_seed(2)
    per_step = {"flash_attention": 2 * FT_LAYERS,
                "flash_attention_backward": FT_LAYERS,
                "ln_modulate": 4 * FT_LAYERS}
    return run_steps(dev, step, state, batch, FT_STEPS, gen, per_step,
                     "full fine-tune")


def check_attention(what: str, o, l2, ro, rl2, l2_mean: bool = True) -> float:
    """Hold an attention forward's o and l2 (None for K11) to its plain
    version's with K5's bounds (o per element and in relative RMS, l2 per
    element and, with ``l2_mean``, on average); returns the largest
    error."""
    o_rms = rel_rms(o, ro)
    msg = (f"{what}: max|o| err {max_abs(o, ro):.3e} (bound {ATTN_RTOL:.3g} "
           f"rel + {ATTN_ATOL:g}), o rel RMS {o_rms:.3e} (bound "
           f"{ATTN_REL_RMS:.3g})")
    if l2 is not None:
        l2_err = float((l2 - rl2).abs().mean())
        msg += (f", max|l2| err {max_abs(l2, rl2):.3e} (bound {L2_ATOL:g}), "
                f"mean|l2| err {l2_err:.3e} (bound "
                f"{L2_MEAN_ATOL if l2_mean else 'none'})")
    print(msg)
    require(bool(torch.isfinite(o.float()).all()), f"{what}: non-finite o")
    torch.testing.assert_close(o.float(), ro.float(), atol=ATTN_ATOL,
                               rtol=ATTN_RTOL, msg=what)
    require(o_rms <= ATTN_REL_RMS, f"{what}: o's relative RMS difference "
            f"{o_rms:.3e} above {ATTN_REL_RMS:.3g}")
    if l2 is None:
        return max_abs(o, ro)
    torch.testing.assert_close(l2, rl2, atol=L2_ATOL, rtol=0.0, msg=what)
    require(not l2_mean or l2_err <= L2_MEAN_ATOL, f"{what}: mean |l2| "
            f"difference {l2_err:.3e} above {L2_MEAN_ATOL:g}")
    return max(max_abs(o, ro), max_abs(l2, rl2))


def phase_k6(dev, results) -> None:
    """K6 against K5 on the same tensors at the request's full width,
    against its plain version at a TP=2 shard and at a Tk != T shape, with
    times; K7 on [B, H, T, D] views of a LoRA shard."""
    gen = torch.Generator(device=dev).manual_seed(5)
    B, T, H, D = 2, K6_T, K6_H, 64
    sc = 1.0 / math.sqrt(D)
    with torch.inference_mode():
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(3))
        o5, l5 = attention_bthd_kernel(q, k, v, sc)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        o6, l6 = flash_attention_kernel(qh, kh, vh, sc)
        same = torch.equal(o6.transpose(1, 2), o5) and torch.equal(l6, l5)
        print(f"K6 vs K5 on q,k,v {list(qh.shape)} (K6 on [B, H, T, D] "
              f"views of K5's [B, T, H, D] operands, one device function): "
              f"o and l2 bit-identical {same} (max|o| diff "
              f"{max_abs(o6.transpose(1, 2), o5):.3e}, max|l2| diff "
              f"{max_abs(l6, l5):.3e})")
        require(same, "K6 and K5 share their device code but differ")
        del o5, l5
        full_ms = cuda_ms(lambda: flash_attention_kernel(qh, kh, vh, sc), 5)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        full_lib = cuda_ms(lambda: sdpa(qh, kh, vh), 5)
        full_bound = bound(flops=4.0 * B * H * T * T * D,
                           moved=nbytes(q, k, v, o6, l6))
        print(f"K6 flash_attention_bhtd at the request's {list(qh.shape)}: "
              f"kernel {full_ms:.4f} ms, scaled_dot_product_attention "
              f"{full_lib:.4f} ms, bound {full_bound['bound_ms']:.4f} ms "
              f"({full_bound['bound_by']}, {4.0 * B * H * T * T * D / 1e12:.3f}"
              f" TFLOP at 989 TFLOP/s)")
        forward_terms("K6 flash_attention_bhtd", full_ms, B, H, T, T,
                      B * H * T * T, dev)
        del o6, l6
        # a TP=2 shard's heads, and 1,000 queries over all keys
        qs, ks, vs = (t[:, :H // 2] for t in (qh, kh, vh))
        err = 0.0
        for what, qq in (("TP=2 shard", qs), ("Tk != T", qs[:, :, :K6_SHORT_T])):
            o, l2 = flash_attention_kernel(qq, ks, vs, sc)
            ro, rl2 = flash_attention_plain(qq, ks, vs, sc)
            err = max(err, check_attention(f"K6 vs plain, {what}: q "
                                           f"{list(qq.shape)}, k, v "
                                           f"{list(ks.shape)}",
                                           o, l2, ro, rl2))
            if what == "TP=2 shard":
                shard_out = (o, l2)
            del ro, rl2
        o, l2 = shard_out
        ms = cuda_ms(lambda: flash_attention_kernel(qs, ks, vs, sc), 5)
        plain_ms = cuda_ms(lambda: flash_attention_plain(qs, ks, vs, sc), 1,
                           warmup=1)
        lib_ms = cuda_ms(lambda: sdpa(qs, ks, vs), 5)
        Hs = H // 2
        k6_bound = bound(flops=4.0 * B * Hs * T * T * D,
                         moved=nbytes(qs, ks, vs, o, l2))
        print(f"K6 flash_attention_bhtd at a TP=2 shard's {list(qs.shape)}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms, bound "
              f"{k6_bound['bound_ms']:.4f} ms ({k6_bound['bound_by']}, "
              f"{4.0 * B * Hs * T * T * D / 1e12:.3f} TFLOP)")
        forward_terms("K6 flash_attention_bhtd", ms, B, Hs, T, T,
                      B * Hs * T * T, dev)
        results["flash_attention_bhtd"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, **k6_bound,
            library_ms=lib_ms)
        # K7 reading [B, H, T, D] views: a TP LoRA shard's q, k, v
        q1, k1, v1 = (t[:1] for t in (qs, ks, vs))
        o1, l21 = flash_attention_kernel(q1, k1, v1, sc)
        do = torch.randn(q1.shape, generator=gen, device=dev).to(q1.dtype)
        got = flash_attention_backward_kernel(q1, k1, v1, o1, l21, do, sc)
        ref = flash_attention_backward_plain(q1, k1, v1, o1, l21, do, sc)
    print(f"K7 on [B, H, T, D] views {list(q1.shape)} vs plain (K7's "
          f"bounds):")
    for name, g, r in zip("qkv", got, ref):
        check_grad(f"d{name}", g, r, BWD_RTOL, BWD_ATOL_FRAC, BWD_REL_RMS)
    del got, ref
    ms7 = cuda_ms(lambda: flash_attention_backward_kernel(
        q1, k1, v1, o1, l21, do, sc), 5)
    k7_bound = bound(flops=10.0 * Hs * T * T * D,
                     moved=nbytes(q1, k1, v1, o1, l21, do, q1, k1, v1))
    print(f"K7 flash_attention_backward on [B, H, T, D] views "
          f"{list(q1.shape)}: kernel {ms7:.4f} ms, bound "
          f"{k7_bound['bound_ms']:.4f} ms ({k7_bound['bound_by']})")


def check_packed_exp2(o, ro, v, what: str) -> float:
    """Hold K13b's o to its plain version's where each p may be one bf16
    ulp away: |o - ro| <= 2^-7 / (1 - 2^-7) (max|v| + |ro|) + 2^-7 |ro|
    and o's relative RMS difference within 2^-7; returns the largest
    error."""
    o, ro = o.float(), ro.float()
    err, o_rms = max_abs(o, ro), rel_rms(o, ro)
    lim = (PACKED_EXP_ULP / (1 - PACKED_EXP_ULP)
           * (float(v.abs().max()) + ro.abs()) + PACKED_EXP_ULP * ro.abs())
    print(f"{what}: max|o| err {err:.3e} (bound 2^-7 (max|v| + |o|) + "
          f"2^-7 |o|, max|v| {float(v.abs().max()):.3g}), o rel RMS "
          f"{o_rms:.3e} (bound {K13B_REL_RMS:.3g}), "
          f"{float((o != ro).float().mean()):.4%} of outputs differ")
    require(bool(torch.isfinite(o).all()), f"{what}: non-finite o")
    require(bool(((o - ro).abs() <= lim).all()), f"{what}: o beyond bound")
    require(o_rms <= K13B_REL_RMS, f"{what}: o's relative RMS difference "
            f"{o_rms:.3e} above {K13B_REL_RMS:.3g}")
    return err


def same_lists(a, b) -> bool:
    """Whether two TileLists agree bit for bit in all seven fields."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def launches_now() -> dict:
    return {k: v for k, v in _build.launch_counts.items() if v}


def phase_exact(dev, results) -> dict:
    """Phase 20, attention-exact-48x17776x64: the exact-softmax attention
    through its entry points with exact launch counts, then K9, K11 and K7
    on K9's (o, l2) against their plain versions, K9 against K6, times and
    the two ported experiments. Returns the counted run's launches."""
    gen = torch.Generator(device=dev).manual_seed(6)
    B, T, H, D = 2, EXACT_T, EXACT_H, 64
    Tv = T - EXACT_TEXT
    sc = 1.0 / math.sqrt(D)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape, mag=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * mag).to(torch.bfloat16)

    q, k, v = (randn(B, H, T, D) for _ in range(3))
    q1, k1, v1 = (t[:1] for t in (q, k, v))
    do = randn(1, H, T, D)
    shapes = {"Tk = T": (k1, v1),
              f"Tk = {Tv} (the video keys)": (k1[:, :, EXACT_TEXT:],
                                              v1[:, :, EXACT_TEXT:])}

    # ---- the path, counted: flash_attention(bounded_logits=False) forward
    # and backward at both key lengths, attention_auto, flash_attention_h2
    _build.reset_launch_counts()
    runs = {}
    for i, (what, (kk, vv)) in enumerate(shapes.items()):
        leaves = [t.detach().requires_grad_() for t in (q1, kk, vv)]
        o = flash_attention(*leaves)
        o.backward(do)
        torch.cuda.synchronize()
        runs[what] = (o.detach(), [t.grad for t in leaves])
        want = {"flash_attention_online": i + 1,
                "flash_attention_backward": i + 1}
        require(launches_now() == want, f"exact attention {what}: launches "
                f"{launches_now()}, expected {want}")
    with torch.no_grad():
        auto = attention_auto(q1, k1, v1, bounded_logits=False)
        h2 = flash_attention_h2(q1, k1, v1)
    torch.cuda.synchronize()
    launches = launches_now()
    want = {"flash_attention_online": 3, "flash_attention_backward": 2,
            "flash_attention_h2": 1}
    print(f"exact attention path, q {list(q1.shape)}: flash_attention("
          f"bounded_logits=False) forward + backward at Tk = {T} and {Tv}, "
          f"attention_auto(bounded_logits=False), flash_attention_h2: "
          f"launches {launches} (expected {want})")
    require(launches == want, "exact attention path: launch counts")
    require(torch.equal(auto, runs["Tk = T"][0]),
            "attention_auto(bounded_logits=False) differs from K9")

    with torch.inference_mode():
        # ---- K9 against its plain version
        o9, l9 = flash_attention_online_kernel(q, k, v, sc)
        ro, rl2 = flash_attention_online_plain(q, k, v, sc,
                                               block_k=WGMMA_BLOCK_K)
        err9 = check_attention(f"K9 vs plain at its {WGMMA_BLOCK_K}-key "
                               f"tile, q, k, v {list(q.shape)}", o9, l9, ro,
                               rl2)
        del ro, rl2
        ro, rl2 = flash_attention_online_plain(q, k, v, sc)
        print(f"K9 vs plain at JAX's 1024-key block, {list(q.shape)}: "
              f"max|o| err {max_abs(o9, ro):.3e} (bound {ATTN_RTOL:.3g} rel "
              f"+ {ATTN_ATOL:g}), o rel RMS {rel_rms(o9, ro):.3e}, max|l2| "
              f"err {max_abs(l9, rl2):.3e} (bound {L2_ATOL:g})")
        torch.testing.assert_close(o9.float(), ro.float(), atol=ATTN_ATOL,
                                   rtol=ATTN_RTOL)
        torch.testing.assert_close(l9, rl2, atol=L2_ATOL, rtol=0.0)
        del ro, rl2
        err7 = 0.0
        for what, (kk, vv) in shapes.items():
            o, l2 = flash_attention_online_kernel(q1, kk, vv, sc)
            require(torch.equal(o, runs[what][0]), f"K9 {what}: the path's "
                    f"output differs from a second launch")
            ro, rl2 = flash_attention_online_plain(q1, kk, vv, sc,
                                                   block_k=WGMMA_BLOCK_K)
            err9 = max(err9, check_attention(
                f"K9 vs plain, {what}, q {list(q1.shape)}", o, l2, ro, rl2))
            ref = flash_attention_backward_plain(q1, kk, vv, o, l2, do, sc)
            print(f"K7 on K9's (o, l2), {what}: the path's gradients vs "
                  f"plain (K7's bounds):")
            err7 = max([err7] + [
                check_grad(f"d{n}", g, r, BWD_RTOL, BWD_ATOL_FRAC,
                           BWD_REL_RMS)[0]
                for n, g, r in zip("qkv", runs[what][1], ref)])
            del ro, rl2, ref
        Bx, Hx, Tx, Tkx = X20_SHAPE
        qx = randn(Bx, Hx, Tx, D, mag=20.0)
        kx, vx = randn(Bx, Hx, Tkx, D, mag=20.0), randn(Bx, Hx, Tkx, D)
        ox, lx = flash_attention_online_kernel(qx, kx, vx, sc)
        rox, rlx = flash_attention_online_plain(qx, kx, vx, sc,
                                                block_k=WGMMA_BLOCK_K)
        err9 = max(err9, check_attention(
            f"K9 vs plain, x20 logits {list(qx.shape)}, Tk {Tkx} (l2 up to "
            f"{float(lx.abs().max()):.4g})", ox, lx, rox, rlx, l2_mean=False))
        bounded = flash_attention_plain(qx, kx, vx, sc)[0]
        print(f"  the bounded softmax (K6's plain version) there: "
              f"{float((~torch.isfinite(bounded.float())).float().mean()):.2%}"
              f" of its outputs non-finite")
        # ---- K9 against K6 on LayerNormed q, k (bounded logits)
        qn, kn = (torch.nn.functional.layer_norm(t.float(), (D,)).to(
            torch.bfloat16) for t in (q1, k1))
        o9n, o6n = (fn(qn, kn, v1, sc)[0] for fn in (
            flash_attention_online_kernel, flash_attention_kernel))
        gap = (o9n.float() - o6n.float()).abs()
        lim = K9_K6_ULP * float(v1.abs().max()) + ATTN_RTOL * o6n.float().abs()
        print(f"K9 vs K6 on LayerNormed q, k {list(qn.shape)}: max|o| diff "
              f"{float(gap.max()):.3e}, rel RMS {rel_rms(o9n, o6n):.3e} "
              f"(bound 2^-8 max|v| + 2^-7 |o|, max|v| "
              f"{float(v1.abs().max()):.3g})")
        require(bool((gap <= lim).all()), "K9 and K6 differ beyond bf16 "
                "rounding on bounded logits")
        del qn, kn, o9n, o6n, gap, lim
        # ---- K11 against its plain version and against K9
        rh = flash_attention_h2_plain(q1, k1, v1, sc, block_k=WGMMA_BLOCK_K)
        err11 = check_attention(f"K11 vs plain at its {WGMMA_BLOCK_K}-key "
                                f"tile, q, k, v {list(q1.shape)}", h2, None,
                                rh, None)
        e11 = rel_rms(h2, runs["Tk = T"][0])
        print(f"K11 vs K9, {list(q1.shape)}: o rel RMS {e11:.3e} (bound "
              f"{K11_K9_REL_RMS:.3g}), max|o| diff "
              f"{max_abs(h2, runs['Tk = T'][0]):.3e}")
        require(e11 <= K11_K9_REL_RMS, "K11 differs from K9 beyond bound")
        del rh

    # ---- times: kernel, plain version, SDPA, bound
    ms9 = cuda_ms(lambda: flash_attention_online_kernel(q, k, v, sc), 5)
    plain9 = cuda_ms(lambda: flash_attention_online_plain(
        q, k, v, sc, block_k=WGMMA_BLOCK_K), 1, warmup=1)
    with torch.no_grad():
        lib9 = cuda_ms(lambda: sdpa(q, k, v), 5)
    b9 = bound(flops=4.0 * B * H * T * T * D, moved=nbytes(q, k, v, o9, l9))
    results["flash_attention_online"] = dict(
        max_abs_err=err9, ms=ms9, plain_ms=plain9, **b9, library_ms=lib9)
    ms11 = cuda_ms(lambda: flash_attention_h2_kernel(q1, k1, v1, sc), 5)
    plain11 = cuda_ms(lambda: flash_attention_h2_plain(
        q1, k1, v1, sc, block_k=WGMMA_BLOCK_K), 1, warmup=1)
    with torch.no_grad():
        lib11 = cuda_ms(lambda: sdpa(q1, k1, v1), 5)
    b11 = bound(flops=4.0 * H * T * T * D, moved=nbytes(q1, k1, v1, h2))
    results["flash_attention_h2"] = dict(
        max_abs_err=err11, ms=ms11, plain_ms=plain11, **b11,
        library_ms=lib11)
    o1, l21 = flash_attention_online_kernel(q1, k1, v1, sc)
    ms7 = cuda_ms(lambda: flash_attention_backward_kernel(
        q1, k1, v1, o1, l21, do, sc), 3)
    plain7 = cuda_ms(lambda: flash_attention_backward_plain(
        q1, k1, v1, o1, l21, do, sc), 1, warmup=1)
    lib7 = sdpa_backward_ms(q1, k1, v1, do)[0]
    b7 = bound(flops=10.0 * H * T * T * D,
               moved=nbytes(q1, k1, v1, o1, l21, do, q1, k1, v1))
    results["flash_attention_backward_split"] = dict(
        max_abs_err=err7, ms=ms7, plain_ms=plain7, **b7, library_ms=lib7)
    kv, vv = shapes[f"Tk = {Tv} (the video keys)"]
    ov, l2v = flash_attention_online_kernel(q1, kv, vv, sc)
    ms7v = cuda_ms(lambda: flash_attention_backward_kernel(
        q1, kv, vv, ov, l2v, do, sc), 3)
    b7v = bound(flops=10.0 * H * T * Tv * D,
                moved=nbytes(q1, kv, vv, ov, l2v, do, q1, kv, vv))
    for name, ms, plain, lib, bd, what in (
            ("K9 flash_attention_online", ms9, plain9, lib9, b9, q.shape),
            ("K11 flash_attention_h2", ms11, plain11, lib11, b11, q1.shape),
            ("K7 on K9's l2 (K12's split backward)", ms7, plain7, lib7, b7,
             q1.shape)):
        print(f"{name} at {list(what)}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, scaled_dot_product_attention"
              f"{' backward' if 'K7' in name else ''} {lib:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    print(f"K7 on K9's l2 at Tk = {Tv}: kernel {ms7v:.4f} ms, bound "
          f"{b7v['bound_ms']:.4f} ms ({b7v['bound_by']})")
    # K11: one ex2 per score and one per row and key tile for the rescale
    require_no_spill("flash_fwd_wgmma",
                     "K5/K6/K9/K11/K13a/K13b flash_fwd_wgmma", count=5)
    forward_terms("K11 flash_attention_h2", ms11, 1, H, T, T,
                  H * T * (T + -(-T // WGMMA_BLOCK_K)), dev)
    del q, k, v, q1, k1, v1, do, runs, shapes, o9, l9, o1, l21, ov, l2v, h2
    torch.cuda.empty_cache()

    # ---- the ported experiments, through their main
    print(f"langscenex_tpu_torch.experiments.ab_attention, {EXPERIMENT_ITERS} "
          f"iterations:")
    ab_attention.main(iters=EXPERIMENT_ITERS, device=dev)
    print(f"langscenex_tpu_torch.experiments.ab_attention4, "
          f"{EXPERIMENT_ITERS} iterations:")
    ab4 = ab_attention4.main(iters=EXPERIMENT_ITERS, device=dev)
    require(all(math.isfinite(x) for x in ab4.values()),
            "ab_attention4: non-finite result")
    return launches


def phase_k13(dev, results) -> dict:
    """Phase 21, attention-exp2-48x18432x64 and gather-640k-w24: the K13
    probes through their entry points with exact launch counts, then K13a
    and K13b against their plain versions, K9 and each other, K13c
    against index_select, times and the two ported experiments. Returns
    the counted run's launches."""
    gen = torch.Generator(device=dev).manual_seed(7)
    D, sc = 64, 0.125
    Tm, Tf = K13_TOKENS
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qkv = {T: tuple(torch.randn((1, K13_H, T, D), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(3)) for T in K13_TOKENS}
    tabs = {dt: ab_gather2.draws(ab_gather2.P + 8, GATHER_W, GATHER_A, dt,
                                 dev) for dt in (torch.float32,
                                                 torch.bfloat16)}

    # ---- the path, counted: flash_exp2 at both lengths, flash_exp2_bf16
    # where it runs and where it refuses, gather_rows in f32 and bf16
    _build.reset_launch_counts()
    with torch.no_grad():
        path = {T: ab_attention2.flash_exp2(*qkv[T]) for T in K13_TOKENS}
        path_bf16 = ab_attention2.flash_exp2_bf16(*qkv[Tf])
        try:
            ab_attention2.flash_exp2_bf16(*qkv[Tm])
            refused = ""
        except ValueError as e:
            refused = str(e)
        rows = {dt: gather_rows(*tabs[dt]) for dt in tabs}
    torch.cuda.synchronize()
    launches = launches_now()
    want = {"flash_attention_exp2": 2, "flash_attention_exp2_bf16": 1,
            "gather_rows": 2}
    print(f"K13 probes: flash_exp2 at q, k, v [1, {K13_H}, {Tm} and {Tf}, "
          f"{D}], flash_exp2_bf16 at {Tf}, gather_rows of {GATHER_A} rows of "
          f"[{ab_gather2.P + 8}, {GATHER_W}] f32 and bf16: launches "
          f"{launches} (expected {want}); flash_exp2_bf16 at {Tm}: "
          f"{refused or 'ran'}")
    require(bool(refused), f"flash_exp2_bf16 took T = {Tm}, where JAX's grid "
            f"drops keys")
    require(launches == want, "K13 probes: launch counts")

    with torch.inference_mode():
        # ---- K13b's packed exp alone, on every bf16 input of [-126, 0]
        x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                         device=dev).to(torch.int16).view(torch.bfloat16)
        x = x[torch.isfinite(x) & (x <= 0) & (x >= -126)]
        x = x[:x.numel() // 2 * 2]
        got, ref = exp2_bf16x2_kernel(x), exp2_bf16x2_plain(x)
        ulps = (got.view(torch.int16).int() - ref.view(torch.int16).int()
                ).abs()
        print(f"K13b's ex2.approx.ftz.bf16x2 on the {x.numel()} bf16 inputs "
              f"of [-126, 0] against exp2 rounded to bf16: "
              f"{float((ulps > 0).float().mean()):.4%} differ, by at most "
              f"{int(ulps.max())} ulp (bound 1), "
              f"{float((got < ref).float().mean()):.4%} below")
        require(int(ulps.max()) <= 1, "the packed exp is off by more than "
                "one bf16 ulp")
        del x, got, ref, ulps
        # ---- K13a against its plain version, JAX's block and K9
        err_a = 0.0
        for T in K13_TOKENS:
            q, k, v = qkv[T]
            o = flash_attention_exp2_kernel(q, k, v, sc)
            require(torch.equal(o, path[T]), f"K13a T = {T}: the path's "
                    f"output differs from a second launch")
            ro = flash_attention_exp2_plain(q, k, v, sc,
                                            block_k=WGMMA_BLOCK_K)
            err_a = max(err_a, check_attention(
                f"K13a vs plain at its {WGMMA_BLOCK_K}-key tile, q, k, v "
                f"{list(q.shape)}", o, None, ro, None))
            del ro
            rj = flash_attention_exp2_plain(q, k, v, sc)
            print(f"  K13a vs plain at JAX's 1024-key block: max|o| err "
                  f"{max_abs(o, rj):.3e}, o rel RMS {rel_rms(o, rj):.3e}")
            del rj
            o9 = flash_attention_online_kernel(q, k, v, sc)[0]
            check_attention(f"K13a vs K9 (l from p against bf16(p)), "
                            f"{list(q.shape)}", o, None, o9, None)
            del o9
        # ---- K13b against its plain version, JAX's block and K13a
        q, k, v = qkv[Tf]
        ob = flash_attention_exp2_bf16_kernel(q, k, v, sc)
        require(torch.equal(ob, path_bf16), "K13b: the path's output differs "
                "from a second launch")
        rb = flash_attention_exp2_bf16_plain(q, k, v, sc,
                                             block_k=WGMMA_BLOCK_K)
        err_b = check_packed_exp2(ob, rb, v, f"K13b vs plain at its "
                                  f"{WGMMA_BLOCK_K}-key tile, q, k, v "
                                  f"{list(q.shape)}")
        del rb
        rj = flash_attention_exp2_bf16_plain(q, k, v, sc)
        print(f"  K13b vs plain at JAX's 1024-key block: max|o| err "
              f"{max_abs(ob, rj):.3e}, o rel RMS {rel_rms(ob, rj):.3e}")
        del rj
        gap = rel_rms(ob, path[Tf])
        print(f"K13b (packed bf16 exp2) vs K13a (f32 exp2), {list(q.shape)}: "
              f"o rel RMS {gap:.3e} (bound {EXP2_BF16_REL_RMS:.3g}), max|o| "
              f"diff {max_abs(ob, path[Tf]):.3e}")
        require(gap <= EXP2_BF16_REL_RMS, "K13b differs from K13a beyond "
                "bound")
        # ---- K13c bit for bit against index_select
        for dt, (tab, idx) in tabs.items():
            lib = tab.index_select(0, idx)
            bits = torch.int16 if dt == torch.bfloat16 else torch.int32
            same = torch.equal(rows[dt].reshape(GATHER_A, GATHER_W).view(bits),
                               lib.view(bits))
            print(f"K13c gather_rows {str(dt)[6:]} [{GATHER_A}, {GATHER_W}] "
                  f"vs index_select: bit-identical {same}")
            require(same, "K13c differs from index_select")
            del lib

    # ---- times: K9, K13a, K11, K13b in turns at T = 18,432; plain, SDPA,
    # bound
    ms, libs, bounds = {}, {}, {}
    for T in K13_TOKENS:
        q, k, v = qkv[T]
        fns = {"K9": lambda: flash_attention_online_kernel(q, k, v, sc),
               "K13a": lambda: flash_attention_exp2_kernel(q, k, v, sc)}
        order = ("K9", "K13a", "K13a", "K9")
        if T == Tf:
            fns["K11"] = lambda: flash_attention_h2_kernel(q, k, v, sc)
            fns["K13b"] = lambda: flash_attention_exp2_bf16_kernel(q, k, v,
                                                                   sc)
            order = ("K9", "K13a", "K11", "K13b", "K13b", "K11", "K13a",
                     "K9")
        runs = {n: [] for n in fns}
        for n in order:
            runs[n].append(cuda_ms(fns[n], K13_ITERS))
        with torch.no_grad():
            libs[T] = lib = cuda_ms(lambda: sdpa(q, k, v), K13_ITERS)
        bounds[T] = b = bound(flops=4.0 * K13_H * T * T * D,
                              moved=nbytes(q, k, v, path[T]))
        ms[T] = {n: sum(r) / len(r) for n, r in runs.items()}
        print(f"K13 attention at [1, {K13_H}, {T}, {D}] (in turns "
              f"{' '.join(order)}): "
              + ", ".join(f"{n} {' / '.join('%.4f' % x for x in runs[n])} "
                          f"ms" for n in fns)
              + f"; scaled_dot_product_attention {lib:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}, "
              f"{4.0 * K13_H * T * T * D / 1e12:.3f} TFLOP at 989 TFLOP/s)")
    # the four wgmma forwards at one shape: K9, K11 and K13a issue one ex2
    # per score, K13b one packed ex2 per two; all one per row and key tile
    # for the rescale. K13b / K11 says whether the SFU bounds the design,
    # K9 / K13a what l from bf16(p) (and l2) costs over l from p
    rescales = K13_H * Tf * -(-Tf // WGMMA_BLOCK_K)
    ratio = ms[Tf]["K13b"] / ms[Tf]["K11"]
    print(f"wgmma forwards at [1, {K13_H}, {Tf}, {D}]: per-score ratio "
          f"K13b / K11 {ratio:.4f} (under about 0.9: the SFU co-bounds "
          f"them), K9 / K13a {ms[Tf]['K9'] / ms[Tf]['K13a']:.4f}")
    for what, n, exps in (
            ("K9 flash_attention_online", "K9", K13_H * Tf * Tf),
            ("K13a flash_attention_exp2", "K13a", K13_H * Tf * Tf),
            ("K11 flash_attention_h2", "K11", K13_H * Tf * Tf),
            ("K13b flash_attention_exp2_bf16", "K13b", K13_H * Tf * Tf / 2)):
        forward_terms(what, ms[Tf][n], 1, K13_H, Tf, Tf, exps + rescales,
                      dev)
    q, k, v = qkv[Tf]
    plain_a = cuda_ms(lambda: flash_attention_exp2_plain(
        q, k, v, sc, block_k=WGMMA_BLOCK_K), 1, warmup=1)
    plain_b = cuda_ms(lambda: flash_attention_exp2_bf16_plain(
        q, k, v, sc, block_k=WGMMA_BLOCK_K), 1, warmup=1)
    print(f"K13a plain {plain_a:.4f} ms, K13b plain {plain_b:.4f} ms at "
          f"[1, {K13_H}, {Tf}, {D}]; K13b / K13a "
          f"{ms[Tf]['K13b'] / ms[Tf]['K13a']:.4f}, K13a / K9 "
          f"{ms[Tf]['K13a'] / ms[Tf]['K9']:.4f}")
    results["flash_attention_exp2"] = dict(
        max_abs_err=err_a, ms=ms[Tf]["K13a"], plain_ms=plain_a, **bounds[Tf],
        library_ms=libs[Tf])
    results["flash_attention_exp2_bf16"] = dict(
        max_abs_err=err_b, ms=ms[Tf]["K13b"], plain_ms=plain_b, **bounds[Tf],
        library_ms=libs[Tf])

    # ---- K13c: queued behind a spin (device time) and paced by the host
    for dt, (tab, idx) in tabs.items():
        out = rows[dt]
        for A in (GATHER_A, GATHER_SHORT_A):
            ii = idx[:A]
            dev_ms = time_ms(lambda: gather_rows_kernel(tab, ii),
                             GATHER_ITERS, dev, queued=True)
            host_ms = time_ms(lambda: gather_rows_kernel(tab, ii),
                              GATHER_ITERS, dev)
            lib = time_ms(lambda: tab.index_select(0, ii), GATHER_ITERS, dev,
                          queued=True)
            moved = nbytes(out[:A // 512], ii, tab)
            b = bound(moved=moved)
            print(f"K13c gather_rows {str(dt)[6:]} A={A} W={GATHER_W}: "
                  f"queued {dev_ms * 1e3:.3f} us, host-paced "
                  f"{host_ms * 1e3:.3f} us, index_select queued "
                  f"{lib * 1e3:.3f} us, bound {b['bound_ms'] * 1e3:.3f} us "
                  f"({b['bound_by']}, {moved / 1e6:.2f} MB at 3.35 TB/s)")
            if A == GATHER_A and dt == torch.float32:
                plain = time_ms(lambda: gather_rows_plain(tab, idx), 20, dev)
                results["gather_rows"] = dict(
                    max_abs_err=0.0, ms=dev_ms, plain_ms=plain, **b,
                    library_ms=lib)
                print(f"  plain version (f32) {plain * 1e3:.3f} us")
    del qkv, path, path_bf16, rows, tabs
    torch.cuda.empty_cache()

    # ---- the ported experiments, through their main
    print(f"langscenex_tpu_torch.experiments.ab_attention2, "
          f"{EXPERIMENT_ITERS} iterations:")
    ab2 = ab_attention2.main(iters=EXPERIMENT_ITERS, device=dev)
    print("langscenex_tpu_torch.experiments.ab_gather2:")
    abg = ab_gather2.main(device=dev)
    require(all(math.isfinite(x) and x > 0 for x in [*ab2.values(),
                                                    *abg.values()]),
            "K13 experiments: a time is not finite")
    return launches


def knn_room(dev, seed: int):
    """The field cell's room for K14: KNN_POINTS points on four walls (wall
    = slot mod 4, so the walls interleave), the rest of the KNN_N slots
    dead at the origin, and KNN_S distinct sampled slots."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = KNN_POINTS
    wall = torch.arange(n, device=dev) % 4
    u = torch.rand(n, generator=g, device=dev) * 3.6 - 1.8
    v = torch.rand(n, generator=g, device=dev) * 2.0 - 1.0
    depth = 1.8 + 0.08 * torch.sin(2.5 * u + wall) * torch.cos(3.0 * v)
    ang = wall * (math.pi / 2)
    xyz = torch.zeros((KNN_N, 3), device=dev)
    xyz[:n, 0] = u * torch.cos(ang) + depth * torch.sin(ang)
    xyz[:n, 1] = v
    xyz[:n, 2] = depth * torch.cos(ang) - u * torch.sin(ang)
    idx = torch.randperm(KNN_N, generator=g, device=dev)[:KNN_S]
    return xyz, idx


def knn_plain(sf, sq_s, xyz, sq_f, k: int):
    """The plain version's d2 [S, N] and slots [S, k] (ops/losses)."""
    with exact_f32():
        d2 = sq_s[:, None] + sq_f[None, :] - 2.0 * (sf @ xyz.T)
    return d2, _knn_smallest(d2, k)


def phase_knn(dev, results) -> None:
    """Phase 30, K14 at field-sem-720x480's shape: its slots and d2 against
    the plain version's on KNN_SEEDS rooms, loss_cls_3d's launch, syncs and
    memory on the card, times beside the bound and the library yardstick,
    resources."""
    S, N, k = KNN_S, KNN_N, KNN_K
    for seed in KNN_SEEDS:
        xyz, idx = knn_room(dev, seed)
        sf = xyz[idx]
        sq_s, sq_f = (sf ** 2).sum(-1), (xyz ** 2).sum(-1)
        before = profiling.counters.get("knn.tie_rows", 0)
        d2, ref = knn_plain(sf, sq_s, xyz, sq_f, k)
        tied = profiling.counters["knn.tie_rows"] - before
        vals, cols = knn_select(sf, sq_s, xyz, sq_f, k)
        torch.cuda.synchronize()
        rows_same = (cols.sort(1).values == ref.sort(1).values).all(1)
        same_d2 = torch.equal(vals.view(torch.int32),
                              d2.gather(1, cols).view(torch.int32))
        # topk orders equal values inside the k by an unstable sort; K14
        # (and lax.top_k) by slot
        reordered = int(((cols != ref).any(1) & rows_same).sum())
        print(f"K14 knn_select seed {seed}: [{S}] x {N}, k = {k}, {tied} "
              f"tied rows (the plain version's stable sort): rows "
              f"with other slots {int((~rows_same).sum())}, with the same "
              f"slots in another order {reordered}; d2 at the slots "
              f"bit-identical {same_d2}")
        require(bool(rows_same.all()) and same_d2,
                "K14 selects other slots than the plain version")
        del d2, ref
        torch.cuda.empty_cache()

    # ---- the loss on the card: one launch, no sync, no [S, N] tensor
    g = torch.Generator(device=dev).manual_seed(11)
    preds = torch.rand((N, 3), generator=g, device=dev)
    loss_cls_3d(idx, xyz, preds, k, 4.0)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = loss_cls_3d(idx, xyz, preds, k, 4.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = launches_now()
    grown = torch.cuda.max_memory_allocated() - base
    print(f"loss_cls_3d on the card: loss {float(loss):.6f}, launches "
          f"{launches}, peak above its inputs {grown / 2 ** 20:.1f} MiB (the "
          f"[S, N] d2 is {S * N * 4 / 2 ** 30:.2f} GiB)")
    require(launches == {"knn_select": 1}, "loss_cls_3d: launch counts")
    require(grown < S * N * 4 // 10, "loss_cls_3d allocates an [S, N] tensor")

    # ---- times: K14, the plain version, cdist + topk; the bound
    ms = cuda_ms(lambda: knn_select(sf, sq_s, xyz, sq_f, k), KNN_ITERS)
    plain = cuda_ms(lambda: knn_plain(sf, sq_s, xyz, sq_f, k),
                    KNN_PLAIN_ITERS, warmup=1)
    lib = cuda_ms(lambda: torch.topk(torch.cdist(sf, xyz), k, dim=1,
                                     largest=False), KNN_PLAIN_ITERS,
                  warmup=1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_mhz()
    issue_ms = S * N * KNN_ISSUE / (sms * FP32_LANES_PER_SM * clock * 1e6) \
        * 1e3
    b = bound(moved=nbytes(sf, sq_s, xyz, sq_f, vals, cols))
    print(f"K14 knn_select [{S}] x {N}, k = {k}: {ms:.4f} ms, plain version "
          f"{plain:.4f} ms, torch.cdist + torch.topk {lib:.4f} ms; bound "
          f"{issue_ms:.4f} ms (FP32 issue: {S * N:.3e} pairs x {KNN_ISSUE} "
          f"on {sms} SMs x {FP32_LANES_PER_SM} lanes at {clock:.0f} MHz; "
          f"bytes {b['bound_ms']:.4f} ms), {issue_ms / ms:.1%} of it")
    require_no_spill("knn_select", "K14 knn_select", count=33)
    results["knn_select"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=issue_ms,
        bound_by="FP32 issue", library_ms=lib)
    del xyz, sf, preds
    torch.cuda.empty_cache()


def room_binning(dev, view: int, seed: int = BIN_SEED):
    """field-sem-720x480's binning inputs: the benchmark's room (its
    configuration's 1.5M splats in 2^21 slots, dead ones at zero opacity)
    from camera ``view`` of its arc, with the default raster config's
    tiles and conic cull: (ProcessedSplats, CullSpec, grid_x, grid_y)."""
    from benchmark.inputs import room
    cfg = json.loads(open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "benchmark", "configs",
        "lsgs-field-1p5m-720x480.json")).read())
    sc = room.scene(cfg, seed, dev)
    W_, H_, fx, fy = cfg["width"], cfg["height"], cfg["fovx"], room.fovy(cfg)
    cam = raster_camera_from_numpy(
        room.w2c(*room.arc_poses(cfg)[view]),
        projection_matrix(0.01, 100.0, fx, fy), W_, H_, math.tan(fx / 2),
        math.tan(fy / 2), dev)
    quats = sc["rotation"] / torch.linalg.norm(sc["rotation"], dim=-1,
                                               keepdim=True)
    opac = torch.sigmoid(sc["opacity"][:, 0]) * sc["alive"]
    tile = RasterConfig().tile_w
    proc = preprocess(sc["xyz"], torch.exp(sc["scaling"]), quats, cam,
                      tile_w=tile, tile_h=tile, opacity=opac,
                      colors_precomp=torch.zeros_like(sc["xyz"]))
    op = torch.where(proc.visible, opac, 0.0)
    qmax = 2.0 * torch.log(torch.clamp(255.0 * op, min=1e-12)) + 0.05
    cull = binning.CullSpec(mean2d=proc.mean2d, conic=proc.conic, qmax=qmax,
                            tile_w=tile, tile_h=tile)
    return proc, cull, -(-W_ // tile), -(-H_ // tile)


def phase_bin_pairs(dev, results) -> None:
    """Phase 31, K15 at field-sem-720x480's shape: build_tile_lists through
    K15 + K4 against the plain path from BIN_VIEWS cameras, its launches,
    syncs and fallback counter, times beside the bound and the path it
    replaces, resources."""
    rc = RasterConfig()
    kw = dict(max_pairs=rc.max_pairs, big_splats=rc.big_splats,
              extra_tiers=rc.extra_tiers, rank_key=rc.rank_key_sort)
    for view in BIN_VIEWS:
        proc, cull, gx, gy = room_binning(dev, view)
        args = (proc, gx, gy, rc.max_tiles_per_splat)
        binning.build_tile_lists(*args, cull=cull, **kw)   # builds, warms
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        before = profiling.counters.get("bin.broadcast", 0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = binning.build_tile_lists(*args, cull=cull, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = launches_now()
        fallback = profiling.counters.get("bin.broadcast", 0) - before
        with _build.plain():
            ref = binning.build_tile_lists(*args, cull=cull, **kw)
        n_live = int((proc.tiles_touched > 0).sum())
        print(f"K15 bin_pairs view {view}: {proc.depth.shape[0]} slots, "
              f"{n_live} touch a tile, {int(ref.num_pairs)} pairs; lists "
              f"bit-identical {same_lists(got, ref)}; launches {launches}, "
              f"broadcast fallbacks {fallback}")
        require(same_lists(got, ref), "K15 + K4 differ from the plain path")
        require(launches.get("bin_pairs") == 1 and "compact_pairs" not in
                launches and fallback == 0, "build_tile_lists: launches")

    # ---- times on the last view at the cap the trainer settles on (1.5x
    # the demand, a multiple of 128): K15 alone, what it replaces, binning
    cap = (max(int(1.5 * int(ref.num_pairs)), 1 << 16) + 127) // 128 * 128
    kw["max_pairs"] = cap
    n_tiles = gx * gy
    P = proc.depth.shape[0]
    K1, K2, B, budget = binning._sizes(P, n_tiles, rc.max_tiles_per_splat,
                                       cap, rc.big_splats)
    tiers = binning._tiers(P, K1, K2, B, n_tiles, rc.extra_tiers)
    specs = [t for t in tiers if t[0] > 0]
    A = P * K1 + sum(b * k for b, _, k in specs)
    out_len = min(cap, A)
    tt = proc.tiles_touched
    sid_base = torch.arange(P, dtype=torch.int32, device=dev)
    rank = binning._rank_of_id(tt, proc.depth, sid_base, sort_pairs)
    top = torch.sort(-tt, stable=True) if specs else None
    k15 = (proc, rank, cull, specs, top, K1, gx, n_tiles, budget, out_len)
    ms = time_ms(lambda: binning._emit_pairs(*k15), BIN_ITERS, dev,
                 queued=True)
    sent = n_tiles << 22

    def broadcast():
        ps = enumerate_pairs(*args, cull=cull, **kw)
        return compact_pairs(ps.key, ps.sid, sent, ps.out_len, sent, P)
    plain_ms = cuda_ms(broadcast, BIN_PLAIN_ITERS, warmup=1)
    lists_ms = cuda_ms(lambda: binning.build_tile_lists(*args, cull=cull,
                                                       **kw), BIN_ITERS)

    def lists_broadcast():
        c = broadcast()
        key, pl = sort_pairs(*c)
        return pl, binning._tile_ranges(key >> 22, n_tiles)
    lists_plain_ms = cuda_ms(lists_broadcast, BIN_PLAIN_ITERS, warmup=1)
    n_live = int((tt > 0).sum())
    moved = 4 * P + BIN_SPLAT_BYTES * n_live + 8 * out_len
    bound_ms = moved / PEAK_HBM_BYTES * 1e3
    print(f"K15 bin_pairs [{P}] splats ({n_live} touch a tile) -> "
          f"{out_len} slots (max_pairs {cap}): {ms:.4f} ms on the device "
          f"(queued); the broadcast enumeration + K3 it replaces "
          f"{plain_ms:.4f} ms (with the depth "
          f"rank); the whole binning {lists_ms:.4f} ms (K15 + K4), "
          f"{lists_plain_ms:.4f} ms (broadcast + K3 + K4); bound "
          f"{bound_ms:.4f} ms (bytes: tiles touched {4 * P}, touching "
          f"splats {BIN_SPLAT_BYTES * n_live}, stream {8 * out_len}), "
          f"{bound_ms / ms:.1%} of it")
    require_no_spill("bin_pairs", "K15 bin_pairs", count=2)
    results["bin_pairs"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", lists_ms=lists_ms, lists_plain_ms=lists_plain_ms)
    del proc, cull, rank, top, k15
    torch.cuda.empty_cache()


def call_recorder(denoiser, on_call):
    """``denoiser`` that hands every call's inputs and output to
    ``on_call(lat, txt, t, out)``."""
    def run(lat, txt, t):
        out = denoiser(lat, txt, t)
        on_call(lat, txt, t, out)
        return out
    return run


def tp_request_reference(pipe, model_in, txt) -> dict:
    """The single-process outputs the TP request is held against: the
    2-step DDIM loop from phase 9's DiT inputs, every DiT call of the CFG
    pair recorded with its inputs (the first at t = 999), on the host."""
    C = pipe.cfg.latent_channels
    noise, img = model_in[:1, :, :C].float(), model_in[:1, :, C:].float()
    host = lambda t: t.float().cpu().numpy()      # noqa: E731
    calls = []
    with torch.inference_mode():
        lat = denoise_loop(call_recorder(
            pipe.denoiser_fn, lambda lat, txt, t, out: calls.append(dict(
                lat=host(lat), t=t.cpu().numpy(), out=out.float().cpu()))),
            noise, img, txt[1:], txt[:1], pipe.scheduler, pipe.cfg)
    torch.cuda.synchronize()
    return dict(loop=(host(noise), host(img), host(txt[1:]), host(txt[:1])),
                calls=calls, latents=lat.float().cpu())


def tp_rank(rank, world, store, dev, req, lora_in):
    """One rank of phases 18 and 19 on ``dev``, the card all ranks share
    (spawned; gloo mesh (data=1, model=2)): its shard of the seed-42 DiT,
    the TP request and the TP LoRA steps. Returns outputs on the host,
    launches, times and peak memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = rank_mesh(rank, world, store, 1, world, device=dev,
                     backend="gloo")
    bf = torch.bfloat16
    t0 = time.perf_counter()
    dit = materialize_sharded_dit(TransformerConfig(remat=True), mesh, bf,
                                  torch.Generator(device=dev).manual_seed(42))
    torch.cuda.synchronize()
    res = dict(build_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in dit.parameters()))
    apply = dit_sharded_apply(dit, mesh)

    def counted(fn):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            k: v for k, v in _build.launch_counts.items() if v}

    # ---- 18. the TP request -------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    loop = [torch.from_numpy(a).to(dev) for a in req["loop"]]
    step_s, clock = [], [0.0]

    def step_done(i, t, evaluated, latents):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now

    calls = []

    def on_call(lat, txt, t, out):
        torch.cuda.synchronize()
        calls.append(dict(t=t.cpu().numpy(), out=out.float().cpu()))
        if len(calls) == 1:
            # the loop starts with the DiT call: the counts so far are its own
            res.update(call_launches={
                k: v for k, v in _build.launch_counts.items() if v},
                call_ms=(time.perf_counter() - clock[0]) * 1e3)

    def tp_call(lat, txt, t):
        return apply(lat.to(bf), txt.to(bf), t)

    def run_loop():
        clock[0] = time.perf_counter()
        return denoise_loop(call_recorder(tp_call, on_call), *loop,
                            DDIMScheduler(),
                            PipelineConfig(num_inference_steps=DIT_STEPS),
                            step_done)
    with torch.inference_mode():
        lat, _, res["loop_launches"] = counted(run_loop)
        # the later calls again on the single process's inputs of each
        text = torch.cat([loop[3], loop[2]])
        for c, ref in zip(calls[1:], req["calls"][1:]):
            c["forced"] = tp_call(
                torch.from_numpy(ref["lat"]).to(dev), text,
                torch.from_numpy(ref["t"]).to(dev)).float().cpu()
    res.update(latents=lat.float().cpu(), calls=calls,
               step_ms=[t * 1e3 for t in step_s],
               request_peak=torch.cuda.max_memory_allocated(dev))
    del lat, loop

    # ---- 19. the TP LoRA step -----------------------------------------
    batch = ft_batch(dev, dit.cfg.text_embed_dim, bf)
    lcfg = LoRAConfig(rank=16)
    blocks = dit.transformer_blocks
    dit.transformer_blocks = blocks[:2]
    try:
        ad = shard_lora({s: {k: torch.from_numpy(v).to(dev)
                             for k, v in ab.items()}
                         for s, ab in lora_in["adapters"].items()},
                        mesh.model_rank, mesh.n_model)
        t = torch.from_numpy(lora_in["t"]).to(dev)
        noise = torch.from_numpy(lora_in["noise"]).to(dev, bf)
        tables = _sched_tables(LORA_TRAIN, dev)
        dit.requires_grad_(False)
        (loss, grads), _, launches = counted(
            lambda: lora_loss_and_grads(dit, ad, lcfg, batch, t, noise,
                                        tables))
        # the whole adapter factors' partial gradients summed over model
        reduce_gradients_({f"{s}/{k}": g for s, ab in grads.items()
                           for k, g in ab.items()},
                          {f"{s}/{k}": lora_kind(s, k) for s, ab in
                           grads.items() for k in ab}, dit.tp, None)
        want = {"flash_attention_bhtd": 4, "flash_attention_backward": 2,
                "ln_modulate": 8}
        require(launches == want, f"rank {rank}: 2-block TP LoRA launches "
                f"{launches}, expected {want}")
    finally:
        dit.transformer_blocks = blocks
    res.update(lora2_loss=float(loss),
               lora2_grads={s: {k: v.float().cpu() for k, v in ab.items()}
                            for s, ab in grads.items()})
    del ad, grads
    init_state, step = make_lora_train_step(dit, LORA_TRAIN, lcfg)
    state = init_state(torch.Generator(device=dev).manual_seed(1))
    n_layers = len(dit.transformer_blocks)
    per_step = {"flash_attention_bhtd": 2 * n_layers,
                "flash_attention_backward": n_layers,
                "ln_modulate": 4 * n_layers}
    res["lora_steps"] = run_steps(
        dev, step, state, batch, TP_LORA_STEPS,
        torch.Generator(device=dev).manual_seed(2), per_step,
        f"TP LoRA rank {rank} ({TP_NOTE})")
    return res


def phase_tp(dev, req: dict, lora_ref: dict, lora_losses: list) -> dict:
    """Phases 18 and 19: two ranks on cuda:0 over gloo, held against the
    single-process outputs. Returns rank 0's K6 launches over the TP
    request's loop."""
    t0 = time.perf_counter()
    ranks = spawn(tp_rank, TP_RANKS,
                  (dev, {"loop": req["loop"], "calls": [
                      {k: c[k] for k in ("lat", "t")} for c in req["calls"]]},
                   {k: lora_ref[k] for k in ("adapters", "t", "noise")}),
                  timeout=TP_TIMEOUT)
    print(f"TP phases 18-19: {TP_RANKS} ranks on "
          f"{torch.cuda.get_device_name(0)} over gloo, spawn to join "
          f"{time.perf_counter() - t0:.1f} s ({TP_NOTE})")
    per_call = {"flash_attention_bhtd": 42, "ln_modulate": 84}
    for r, res in enumerate(ranks):
        print(f"rank {r}: shard of {res['params'] / 1e9:.3f}B parameters built "
              f"in {res['build_s']:.2f} s; DiT call {res['call_ms']:.1f} ms, "
              f"launches {res['call_launches']}; denoise steps "
              f"{ms_list([t / 1e3 for t in res['step_ms']])} ms, launches "
              f"{res['loop_launches']}; request peak allocated "
              f"{res['request_peak'] / 2 ** 30:.3f} GiB ({TP_NOTE})")
        require(res["call_launches"] == per_call, f"rank {r}: TP DiT call "
                f"launches {res['call_launches']}, expected {per_call}")
        loop_want = {k: DIT_STEPS * v for k, v in per_call.items()}
        require(res["loop_launches"] == loop_want, f"rank {r}: TP loop "
                f"launches {res['loop_launches']}, expected {loop_want}")
    calls, refs = ranks[0]["calls"], req["calls"]
    require(len(calls) == len(refs) == DIT_STEPS, f"TP loop made "
            f"{len(calls)} DiT calls, the single process {len(refs)}, "
            f"expected {DIT_STEPS}")
    g = PipelineConfig().guidance_scale
    for i, (c, ref) in enumerate(zip(calls, refs)):
        out = c["forced"] if i else c["out"]
        e = rel_rms(out, ref["out"])
        guided = [o[:1] + g * (o[1:] - o[:1]) for o in (c["out"],
                                                        ref["out"])]
        where = " on the single process's inputs" if i else ""
        print(f"TP request vs single process: DiT call {i + 1} "
              f"{list(ref['out'].shape)} at t = {c['t'].tolist()}{where} "
              f"rel RMS {e:.3e} (bound {DIT_REL_RMS:g}), max abs "
              f"{max_abs(out, ref['out']):.3e}; in the loop, its guided "
              f"prediction rel RMS {rel_rms(*guided):.3e}")
        require(np.array_equal(c["t"], ref["t"]), f"TP DiT call {i + 1} "
                f"at t {c['t'].tolist()}, the single process at "
                f"{ref['t'].tolist()}")
        require(bool(torch.isfinite(c["out"]).all()),
                f"TP DiT call {i + 1}: non-finite output")
        require(e <= DIT_REL_RMS, f"TP DiT call {i + 1} differs from the "
                f"single process beyond the bound")
    e_loop = rel_rms(ranks[0]["latents"], req["latents"])
    same = all(all(torch.equal(a["out"], b["out"])
                   for a, b in zip(res["calls"], calls))
               and torch.equal(res["latents"], ranks[0]["latents"])
               for res in ranks)
    print(f"TP request vs single process: latents after {DIT_STEPS} DDIM "
          f"steps rel RMS {e_loop:.3e} (bound {TP_LATENTS_REL_RMS:g}); "
          f"ranks' outputs identical {same}")
    require(same, "TP request: the ranks' outputs differ")
    require(e_loop <= TP_LATENTS_REL_RMS, "TP latents differ from the "
            "single process beyond the bound")
    # ---- 19 -----------------------------------------------------------
    got = gather_lora([res["lora2_grads"] for res in ranks])
    worst = max((rel_rms(got[s][x], lora_ref["grads"][s][x]), f"{s}/{x}")
                for s in got for x in got[s])
    lk, lr = ranks[0]["lora2_loss"], lora_ref["loss"]
    print(f"TP LoRA on 2 blocks vs single process: loss {lk:.6f} vs "
          f"{lr:.6f}; {len(got)} adapters gathered, worst gradient rel RMS "
          f"{worst[0]:.3e} at {worst[1]} (bound {LORA2_GRAD_REL_RMS:g})")
    require(abs(lk - lr) <= LORA2_LOSS_RTOL * abs(lr),
            "TP LoRA 2-block loss differs from the single process")
    require(worst[0] <= LORA2_GRAD_REL_RMS,
            "TP LoRA adapter gradients differ from the single process")
    for r, res in enumerate(ranks):
        recs = res["lora_steps"]
        print(f"rank {r}: TP LoRA steps {' '.join('%.1f' % x['ms'] for x in recs)}"
              f" ms, losses {' '.join('%.6f' % x['loss'] for x in recs)} "
              f"(single process {' '.join('%.6f' % x for x in lora_losses[:len(recs)])}),"
              f" peak allocated {max(x['peak'] for x in recs) / 2 ** 30:.3f} GiB "
              f"({TP_NOTE})")
        for x, ref in zip(recs, lora_losses):
            require(abs(x["loss"] - ref) <= LORA2_LOSS_RTOL * abs(ref),
                    f"rank {r}: TP LoRA loss {x['loss']} differs from the "
                    f"single process's {ref}")
    return dict(launches=ranks[0]["loop_launches"]["flash_attention_bhtd"])


# ---- 22. the field stage through its CLI, field-e2e-200k-720x480 ---------

E2E_ITERS = 30
E2E_SAVE = (10, 30)
E2E_RESUME_TO = 20
E2E_POSE_ITERS = 20
E2E_WALL = 1.8            # the room's walls at x, z = +-1.8
E2E_RELIEF = 0.08         # each wall's relief, +-
E2E_CAM_R = 0.1           # each camera 0.1 from the centre, facing its wall
E2E_MIN_FACES = 100_000   # the walls' mesh, so meshing runs at a real size
MESHES = ("mesh.ply", "mesh_post.ply", "feature_mesh.ply",
          "feature_mesh_post.ply")
EVAL_DIRS = ("renders_rgb", "renders_depth", "renders_depth_npy",
             "renders_normal", "renders_lang", "renders_instance",
             "renders_lang_npy", "renders_instance_npy")


def e2e_cameras() -> list[Camera]:
    """Four views from near a room's centre, one facing each wall (yaws 0,
    90, 180 and 270 degrees about y), each E2E_CAM_R towards its wall."""
    fovy = focal2fov(fov2focal(FOVX, W), H)
    cams = []
    for i in range(4):
        R = _rot(1, 90.0 * i)                    # camera to world
        centre = E2E_CAM_R * R[:, 2]
        cams.append(Camera(uid=i, colmap_id=i, R=R, T=-R.T @ centre,
                           fovx=FOVX, fovy=fovy, width=W, height=H,
                           image_name=f"{i + 1:04d}"))
    return cams


def e2e_room(n: int):
    """n seeded points on the four walls of a room around the cameras, each
    with a smooth relief, as scene arrays (see ``scene``) plus RGB colours;
    the instance feature's first channel is the wall's, so each wall is
    one segment."""
    rng = np.random.default_rng(1)
    wall = np.arange(n) % 4
    u = rng.uniform(-E2E_WALL, E2E_WALL, n)
    v = rng.uniform(-1.0, 1.0, n)
    depth = E2E_WALL + E2E_RELIEF * np.sin(2.5 * u + wall) * np.cos(3.0 * v)
    R = np.stack([_rot(1, 90.0 * k) for k in range(4)])[wall]
    means = (u[:, None] * R[:, :, 0] + v[:, None] * R[:, :, 1]
             + depth[:, None] * R[:, :, 2]).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(-5.0, -4.0, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = (cols - 0.5) / 0.28209479177387814      # RGB -> SH DC
    lang = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    inst = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    inst[:, 0] = (wall - 1.5) / 2.0
    return (means, scales, quats, opac, shs, lang, inst), cols


def write_e2e_scene(dev, root: str) -> None:
    """A CUT3R-contract scene of the room: input/000N.png (the port's
    renders of the room's splats, one per camera of ``e2e_cameras``),
    camera/000N.npz (c2w and K), points3D.ply with the FIELD_P points and
    their colours, and lang_features_dim3/000N_{f,s}.npy (the rendered
    language map and the segments, as phase 6 makes them)."""
    for d in ("input", "camera", "lang_features_dim3"):
        os.makedirs(os.path.join(root, d))
    arrays, cols = e2e_room(FIELD_P)
    st = gaussian_state(arrays)
    splats = dataclasses.replace(st, **{
        f.name: getattr(st, f.name).to(dev) for f in dataclasses.fields(st)})
    cams = e2e_cameras()
    for cam, (_, m) in zip(cams, render_all_views(splats, cams, EXACT_CFG,
                                                  sh_degree=3)):
        require(not bool(m["pairs_overflowed"]) and not
                bool(m["k_overflowed"]), "room render: overflow flag")
        require(float(m["alpha"].min()) > 0.5, "room render: a pixel with "
                "no wall behind it")
        name = cam.image_name
        write_png(os.path.join(root, "input", name + ".png"),
                  (m["render"].clamp(0, 1).permute(1, 2, 0) * 255)
                  .to(torch.uint8).cpu().numpy())
        K = np.array([[cam.fx, 0, W / 2], [0, cam.fy, H / 2], [0, 0, 1]])
        np.savez(os.path.join(root, "camera", name + ".npz"),
                 pose=np.linalg.inv(cam.w2c), intrinsics=K)
        np.save(os.path.join(root, "lang_features_dim3", name + "_f.npy"),
                m["language_feature"].cpu().numpy())
        np.save(os.path.join(root, "lang_features_dim3", name + "_s.npy"),
                segments(m))
    write_ply_points(os.path.join(root, "points3D.ply"), arrays[0], cols)


@contextlib.contextmanager
def recorded_training():
    """Record every trainer iteration inside the block: (iteration, seconds
    since the previous one, metrics, launch counts after it)."""
    recs = []
    train = GaussianFieldTrainer.train

    def recorded(self, *args, **kw):
        clock = [time.perf_counter()]

        def cb(it, state, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            recs.append((it, now - clock[0],
                         {k: float(v) for k, v in metrics.items()},
                         dict(_build.launch_counts)))
            clock[0] = now
        kw["callback"] = cb
        return train(self, *args, **kw)
    GaussianFieldTrainer.train = recorded
    try:
        yield recs
    finally:
        GaussianFieldTrainer.train = train


@contextlib.contextmanager
def recorded_renders():
    """Record every render_view call of the render and eval modes inside
    the block: (time at its start after a synchronise, launch counts at
    its start, the output's overflow flags)."""
    recs = []
    inner = render_mode.render_view

    def record(*args, **kw):
        torch.cuda.synchronize()
        start = (time.perf_counter(), dict(_build.launch_counts))
        out = inner(*args, **kw)
        recs.append(start + (bool(out.pairs_overflowed),
                             bool(out.k_overflowed)))
        return out
    render_mode.render_view = record
    try:
        yield recs
    finally:
        render_mode.render_view = inner


def launch_delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in RENDER_TRAIN_KERNELS}


def require_pngs(root: str, shapes: dict) -> int:
    """Decode every PNG under root; a file whose name ends with a key of
    ``shapes`` must have that shape. Returns the count."""
    n = 0
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".png"):
                continue
            img = read_png(os.path.join(d, f))
            for suffix, shape in shapes.items():
                if os.path.join(d, f).endswith(suffix):
                    require(img.shape == shape, f"{f}: shape {img.shape}, "
                            f"expected {shape}")
            n += 1
    return n


def run_mode(argv: list, what: str):
    """One CLI call with the launch counts reset before it: (pipeline,
    seconds, launches)."""
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = entry_point.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    print(f"field-e2e {what}: {dt:.3f} s, launches "
          f"{ {k: launches[k] for k in RENDER_TRAIN_KERNELS} }")
    need = RENDER_TRAIN_KERNELS if what != "render" else (
        "sort_pairs", "bin_pairs", "blend_forward")
    for k in need:
        require(launches[k] > 0, f"{what}: kernel {k} was not launched")
    return pipe, dt, launches


def phase_field_e2e(dev) -> dict:
    """field-e2e-200k-720x480: the field stage through entry_point on the
    card, with PIL blocked. scipy (the mesh clean-up's clustering) is
    imported first, so the clean-up's time leaves its import out."""
    import scipy.sparse.csgraph  # noqa: F401
    had_pil = "PIL" in sys.modules
    saved_pil = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        with tempfile.TemporaryDirectory() as root:
            write_e2e_scene(dev, root)
            return _field_e2e(root)
    finally:
        if had_pil:
            sys.modules["PIL"] = saved_pil
        else:
            sys.modules.pop("PIL", None)


def _field_e2e(root: str) -> dict:
    out = os.path.join(root, "output")
    common = [f"pipeline.data_path={root}", "pipeline.skip_video_process=true",
              "pipeline.skip_pose_estimate=true",
              "pipeline.skip_lang_feature_extraction=true",
              f"gaussian.render.load_iteration={E2E_ITERS}",
              f"gaussian.render.pose_optim_iter={E2E_POSE_ITERS}"]
    save = ",".join(str(i) for i in E2E_SAVE)

    # train, with outputs
    with recorded_training() as recs:
        pipe, train_s, train_l = run_mode(
            ["mode=train", f"gaussian.opt.iterations={E2E_ITERS}",
             f"gaussian.save_iterations={save}",
             "gaussian.checkpoint_iterations=10",
             f"gaussian.test_iterations={E2E_ITERS}"] + common, "train")
    tr = pipe.trainer
    require([r[0] for r in recs] == list(range(1, E2E_ITERS + 1)),
            "train: iterations")
    for it, _, m, _ in recs:
        require(m["pair_overflow"] == 0.0 and m["k_overflow"] == 0.0,
                f"train {it}: overflow flag")
        require(math.isfinite(m["total"]), f"train {it}: non-finite loss")
    plain_ms = [dt * 1e3 for it, dt, _, _ in recs
                if 1 < it and it not in E2E_SAVE]
    out_ms = {it: dt * 1e3 for it, dt, _, _ in recs if it in E2E_SAVE}
    per_it = launch_delta(recs[3][3], recs[4][3])
    print(f"field-e2e train: {len(recs)} iterations, ms/iteration without "
          f"outputs median {np.median(plain_ms):.2f} (min "
          f"{min(plain_ms):.2f}, max {max(plain_ms):.2f}), with outputs "
          + ", ".join(f"{it}: {ms:.2f}" for it, ms in out_ms.items())
          + f" (snapshot; 30 also the report), first {recs[0][1] * 1e3:.2f}"
          f"; launches per iteration {per_it}; loss "
          f"{recs[0][2]['total']:.5f} -> {recs[-1][2]['total']:.5f}")
    t0 = time.perf_counter()
    tr.debug_collage(E2E_ITERS, 0, out)
    torch.cuda.synchronize()
    print(f"field-e2e debug collage: {(time.perf_counter() - t0) * 1e3:.2f}"
          f" ms")
    for it in E2E_SAVE:
        for f in (f"point_cloud/iteration_{it}/point_cloud.ply",
                  f"pose/iter_{it}/pose_org.npy",
                  f"pose/iter_{it}/pose_optimized.npy"):
            require(os.path.isfile(os.path.join(out, f)), f"train: no {f}")
    require(os.path.isfile(os.path.join(out, "chkpnt10")), "no chkpnt10")
    # the report renders cameras 1, 2, 3, 0, 1: four files
    valid = os.listdir(os.path.join(out, "valid"))
    require(sorted(valid) == [f"{E2E_ITERS}_{i}.png" for i in range(4)],
            f"train: the report's PNGs {valid}")
    require(len(os.listdir(os.path.join(root, "render_camera"))) == 4,
            "train: render_camera/")
    collage = os.listdir(os.path.join(out, "debug"))
    require(len(collage) == 1 and collage[0].startswith(f"{E2E_ITERS:05d}_"),
            f"train: the collage {collage}")
    n_png = require_pngs(out, {f"{E2E_ITERS}_0.png": (H, 2 * W, 3),
                               collage[0]: (2 * H, 4 * W, 3)})
    ply = load_ply(os.path.join(out, f"point_cloud/iteration_{E2E_ITERS}/"
                                "point_cloud.ply"), 3,
                   capacity=tr.state.splats.capacity, device=tr.device)
    s, alive = tr.state.splats, tr.state.splats.alive
    n_alive = int(alive.sum())
    require(int(ply.alive.sum()) == n_alive, "PLY: alive count")
    for f in ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation", "language_feature", "instance_feature"):
        require(torch.equal(getattr(ply, f)[:n_alive], getattr(s, f)[alive]),
                f"PLY at {E2E_ITERS}: {f} differs from the trained state")
    print(f"field-e2e train artifacts: {n_png} PNGs decoded, PLY at "
          f"{E2E_ITERS} ({n_alive} splats) equal to the trained state")
    del pipe, tr, s, alive, ply

    # resume from the iteration-10 checkpoint to 20
    with recorded_training() as recs:
        _, resume_s, _ = run_mode(
            ["mode=train", f"gaussian.opt.iterations={E2E_RESUME_TO}",
             f"gaussian.start_checkpoint={out}/chkpnt10"] + common,
            "resume")
    require([r[0] for r in recs] == list(range(11, E2E_RESUME_TO + 1)),
            "resume: iterations")
    require(all(math.isfinite(m["total"]) and m["pair_overflow"] == 0.0
                for _, _, m, _ in recs), "resume: loss or overflow")
    require(os.path.isfile(os.path.join(
        out, f"point_cloud/iteration_{E2E_RESUME_TO}/point_cloud.ply")),
        "resume: no snapshot")

    # render
    with recorded_renders() as rrecs:
        pipe, render_s, render_l = run_mode(["mode=render"] + common,
                                            "render")
    meshes = pipe.result
    require(all(not a and not b for _, _, a, b in rrecs),
            "render: overflow flag")
    rdir = os.path.join(out, f"renders/iteration_{E2E_ITERS}")
    for f in MESHES:
        require(os.path.isfile(os.path.join(rdir, f)), f"render: no {f}")
    for name, st in meshes.items():
        print(f"field-e2e {name}: volume {st['dims']}, TSDF fuse "
              f"{st['fuse_s'] * 1e3:.1f} ms, mesh extraction "
              f"{st['extract_s'] * 1e3:.1f} ms, clean-up and PLYs "
              f"{st['post_s'] * 1e3:.1f} ms, {st['vertices']} vertices "
              f"{st['faces']} faces ({st['post_vertices']} / "
              f"{st['post_faces']} after)")
        require(st["faces"] >= E2E_MIN_FACES, f"{name}: {st['faces']} "
                f"faces, fewer than {E2E_MIN_FACES}")
    n_png = require_pngs(rdir, {"_render.png": (H, W, 3),
                                "_depth.png": (H, W),
                                "_language_pca.png": (H, W, 3)})
    per_view = {k: render_l[k] / len(rrecs) for k in RENDER_TRAIN_KERNELS}
    print(f"field-e2e render: {len(rrecs)} views, {n_png} PNGs decoded, "
          f"launches per view {per_view}")

    # eval
    with recorded_renders() as erecs:
        pipe, eval_s, eval_l = run_mode(["mode=eval"] + common, "eval")
    psnr = [r["psnr"] for r in pipe.result]
    require(len(psnr) == 4 and all(math.isfinite(p) for p in psnr),
            f"eval: PSNRs {psnr}")
    require(all(not a and not b for _, _, a, b in erecs),
            "eval: overflow flag")
    step = E2E_POSE_ITERS + 1                       # renders per view
    pose_ms = [(erecs[v * step + i + 1][0] - erecs[v * step + i][0]) * 1e3
               for v in range(4) for i in range(E2E_POSE_ITERS - 1)]
    per_pose = launch_delta(erecs[1][1], erecs[2][1])
    for d in EVAL_DIRS:
        require(len(os.listdir(os.path.join(out, "eval", d))) == 4,
                f"eval: {d}")
    n_png = require_pngs(os.path.join(out, "eval"), {
        os.path.join("renders_rgb", "0001.png"): (H, 2 * W, 3),
        os.path.join("renders_depth", "0001.png"): (H, W)})
    print(f"field-e2e eval: PSNR {', '.join('%.3f' % p for p in psnr)} dB, "
          f"{n_png} PNGs decoded, ms per pose iteration median "
          f"{np.median(pose_ms):.2f} (min {min(pose_ms):.2f}), launches per "
          f"pose iteration {per_pose}")
    return dict(train_s=train_s, resume_s=resume_s, render_s=render_s,
                eval_s=eval_s, per_iteration=per_it, per_view=per_view,
                per_pose_iteration=per_pose)


# ---- 23-25. the rest of TriMap and auto-seg ---------------------------

VAE_CLIP = (1, 9, 3, 256, 256)      # vae-train-c16-9x256x256
VAE_CLIP_CUT = (1, 5, 3, 256, 256)  # if 9 frames do not fit in the card
VAE_CHECK = (1, 5, 3, 64, 64)       # one step on the card and on the CPU
VAE_STEPS = 3
# the default lr 1e-4, logvar in the VAE's Adam (the JAX package's plain
# logvar step overflows the loss at this clip by step 3)
VAE_TRAIN = dict(disc_start_step=1, logvar_in_adam=True)
# card vs CPU, one step from one state and one eps, f32 without TF32:
# the convolutions sum in another order, so losses and logvar 1e-3 rel
VAE_RTOL = 1e-3
T5_LEN, T5_PAD_AFTER = 226, 40      # t5-xxl-encoder-2x226
T5_ITERS = 5
# the 2-block cut + final norm on the card vs the CPU (f32 without TF32)
T5_REL_RMS = 1e-4
AUTOSEG_FRAMES = 9                  # autoseg-full-random-9x1024
AUTOSEG_ARC = 30.0                  # degrees of yaw across the clip
# the same weights through torch.save and build_from_checkpoints give the
# same embedding, up to the card's choice of kernels (1e-6 absolute)
AUTOSEG_CKPT_ATOL = 1e-6


def gib(n: float) -> float:
    return n / 2 ** 30


def move_vae_state(st, dev):
    """A VAETrainState with every tensor on ``dev``."""
    from langscenex_tpu_torch.models.cogvideox.losses import LeCamEMA
    from langscenex_tpu_torch.train.optim import AdamState

    def d(x):
        return {k: v.to(dev) for k, v in x.items()}

    def adam(o):
        return AdamState(count=o.count, mu=d(o.mu), nu=d(o.nu))
    return dataclasses.replace(
        st, vae_params=d(st.vae_params), disc_params=d(st.disc_params),
        vae_opt=adam(st.vae_opt), disc_opt=adam(st.disc_opt),
        logvar=st.logvar.to(dev),
        lecam=LeCamEMA(st.lecam.real.to(dev), st.lecam.fake.to(dev)))


def vae_lpips(dev, state=None):
    """The full-width LPIPS, frozen: seeded random weights (seed 0), or
    ``state``."""
    from langscenex_tpu_torch.models import lpips
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(0)
        lp = lpips.LPIPS(device=dev)
    if state is not None:
        lp.load_state_dict(state)
    return lp.eval().requires_grad_(False)


def vae_trainer(dev, lp):
    """presets.vae_c16 with D (base 32) and ``lp`` through the per-frame
    wrapper, f32, seed 0, VAE_TRAIN."""
    from langscenex_tpu_torch.models import lpips
    from langscenex_tpu_torch.train import vae as vae_train
    from langscenex_tpu_torch.utils import presets
    return vae_train.VAETrainer(
        presets.vae_c16(), vae_train.VAETrainConfig(**VAE_TRAIN),
        seed=0, lpips_fn=lpips.per_frame(lp), device=dev)


def phase_vae_train(dev, smi: str) -> None:
    """vae-train-c16-9x256x256: 3 VAETrainer steps on a seeded clip
    (9 frames, or 5 where 9 do not fit), then one step at VAE_CHECK on
    the card and on the CPU from one state and one eps."""
    rng = np.random.default_rng(0)
    lp = vae_lpips(dev)
    for shape in (VAE_CLIP, VAE_CLIP_CUT):
        tr = vae_trainer(dev, lp)
        clip = torch.from_numpy(rng.uniform(-1, 1, shape).astype(
            np.float32)).to(dev)
        d0 = {k: v.clone() for k, v in tr.state.disc_params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        recs = []
        try:
            for i in range(VAE_STEPS):
                t0 = time.perf_counter()
                m = tr.train_step(clip)
                torch.cuda.synchronize()
                recs.append((time.perf_counter() - t0, m, all(
                    torch.equal(tr.state.disc_params[k], d0[k])
                    for k in d0)))
        except torch.cuda.OutOfMemoryError:
            print(f"vae-train: {shape} does not fit in the card; "
                  f"cutting to {VAE_CLIP_CUT[1]} frames")
            del tr, clip
            torch.cuda.empty_cache()
            continue
        break
    else:
        raise AssertionError("vae-train: no clip fits in the card")
    peak = gib(torch.cuda.max_memory_allocated())
    for i, (dt, m, same_d) in enumerate(recs):
        require(all(math.isfinite(v) for v in m.values()),
                f"vae-train step {i}: a loss is not finite: {m}")
        print(f"vae-train step {i}: {dt * 1e3:.1f} ms, " + ", ".join(
            f"{k} {v:.6g}" for k, v in m.items()))
    require(recs[0][2], "vae-train: D changed before disc_start_step")
    require(not recs[1][2], "vae-train: D did not change after "
            "disc_start_step")
    require(float(tr.state.logvar) != 0.0, "vae-train: logvar did not move")
    print(f"vae-train-c16-9x256x256: clip {list(shape)}, ms per step "
          f"{ms_list([r[0] for r in recs])} (first includes cuDNN's "
          f"choices), peak {peak:.2f} GiB, logvar "
          f"{float(tr.state.logvar):.6g} on {smi}")
    del tr, clip
    torch.cuda.empty_cache()

    # one step from one state and one eps on the card and on the CPU
    cpu_dev = torch.device("cpu")
    gpu = vae_trainer(dev, lp)
    cpu = vae_trainer(cpu_dev, vae_lpips(cpu_dev, {
        k: v.cpu() for k, v in lp.state_dict().items()}))
    cpu.state = move_vae_state(gpu.state, cpu_dev)
    x = rng.uniform(-1, 1, VAE_CHECK).astype(np.float32)
    with torch.no_grad():
        lat = gpu.vae.encode(torch.from_numpy(x).to(dev))[0].shape
    eps = rng.standard_normal(tuple(lat)).astype(np.float32)
    mg, mc = gpu.train_step(x, eps=eps), cpu.train_step(x, eps=eps)
    errs = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc}
    lv = (float(gpu.state.logvar), float(cpu.state.logvar))
    errs["logvar"] = abs(lv[0] - lv[1]) / max(abs(lv[1]), 1e-30)
    print(f"vae-train card vs CPU at {list(VAE_CHECK)}: rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (bound {VAE_RTOL})")
    require(max(errs.values()) <= VAE_RTOL, "vae-train: card and CPU "
            "step disagree")
    del gpu, cpu, lp
    torch.cuda.empty_cache()


def phase_t5(dev, smi: str) -> None:
    """t5-xxl-encoder-2x226: T5Config() in f32 with seeded weights drawn
    on the card, encode_ids on [2, 226] seeded ids (row 2 padded after 40
    tokens); the first two blocks + the final norm against the same
    weights on the CPU."""
    from langscenex_tpu_torch.models.t5 import TextEncoder
    from langscenex_tpu_torch.models.t5_encoder import (T5Config, T5Encoder,
                                                        init_t5_)
    cfg = T5Config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_t5_(T5Encoder(cfg, device=dev), seed=0)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"t5-xxl: {n / 1e9:.3f}B f32 parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, (2, T5_LEN))
    mask = np.ones((2, T5_LEN), np.int64)
    ids[1, T5_PAD_AFTER:], mask[1, T5_PAD_AFTER:] = 0, 0
    enc = TextEncoder.from_encoder(model)
    out = enc.encode_ids(ids, mask)
    require(out.shape == (2, T5_LEN, cfg.d_model) and np.isfinite(out).all(),
            "t5-xxl: output not finite or of the wrong shape")
    ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(
        dev)

    def encode():
        with torch.no_grad():
            model(ids_t, mask_t)
    ms = cuda_ms(encode, T5_ITERS)
    peak = gib(torch.cuda.max_memory_allocated())

    cut = dataclasses.replace(cfg, num_layers=2)
    keep = {k: v for k, v in model.state_dict().items()
            if not k.startswith("encoder.block.")
            or int(k.split(".")[2]) < 2}
    del model, enc
    torch.cuda.empty_cache()
    outs = []
    for d in (dev, torch.device("cpu")):
        m = T5Encoder(cut, device=d)
        m.load_state_dict({k: v.to(d) for k, v in keep.items()}, strict=True)
        with torch.no_grad():
            outs.append(m(torch.from_numpy(ids), torch.from_numpy(mask)
                          ).cpu())
        del m
    err = rel_rms(outs[0], outs[1])
    print(f"t5-xxl 2 blocks + final norm, card vs CPU: rel RMS {err:.2e} "
          f"(bound {T5_REL_RMS}), max abs {max_abs(outs[0], outs[1]):.3e}")
    require(err <= T5_REL_RMS, "t5-xxl: card and CPU disagree")
    print(f"t5-xxl-encoder-2x226: {ms:.2f} ms per encode of [2, 226], peak "
          f"{peak:.2f} GiB on {smi}")
    del keep, outs
    torch.cuda.empty_cache()


def arc_cameras(n: int) -> list[Camera]:
    """n views from near the room's centre, panning AUTOSEG_ARC degrees
    of yaw across wall 0 and 1's corner region."""
    fovy = focal2fov(fov2focal(FOVX, W), H)
    cams = []
    for i in range(n):
        R = _rot(1, AUTOSEG_ARC * (i / max(n - 1, 1) - 0.5) + 20.0)
        centre = E2E_CAM_R * R[:, 2]
        cams.append(Camera(uid=i, colmap_id=i, R=R, T=-R.T @ centre,
                           fovx=FOVX, fovy=fovy, width=W, height=H,
                           image_name=f"{i + 1:04d}"))
    return cams


def room_splats(dev) -> GaussianState:
    """Phase 22's room as splats on ``dev``."""
    arrays, _ = e2e_room(FIELD_P)
    st = gaussian_state(arrays)
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).to(dev) for f in dataclasses.fields(st)})


def write_arc_frames(dev, root: str, n: int = AUTOSEG_FRAMES) -> None:
    """n PNGs of phase 22's room along ``arc_cameras``, rendered by the
    port."""
    splats = room_splats(dev)
    cams = arc_cameras(n)
    for cam, (_, m) in zip(cams, render_all_views(splats, cams, EXACT_CFG,
                                                  sh_degree=3)):
        require(not bool(m["pairs_overflowed"]), "arc render: overflow")
        write_png(os.path.join(root, cam.image_name + ".png"),
                  (m["render"].clamp(0, 1).permute(1, 2, 0) * 255)
                  .to(torch.uint8).cpu().numpy())


@contextlib.contextmanager
def timed_calls(obj, name: str, out: list):
    """Record the seconds of every ``obj.name`` call (synchronised); obj
    may be an instance, a class or a module."""
    fn = getattr(obj, name)
    own = name in vars(obj)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        return r
    setattr(obj, name, wrapper)
    try:
        yield out
    finally:
        if own:
            setattr(obj, name, fn)
        else:
            delattr(obj, name)


def phase_autoseg(dev, smi: str) -> None:
    """autoseg-full-random-9x1024: SAM1 ViT-H (AMG with the thresholds
    off) and SAM2 Hiera-L (64 objects at most) with seeded random weights,
    each normalising its input (as build_from_checkpoints builds them),
    over 9 rendered 720x480 PNG frames through the CLI's frame loader,
    MaskAligner.run, the id-map resize and save_outputs; then
    build_from_checkpoints on the same weights torch.saved in the two
    checkpoints' layouts."""
    from langscenex_tpu_torch.autoseg import __main__ as autoseg_cli
    from langscenex_tpu_torch.autoseg import mask_align
    from langscenex_tpu_torch.models import sam1 as sam1_mod
    from langscenex_tpu_torch.models.sam2 import model as sam2_mod
    t0 = time.perf_counter()
    m1 = sam1_mod.init_sam1_params(sam1_mod.SAM1(
        sam1_mod.SAM1Config(), device=dev, normalize_input=True), 0)
    m2 = sam2_mod.init_sam2_params(sam2_mod.SAM2(
        sam2_mod.SAM2Config(), device=dev, normalize_input=True), 0)
    torch.cuda.synchronize()
    print(f"autoseg: SAM1 {sum(p.numel() for p in m1.parameters()) / 1e6:.1f}"
          f"M and SAM2 {sum(p.numel() for p in m2.parameters()) / 1e6:.1f}M "
          f"f32 parameters, {time.perf_counter() - t0:.2f} s")
    amg = sam1_mod.SAM1AutomaticMaskGenerator(m1, sam1_mod.SAM1AMGConfig(
        pred_iou_thresh=-1e9, stability_score_thresh=-1e9,
        min_mask_region_area=0))
    pred = sam2_mod.SAM2VideoPredictor(m2)
    cfg = mask_align.MaskAlignConfig(level="default", new_obj_min_area=4,
                                     postnms_score=-1e9, max_objects=64)
    with tempfile.TemporaryDirectory() as root:
        frames_dir = os.path.join(root, "rgb")
        out_dir = os.path.join(root, "seg")
        os.makedirs(frames_dir)
        write_arc_frames(dev, frames_dir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        frames, hw = autoseg_cli.load_frames(frames_dir, m1.cfg.img_size)
        t_load = time.perf_counter() - t0
        amg_s, enc_s, frame_s = [], [], []
        with timed_calls(amg, "generate", amg_s), \
                timed_calls(m2, "forward_image", enc_s):
            gen = pred.propagate_in_video

            def timed_propagate(*a, **k):
                it = gen(*a, **k)
                while True:
                    t1 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    torch.cuda.synchronize()
                    frame_s.append(time.perf_counter() - t1)
                    yield item
            pred.propagate_in_video = timed_propagate
            t1 = time.perf_counter()
            seg_maps, colors = mask_align.MaskAligner(amg, pred, cfg).run(
                frames)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t1
            del pred.propagate_in_video
        t1 = time.perf_counter()
        seg_maps = autoseg_cli.resize_id_maps(seg_maps, hw)
        mask_align.save_outputs(seg_maps, colors, out_dir)
        t_save = time.perf_counter() - t1
        t_all = time.perf_counter() - t0
        peak = gib(torch.cuda.max_memory_allocated())
        n_obj = len(colors)
        # the artifact contract
        cols = np.load(os.path.join(out_dir, "colors.npy"))
        require(cols.shape == (n_obj + 1, 3) and not cols[0].any(),
                "autoseg: colors.npy has no black background row 0")
        ids = [np.load(os.path.join(out_dir, f"{t + 1:04d}_s.npy"))
               for t in range(AUTOSEG_FRAMES)]
        require(all(a.dtype == np.int32 and a.shape == (H, W) for a in ids),
                "autoseg: an id map is not int32 [480, 720]")
        lo, hi = min(a.min() for a in ids), max(a.max() for a in ids)
        require(lo >= -1 and hi < len(cols) - 1,
                f"autoseg: ids in [{lo}, {hi}] outside [-1, {n_obj})")
        require(1 <= n_obj <= 64 and hi >= 0, f"autoseg: {n_obj} objects")
        keys = sorted(f for f in os.listdir(out_dir) if f.startswith("key_"))
        require(len(keys) == 2 and all(read_png(os.path.join(
            out_dir, f)).shape == (H, W, 3) for f in keys),
            f"autoseg: key PNGs {keys}")
        n_files = len([f for f in os.listdir(out_dir) if f.endswith(
            "_s.npy")])
        require(n_files == AUTOSEG_FRAMES, f"autoseg: {n_files} id maps")
        covered = float(np.mean([(a >= 0).mean() for a in ids]))
        track = [f - e for f, e in zip(frame_s, enc_s)]
        print(f"autoseg-full-random-9x1024: {n_obj} objects, "
              f"{covered:.3f} of pixels covered; AMG "
              f"{ms_list(amg_s)} ms per keyframe ({len(amg_s)} keyframes), "
              f"SAM2 image encode median "
              f"{np.median(enc_s) * 1e3:.1f} ms per frame ({len(enc_s)} "
              f"encodes), track step (frame minus its encode) median "
              f"{np.median(track) * 1e3:.1f} ms per frame ({len(frame_s)} "
              f"frames over the passes), load {t_load:.2f} s, run "
              f"{t_run:.2f} s, resize + save {t_save:.2f} s, whole "
              f"{t_all:.2f} s, peak {peak:.2f} GiB on {smi}")

        # the same weights through the checkpoint layouts
        ck1, ck2 = os.path.join(root, "sam1.pth"), os.path.join(root,
                                                                 "sam2.pt")
        torch.save(m1.state_dict(), ck1)
        torch.save({"model": m2.state_dict()}, ck2)
        f0 = torch.from_numpy(frames[:1]).to(dev)
        with torch.no_grad():
            e1, e2 = (m1.encode_image(f0),
                      m2.forward_image(f0)["vision_features"])
        del m1, m2, amg, pred
        torch.cuda.empty_cache()
        amg2, pred2 = mask_align.build_from_checkpoints(ck1, ck2, device=dev)
        with torch.no_grad():
            g1 = amg2.model.encode_image(f0)
            g2 = pred2.model.forward_image(f0)["vision_features"]
        err = max(max_abs(g1, e1), max_abs(g2, e2))
        print(f"autoseg build_from_checkpoints: first-frame embeddings "
              f"max abs diff {err:.3e} (SAM1 {list(g1.shape)}, SAM2 "
              f"{list(g2.shape)})")
        require(err <= AUTOSEG_CKPT_ATOL, "autoseg: checkpoint models "
                "differ")
        del amg2, pred2
    torch.cuda.empty_cache()


# ---- 26-27. pose and language lifting ---------------------------------

LIFT_FRAMES = 49                    # the TriMap clip quick_start feeds VGGT
DENSE_STRIDE = 6                    # every 6th frame: 8 for the export
VGGT_WARMUP = 2                     # frames of the warmup forward
# the 2-block cut on the card vs the CPU: the card runs the aggregator and
# the ViT in bf16 (VGGTConfig.dtype), the CPU in f32, so each output is
# held to bf16's rounding carried through the blocks and the heads
VGGT_REL_RMS = 2e-2
VGGT_CUT = dict(depth=2, vit_depth=2, intermediate_layers=(0, 0, 1, 1))
# the checkpoint read back through the CLI: the same weights and the same
# inputs, so the same pose encoding up to the card's choice of kernels
VGGT_CKPT_ATOL = 1e-5
# K9 at VGGT-1B's two attention shapes (B, T): a global block's one
# sequence of 49 frames x 1,374 tokens (its last 128-key tile holds 126
# keys) and a frame block's 49 sequences (94); 16 heads of 64 drawn as
# phase 20's, the plain version run VGGT_K9_HEADS heads at a time. The
# mean |l2| bound is not held there: K9's l, summed on the tensor cores
# over every tile, drifts from the plain version's by a share that grows
# with Tk (1.1e-4 in log2 at 67,326 keys; o moves by 8e-5 of itself)
VGGT_K9_SHAPES = ((1, LIFT_FRAMES * 1374), (LIFT_FRAMES, 1374))
VGGT_K9_HEADS = 4
LANG_GRID = 8                       # an 8 x 8 grid: 64 seg ids a frame
CLIP_REL_RMS = 1e-4                 # one CLIP-L forward, card vs CPU
AE_CHECK_STEPS = 4
# 4 AE steps from one state, card vs CPU, their train losses: the first
# (the same weights, a forward) to AE_RTOL_FIRST; all to AE_RTOL, as
# training this AE is chaotic in rounding (Adam moves each weight by ~lr
# whatever its gradient, and the biases before a batch norm have a zero
# gradient: the JAX trainer from a start one ulp away is 1e-4 apart by
# step 5; tests/test_torch_language.py)
AE_RTOL_FIRST = 1e-5
AE_RTOL = 1e-3
QUERIES = ("a grey wall", "the corner of the room", "a window", "the floor")


@contextlib.contextmanager
def recorded_forwards(model, out: list):
    """Append (seconds, outputs) of every forward of ``model`` inside the
    block, synchronised."""
    fwd = model.forward

    def rec(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fwd(*a, **k)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, r))
        return r
    model.forward = rec
    try:
        yield out
    finally:
        del model.forward


def require_finite(what: str, **tensors) -> None:
    for k, v in tensors.items():
        v = torch.as_tensor(v)
        require(bool(torch.isfinite(v).all()), f"{what}: {k} is not finite")


def check_k9_vggt(dev) -> None:
    """K9 against its plain version at its 128-key tile at VGGT_K9_SHAPES,
    over all 16 heads, with K5's bounds on o and on each l2 (check_attention;
    the mean |l2| printed, not held: see VGGT_K9_SHAPES); q,
    k, v strided views of one [B, T, 3, H, D] tensor, as the model's fused
    qkv gives them; each launch's time beside its bound."""
    H, D = 16, 64
    sc = D ** -0.5
    gen = torch.Generator(device=dev).manual_seed(26)
    for B, T in VGGT_K9_SHAPES:
        qkv = torch.randn((B, T, 3, H, D), generator=gen,
                          device=dev).to(torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        del qkv
        n0 = _build.launch_counts["flash_attention_online"]
        with torch.inference_mode():
            o, l2 = flash_attention_online_kernel(q, k, v, sc)
            torch.cuda.synchronize()
            require(_build.launch_counts["flash_attention_online"] - n0
                    == 1, f"K9 at [{B}, {H}, {T}, {D}]: not one launch")
            ms = cuda_ms(lambda: flash_attention_online_kernel(q, k, v, sc),
                         5, warmup=1)
            ro, rl2 = [], []
            for h in range(0, H, VGGT_K9_HEADS):
                hs = slice(h, h + VGGT_K9_HEADS)
                a, b = flash_attention_online_plain(
                    q[:, hs], k[:, hs], v[:, hs], sc, block_k=WGMMA_BLOCK_K)
                ro.append(a)
                rl2.append(b.view(B, -1, T))
            ro, rl2 = torch.cat(ro, 1), torch.cat(rl2, 1).reshape(B * H, T)
        tail = T % WGMMA_BLOCK_K or WGMMA_BLOCK_K
        check_attention(f"K9 vs plain at its {WGMMA_BLOCK_K}-key tile, VGGT "
                        f"q, k, v [{B}, {H}, {T}, {D}] (last tile {tail} "
                        f"keys), all heads", o, l2, ro, rl2, l2_mean=False)
        forward_terms(f"K9 at VGGT's {'global' if B == 1 else 'frame'} "
                      f"shape", ms, B, H, T, T,
                      B * H * T * (T + -(-T // WGMMA_BLOCK_K)), dev)
        del q, k, v, o, l2, ro, rl2
        torch.cuda.empty_cache()


def phase_vggt(dev, smi: str, root: str) -> None:
    """vggt-1b-49x518 over root/input (LIFT_FRAMES PNGs)."""
    check_k9_vggt(dev)
    from langscenex_tpu_torch import get_normal, pose_estimation
    from langscenex_tpu_torch.models import vggt as vggt_mod
    from langscenex_tpu_torch.pipeline import (FieldConstructionPipeline,
                                               PipelinePaths)
    from langscenex_tpu_torch.scene.colmap_io import (read_cameras_binary,
                                                      read_images_binary)
    from langscenex_tpu_torch.scene.dataset_readers import read_ply_points
    cfg = vggt_mod.VGGTConfig()
    S = cfg.img_size - cfg.img_size % cfg.patch_size
    t0 = time.perf_counter()
    model = vggt_mod.init_vggt_params(vggt_mod.VGGT(cfg, device=dev),
                                      0).eval()
    torch.cuda.synchronize()
    print(f"vggt: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
          f"f32 parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    names = sorted(os.listdir(os.path.join(root, "input")))
    n = len(names)
    paths = [os.path.join(root, "input", f) for f in names]
    warm = pose_estimation.load_frames(paths[:VGGT_WARMUP], S)
    pose_estimation.run_vggt(model, warm)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the pipeline's pose step: camera/*.npz and points3D.ply
    pipe = FieldConstructionPipeline(PipelinePaths(
        data_path=root, skip_video_process=True,
        skip_lang_feature_extraction=True), device=dev)
    pipe.vggt = model
    fwd = []
    sdpa = []
    nnf = torch.nn.functional
    inner_sdpa = nnf.scaled_dot_product_attention

    def counted_sdpa(*a, **k):
        sdpa.append(1)
        return inner_sdpa(*a, **k)
    k9 = _build.launch_counts["flash_attention_online"]
    nnf.scaled_dot_product_attention = counted_sdpa
    try:
        with recorded_forwards(model, fwd):
            t0 = time.perf_counter()
            pipe.preprocess()
            torch.cuda.synchronize()
            t_pose = time.perf_counter() - t0
    finally:
        nnf.scaled_dot_product_attention = inner_sdpa
    k9 = _build.launch_counts["flash_attention_online"] - k9
    peak = gib(torch.cuda.max_memory_allocated())
    require(len(fwd) == 1, f"vggt: {len(fwd)} forwards in estimate_poses")
    fwd_s, out = fwd[0]
    require_finite("vggt", pose_enc=out["pose_enc"], depth=out["depth"],
                   depth_conf=out["depth_conf"])
    want_k9 = cfg.vit_depth + 2 * cfg.depth
    want_sdpa = cfg.camera_trunk_depth * cfg.camera_iterations
    print(f"vggt forward: {k9} K9 launches (want {want_k9}), {len(sdpa)} "
          f"SDPA calls (the camera trunk's {want_sdpa}), outputs "
          f"{sorted(out)}")
    require(k9 == want_k9 and len(sdpa) == want_sdpa,
            "vggt: the aggregator and the ViT are not on K9 alone")
    require("world_points" not in out, "vggt: run_vggt ran the point head")
    cams = sorted(os.listdir(os.path.join(root, "camera")))
    require(cams == [f"{i + 1:04d}.npz" for i in range(n)],
            f"vggt: camera files {cams[:3]}... ({len(cams)})")
    for c in cams:
        z = np.load(os.path.join(root, "camera", c))
        require(z["pose"].shape == (4, 4) and z["intrinsics"].shape ==
                (3, 3) and np.isfinite(z["pose"]).all()
                and np.isfinite(z["intrinsics"]).all(),
                f"vggt: {c} is not a finite 4x4 pose and 3x3 K")
    pts, cols = read_ply_points(os.path.join(root, "points3D.ply"))
    require(len(pts) > 0 and np.isfinite(pts).all(),
            "vggt: points3D.ply empty or not finite")
    del fwd, out
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # the dense-init COLMAP export on 8 of the frames
        dense = os.path.join(tmp, "dense")
        os.makedirs(os.path.join(dense, "input"))
        picked = names[::DENSE_STRIDE][:8]
        for f in picked:
            shutil.copy(os.path.join(root, "input", f),
                        os.path.join(dense, "input", f))
        t0 = time.perf_counter()
        n_pts = pose_estimation.estimate_poses_dense_init(dense, model=model,
                                                          device=dev)
        t_dense = time.perf_counter() - t0
        s0 = os.path.join(dense, "sparse_0", "0")
        have = sorted(os.listdir(s0))
        want = sorted(["images.bin", "images.txt", "cameras.bin",
                       "cameras.txt", "points3D.ply", "confidence.npy",
                       "confidence_dsp.npy", "non_scaled_focals.npy"])
        require(have == want, f"dense init: sparse_0/0 holds {have}")
        require(os.path.exists(os.path.join(dense, "pts_num.txt")),
                "dense init: no pts_num.txt")
        ims = read_images_binary(os.path.join(s0, "images.bin"))
        cms = read_cameras_binary(os.path.join(s0, "cameras.bin"))
        require(len(ims) == len(cms) == len(picked) and sorted(
            im.name for im in ims.values()) == picked,
            f"dense init: {len(ims)} images, {len(cms)} cameras")
        require(all(c.width == W and c.height == H for c in cms.values()),
                "dense init: cameras not at the frames' 720x480")
        conf = np.load(os.path.join(s0, "confidence.npy"))
        dsp = np.load(os.path.join(s0, "confidence_dsp.npy"))
        dpts, _ = read_ply_points(os.path.join(s0, "points3D.ply"))
        require(conf.shape == (len(picked), S * S) and len(dsp) == n_pts
                == len(dpts) and 0 < n_pts <= len(picked) * S * S
                and np.isfinite(dpts).all(),
                f"dense init: confidence {conf.shape}, {len(dsp)} kept "
                f"confidences, {len(dpts)} points, {n_pts} returned")

        # normal keyframes from the first and last frames
        kf = os.path.join(tmp, "kf")
        os.makedirs(os.path.join(kf, "rgb"))
        for i, f in enumerate((names[0], names[-1])):
            shutil.copy(os.path.join(root, "input", f),
                        os.path.join(kf, "rgb", f"{i + 1:04d}.png"))
        t0 = time.perf_counter()
        out_n = get_normal.generate_normals(kf, model=model, device=dev)
        torch.cuda.synchronize()
        t_norm = time.perf_counter() - t0
        for i in range(2):
            img = read_png(os.path.join(kf, "normal", f"{i + 1:04d}.png"))
            require(img.shape == (H, W, 3), f"normals: shape {img.shape}")

        # the state_dict through torch.save and the CLI
        ckpt = os.path.join(tmp, "model.pt")
        t0 = time.perf_counter()
        torch.save(model.state_dict(), ckpt)
        t_save = time.perf_counter() - t0
        os.rename(os.path.join(kf, "normal"), os.path.join(kf, "direct"))
        cli = []
        inner = get_normal.generate_normals

        def captured(*a, **k):
            cli.append(inner(*a, **k))
            return cli[-1]
        get_normal.generate_normals = captured
        try:
            t0 = time.perf_counter()
            rc = get_normal.main(["--base_path", kf, "--vggt_checkpoint",
                                  ckpt, "--device", str(dev)])
            t_cli = time.perf_counter() - t0
        finally:
            get_normal.generate_normals = inner
        require(rc == 0 and len(cli) == 1, "get_normal CLI failed")
        err = max_abs(cli[0]["pose_enc"], out_n["pose_enc"])
        same_png = all(np.array_equal(
            read_png(os.path.join(kf, "normal", f"{i + 1:04d}.png")),
            read_png(os.path.join(kf, "direct", f"{i + 1:04d}.png")))
            for i in range(2))
        print(f"vggt checkpoint: torch.save {t_save:.2f} s, the get_normal "
              f"CLI {t_cli:.2f} s; pose_enc max abs diff {err:.3e} (bound "
              f"{VGGT_CKPT_ATOL}), normal PNGs equal: {same_png}")
        require(err <= VGGT_CKPT_ATOL, "vggt: the CLI's checkpoint model "
                "differs")
        del cli, out_n
    torch.cuda.empty_cache()

    # the 2-block cut, card vs CPU, on the warmup's 2 frames
    cut = dataclasses.replace(cfg, **VGGT_CUT)

    def kept(k):
        for pre in ("aggregator.frame_blocks.", "aggregator.global_blocks.",
                    "aggregator.patch_embed.blocks."):
            if k.startswith(pre):
                return int(k[len(pre):].split(".")[0]) < 2
        return True
    keep = {k: v for k, v in model.state_dict().items() if kept(k)}
    del model, pipe
    torch.cuda.empty_cache()
    outs = []
    for d in (dev, torch.device("cpu")):
        m = vggt_mod.VGGT(cut, device=d).eval()
        m.load_state_dict({k: v.to(d) for k, v in keep.items()}, strict=True)
        with torch.no_grad():
            o = m(torch.from_numpy(warm)[None].to(d))
        outs.append({k: v.cpu() for k, v in o.items()})
        del m
    errs = {k: rel_rms(outs[0][k], outs[1][k]) for k in outs[1]}
    print("vggt 2 blocks + both heads at 2x518, card vs CPU: rel RMS "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (bound {VGGT_REL_RMS})")
    require(max(errs.values()) <= VGGT_REL_RMS, "vggt: card and CPU "
            "disagree")
    print(f"vggt-1b-49x518: forward {fwd_s:.2f} s over {n} frames at "
          f"{S}x{S} (after a {VGGT_WARMUP}-frame warmup), estimate_poses "
          f"{t_pose:.2f} s whole ({len(pts)} init points), dense-init "
          f"export of {len(picked)} "
          f"frames {t_dense:.2f} s ({n_pts} points), normals of 2 keyframes "
          f"{t_norm:.2f} s, peak {peak:.2f} GiB on {smi}")
    del keep, outs
    torch.cuda.empty_cache()


class CharTokenizer:
    """A stand-in for HF's CLIPTokenizer (the card has no transformers):
    BOS, one id per byte, EOS, zero padding."""

    def __call__(self, texts, padding, max_length, truncation,
                 return_tensors):
        ids = np.zeros((len(texts), max_length), np.int64)
        for r, t in enumerate(texts):
            toks = [49406] + list(t.encode())[:max_length - 2] + [49407]
            ids[r, :len(toks)] = toks
        return {"input_ids": ids}


def grid_segments(h: int, w: int) -> np.ndarray:
    """[h, w] ids 0..LANG_GRID^2 - 1: an LANG_GRID x LANG_GRID grid."""
    ys, xs = np.mgrid[0:h, 0:w]
    return (ys * LANG_GRID // h) * LANG_GRID + xs * LANG_GRID // w


def phase_lang(dev, smi: str, root: str) -> None:
    """lang-lift-clip-l14-49x720x480 over root/input."""
    from langscenex_tpu_torch.eval import open_vocab
    from langscenex_tpu_torch.models import clip_dense, lseg, vq_model
    from langscenex_tpu_torch.pipeline import (FieldConstructionPipeline,
                                               PipelinePaths)
    from langscenex_tpu_torch.train import ae as ae_mod
    names = sorted(os.listdir(os.path.join(root, "input")))
    n = len(names)
    seg_dir = os.path.join(root, "lang_features_dim3")
    os.makedirs(seg_dir, exist_ok=True)
    seg = grid_segments(H, W)
    for i in range(n):
        np.save(os.path.join(seg_dir, f"{i + 1:04d}_s.npy"), seg)
    ccfg = clip_dense.CLIPVisionConfig()
    clip = clip_dense.init_clip_params(clip_dense.CLIPVisionDense(
        ccfg, device=dev), 1).eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = FieldConstructionPipeline(PipelinePaths(
        data_path=root, skip_video_process=True, skip_pose_estimate=True),
        device=dev)
    pipe.lang_extractor = clip_dense.ClipDenseExtractor(clip)
    clip_s, fit_s = [], []
    with timed_calls(clip, "forward", clip_s), \
            timed_calls(ae_mod.AETrainer, "fit", fit_s):
        t0 = time.perf_counter()
        pipe.preprocess()
        t_all = time.perf_counter() - t0
    peak = gib(torch.cuda.max_memory_allocated())
    tr = pipe.ae_trainer
    rows = 0
    for i in range(n):
        r = np.load(os.path.join(root, "lang_features", f"{i + 1:04d}.npy"))
        f = np.load(os.path.join(seg_dir, f"{i + 1:04d}_f.npy"))
        require(r.shape == (LANG_GRID ** 2, ccfg.projection_dim)
                and np.isfinite(r).all(), f"lang: rows {r.shape}")
        require(f.shape == (3, H, W) and np.isfinite(f).all(),
                f"lang: 3-d map {f.shape}")
        rows += len(r)
    ev = tr.history["eval"]
    require(len(ev) > 1 and min(v for _, v in ev) < ev[0][1],
            f"lang: the AE's best eval loss is not below its first "
            f"({ev[:2]}...)")
    steps = pipe.ae_epochs * max(rows // 512, 1)
    print(f"lang AE: {rows} rows, {pipe.ae_epochs} epochs, {steps} steps; "
          f"eval loss {ev[0][1]:.6f} (epoch {ev[0][0]}) -> best "
          f"{min(v for _, v in ev):.6f} (epoch {tr.best_epoch})")

    # one CLIP forward and AE_CHECK_STEPS AE steps, card vs CPU
    img = read_png(os.path.join(root, "input", names[0]))
    x = pipe.lang_extractor.pixels(img)
    cpu = torch.device("cpu")
    clip_cpu = clip_dense.CLIPVisionDense(ccfg, device=cpu).eval()
    clip_cpu.load_state_dict({k: v.cpu() for k, v in
                              clip.state_dict().items()})
    with torch.no_grad():
        got = [t.cpu() for t in clip(x)]
        ref = clip_cpu(x.cpu())
    clip_err = max(rel_rms(a, b) for a, b in zip(got, ref))
    del clip_cpu
    feats = np.concatenate([np.load(os.path.join(
        root, "lang_features", f"{i + 1:04d}.npy")) for i in range(n)])
    ae_gpu = ae_mod.AETrainer(input_dim=feats.shape[1], device=dev)
    ae_cpu = ae_mod.AETrainer(input_dim=feats.shape[1], device=cpu)
    ae_cpu.model.load_state_dict({k: v.cpu() for k, v in
                                  ae_gpu.model.state_dict().items()})
    rng = np.random.default_rng(0)
    ae_errs = []
    for _ in range(AE_CHECK_STEPS):
        b = torch.from_numpy(feats[rng.permutation(len(feats))[:512]])
        lg = float(ae_gpu.train_step(b.to(dev)))
        lc = float(ae_cpu.train_step(b))
        ae_errs.append(abs(lg - lc) / abs(lc))
    print(f"lang card vs CPU: CLIP-L forward rel RMS {clip_err:.2e} (bound "
          f"{CLIP_REL_RMS}), {AE_CHECK_STEPS} AE steps' losses rel "
          + " ".join(f"{e:.2e}" for e in ae_errs)
          + f" (bounds {AE_RTOL_FIRST} for the first, {AE_RTOL})")
    require(clip_err <= CLIP_REL_RMS, "lang: CLIP card and CPU disagree")
    require(ae_errs[0] <= AE_RTOL_FIRST and max(ae_errs) <= AE_RTOL,
            "lang: AE card and CPU disagree")
    del ae_gpu, ae_cpu

    # the LSeg + VQ branch from checkpoints
    vq = vq_model.init_vq_params(vq_model.VQModel(vq_model.VQConfig(),
                                                  device=dev), 2)
    with tempfile.TemporaryDirectory() as tmp:
        lseg_ckpt, vq_ckpt = (os.path.join(tmp, "lseg.pt"),
                              os.path.join(tmp, "vq.pt"))
        torch.save(clip.state_dict(), lseg_ckpt)
        torch.save(vq.state_dict(), vq_ckpt)
        del vq
        lpipe = FieldConstructionPipeline(PipelinePaths(
            data_path=root, skip_video_process=True, skip_pose_estimate=True,
            feature_extractor_type="lseg", lseg_ckpt=lseg_ckpt,
            sem_ae_ckpt=vq_ckpt), device=dev)
        lseg_s = []
        with timed_calls(lseg, "generate_lang_features_with_lseg",
                          lseg_s):
            t0 = time.perf_counter()
            lpipe.extract_language_features()
            t_lseg_all = time.perf_counter() - t0
    d4 = sorted(os.listdir(os.path.join(root, "lang_features_dim4")))
    require(len(d4) == n and len(lseg_s) == 1, f"lseg: {len(d4)} maps")
    for f in d4:
        z = np.load(os.path.join(root, "lang_features_dim4", f))
        require(z.shape == (1, 4, 120, 160) and np.isfinite(z).all(),
                f"lseg: {f} {z.shape}")

    # open-vocabulary queries on phase 22's rendered language maps
    text = clip_dense.init_clip_params(clip_dense.CLIPTextEncoder(
        clip_dense.CLIPTextConfig(), device=dev), 3).eval()
    emb = open_vocab.embed_queries(QUERIES, text, CharTokenizer())
    codes = open_vocab.encode_queries_to_lang3(emb, tr)
    require_finite("queries", emb=emb, codes=codes)
    require(codes.shape == (len(QUERIES), 3), f"queries: {codes.shape}")
    cams = e2e_cameras()
    for cam, (_, m) in zip(cams, render_all_views(room_splats(dev), cams,
                                                  EXACT_CFG, sh_degree=3)):
        rel = open_vocab.relevancy_maps(
            m["language_feature"].cpu().numpy(), codes)
        require(rel.shape == (len(QUERIES), H, W) and np.isfinite(rel).all()
                and np.abs(rel).max() <= 1.0 + 1e-5,
                f"queries: relevancy {rel.shape}")
    pred = open_vocab.predict_masks(rel, 0.5)
    print(f"lang-lift-clip-l14-49x720x480: CLIP {np.median(clip_s):.3f} s a "
          f"frame (median of {len(clip_s)}), extract + AE "
          f"{t_all:.2f} s whole, AE fit {fit_s[0]:.2f} s ({steps} steps, "
          f"{fit_s[0] / steps * 1e3:.2f} ms a step with its evals), "
          f"LSeg + VQ {lseg_s[0] / n:.3f} s a frame ({t_lseg_all:.2f} s "
          f"with the checkpoints' loading), queries: {len(QUERIES)} codes, "
          f"{(pred >= 0).mean():.3f} of the last view above 0.5; peak "
          f"{peak:.2f} GiB (extract + AE) on {smi}")
    del clip, text, pipe, lpipe
    torch.cuda.empty_cache()


def phase_26_27(dev, smi: str, which=(26, 27)) -> None:
    """Phases 26 and 27 over one scene of LIFT_FRAMES arc frames."""
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "input"))
        write_arc_frames(dev, os.path.join(root, "input"), LIFT_FRAMES)
        torch.cuda.empty_cache()
        if 26 in which:
            t0 = time.perf_counter()
            phase_vggt(dev, smi, root)
            print(f"phase 26: {time.perf_counter() - t0:.1f} s")
        if 27 in which:
            t0 = time.perf_counter()
            phase_lang(dev, smi, root)
            print(f"phase 27: {time.perf_counter() - t0:.1f} s")


def phase_23_25(dev, smi: str, which=(23, 24, 25)) -> None:
    if 23 in which:
        phase_vae_train(dev, smi)
    if 24 in which:
        phase_t5(dev, smi)
    if 25 in which:
        phase_autoseg(dev, smi)


def phase_22(dev) -> None:
    e2e = phase_field_e2e(dev)
    print(f"field-e2e-200k-720x480: train {e2e['train_s']:.2f} s, resume "
          f"{e2e['resume_s']:.2f} s, render {e2e['render_s']:.2f} s, eval "
          f"{e2e['eval_s']:.2f} s")


# ---- 28. the four-stage chain, quickstart-full-random-720x480 ---------

QS_FRAMES = 49                      # the TriMap clip's frames
QS_STEPS = 2                        # DDIM steps a request (of 50)
QS_ITERS = 30                       # field iterations (of 12,000)
QS_AE_EPOCHS = 40                   # scene-AE epochs (of 400)
QS_POSE_ITERS = 20                  # eval pose iterations per view
QS_TRIMAP_KERNELS = ("flash_attention", "ln_modulate")          # K5, K8
QS_FIELD_KERNELS = ("blend_forward", "bin_pairs", "sort_pairs")  # K1, K15, K4


@contextlib.contextmanager
def stage_launches(obj, name: str, out: dict, what: str, results=None):
    """Add the kernel launches (and, with ``results``, the return values)
    of every ``obj.name`` call inside the block to ``out[what]``."""
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        before = dict(_build.launch_counts)
        r = fn(*a, **k)
        torch.cuda.synchronize()
        acc = out.setdefault(what, {})
        for key, v in _build.launch_counts.items():
            acc[key] = acc.get(key, 0) + v - before.get(key, 0)
        if results is not None:
            results.setdefault(what, []).append(r)
        return r
    setattr(obj, name, wrapper)
    try:
        yield out
    finally:
        setattr(obj, name, fn)


def require_files(d: str, n: int, what: str, suffix: str = "") -> None:
    got = [f for f in os.listdir(d) if f.endswith(suffix)]
    require(len(got) == n, f"{what}: {len(got)} files{' ' + suffix if suffix else ''} "
            f"in {d}, expected {n}")


def phase_quickstart(dev, smi: str) -> dict:
    """quickstart-full-random-720x480: the port's quick_start.run with
    --full-random on two 720x480 keyframes of phase 22's room from the
    ends of phase 25's arc, at full widths and reduced depths; the chain
    contract of the JAX package's tests/test_quick_start_chain.py at
    QS_FRAMES frames, finite losses, per-stage times, peak memory and
    launches."""
    from langscenex_tpu_torch import quick_start, video_inference
    from langscenex_tpu_torch.pipeline import FieldConstructionPipeline
    with tempfile.TemporaryDirectory() as root:
        kf = os.path.join(root, "keyframes")
        os.makedirs(kf)
        write_arc_frames(dev, kf, 2)           # 0001.png, 0002.png
        torch.cuda.empty_cache()
        dp = os.path.join(root, "demo")
        argv = ["--data_path", dp,
                "--first_image", os.path.join(kf, "0001.png"),
                "--last_image", os.path.join(kf, "0002.png"),
                "--prompt", PROMPT, "--full-random",
                "--num_inference_steps", str(QS_STEPS),
                "--iterations", str(QS_ITERS),
                "--ae_epochs", str(QS_AE_EPOCHS),
                "--pose_optim_iter", str(QS_POSE_ITERS), "--render", "--eval"]
        counts, rets = {}, {}
        Pipe = FieldConstructionPipeline
        with stage_launches(video_inference, "main", counts, "trimap"), \
                stage_launches(Pipe, "preprocess", counts, "preprocess"), \
                stage_launches(Pipe, "construct_field", counts, "field",
                               rets), \
                stage_launches(Pipe, "render_result", counts, "render"), \
                stage_launches(Pipe, "eval", counts, "eval", rets):
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            rec = quick_start.run(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        total = {k: v for k, v in _build.launch_counts.items() if v}
        stage_t, peak = rec["stage_t"], rec["peak_gib"]
        print(f"quickstart-full-random-720x480: stage seconds "
              f"{json.dumps(stage_t)}, peak GiB per stage {json.dumps(peak)},"
              f" {wall:.1f} s whole, on {smi}")
        for what, c in counts.items():
            print(f"quickstart {what}: launches "
                  f"{ {k: v for k, v in c.items() if v} }")
        print(f"quickstart launches over the run: {total}")
        for k in QS_TRIMAP_KERNELS:
            require(counts["trimap"].get(k, 0) > 0,
                    f"quickstart: kernel {k} was not launched in TriMap")
        for k in QS_FIELD_KERNELS:
            require(counts["field"].get(k, 0) > 0,
                    f"quickstart: kernel {k} was not launched in the field "
                    f"stage")
        require(set(stage_t) == {"1_keyframes", "2_trimap_x3",
                                 "3_preprocess", "4_field", "5a_render",
                                 "5b_eval", "total"},
                f"quickstart: stages {sorted(stage_t)}")
        _, metrics = rets["field"][0]
        m = {k: float(v) for k, v in metrics.items()}
        require(all(math.isfinite(v) for v in m.values()),
                f"quickstart: non-finite field metrics {m}")
        psnr = [r["psnr"] for r in rets["eval"][0]]
        require(len(psnr) == QS_FRAMES and all(math.isfinite(x)
                                               for x in psnr),
                f"quickstart: eval PSNRs {psnr[:4]}...")
        print(f"quickstart field: last step " + " ".join(
            f"{k}={v:.5g}" for k, v in m.items()) + f"; eval PSNR "
            f"{min(psnr):.2f}-{max(psnr):.2f} dB over {len(psnr)} views")

        # tests/test_quick_start_chain.py:41-77 at QS_FRAMES frames
        colors = np.load(os.path.join(dp, "seg", "colors.npy"))
        require(colors.ndim == 2 and colors.shape[1] == 3
                and not colors[0].any(), f"quickstart: colors {colors.shape}")
        for f in ("seg/0001.png", "normal/0001.png", "colors.npy",
                  "points3D.ply"):
            require(os.path.exists(os.path.join(dp, f)),
                    f"quickstart: no {f}")
        for kind in ("rgb", "seg", "normal"):
            require_files(os.path.join(dp, f"trimap_{kind}"), QS_FRAMES,
                          f"trimap {kind}", ".png")
        require_files(os.path.join(dp, "input"), QS_FRAMES, "input")
        for suffix in ("_s.npy", "_f.npy"):
            require_files(os.path.join(dp, "lang_features_dim3"), QS_FRAMES,
                          "lang_features_dim3", suffix)
        require_files(os.path.join(dp, "camera"), QS_FRAMES, "camera")
        require_files(os.path.join(dp, "lang_features"), QS_FRAMES,
                      "lang_features")
        out = os.path.join(dp, "output")
        require(os.path.exists(os.path.join(
            out, "point_cloud", f"iteration_{QS_ITERS}", "point_cloud.ply")),
            "quickstart: no field snapshot")
        pose = np.load(os.path.join(out, "pose", f"iter_{QS_ITERS}",
                                    "pose_optimized.npy"))
        require(pose.shape == (QS_FRAMES, 4, 4) and np.isfinite(pose).all(),
                f"quickstart: optimised poses {pose.shape}")
        require(os.path.exists(os.path.join(out, "pose", f"iter_{QS_ITERS}",
                                            "pose_org.npy")),
                "quickstart: no pose_org.npy")
        require_files(os.path.join(dp, "render_camera"), QS_FRAMES,
                      "render_camera")
        require(any(f.endswith("_render.png") for f in os.listdir(
            os.path.join(out, "renders", f"iteration_{QS_ITERS}"))),
            "quickstart: no render PNG")
        for d in ("renders_rgb", "renders_lang_npy", "renders_instance_npy"):
            require_files(os.path.join(out, "eval", d), QS_FRAMES, d)
        n_png = require_pngs(dp, {})
        print(f"quickstart contract: {QS_FRAMES} frames through every stage,"
              f" {n_png} PNGs decoded, {len(colors) - 1} objects")
    torch.cuda.empty_cache()
    return dict(stage_t=stage_t, peak=peak, launches=counts)


# ---- 29. view-parallel field step and the SP ring, two ranks -----------

VP_RANKS = 2
VP_WARM = 5                # single-view iterations before the step (Adam
                           # moments non-zero, so the step is continuous)
VP_IT = 600                # the step's flags: geometry + single/multi-view
# two ranks against one process on the same state, views and draws: the
# forward is the same; K2's float atomics and the gradient all-reduce sum
# in other orders, so each update differs at f32 rounding of its sums
VP_STEP_REL_RMS = 1e-3     # rel RMS of (new - old), per leaf
VP_STAT_REL_RMS = 1e-4     # the densify gradient norms
SP_LAYERS = 2              # of 42
SP_SEED = 7
# the ring's per-shard K9 outputs are rounded to bf16 and merged in f32;
# the reference runs one K9 (or, in the DiT, K5) over every key
RING_FWD_REL_RMS = 2 ** -7
RING_BWD_REL_RMS = 2 ** -6
SP_DIT_REL_RMS = 2 ** -6
RING_SHAPE = (1, 48, 17776, 64)


def vp_inputs(dev):
    """Phase 6's scene (200,000 points, 720x480, supervised by the render
    path's maps of the 100k-splat scene), VP_WARM single-view iterations,
    then the step at VP_IT's flags for views 0 and 1 with their draws, on
    the host: (step args, state, batches, samples, SH degree)."""
    arrays = scene(P, seed=0)
    st = gaussian_state(arrays)
    st = GaussianState(**{k: v.to(dev) for k, v in st.__dict__.items()})
    cams = cameras()
    maps = [m for _, m in render_all_views(st, cams, EXACT_CFG,
                                           sh_degree=3)]
    del st
    lang_dir = tempfile.mkdtemp()
    try:
        supervise(cams, maps, lang_dir)
        del maps
        tr = field_trainer(dev, cams, lang_dir)
        tr.train(iterations=VP_WARM)
        flags = phase_flags(VP_IT, tr.cfg)
        batches = [tr._camera_batch(i, flags) for i in range(VP_RANKS)]
        samples = [tr.draw_samples(flags) for _ in range(VP_RANKS)]
        args = (tr.cfg, flags, tr.rcfg, tr.proxy_cam, tr.scene_extent)
        host = dryrun._to((args, tr.state, batches, samples), "cpu")
        sh = tr.active_sh_degree
    finally:
        shutil.rmtree(lang_dir, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()
    return (*host, sh)


def parallel_rank(rank, world, store, dev, vp, dit_in, dit_ref):
    """One rank of phase 29 on ``dev`` (spawned; gloo mesh (data=world)):
    its view of the view-parallel field step (``vp``: the step's args,
    state, views, draws, SH degree), the SP_LAYERS-layer DiT under
    sequence_parallel, then the ring alone forward and backward at
    RING_SHAPE against flash_attention (K9 + K7) on the same seeded
    tensors."""
    from langscenex_tpu_torch.ops.flash_attention import sequence_parallel
    from langscenex_tpu_torch.ops.ring_attention import ring_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = rank_mesh(rank, world, store, world, 1, device=dev,
                     backend="gloo")
    res = {"vp": dryrun.field_step(mesh, *vp)}
    torch.cuda.empty_cache()

    def timed(fn):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, {
            k: v for k, v in _build.launch_counts.items() if v}

    dit = materialize(CogVideoXTransformer(TransformerConfig(
        num_layers=SP_LAYERS), device="meta"), torch.bfloat16, dev,
        torch.Generator(device=dev).manual_seed(SP_SEED))
    x, txt, tt = (torch.from_numpy(a).to(dev) for a in dit_in)
    with torch.no_grad(), sequence_parallel(mesh):
        out, res["dit_ms"], res["dit_launches"] = timed(
            lambda: dit(x.to(torch.bfloat16), txt.to(torch.bfloat16), tt))
    res["dit_rel_rms"] = rel_rms(out.float().cpu(), dit_ref)
    res["dit_finite"] = bool(torch.isfinite(out).all())
    del dit, out
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(SP_SEED + 1)
    q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, res["ref_fwd_ms"], _ = timed(lambda: flash_attention(*qkv))
    gref, res["ref_bwd_ms"], _ = timed(
        lambda: torch.autograd.grad(ref, qkv, do))
    qkv2 = [t.clone().requires_grad_() for t in (q, k, v)]
    got, res["ring_fwd_ms"], res["ring_fwd_launches"] = timed(
        lambda: ring_attention(*qkv2, mesh))
    ggot, res["ring_bwd_ms"], res["ring_bwd_launches"] = timed(
        lambda: torch.autograd.grad(got, qkv2, do))
    res["ring_fwd_rel_rms"] = rel_rms(got.detach().float(),
                                      ref.detach().float())
    res["ring_bwd_rel_rms"] = [rel_rms(a.float(), b.float())
                               for a, b in zip(ggot, gref)]
    res["ring_finite"] = bool(torch.isfinite(got).all()) and all(
        bool(torch.isfinite(g).all()) for g in ggot)
    res["peak_gib"] = gib(torch.cuda.max_memory_allocated(dev))
    return res


def phase_parallel(dev, smi: str) -> dict:
    """field-vp2-200k-720x480 and dit-sp2-2L-49x480x720: two ranks on the
    card over gloo (not a multi-card speed), against one process."""
    from langscenex_tpu_torch.parallel import dryrun as dr
    # ---- the one-process references -----------------------------------
    t0 = time.perf_counter()
    args, state, batches, samples, sh = vp_inputs(dev)
    print(f"field-vp2-200k-720x480: inputs (render, supervise, "
          f"{VP_WARM} warm-up iterations) {time.perf_counter() - t0:.1f} s")
    step = train_field.make_parallel_train_step(*dr._to(args, dev))
    on = dr._to((state, batches, samples), dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    one, one_m = step(*on, sh)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    one_launch = {k: v for k, v in _build.launch_counts.items() if v}
    one = dr._numpy(train_field.state_dict(one))
    del on
    torch.cuda.empty_cache()
    cfg = TransformerConfig(num_layers=SP_LAYERS)
    dit = materialize(CogVideoXTransformer(cfg, device="meta"),
                      torch.bfloat16, dev,
                      torch.Generator(device=dev).manual_seed(SP_SEED))
    pcfg = PipelineConfig()
    gen = torch.Generator(device=dev).manual_seed(SP_SEED + 2)
    x = torch.randn((1, pcfg.latent_frames, cfg.in_channels,
                     pcfg.latent_height, pcfg.latent_width), generator=gen,
                    device=dev)
    txt = torch.randn((1, 226, cfg.text_embed_dim), generator=gen,
                      device=dev)
    tt = torch.full((1,), 500, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = dit(x.to(torch.bfloat16), txt.to(torch.bfloat16), tt)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    ref_launch = {k: v for k, v in _build.launch_counts.items() if v}
    dit_in = tuple(a.cpu().numpy() for a in (x, txt, tt))
    dit_ref = ref.float().cpu()
    del dit, ref, x, txt
    torch.cuda.empty_cache()

    # ---- two ranks ------------------------------------------------------
    t0 = time.perf_counter()
    ranks = spawn(parallel_rank, VP_RANKS,
                  (dev, (args, state, batches, samples, sh), dit_in,
                   dit_ref), timeout=TP_TIMEOUT)
    print(f"phase 29: {VP_RANKS} ranks spawn to join "
          f"{time.perf_counter() - t0:.1f} s ({TP_NOTE})")
    old = dr._numpy(train_field.state_dict(state))
    worst = (0.0, "")
    for r, res in enumerate(ranks):
        vp = res["vp"]
        require(vp["metrics"] == ranks[0]["vp"]["metrics"],
                f"field-vp2: rank {r}'s metrics differ from rank 0's")
        st = vp["state"]
        for grp in ("splats", "poses", "app_ab"):
            for k, a, b, o in _vp_leaves(st, one, old, grp):
                if k.endswith("alive"):
                    require(np.array_equal(a, b), f"field-vp2: {k}")
                    continue
                e = rel_rms(torch.from_numpy(a - o), torch.from_numpy(b - o))
                worst = max(worst, (e, k))
        for k in ("denom", "denom_abs", "max_radii2D"):
            require(np.array_equal(st["stats"][k], one["stats"][k]),
                    f"field-vp2: densify {k} differs from one process")
        for k in ("xyz_gradient_accum", "xyz_gradient_accum_abs"):
            e = rel_rms(torch.from_numpy(st["stats"][k]),
                        torch.from_numpy(one["stats"][k]))
            require(e <= VP_STAT_REL_RMS, f"field-vp2: densify {k} rel RMS "
                    f"{e:.3e}")
        m = vp["metrics"]
        require(math.isfinite(m["total"]) and not m["pair_overflow"],
                f"field-vp2: rank {r} metrics {m}")
        print(f"field-vp2 rank {r}: step {vp['step_s'] * 1e3:.1f} ms, "
              f"gradient all-reduce {vp['reduce_s'] * 1e3:.1f} ms "
              f"({vp['reduce_s'] / vp['step_s']:.1%} of the step; "
              f"{TP_NOTE}); loss {m['total']:.6f}")
    print(f"field-vp2 vs one process holding both views ({one_ms:.1f} ms, "
          f"launches {one_launch}): loss {one_m['total'].item():.6f}, "
          f"worst update rel RMS {worst[0]:.3e} at {worst[1]} (bound "
          f"{VP_STEP_REL_RMS:g})")
    require(one_launch.get("blend_backward", 0) == 2 * VP_RANKS,
            f"field-vp2: one process launched K2 {one_launch}")
    require(worst[0] <= VP_STEP_REL_RMS, "field-vp2: the two-rank step "
            "differs from the one-process step beyond the bound")
    print(f"dit-sp2-2L-49x480x720: unsharded {SP_LAYERS}-layer forward "
          f"{ref_ms:.1f} ms, launches {ref_launch}")
    for r, res in enumerate(ranks):
        print(f"dit-sp2 rank {r}: SP forward {res['dit_ms']:.1f} ms, "
              f"launches {res['dit_launches']}, rel RMS vs unsharded K5 "
              f"{res['dit_rel_rms']:.3e} (bound {SP_DIT_REL_RMS:g})")
        print(f"ring {list(RING_SHAPE)} rank {r}: forward "
              f"{res['ring_fwd_ms']:.1f} ms (K9 whole {res['ref_fwd_ms']:.1f}"
              f" ms), launches {res['ring_fwd_launches']}, rel RMS "
              f"{res['ring_fwd_rel_rms']:.3e} (bound {RING_FWD_REL_RMS:g}); "
              f"backward {res['ring_bwd_ms']:.1f} ms (K7 whole "
              f"{res['ref_bwd_ms']:.1f} ms), launches "
              f"{res['ring_bwd_launches']}, dq/dk/dv rel RMS "
              + " ".join(f"{e:.3e}" for e in res["ring_bwd_rel_rms"])
              + f" (bound {RING_BWD_REL_RMS:g}); peak {res['peak_gib']:.2f} "
              f"GiB ({TP_NOTE}) on {smi}")
        want_dit = {"flash_attention_online": VP_RANKS * SP_LAYERS,
                    "ln_modulate": 2 * SP_LAYERS}
        require(res["dit_finite"] and res["ring_finite"],
                f"dit-sp2 rank {r}: non-finite output")
        require(res["dit_launches"] == want_dit, f"dit-sp2 rank {r}: "
                f"launches {res['dit_launches']}, expected {want_dit}")
        require(res["ring_fwd_launches"] == {
            "flash_attention_online": VP_RANKS}, f"ring rank {r}: forward "
            f"launches {res['ring_fwd_launches']}")
        require(res["ring_bwd_launches"] == {
            "flash_attention_backward": VP_RANKS}, f"ring rank {r}: "
            f"backward launches {res['ring_bwd_launches']}")
        require(res["dit_rel_rms"] <= SP_DIT_REL_RMS,
                f"dit-sp2 rank {r}: the SP forward differs")
        require(res["ring_fwd_rel_rms"] <= RING_FWD_REL_RMS,
                f"ring rank {r}: the forward differs")
        require(max(res["ring_bwd_rel_rms"]) <= RING_BWD_REL_RMS,
                f"ring rank {r}: the backward differs")
    return ranks[0]


def _vp_leaves(st, one, old, grp):
    """(key, two-rank, one-process, before) numpy leaves of ``grp``."""
    a, b, o = st[grp], one[grp], old[grp]
    if isinstance(a, dict):
        for k in a:
            if a[k] is not None:
                yield f"{grp}.{k}", a[k], b[k], o[k]
    else:
        yield grp, a, b, o


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", type=int,
                    choices=(22, 23, 24, 25, 26, 27, 28, 29, 30, 31),
                    default=None,
                    help="run phases 1, 2 and this phase only (no result "
                         "lines)")
    args = ap.parse_args(argv)
    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(verbose=True)          # prints ptxas registers / spills
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s) -> {_build.library_path()}")
    if args.phase == 22:
        phase_22(dev)
        print(smi)
        return 0
    if args.phase in (23, 24, 25):
        phase_23_25(dev, smi, (args.phase,))
        print(smi)
        return 0
    if args.phase in (26, 27):
        phase_26_27(dev, smi, (args.phase,))
        print(smi)
        return 0
    if args.phase == 28:
        phase_quickstart(dev, smi)
        print(smi)
        return 0
    if args.phase == 29:
        phase_parallel(dev, smi)
        print(smi)
        return 0
    if args.phase == 30:
        phase_knn(dev, {})
        print(smi)
        return 0
    if args.phase == 31:
        phase_bin_pairs(dev, {})
        print(smi)
        return 0

    # ---- 3. kernels vs plain versions at the slice's shapes --------------
    arrays = scene(P, seed=0)
    state = gaussian_state(arrays)
    results = {}
    phase_kernels(dev, GaussianState(**{
        k: v.to(dev) for k, v in state.__dict__.items()}), results)

    # ---- 4. main path ---------------------------------------------------
    cams = cameras()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.ply")
        save_ply(state, path)
        main = phase_main_path(dev, cams, path)
    err = compare_plain_view(dev, main["splats"], cams[0])
    print(f"main path: {P} splats, {W}x{H}, 14 channels + plane depth, "
          f"views {['%.3f ms' % t for t in main['view_ms']]}, "
          f"plain-path max err {err:.3e}")
    phase_profile(dev, main["splats"], cams[0])

    # ---- 6-8. training path --------------------------------------------
    with tempfile.TemporaryDirectory() as lang_dir:
        tcams = cameras()
        supervise(tcams, main["maps"], lang_dir)
        train = phase_train(dev, tcams, lang_dir)
        step_in = compare_plain_step(train["trainer"])
        phase_field_blend(dev, step_in.pop("blend"), results)
        phase_field_binning(dev, step_in.pop("binnings"), results)
        phase_train_profile(train["trainer"], step_in)
    train_launches = train["launches"]
    del train, step_in, main
    torch.cuda.empty_cache()

    # ---- 9-12. video diffusion, trimap-dit-5b-49x480x720 ----------------
    t0 = time.perf_counter()
    pipe, text, pcfg, aux = build_pipeline(
        device=dev, pcfg_overrides={"num_inference_steps": DIT_STEPS})
    dit = aux["dit"]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dit.parameters())
    print(f"build_pipeline: DiT {n_params / 1e9:.3f}B parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16), VAE "
          f"{sum(p.numel() for p in aux['vae'].parameters()) / 1e6:.1f}M, "
          f"{time.perf_counter() - t0:.2f} s")
    model_in, txt, tt = dit_inputs(dev, text, pcfg, torch.bfloat16)
    phase_dit_kernels(dev, dit, model_in, txt, tt, results)
    phase_dit_compare(dit, model_in, txt, tt)
    request = phase_request(dev, pipe, text, pcfg,
                            len(dit.transformer_blocks))
    phase_dit_profile(pipe, model_in, txt)
    tp_req = tp_request_reference(pipe, model_in, txt)
    del pipe, text, aux, dit, model_in, txt, tt
    torch.cuda.empty_cache()

    # ---- 13-15. LoRA fine-tune, lora-5b-49x480x720 ----------------------
    t0 = time.perf_counter()
    dit = ft_dit(dev, TransformerConfig(remat=True), torch.bfloat16)
    batch = ft_batch(dev, dit.cfg.text_embed_dim, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"LoRA base DiT: {sum(p.numel() for p in dit.parameters()) / 1e9:.3f}"
          f"B bf16 parameters, remat, {time.perf_counter() - t0:.2f} s")
    phase_k7(dev, dit, batch, results)
    lora_ref = compare_lora_grads(dev, dit, batch)
    lora = phase_lora(dev, dit, batch)
    profile(lambda: lora["step"](lora["state"], batch, lora["gen"]), 1,
            "one LoRA step, lora-5b-49x480x720")
    del dit, batch, lora["state"], lora["step"]
    torch.cuda.empty_cache()

    # ---- 16. full fine-tune, dit-ft-8L-49x480x720 -----------------------
    phase_ft(dev)
    torch.cuda.empty_cache()

    # ---- 17. K6 ---------------------------------------------------------
    phase_k6(dev, results)
    torch.cuda.empty_cache()

    # ---- 18-19. TP=2 request and LoRA step, two ranks on the card -------
    tp = phase_tp(dev, tp_req, lora_ref, [r["loss"] for r in lora["recs"]])
    torch.cuda.empty_cache()

    # ---- 20. exact attention, attention-exact-48x17776x64 ---------------
    exact = phase_exact(dev, results)

    # ---- 21. K13, attention-exp2-48x18432x64 and gather-640k-w24 ---------
    k13 = phase_k13(dev, results)
    torch.cuda.empty_cache()

    # ---- 30. K14, the 3D kNN selection at field-sem-720x480's shape -----
    phase_knn(dev, results)

    # ---- 31. K15, the pair enumeration at field-sem-720x480's shape -----
    phase_bin_pairs(dev, results)

    # ---- 22. the field stage through its CLI, field-e2e-200k-720x480 ----
    phase_22(dev)
    torch.cuda.empty_cache()

    # ---- 23-25. the VAE trainer, the T5-XXL encoder, auto-seg ------------
    phase_23_25(dev, smi)
    torch.cuda.empty_cache()

    # ---- 26-27. pose and language lifting ------------------------------
    phase_26_27(dev, smi)
    torch.cuda.empty_cache()

    # ---- 28. the four-stage chain, quickstart-full-random-720x480 --------
    t0 = time.perf_counter()
    phase_quickstart(dev, smi)
    print(f"phase 28: {time.perf_counter() - t0:.1f} s")

    # ---- 29. view-parallel field step and SP ring, two ranks -------------
    t0 = time.perf_counter()
    phase_parallel(dev, smi)
    print(f"phase 29: {time.perf_counter() - t0:.1f} s")

    launches = {**{k: train_launches[k] for k in RENDER_TRAIN_KERNELS
                   + BIN_FALLBACK_KERNELS},
                **{k: request["launches"][k] for k in DIT_KERNELS},
                "flash_attention_backward": lora["launches"],
                "flash_attention_bhtd": tp["launches"],
                "flash_attention_online": exact["flash_attention_online"],
                "flash_attention_h2": exact["flash_attention_h2"],
                "flash_attention_backward_split":
                    exact["flash_attention_backward"],
                **{k: k13[k] for k in K13_KERNELS},
                **{k: train_launches[k] for k in KNN_KERNELS}}
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=TPU_KERNELS[name], launches=launches[name],
                    **results[name])
               for name in RENDER_TRAIN_KERNELS + BIN_FALLBACK_KERNELS
               + DIT_KERNELS
               + TRAIN_DIT_KERNELS + TP_KERNELS + EXACT_KERNELS
               + K13_KERNELS + KNN_KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
