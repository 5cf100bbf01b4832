#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render, training and video-diffusion
paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print nvidia-smi's name and power limit;
  2. build: compile langscenex_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version at the slice's shapes,
     with CUDA-event times of both after warmup: K4 sort on a 2^19 pair
     stream and on 100k depth keys with ties and +inf rows (exact), K3
     compaction on the render scene's enumerated stream (exact), K1 blend
     forward and K2 blend backward (random upstream gradients, 14
     channels and the abs hook) on the render scene's identity-view tile
     lists (stated tolerances);
  4. render path: a 100k-splat SH-3 scene (random, seed 0) packed into a
     GaussianState, written to a PLY and read back onto the GPU, then
     render_all_views over 4 views at 720x480 with the exact raster
     config (32x32 tiles, 14 blended channels + plane depth); no overflow
     flag, finite outputs, one view held against the plain path on the
     card, and K1/K3/K4's launch counters > 0 for that run;
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
     through the plain path (use_pallas=False) on the same state, batch
     and draws: loss and per-group gradients within stated bounds;
  8. train profile: host wall time, device busy time and idle share of
     that step;
  9. configuration trimap-dit-5b-49x480x720 (the JAX package's full-scale
     TransformerConfig, VAEConfig and PipelineConfig; build_pipeline's
     random bf16 weights from seed 42): build_pipeline on the card, then
     K5 and K8 against
     their plain versions on the real layer-0 inputs (q, k, v
     [2, 17776, 48, 64], x [2, 17776, 3072]), with CUDA-event times of
     kernel, plain and (K5) scaled_dot_product_attention;
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
     for dq, dk, dv; CUDA-event times of kernel, plain and the backward of
     scaled_dot_product_attention), and K8 in f32 at [1, 17776, 3072];
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
     and exactly 16 K5, 8 K7 and 32 K8 (f32) launches per step.
Every kernel's bound is computed from this run's shapes: the larger of
its operations over the bf16 tensor-core peak and its bytes (each input
read once, each output written once) over the HBM rate.
Prints a JSON line of per-kernel results, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from langscenex_tpu_torch import _build
from langscenex_tpu_torch.ops.binning import enumerate_pairs
from langscenex_tpu_torch.models.cogvideox.pipeline import guided_prediction
from langscenex_tpu_torch.models.cogvideox.transformer import (
    CogVideoXTransformer, TransformerConfig)
from langscenex_tpu_torch.ops.compaction import (compact_pairs,
                                                 compact_pairs_plain)
from langscenex_tpu_torch.ops.flash_attention import (
    attention_bthd_backward_kernel, attention_bthd_backward_plain,
    attention_bthd_kernel, attention_bthd_plain)
from langscenex_tpu_torch.ops.ln_modulate import (ln_modulate,
                                                  ln_modulate_plain)
from langscenex_tpu_torch.ops.rasterize import RasterConfig, prepare_blend
from langscenex_tpu_torch.ops.rasterize_cuda import (blend_backward,
                                                     blend_backward_plain,
                                                     blend_forward,
                                                     blend_tiles_plain)
from langscenex_tpu_torch.ops.sort_engine import sort_pairs, sort_pairs_plain
from langscenex_tpu_torch.ops.transforms import focal2fov, fov2focal
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
from langscenex_tpu_torch.train.render_mode import render_all_views
from langscenex_tpu_torch.utils.config import OptimizationConfig
from langscenex_tpu_torch.video_inference import build_pipeline, materialize

P = 100_000
W, H = 720, 480
FOVX = 1.0
# the exact raster config of the JAX package's flagship render entry
EXACT_CFG = RasterConfig(tile_w=32, tile_h=32, max_tiles_per_splat=16,
                         chunk=128, max_splats_per_tile=1024, big_splats=64,
                         extra_tiers=((7168, 16), (1536, 32)),
                         rank_key_sort=True, max_pairs=520_000,
                         compact_sort=True, pallas_sort=True)
# Kernel K1 vs the plain blend: the kernel evaluates dx, dy relative to
# the tile centre and carries log T as a running sum, the plain version
# uses global pixel coordinates and a per-chunk cumsum. Near the T < 1e-4
# sticky stop that rounding can flip one pair's inclusion at a pixel, so
# the bounds are those of the JAX package's dense-occlusion blend test
# (accum 5e-4 + 1e-3 rel, T 1e-4, observe off by <= 2 at < 2% of splats).
BLEND_ATOL, BLEND_RTOL, T_ATOL = 5e-4, 1e-3, 1e-4
OBS_MAX_DIFF, OBS_MAX_FRAC = 2, 0.02
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
# is held to 1e-4; a dropped or doubled 64-key tile of near-uniform
# attention moves every l2 of its rows by about 64 / 17776 / ln 2 = 5e-3.
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
# the card's published peaks (H100 SXM): bf16 dense tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

TPU_KERNELS = {
    "sort_pairs": "langscenex_tpu/ops/sort_engine.py:92 _local_kernel, "
                  "langscenex_tpu/ops/sort_engine.py:104 _cross_kernel",
    "compact_pairs": "langscenex_tpu/ops/compaction.py:121 _compact_kernel",
    "blend_forward": "langscenex_tpu/ops/rasterize_pallas.py:299 _fwd_kernel",
    "blend_backward": "langscenex_tpu/ops/rasterize_pallas.py:447 "
                      "_bwd_kernel",
    "flash_attention": "langscenex_tpu/ops/flash_attention.py:991 "
                       "_attn_kernel_nomax_t4",
    "ln_modulate": "langscenex_tpu/ops/ln_modulate.py:31 _lnz_kernel",
    "flash_attention_backward": "langscenex_tpu/ops/flash_attention.py:360 "
                                "_bwd_fused_kernel_t",
}
SOURCES = {
    "sort_pairs": "langscenex_tpu_torch/csrc/sort.cu",
    "compact_pairs": "langscenex_tpu_torch/csrc/compaction.cu",
    "blend_forward": "langscenex_tpu_torch/csrc/blend.cu",
    "blend_backward": "langscenex_tpu_torch/csrc/blend_backward.cu",
    "flash_attention": "langscenex_tpu_torch/csrc/flash_attention.cu",
    "ln_modulate": "langscenex_tpu_torch/csrc/ln_modulate.cu",
    "flash_attention_backward":
        "langscenex_tpu_torch/csrc/flash_attention_backward.cu",
}
RENDER_TRAIN_KERNELS = ("blend_forward", "blend_backward", "compact_pairs",
                        "sort_pairs")
DIT_KERNELS = ("flash_attention", "ln_modulate")
TRAIN_DIT_KERNELS = ("flash_attention_backward",)


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


def check_blend(got, ref, what: str) -> float:
    """Hold (accum, T, observe) against the plain blend's; returns the
    max abs error over accum and T."""
    (a, t, o), (ra, rt, ro) = got, ref
    require(bool(torch.isfinite(a).all() and torch.isfinite(t).all()),
            f"{what}: non-finite output")
    torch.testing.assert_close(a, ra, atol=BLEND_ATOL, rtol=BLEND_RTOL)
    torch.testing.assert_close(t, rt, atol=T_ATOL, rtol=0.0)
    od = (o.long() - ro.long()).abs()
    frac = float((od > 0).float().mean())
    print(f"  {what}: max|accum| err {max_abs(a, ra):.3e}, max|T| err "
          f"{max_abs(t, rt):.3e}, observe max diff {int(od.max())} at "
          f"{frac:.4%} of splats")
    require(int(od.max()) <= OBS_MAX_DIFF and frac < OBS_MAX_FRAC,
            f"{what}: observe differs beyond bounds")
    return max(max_abs(a, ra), max_abs(t, rt))


def bad_rows(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of rows with an entry outside 2e-3 of its column's largest
    |ref| (or of the array's, for a 1-D or per-group tensor) + 5e-3
    relative."""
    got, ref = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    scale = ref.abs().amax(0, keepdim=True).clamp(min=1e-12)
    bad = ((got - ref).abs() > GRAD_ATOL_FRAC * scale
           + GRAD_RTOL * ref.abs()).any(1)
    return float(bad.float().mean())


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
    ms = cuda_ms(lambda: sort_pairs(key, val), 20)
    plain_ms = cuda_ms(lambda: sort_pairs_plain(key, val), 20)
    lib_ms = cuda_ms(lambda: torch.sort(key, stable=True), 20)
    sort_bound = bound(moved=2 * nbytes(key, val))
    print(f"K4 sort_pairs 2^19 pairs: exact; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.sort(stable=True) {lib_ms:.4f} "
          f"ms, bound {sort_bound['bound_ms']:.4f} ms "
          f"({sort_bound['bound_by']})")
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
    dms = cuda_ms(lambda: sort_pairs(dkey, sid), 20)
    dplain = cuda_ms(lambda: sort_pairs_plain(dkey, sid), 20)
    print(f"K4 sort_pairs 100k depth keys (ties, +inf): exact; kernel "
          f"{dms:.4f} ms, plain {dplain:.4f} ms")
    results["sort_pairs"] = dict(max_abs_err=sort_err, ms=ms,
                                 plain_ms=plain_ms, **sort_bound,
                                 library_ms=lib_ms)

    # ---- slice scene, identity view: the real K3 and K1 inputs ----------
    cam = cameras()[0]
    rcam = cam.raster_camera(device=dev)
    cfg = EXACT_CFG
    s = state_gpu
    opacity = s.get_opacity()[:, 0] * s.alive
    all_map = torch.cat([torch.nn.functional.normalize(s.xyz, dim=-1),
                         torch.ones_like(s.xyz[:, :1]),
                         s.xyz[:, 2:3]], -1)
    bi = prepare_blend(s.xyz, s.get_scaling(), s.get_rotation(), opacity,
                       rcam, shs=s.get_features(), sh_degree=3,
                       language_feature=s.language_feature,
                       instance_feature=s.instance_feature, all_map=all_map,
                       cfg=cfg)
    proc = bi.proc
    ps = enumerate_pairs(proc, bi.grid_x, bi.grid_y, cfg.max_tiles_per_splat,
                         cfg.max_pairs, cfg.big_splats, bi.cull,
                         cfg.extra_tiers, rank_key=True)
    require(ps.rank_key, "slice scene should take the rank-key path")
    sent = (bi.grid_x * bi.grid_y) << 22
    args = (ps.key, ps.sid, sent, ps.out_len, sent, P)
    got, ref = compact_pairs(*args), compact_pairs_plain(*args)
    require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
            "compact_pairs differs from the argsort reference")
    gs, rs = sort_pairs_plain(*got), sort_pairs_plain(*ref)
    require(torch.equal(gs[0], rs[0]) and torch.equal(gs[1], rs[1]),
            "compact_pairs differs after the sort")
    compact_err = pair_err(got, ref)
    ms = cuda_ms(lambda: compact_pairs(*args), 20)
    plain_ms = cuda_ms(lambda: compact_pairs_plain(*args), 20)
    n_valid = int((ps.key < sent).sum())
    print(f"K3 compact_pairs {ps.key.numel()} slots -> {ps.out_len} "
          f"({n_valid} valid): exact; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    results["compact_pairs"] = dict(
        max_abs_err=compact_err, ms=ms, plain_ms=plain_ms,
        **bound(moved=nbytes(ps.key, ps.sid, *got)), library_ms=None)

    # ---- K1 on the slice scene's lists (14 channels) ---------------------
    bargs = (bi.lists, proc.mean2d, proc.conic, bi.opacity, bi.channels,
             bi.grid_x, bi.grid_y)
    got = blend_forward(*bargs, cfg)
    ref = blend_tiles_plain(*bargs, cfg.tile_w, cfg.tile_h, cfg.chunk)
    err = check_blend(got, ref, "K1 blend_forward")
    ms = cuda_ms(lambda: blend_forward(*bargs, cfg), 10)
    plain_ms = cuda_ms(lambda: blend_tiles_plain(
        *bargs, cfg.tile_w, cfg.tile_h, cfg.chunk), 3, warmup=1)
    counts = bi.lists.tile_counts
    print(f"K1 blend_forward {bi.grid_x * bi.grid_y} tiles, "
          f"{int(counts.sum())} pairs (max {int(counts.max())}/tile), "
          f"{bi.channels.shape[1]} channels: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    lists = (bi.lists.point_list, bi.lists.tile_starts, counts)
    results["blend_forward"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(moved=nbytes(*lists, *bargs[1:5], *got)), library_ms=None)

    # ---- K2 on the same lists, K1's outputs, random upstream gradients --
    accum, T, _ = got
    grng = torch.Generator(device=dev).manual_seed(2)
    g_accum = torch.randn(accum.shape, generator=grng, device=dev)
    g_T = torch.randn(T.shape, generator=grng, device=dev)
    k2args = (*bargs[:5], accum, T, g_accum, g_T, bi.grid_x, bi.grid_y)
    got2 = blend_backward(*k2args, cfg)
    ref2 = blend_backward_plain(*k2args, cfg.tile_w, cfg.tile_h, cfg.chunk)
    require(tuple(got2.shape) == (P, 8 + bi.channels.shape[1]),
            "K2 output shape")
    require(bool(torch.isfinite(got2).all()), "K2: non-finite gradient")
    require(bool((got2[:, -2:] >= 0).all()), "K2: negative abs rows")
    bad = bad_rows(got2, ref2)
    err2 = max_abs(got2, ref2)
    ms2 = cuda_ms(lambda: blend_backward(*k2args, cfg), 10)
    plain_ms2 = cuda_ms(lambda: blend_backward_plain(
        *k2args, cfg.tile_w, cfg.tile_h, cfg.chunk), 2, warmup=1)
    print(f"K2 blend_backward same lists, {bi.channels.shape[1]} channels "
          f"+ abs hook: max abs err {err2:.3e} (largest |grad| "
          f"{float(ref2.abs().max()):.3e}), {bad:.4%} of splats outside the "
          f"per-column bound; kernel {ms2:.4f} ms, plain {plain_ms2:.4f} ms")
    require(bad <= K2_MAX_BAD, "K2 differs from the plain backward beyond "
            "bounds")
    results["blend_backward"] = dict(
        max_abs_err=err2, ms=ms2, plain_ms=plain_ms2,
        **bound(moved=nbytes(*lists, *bargs[1:5], accum, T, g_accum, g_T,
                             got2)), library_ms=None)


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
    for name in ("sort_pairs", "compact_pairs", "blend_forward"):
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
    plain_cfg = dataclasses.replace(EXACT_CFG, use_pallas=False)
    k = render_view(splats, None, w2c, rcam, bg, 3, True, True, None,
                    EXACT_CFG)
    r = render_view(splats, None, w2c, rcam, bg, 3, True, True, None,
                    plain_cfg)
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
        inst = m["instance_feature"][0]
        seg = torch.clamp(((inst + 1.0) * 0.5 * N_SEGMENTS).long(), 0,
                          N_SEGMENTS - 1)
        seg = torch.where(m["alpha"] > 0.5, seg, -1)
        np.save(os.path.join(lang_dir, cam.image_name + "_s.npy"),
                seg.cpu().numpy())


def phase_train(dev, cams, lang_dir: str) -> dict:
    """field-200k-720x480 through GaussianFieldTrainer.train in the phase
    windows; every step checked. Returns the trainer and the launch
    counts of the phase."""
    pts, cols = field_points(FIELD_P)
    t0 = time.perf_counter()
    splats = create_from_points(pts, cols, max_sh_degree=3,
                                capacity=FIELD_CAP, seed=0, device=dev)
    cfg = OptimizationConfig()
    tr = GaussianFieldTrainer(cams, splats, cfg, scene_extent=FIELD_EXTENT,
                              sh_degree_max=3, rcfg=RasterConfig(),
                              lang_dir=lang_dir)
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
    for name in RENDER_TRAIN_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                f"training path")
    first = [m["total"] for _, _, m in steps[:5]]
    last = [m["total"] for _, _, m in steps[15:20]]
    print(f"window 1-20 loss: first 5 steps mean {np.mean(first):.5f}, "
          f"last 5 steps mean {np.mean(last):.5f}")
    require(np.mean(last) < np.mean(first),
            "the loss did not fall over the first window")
    return dict(trainer=tr, launches=launches, windows=windows)


def compare_plain_step(tr, it: int = 600) -> dict:
    """One geometry + multi-view step's loss and gradients through the
    kernels and through the plain path, same state, batch and draws."""
    flags = phase_flags(it, tr.cfg)
    batch = tr._camera_batch(0, flags)
    require(batch.has_near, "the plain-step view has no near view")
    samples = tr.draw_samples(flags)
    plain = dataclasses.replace(tr.rcfg, use_pallas=False)
    _build.reset_launch_counts()
    k = loss_and_grads(tr.cfg, flags, tr.rcfg, tr.proxy_cam, tr.state,
                       batch, samples, tr.active_sh_degree)
    require(_build.launch_counts["blend_backward"] == 2,
            "the kernel step did not run K2 for both views")
    _build.reset_launch_counts()
    r = loss_and_grads(tr.cfg, flags, plain, tr.proxy_cam, tr.state, batch,
                       samples, tr.active_sh_degree)
    require(sum(_build.launch_counts.values()) == 0,
            "the plain step launched a kernel")
    lk, lr = float(k[0]), float(r[0])
    worst, bad_groups = 0.0, []
    for name in k[4]:
        bad = bad_rows(k[4][name], r[4][name])
        worst = max(worst, bad)
        if bad > STEP_MAX_BAD:
            bad_groups.append(name)
    print(f"train step vs plain path (it {it}): loss {lk:.6f} vs {lr:.6f}, "
          f"worst group {worst:.4%} of rows outside the gradient bound")
    require(abs(lk - lr) <= LOSS_RTOL * abs(lr), "step loss differs")
    require(not bad_groups, f"gradients differ: {bad_groups}")
    return dict(flags=flags, batch=batch, samples=samples)


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
    n_exp = B * H * T * T
    sfu_cycles = n_exp / (16 * torch.cuda.get_device_properties(
        dev).multi_processor_count)
    print(f"K5 flash_attention q,k,v {list(q.shape)} {q.dtype}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{lib_ms:.4f} ms, bound {attn_bound['bound_ms']:.4f} ms "
          f"({attn_bound['bound_by']}, {4.0 * B * H * T * T * D / 1e12:.3f} "
          f"TFLOP); {n_exp:.4g} exp2 = {sfu_cycles:.4g} SFU cycles per SM "
          f"at 16 ex2/clk")
    results["flash_attention"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, **attn_bound,
                                      library_ms=lib_ms)


@torch.inference_mode()
def phase_dit_compare(dit, model_in, txt, tt) -> None:
    """The full-width DiT through the kernels and through the plain path
    on the same weights and inputs."""
    Tt = txt.shape[1]
    joint, temb, rope = dit.embed(model_in, txt, tt)

    def two_blocks(kernels: bool):
        dit.set_use_kernels(kernels)
        x = joint
        for blk in dit.transformer_blocks[:2]:
            x = blk(x, temb, rope, Tt)
        return x

    k2, p2 = two_blocks(True), two_blocks(False)
    e2 = rel_rms(k2, p2)
    del k2, p2
    dit.set_use_kernels(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kout = dit(model_in, txt, tt)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    dit.set_use_kernels(False)
    t0 = time.perf_counter()
    pout = dit(model_in, txt, tt)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    dit.set_use_kernels(True)
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
    ms = cuda_ms(lambda: attention_bthd_backward_kernel(q, k, v, o, l2, do,
                                                        sc), 5)
    plain_ms = cuda_ms(lambda: attention_bthd_backward_plain(
        q, k, v, o, l2, do, sc), 1, warmup=1)
    # the library yardstick: SDPA's backward, as fwd+bwd minus fwd in the
    # [B, H, T, D] layout
    bq, bk, bv = (t.transpose(1, 2).clone().requires_grad_()
                  for t in (q, k, v))
    bdo = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_bwd():
        torch.autograd.grad(sdpa(bq, bk, bv), (bq, bk, bv), bdo)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: sdpa(bq, bk, bv), 5)
    lib_ms = cuda_ms(fwd_bwd, 5) - fwd_ms
    B, T, H, D = q.shape
    flops = 10.0 * B * H * T * T * D          # s, dp, dv, dk, dq products
    k7_bound = bound(flops=flops, moved=nbytes(q, k, v, o, l2, do, q, k, v))
    n_exp = B * H * T * T
    sfu = n_exp / (16 * torch.cuda.get_device_properties(
        dev).multi_processor_count)
    print(f"K7 flash_attention_backward: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention backward "
          f"{lib_ms:.4f} ms (fwd+bwd minus fwd {fwd_ms:.4f}), bound "
          f"{k7_bound['bound_ms']:.4f} ms ({k7_bound['bound_by']}, "
          f"{flops / 1e12:.3f} TFLOP); {n_exp:.4g} exp2 = {sfu:.4g} SFU "
          f"cycles per SM at 16 ex2/clk")
    results["flash_attention_backward"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, **k7_bound,
        library_ms=lib_ms)
    del bq, bk, bv, bdo, q, k, v, o, l2, do

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
            dit.set_use_kernels(kernels)
            _build.reset_launch_counts()
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
        dit.set_use_kernels(True)
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


def main() -> int:
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
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s) -> {_build.library_path()}")

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
    compare_lora_grads(dev, dit, batch)
    lora = phase_lora(dev, dit, batch)
    profile(lambda: lora["step"](lora["state"], batch, lora["gen"]), 1,
            "one LoRA step, lora-5b-49x480x720")
    del dit, batch, lora["state"], lora["step"]
    torch.cuda.empty_cache()

    # ---- 16. full fine-tune, dit-ft-8L-49x480x720 -----------------------
    phase_ft(dev)

    launches = {**{k: train_launches[k] for k in RENDER_TRAIN_KERNELS},
                **{k: request["launches"][k] for k in DIT_KERNELS},
                "flash_attention_backward": lora["launches"]}
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=TPU_KERNELS[name], launches=launches[name],
                    **results[name])
               for name in RENDER_TRAIN_KERNELS + DIT_KERNELS
               + TRAIN_DIT_KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
