#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render and training paths once on one
NVIDIA GPU.

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
     that step.
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
from langscenex_tpu_torch.ops.compaction import (compact_pairs,
                                                 compact_pairs_plain)
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
from langscenex_tpu_torch.train.field import (GaussianFieldTrainer,
                                              loss_and_grads, phase_flags,
                                              render_view)
from langscenex_tpu_torch.train.render_mode import render_all_views
from langscenex_tpu_torch.utils.config import OptimizationConfig

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

TPU_KERNELS = {
    "sort_pairs": "langscenex_tpu/ops/sort_engine.py:92 _local_kernel, "
                  "langscenex_tpu/ops/sort_engine.py:104 _cross_kernel",
    "compact_pairs": "langscenex_tpu/ops/compaction.py:121 _compact_kernel",
    "blend_forward": "langscenex_tpu/ops/rasterize_pallas.py:299 _fwd_kernel",
    "blend_backward": "langscenex_tpu/ops/rasterize_pallas.py:447 "
                      "_bwd_kernel",
}
SOURCES = {
    "sort_pairs": "langscenex_tpu_torch/csrc/sort.cu",
    "compact_pairs": "langscenex_tpu_torch/csrc/compaction.cu",
    "blend_forward": "langscenex_tpu_torch/csrc/blend.cu",
    "blend_backward": "langscenex_tpu_torch/csrc/blend_backward.cu",
}


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
    print(f"K4 sort_pairs 2^19 pairs: exact; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
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
                                 plain_ms=plain_ms)

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
    results["compact_pairs"] = dict(max_abs_err=compact_err, ms=ms,
                                    plain_ms=plain_ms)

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
    results["blend_forward"] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms)

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
    results["blend_backward"] = dict(max_abs_err=err2, ms=ms2,
                                     plain_ms=plain_ms2)


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
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the training "
                f"path")
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

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=TPU_KERNELS[name],
                    launches=train["launches"][name], **results[name])
               for name in ("blend_forward", "blend_backward",
                            "compact_pairs", "sort_pairs")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
