"""Field-construction training, port of the JAX ``train/field.py``.

Parity target: GaussianField.train (field_construction/gaussian_field.py:
113-560), in the JAX package's restructuring:

  - one step function per static phase-flag combination (:class:`StepFlags`);
    frozen groups are masked by zeroing their gradients
    (``train/optim.phase_grad_mask``), and a step differentiates only the
    leaves its update reads (:func:`trained_leaves`), as ``jit`` drops
    the dead gradients of a static phase;
  - camera-pose gradients flow by moving the splats with the learnable
    quat + t and rendering with an identity view matrix (the reference
    shim, gaussian_renderer/__init__.py:79-91);
  - densification runs between steps at the reference cadence on the
    fixed-capacity state;
  - densify screen-space gradients are taken with respect to a zero pixel
    offset and rescaled by (W/2, H/2) to the reference's NDC units; the
    exact per-splat |gradient| comes from the blend backward (kernel K2)
    as the gradient of a zero hook.

Port notes. PyTorch runs eagerly: a step is a function that renders,
takes ``torch.autograd.grad`` and applies the functional Adam of
``train/optim.py``; nothing is compiled. The random draws of a step (the
multi-view pixel permutation, the grouping and obj3d samples) and of
densification (the clone/split noise) are arguments, drawn by the trainer
from a ``torch.Generator``: the JAX package draws them from PRNG keys,
which no torch generator reproduces, so the parity tests inject JAX's
draws. The trainer picks views with the same numpy generator as the JAX
trainer. :func:`make_parallel_train_step` is the view-parallel step over
the ranks of a mesh's ``data`` axis. Spans (``utils/profiling.span``:
``field.iter``, ``field.step``, ``field.render``, ``field.loss.*``,
``field.backward``, ``field.optim``, ...) name the parts of an iteration
for a profiler; the counters ``field.grad_leaves`` and
``field.grad_leaves_skipped`` count a step's differentiated and detached
leaves.

The trainer's outputs under ``save_dir`` are the JAX package's: PLY and
pose snapshots, checkpoints, the training report's side-by-side PNGs and
the debug collage, with two deviations. The collage is a PNG,
``debug/{it:05d}_{name}.png``, where the JAX package writes a JPEG
(nothing reads it; the port writes no JPEG). A checkpoint is a
``torch.save`` of the state as nested dicts of tensors and ints
(:func:`state_dict`, saved by ``train/checkpoint.py``), written after the iteration's pair-cap check,
and it also holds what the next iteration needs besides the state: the
pair caps, the SH degree, the view stack and both generators, so a
resumed run continues as the uninterrupted one would have.

Deviation kept from the JAX package: in pose-optimised mode the all_map
plane channels are built consistently in the render camera frame (the
reference builds them with the nominal camera on already-moved means).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import losses as L
from ..ops.depth_normal import points_to_normals
from ..ops.projection import RasterCamera
from ..ops.quat import camera_from_tensor, quat_multiply, tensor_from_camera
from ..ops.rasterize import RasterConfig, RenderOutput, rasterize
from ..ops.transforms import projection_matrix
from ..scene.cameras import ZFAR, ZNEAR, Camera
from ..scene.gaussians import DensifyStats, GaussianState
from ..utils.config import OptimizationConfig
from ..utils.png import write_png
from ..utils.profiling import count, span
from .densify import densify_and_prune
from .multiview import multi_view_loss
from .optim import (PARAM_FIELDS, AdamState, make_app_optimizer,
                    make_pose_optimizer, make_splat_optimizer,
                    phase_grad_mask, splat_params, zero_moments_at)

log = logging.getLogger(__name__)

# sample sizes of the sampled losses (the JAX defaults)
GROUP_SAMPLES_LANG = 10_000       # loss_semantic_group num
GROUP_SAMPLES_INSTANCE = 1_000    # loss_instance_group num
OBJ3D_SAMPLES = 800               # loss_cls_3d sample_size


class StepFlags(NamedTuple):
    """Static loss gates for one step variant (phase schedule per
    gaussian_field.py:234-487)."""
    image: bool
    single_view: bool
    multiview: bool
    lang: bool
    instance: bool
    optim_pose: bool
    phase: str              # optimizer mask phase


def phase_flags(it: int, cfg: OptimizationConfig) -> StepFlags:
    """Map iteration -> flags (the reference's iteration gates)."""
    image = it < cfg.max_geo_iter
    single = (cfg.single_view_weight_from_iter < it
              < cfg.single_view_weight_end_iter) and image
    multi = (cfg.multi_view_weight_from_iter < it
             < cfg.multi_view_weight_end_iter) and image
    lang = cfg.lang_loss_start_iter <= it < cfg.instance_supervision_from_iter
    inst = it >= cfg.instance_supervision_from_iter
    if inst:
        phase = "instance"
    elif it >= cfg.max_geo_iter:
        phase = "semantic_only"
    else:
        phase = "semantic"
    return StepFlags(image=image, single_view=single, multiview=multi,
                     lang=lang, instance=inst,
                     optim_pose=cfg.optim_pose and phase == "semantic",
                     phase=phase)


class CameraBatch(NamedTuple):
    """Per-step inputs (one view + optional nearest view): tensors on the
    render device, indices as ints."""
    cam_idx: int                 # index into the pose table
    uid: int                     # index into the app table
    w2c: torch.Tensor            # [4,4] nominal world-to-cam
    gt_image: torch.Tensor       # [3,H,W]
    gt_gray: torch.Tensor        # [1,H,W]
    normal_prior: torch.Tensor   # [3,H,W] world-space prior
    normal_mask: torch.Tensor    # [H,W] bool
    lang_feat: torch.Tensor      # [3,H,W]
    lang_mask: torch.Tensor      # [H,W] bool
    seg: torch.Tensor            # [H,W] int64
    near_idx: int                # pose index of the nearest cam
    near_w2c: torch.Tensor       # [4,4]
    near_gt_gray: torch.Tensor   # [1,H,W]
    has_near: bool
    bg: torch.Tensor             # [3]


class StepSamples(NamedTuple):
    """The random draws of one step, each a prefix of a permutation, or
    None where the step's flags use no such draw."""
    mv_sel: Optional[torch.Tensor] = None     # [min(sample_num, H*W)] pixels
    group_idx: Optional[torch.Tensor] = None  # grouping-loss pixels
    obj_idx: Optional[torch.Tensor] = None    # [min(800, CAP)] splats


@dataclasses.dataclass
class TrainState:
    splats: GaussianState
    poses: torch.Tensor          # [Ncam,7] learnable quat + t (w2c)
    app_ab: torch.Tensor         # [Nimg,2] exposure affine
    splat_opt: AdamState
    pose_opt: AdamState
    app_opt: AdamState
    stats: DensifyStats
    step: int


def state_dict(state: TrainState) -> dict:
    """A TrainState as nested dicts of tensors and ints: splats, poses,
    exposure table, the three Adam states with the per-point multipliers,
    densify statistics and step."""
    def adam(a: AdamState) -> dict:
        return dict(count=a.count, mu=dict(a.mu), nu=dict(a.nu),
                    per_point_lr=a.per_point_lr)
    return dict(
        splats={f.name: getattr(state.splats, f.name)
                for f in dataclasses.fields(GaussianState)},
        poses=state.poses, app_ab=state.app_ab,
        splat_opt=adam(state.splat_opt), pose_opt=adam(state.pose_opt),
        app_opt=adam(state.app_opt),
        stats={f.name: getattr(state.stats, f.name)
               for f in dataclasses.fields(DensifyStats)},
        step=state.step)


def state_from_dict(d: dict, device: torch.device | str) -> TrainState:
    """Inverse of :func:`state_dict`, every tensor on ``device``."""
    def to(t):
        return None if t is None else t.to(device)

    def adam(a: dict) -> AdamState:
        return AdamState(count=a["count"],
                         mu={k: to(v) for k, v in a["mu"].items()},
                         nu={k: to(v) for k, v in a["nu"].items()},
                         per_point_lr=to(a["per_point_lr"]))
    return TrainState(
        splats=GaussianState(**{k: to(v) for k, v in d["splats"].items()}),
        poses=to(d["poses"]), app_ab=to(d["app_ab"]),
        splat_opt=adam(d["splat_opt"]), pose_opt=adam(d["pose_opt"]),
        app_opt=adam(d["app_opt"]),
        stats=DensifyStats(**{k: to(v) for k, v in d["stats"].items()}),
        step=d["step"])


def render_view(splats: GaussianState, pose: Optional[torch.Tensor],
                w2c: torch.Tensor, cam: RasterCamera, bg: torch.Tensor,
                sh_degree: int, include_feature: bool, return_plane: bool,
                mean2d_offset: Optional[torch.Tensor], rcfg: RasterConfig,
                mean2d_abs_hook: Optional[torch.Tensor] = None
                ) -> RenderOutput:
    """The render shim (gaussian_renderer/__init__.py:42-239). With
    ``pose`` (a [7] quat + t w2c tensor) the splats move into the camera
    frame and render with an identity view matrix, so gradients reach the
    pose; without it ``w2c`` is the view matrix."""
    opacity = splats.get_opacity()[:, 0] * splats.alive
    scales = splats.get_scaling()
    rot = splats.get_rotation()

    if pose is not None:
        rel = camera_from_tensor(pose)
        means = splats.xyz @ rel[:3, :3].T + rel[:3, 3]
        quats = quat_multiply(pose[None, :4] / torch.linalg.norm(pose[:4]),
                              rot)
        render_w2c = torch.eye(4, dtype=torch.float32, device=pose.device)
        eff_w2c = rel        # the true frame the rasterizer sees
    else:
        means = splats.xyz
        quats = rot
        render_w2c = w2c
        eff_w2c = w2c

    rcam = RasterCamera(w2c=render_w2c, proj=cam.proj, width=cam.width,
                        height=cam.height, tan_fovx=cam.tan_fovx,
                        tan_fovy=cam.tan_fovy)

    all_map = None
    if return_plane:
        cam_center = -(eff_w2c[:3, :3].T @ eff_w2c[:3, 3])
        global_normal = splats.get_normal(cam_center)
        local_normal = global_normal @ eff_w2c[:3, :3].T
        pts_in_cam = splats.xyz @ eff_w2c[:3, :3].T + eff_w2c[:3, 3]
        local_distance = torch.abs((local_normal * pts_in_cam).sum(-1))
        all_map = torch.cat([local_normal,
                             torch.ones_like(local_distance[:, None]),
                             local_distance[:, None]], -1)

    return rasterize(
        means, scales, quats, opacity, rcam, bg,
        shs=splats.get_features(), sh_degree=sh_degree,
        language_feature=splats.language_feature if include_feature else None,
        instance_feature=splats.instance_feature if include_feature else None,
        all_map=all_map, mean2d_offset=mean2d_offset,
        mean2d_abs_hook=mean2d_abs_hook, cfg=rcfg)


def _pix_rays(H: int, W: int, fx: float, fy: float, device) -> torch.Tensor:
    ix = torch.arange(W, dtype=torch.float32, device=device)
    iy = torch.arange(H, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(iy, ix, indexing="ij")
    return torch.stack([(gx - W * 0.5) / fx, (gy - H * 0.5) / fy,
                        torch.ones_like(gx)], -1)


def view_loss(cfg: OptimizationConfig, flags: StepFlags, rcfg: RasterConfig,
              proxy_cam: RasterCamera, sh_degree: int, alive: torch.Tensor,
              params: dict, poses: torch.Tensor, app_ab: torch.Tensor,
              m2d_off: torch.Tensor, batch: CameraBatch,
              samples: StepSamples,
              m2d_abs: Optional[torch.Tensor] = None):
    """The phase-gated loss of ONE view (the loss body of
    gaussian_field.py:234-487). Returns (total, (metrics, radii, observe,
    visible))."""
    H, W = proxy_cam.height, proxy_cam.width
    fx = W / (2 * proxy_cam.tan_fovx)
    fy = H / (2 * proxy_cam.tan_fovy)
    dev = batch.gt_image.device
    splats = GaussianState(alive=alive, **params)
    pose = poses[batch.cam_idx] if flags.optim_pose else None
    with span("field.render"):
        out = render_view(splats, pose, batch.w2c, proxy_cam, batch.bg,
                          sh_degree, include_feature=True,
                          return_plane=True, mean2d_offset=m2d_off,
                          rcfg=rcfg, mean2d_abs_hook=m2d_abs)
    metrics = {}
    total = torch.zeros((), device=dev)
    image = out.color
    eff_w2c = camera_from_tensor(pose) if pose is not None else batch.w2c

    if flags.image:
        with span("field.loss.image"):
            ssim_val = L.ssim(image, batch.gt_image)
            ssim_loss = 1.0 - ssim_val
            app = app_ab[batch.uid]
            app_image = torch.exp(app[0]) * image + app[1]
            l1 = torch.where(ssim_loss < 0.5,
                             L.l1_loss(app_image, batch.gt_image),
                             L.l1_loss(image, batch.gt_image))
            image_loss = ((1.0 - cfg.lambda_dssim) * l1
                          + cfg.lambda_dssim * ssim_loss)
            total = total + image_loss
            metrics["image_loss"] = image_loss
            metrics["ssim"] = ssim_val

            # min-scale flatness loss (gaussian_field.py:247-252)
            vis = out.visible & (out.radii > 0)
            # amin spreads the gradient over tied scales, as jnp.min does
            # (create_from_points makes every splat's three scales equal)
            min_scale = torch.amin(splats.get_scaling(), -1)
            n_vis = torch.clamp(vis.sum(), min=1)
            total = total + cfg.scale_loss_weight * torch.where(
                vis, min_scale, 0.0).sum() / n_vis

    if flags.single_view:
        with span("field.loss.normal"):
            # depth -> normal consistency (gaussian_field.py:255-283)
            pts = _pix_rays(H, W, fx, fy, dev) * out.plane_depth[..., None]
            depth_normal = points_to_normals(pts).permute(2, 0, 1)
            depth_normal = depth_normal * out.all_map[3].detach()[None]
            normal_ch = out.all_map[:3]
            if cfg.normal_optim:
                # StableNormal prior (:264-276): rendered and depth normals
                # rotated to world, compared with the prior by cosine
                Rcw = eff_w2c[:3, :3].T
                rn_world = torch.einsum("ij,jhw->ihw", Rcw, normal_ch)
                dn_world = torch.einsum("ij,jhw->ihw", Rcw, depth_normal)
                err = ((1.0 - _cos_hw(batch.normal_prior, rn_world))
                       + (1.0 - _cos_hw(batch.normal_prior, dn_world)))
                msum = torch.clamp(batch.normal_mask.sum(), min=1)
                nl = cfg.single_view_weight * torch.where(
                    batch.normal_mask, err, 0.0).sum() / msum
            else:
                iw = (1.0 - L.image_grad_weight(batch.gt_image))
                iw = (torch.clamp(iw, 0, 1) ** 2).detach()
                diff = (depth_normal - normal_ch).abs().sum(0)
                nl = cfg.single_view_weight * (
                    diff if cfg.wo_image_weight else iw * diff).mean()
            total = total + nl
            metrics["normal_loss"] = nl

    if flags.multiview:
        near_pose = (poses[batch.near_idx].detach() if flags.optim_pose
                     else None)
        with span("field.render_near"):
            near_out = render_view(
                splats, near_pose, batch.near_w2c, proxy_cam, batch.bg,
                sh_degree, include_feature=False, return_plane=True,
                mean2d_offset=None, rcfg=rcfg)
        with span("field.loss.multiview"):
            Kmat = torch.tensor([[fx, 0, W * 0.5], [0, fy, H * 0.5],
                                 [0, 0, 1.0]], dtype=torch.float32,
                                device=dev)
            near_eff = (camera_from_tensor(near_pose)
                        if near_pose is not None else batch.near_w2c)
            mv = multi_view_loss(
                samples.mv_sel, out.plane_depth, out.all_map[:3],
                out.all_map[4], near_out.plane_depth, batch.gt_gray,
                batch.near_gt_gray, eff_w2c, near_eff, Kmat,
                patch_size=cfg.multi_view_patch_size,
                pixel_noise_th=cfg.multi_view_pixel_noise_th,
                geo_weight=cfg.multi_view_geo_weight,
                ncc_weight=cfg.multi_view_ncc_weight,
                wo_geo_occ_aware=cfg.wo_use_geo_occ_aware,
                ncc_dense=cfg.multi_view_dense_ncc)
            if batch.has_near:
                total = total + (mv.geo_loss + mv.ncc_loss)
        metrics["geo_loss"] = mv.geo_loss
        metrics["ncc_loss"] = mv.ncc_loss

    if flags.lang or flags.instance:
        flat_seg = torch.where(batch.lang_mask, batch.seg, -1).reshape(-1)
    if flags.lang:
        with span("field.loss.lang"):
            m = batch.lang_mask[None].to(torch.float32)
            lang_loss = L.l1_loss(out.language * m, batch.lang_feat * m)
            total = total + lang_loss
            metrics["lang_loss"] = lang_loss
            if cfg.grouping_loss:
                gl = L.loss_semantic_group(samples.group_idx, flat_seg,
                                           out.language.reshape(3, -1).T)
                total = total + gl
                metrics["grouping_loss"] = gl
        if cfg.loss_obj_3d:
            with span("field.loss.knn"):
                ol = L.loss_cls_3d(samples.obj_idx, splats.xyz.detach(),
                                   splats.language_feature, cfg.reg3d_k,
                                   cfg.reg3d_lambda_val)
                total = total + ol
            metrics["obj3d_loss"] = ol

    if flags.instance:
        if cfg.grouping_loss:
            with span("field.loss.lang"):
                inst_flat = out.instance.reshape(3, -1).T
                lang_flat = out.language.detach().reshape(3, -1).T
                gl = L.loss_instance_group(samples.group_idx, flat_seg,
                                           inst_flat, lang_flat)
                total = total + gl
            metrics["ins_grouping_loss"] = gl
        if cfg.loss_obj_3d:
            with span("field.loss.knn"):
                ol = L.loss_cls_3d(samples.obj_idx, splats.xyz.detach(),
                                   splats.instance_feature, cfg.reg3d_k,
                                   cfg.reg3d_lambda_val)
                total = total + ol
            metrics["ins_obj3d_loss"] = ol

    metrics["total"] = total
    metrics["pair_overflow"] = out.pairs_overflowed.to(torch.float32)
    if out.k_overflowed is not None:
        metrics["k_overflow"] = out.k_overflowed.to(torch.float32)
    if out.num_pairs is not None:
        metrics["num_pairs"] = out.num_pairs.to(torch.float32)
    if out.num_big is not None:
        metrics["num_big"] = out.num_big.to(torch.float32)
    return total, (metrics, out.radii, out.out_observe, out.visible)


def tracks_densify_stats(cfg: OptimizationConfig, step: int) -> bool:
    """Whether the step at ``step`` adds to the densify statistics: before
    the geometry phase or densification ends. Only then does a step take
    the screen-space gradients."""
    return step < min(cfg.max_geo_iter, cfg.densify_until_iter)


def trained_leaves(cfg: OptimizationConfig, flags: StepFlags,
                   step: int) -> set:
    """The leaves whose gradients the step's update reads: the splat
    groups that ``phase_grad_mask`` lets through (asked of the mask itself,
    which passes a kept group's tensor on as it came), ``poses`` where the
    flags train the pose, ``app_ab`` where they train the exposure, and
    ``mean2d`` and ``mean2d_abs`` while the densify statistics are
    tracked. The step differentiates these alone (the reference's
    per-phase ``requires_grad``)."""
    probe = {k: torch.empty(0) for k in PARAM_FIELDS}
    kept = phase_grad_mask(flags.phase, probe)
    names = {k for k, g in kept.items() if g is probe[k]}
    if flags.optim_pose:
        names.add("poses")
    if flags.image:
        names.add("app_ab")
    if tracks_densify_stats(cfg, step):
        names |= {"mean2d", "mean2d_abs"}
    return names


def _step_leaves(state: "TrainState", trained: set, abs_hook: bool) -> dict:
    """The step's leaves, detached from the state: the splat groups,
    ``poses``, ``app_ab``, a zero ``mean2d`` offset and (``abs_hook``) a
    zero ``mean2d_abs`` hook. Those in ``trained`` require grad; the rest
    enter the loss as constants."""
    cap, dev = state.splats.capacity, state.splats.device
    leaves = dict(splat_params(state.splats), poses=state.poses,
                  app_ab=state.app_ab,
                  mean2d=torch.zeros((cap, 2), device=dev))
    if abs_hook:
        leaves["mean2d_abs"] = torch.zeros((cap, 2), device=dev)
    return {k: v.detach().requires_grad_(k in trained)
            for k, v in leaves.items()}


def _count_leaves(leaves: dict) -> None:
    """Count a step's differentiated and detached leaves (once a step)."""
    n = sum(v.requires_grad for v in leaves.values())
    count("field.grad_leaves", n)
    count("field.grad_leaves_skipped", len(leaves) - n)


def _leaf_grads(total: torch.Tensor, leaves: dict) -> dict:
    """d total / d leaf for the leaves that require grad; zeros for the
    others and for those the loss does not reach."""
    live = [k for k, v in leaves.items() if v.requires_grad]
    gs = torch.autograd.grad(total, [leaves[k] for k in live],
                             allow_unused=True) if live else ()
    got = dict(zip(live, gs))
    return {k: torch.zeros_like(v) if got.get(k) is None else got[k]
            for k, v in leaves.items()}


def loss_and_grads(cfg: OptimizationConfig, flags: StepFlags,
                   rcfg: RasterConfig, proxy_cam: RasterCamera,
                   state: "TrainState", batch: CameraBatch,
                   samples: StepSamples, sh_degree: int):
    """The phase-gated loss of one view and its gradients, in exact f32.
    Returns (total, metrics, radii, visible, grads): ``grads`` maps each
    splat parameter group, ``poses``, ``app_ab``, ``mean2d`` (the signed
    screen-space gradient, from a fresh zero offset) and ``mean2d_abs``
    (the per-splat sum of |screen-space gradient|, from the abs hook) to
    a tensor. Only :func:`trained_leaves` are differentiated: the others,
    and those the loss does not reach, get zeros."""
    trained = trained_leaves(cfg, flags, state.step)
    with L.exact_f32():
        leaves = _step_leaves(state, trained, abs_hook=True)
        params = {k: leaves[k] for k in PARAM_FIELDS}
        total, (metrics, radii, _, visible) = view_loss(
            cfg, flags, rcfg, proxy_cam, sh_degree, state.splats.alive,
            params, leaves["poses"], leaves["app_ab"], leaves["mean2d"],
            batch, samples, leaves["mean2d_abs"])
        with span("field.backward", adopts=True):
            grads = _leaf_grads(total, leaves)
    _count_leaves(leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, radii, visible, grads


def draw_step_samples(cfg: OptimizationConfig, flags: StepFlags, H: int,
                      W: int, capacity: int, gen: torch.Generator,
                      device) -> StepSamples:
    """One step's random draws for one view from ``gen``: the multi-view
    pixels, the grouping-loss pixels and the obj3d splats, each a prefix of
    a permutation, where the flags and the config use them."""
    def perm_prefix(n, k):
        return torch.randperm(n, generator=gen, device=device)[:min(k, n)]
    mv_sel = group_idx = obj_idx = None
    if flags.multiview:
        mv_sel = perm_prefix(H * W, cfg.multi_view_sample_num)
    if (flags.lang or flags.instance) and cfg.grouping_loss:
        group_idx = perm_prefix(H * W, GROUP_SAMPLES_LANG if flags.lang
                                else GROUP_SAMPLES_INSTANCE)
    if (flags.lang or flags.instance) and cfg.loss_obj_3d:
        obj_idx = perm_prefix(capacity, OBJ3D_SAMPLES)
    return StepSamples(mv_sel=mv_sel, group_idx=group_idx, obj_idx=obj_idx)


def _optimizers(cfg: OptimizationConfig, spatial_lr_scale: float):
    return (make_splat_optimizer(cfg, spatial_lr_scale),
            make_pose_optimizer(cfg), make_app_optimizer())


@torch.no_grad()
def _apply_update(cfg: OptimizationConfig, flags: StepFlags, txs,
                  state: TrainState, grads: dict, ndc_grad: torch.Tensor,
                  ndc_abs: torch.Tensor, radii: torch.Tensor,
                  upd_filter: torch.Tensor) -> TrainState:
    """The densify statistics (tracked before the geometry phase or
    densification ends), the phase-masked splat Adam step, and the pose and
    exposure steps where the flags train them."""
    splat_tx, pose_tx, app_tx = txs
    stats = state.stats
    if tracks_densify_stats(cfg, state.step):
        stats = stats.update(ndc_grad, ndc_abs, radii, upd_filter)
    params = splat_params(state.splats)
    with span("field.optim"):
        gs = phase_grad_mask(flags.phase, {k: grads[k] for k in params})
        new_params, splat_opt = splat_tx.update(gs, state.splat_opt, params)
        new_poses, pose_opt = state.poses, state.pose_opt
        if flags.optim_pose:
            p, pose_opt = pose_tx.update({"poses": grads["poses"]},
                                         state.pose_opt,
                                         {"poses": state.poses})
            new_poses = p["poses"]
        new_app, app_opt = state.app_ab, state.app_opt
        if flags.image:
            a, app_opt = app_tx.update({"app_ab": grads["app_ab"]},
                                       state.app_opt,
                                       {"app_ab": state.app_ab})
            new_app = a["app_ab"]
    return TrainState(
        splats=dataclasses.replace(state.splats, **new_params),
        poses=new_poses, app_ab=new_app, splat_opt=splat_opt,
        pose_opt=pose_opt, app_opt=app_opt, stats=stats,
        step=state.step + 1)


def make_train_step(cfg: OptimizationConfig, flags: StepFlags,
                    rcfg: RasterConfig, proxy_cam: RasterCamera,
                    spatial_lr_scale: float):
    """Build the single-view step for one flag combination:
    ``step(state, batch, samples, sh_degree) -> (new state, metrics)``.
    Metrics stay on the device (no host sync)."""
    txs = _optimizers(cfg, spatial_lr_scale)
    H, W = proxy_cam.height, proxy_cam.width

    def step_fn(state: TrainState, batch: CameraBatch, samples: StepSamples,
                sh_degree: int):
        _, metrics, radii, visible, grads = loss_and_grads(
            cfg, flags, rcfg, proxy_cam, state, batch, samples, sh_degree)
        # densify stats in the reference's NDC-gradient units
        # (backward.cu:663 ddelx_dx = 0.5*W); the abs channel is exact
        scale = torch.tensor([0.5 * W, 0.5 * H], device=radii.device)
        ndc_grad = grads["mean2d"] * scale
        ndc_abs = torch.maximum(ndc_grad.abs(), grads["mean2d_abs"] * scale)
        return _apply_update(cfg, flags, txs, state, grads, ndc_grad,
                             ndc_abs, radii, visible & (radii > 0)), metrics

    return step_fn


def make_parallel_train_step(cfg: OptimizationConfig, flags: StepFlags,
                             rcfg: RasterConfig, proxy_cam: RasterCamera,
                             spatial_lr_scale: float, mesh=None):
    """The view-parallel step over a mesh's ``data`` ranks, the counterpart
    of the JAX package's ``make_parallel_train_step`` (its ``jit`` with the
    CameraBatch leaves sharded over ``data`` and the state replicated):
    ``step(state, batches, samples, sh_degree) -> (new state, metrics)``
    where ``batches`` and ``samples`` are this rank's views (one
    :class:`CameraBatch` and :class:`StepSamples` each, equal counts on
    every rank).

    The loss is the mean over all the ranks' views of :func:`view_loss`.
    Each rank takes the gradients of the mean over its own views (of the
    splat groups, ``poses``, ``app_ab`` and the 2-D mean offsets, those
    in :func:`trained_leaves`; one view at a time) and averages them over
    ``data`` in one flat ``all_reduce_many_``; the densify statistics take
    the signed screen-space gradient's magnitude as their abs channel (as
    JAX's step, which has no abs hook), the radii max-reduced and the
    visibility any-reduced over every view. Every rank then applies the
    same update to its replica of the state, and the metrics are the means
    over all views. With ``mesh=None`` (or a mesh without a ``data``
    group) the one process holds every view: the step's own single-process
    reference."""
    txs = _optimizers(cfg, spatial_lr_scale)
    H, W = proxy_cam.height, proxy_cam.width
    group = mesh if mesh is not None and mesh.data_group is not None \
        else None
    n_data = group.n_data if group is not None else 1

    def step_fn(state: TrainState, batches: list, samples: list,
                sh_degree: int):
        if not batches or len(batches) != len(samples):
            raise ValueError(f"{len(batches)} views and {len(samples)} "
                             f"draws: give one StepSamples per view")
        dev = state.splats.device
        n_views = len(batches) * n_data
        trained = trained_leaves(cfg, flags, state.step)
        grads, metrics = None, {}
        radii = visible = None
        with L.exact_f32():
            for batch, smp in zip(batches, samples):
                leaves = _step_leaves(state, trained, abs_hook=False)
                params = {k: leaves[k] for k in PARAM_FIELDS}
                total, (m, r, _, vis) = view_loss(
                    cfg, flags, rcfg, proxy_cam, sh_degree,
                    state.splats.alive, params, leaves["poses"],
                    leaves["app_ab"], leaves["mean2d"], batch, smp)
                with span("field.backward", adopts=True):
                    g = _leaf_grads(total / n_views, leaves)
                grads = g if grads is None else {k: grads[k] + g[k]
                                                 for k in grads}
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v.detach()
                seen = vis & (r > 0)
                radii = r if radii is None else torch.maximum(radii, r)
                visible = seen if visible is None else visible | seen
        _count_leaves(leaves)
        names = sorted(metrics)
        mvec = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                            device=dev) for k in names])
        if group is not None:
            # each rank's share of the mean is already over n_views
            group.all_reduce_many_(list(grads.values()) + [mvec], "data")
            flags_t = torch.stack([radii.to(torch.int32),
                                   visible.to(torch.int32)])
            torch.distributed.all_reduce(
                flags_t, op=torch.distributed.ReduceOp.MAX,
                group=group.data_group)
            radii = flags_t[0].to(radii.dtype)
            visible = flags_t[1].bool()
        mvec = mvec / n_views
        scale = torch.tensor([0.5 * W, 0.5 * H], device=dev)
        ndc_grad = grads["mean2d"] * scale
        new_state = _apply_update(cfg, flags, txs, state, grads, ndc_grad,
                                  ndc_grad.abs(), radii, visible)
        return new_state, dict(zip(names, mvec.unbind()))

    return step_fn


def _cos_hw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity along the channels of [3,H,W] maps (gradient-safe
    at zero vectors)."""
    num = (a * b).sum(0)
    na = torch.sqrt(torch.clamp((a * a).sum(0), min=1e-16))
    nb = torch.sqrt(torch.clamp((b * b).sum(0), min=1e-16))
    return num / (na * nb)


class GaussianFieldTrainer:
    """Host-side trainer (the Python loop of gaussian_field.train):
    view shuffling, phase switching, densification cadence, the instance
    feature copy at the instance phase boundary, the SH degree ramp and
    adaptive pair-buffer sizing. Cameras share one resolution. Training
    runs on the device of ``splats``. ``confidence_lr`` [P,1] seeds the
    per-point Adam's multipliers (``pp_optimizer``)."""

    def __init__(self, cams: list[Camera], splats: GaussianState,
                 cfg: OptimizationConfig, scene_extent: float,
                 sh_degree_max: int = 3, rcfg: RasterConfig = RasterConfig(),
                 white_background: bool = False, seed: int = 42,
                 lang_dir: Optional[str] = None,
                 confidence_lr: Optional[torch.Tensor] = None):
        self.cams = cams
        self.cfg = cfg
        self.device = splats.device
        # training default: cap the pair list at 8x capacity with a 64k
        # floor; a step reports metrics['pair_overflow'] if a view exceeds
        # it and _grow_pair_caps resizes
        if rcfg.max_pairs is None:
            rcfg = dataclasses.replace(
                rcfg, max_pairs=max(8 * splats.capacity, 1 << 16))
        self.rcfg = rcfg
        self.max_pairs_ceiling = 32 * 1024 * 1024
        self._demand_hwm = 0.0
        self._last_cap_resize = 0
        self.scene_extent = scene_extent
        self.sh_degree_max = sh_degree_max
        self.lang_dir = lang_dir
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        cam0 = cams[0]
        dev = self.device
        self.proxy_cam = RasterCamera(
            w2c=torch.eye(4, device=dev), proj=torch.as_tensor(
                projection_matrix(ZNEAR, ZFAR, cam0.fovx, cam0.fovy),
                device=dev),
            width=cam0.width, height=cam0.height,
            tan_fovx=math.tan(cam0.fovx * 0.5),
            tan_fovy=math.tan(cam0.fovy * 0.5))
        self.bg = torch.tensor([1.0, 1.0, 1.0] if white_background
                               else [0.0, 0.0, 0.0], device=dev)

        # learnable pose table from the nominal extrinsics
        # (gaussian_model.init_RT_seq:238-247)
        poses = tensor_from_camera(torch.as_tensor(
            np.stack([c.w2c for c in cams]).astype(np.float32), device=dev))
        app_ab = torch.zeros((len(cams), 2), device=dev)
        self.state = TrainState(
            splats=splats, poses=poses, app_ab=app_ab,
            splat_opt=make_splat_optimizer(
                cfg, scene_extent, confidence_lr=confidence_lr).init(
                splat_params(splats)),
            pose_opt=make_pose_optimizer(cfg).init({"poses": poses}),
            app_opt=make_app_optimizer().init({"app_ab": app_ab}),
            stats=DensifyStats.zeros(splats.capacity, dev), step=0)

        self._steps = {}
        self._batch_cache = {}
        self._full_batch_cache = {}
        self._viewpoint_stack: list[int] = []
        self.active_sh_degree = 0

    # ---------------- data marshalling ----------------

    def _camera_arrays(self, ci: int) -> dict:
        """Device-cached per-camera tensors."""
        if ci in self._batch_cache:
            return self._batch_cache[ci]
        cam = self.cams[ci]
        img, gray = cam.load_image()
        H, W = img.shape[1:]
        normal_prior = normal_mask = None
        if self.cfg.normal_optim:
            try:
                normal_prior, normal_mask = cam.load_normal()
            except FileNotFoundError:
                pass
        if normal_prior is None:
            normal_prior, normal_mask = np.zeros_like(img), np.zeros((H, W),
                                                                     bool)
        lf = lm = seg = None
        if self.lang_dir:
            try:
                lf, lm, seg = cam.load_language_feature(self.lang_dir)
            except FileNotFoundError:
                pass
        if lf is None:
            lf, lm = np.zeros_like(img), np.zeros((H, W), bool)
            seg = np.full((H, W), -1, np.int64)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)
        arrs = dict(w2c=t(cam.w2c), gt_image=t(img), gt_gray=t(gray),
                    normal_prior=t(normal_prior),
                    normal_mask=t(normal_mask, torch.bool),
                    lang_feat=t(lf), lang_mask=t(lm, torch.bool),
                    seg=t(seg, torch.int64))
        self._batch_cache[ci] = arrs
        return arrs

    def _camera_batch(self, ci: int, flags: StepFlags) -> CameraBatch:
        cam = self.cams[ci]
        if flags.multiview and cam.nearest_id:
            ni = int(self.rng.choice(cam.nearest_id))
            has_near = True
        else:
            ni, has_near = ci, False
        key = (ci, ni)
        hit = self._full_batch_cache.get(key)
        if hit is not None:
            return hit
        a = self._camera_arrays(ci)
        na = self._camera_arrays(ni) if has_near else a
        batch = CameraBatch(cam_idx=ci, uid=cam.uid, near_idx=ni,
                            near_w2c=na["w2c"], near_gt_gray=na["gt_gray"],
                            has_near=has_near, bg=self.bg, **a)
        self._full_batch_cache[key] = batch
        return batch

    def draw_samples(self, flags: StepFlags) -> StepSamples:
        """This step's random draws, from the trainer's generator."""
        return draw_step_samples(self.cfg, flags, self.proxy_cam.height,
                                 self.proxy_cam.width,
                                 self.state.splats.capacity, self.gen,
                                 self.device)

    def _get_step(self, flags: StepFlags):
        if flags not in self._steps:
            self._steps[flags] = make_train_step(
                self.cfg, flags, self.rcfg, self.proxy_cam,
                self.scene_extent)
        return self._steps[flags]

    def _grow_pair_caps(self, metrics) -> None:
        """Adaptive pair-buffer growth: when a step reports truncation,
        resize max_pairs to 1.25x the true demand (binning reports it in
        num_pairs), or double the big-splat register when that overflowed
        (see the JAX trainer)."""
        if float(metrics.get("k_overflow", 0.0)) > 0:
            nb = float(metrics.get("num_big", 0.0))
            new_b = max(2 * self.rcfg.big_splats, int(1.25 * nb))
            self.rcfg = dataclasses.replace(self.rcfg, big_splats=new_b)
            self._steps.clear()
            log.warning("big-splat register overflowed: growing big_splats "
                        "to %d", new_b)
            if float(metrics.get("num_pairs", 0.0)) <= \
                    float(self.rcfg.max_pairs or 0):
                return
        mp = self.rcfg.max_pairs
        if mp is None:
            return
        grid_x = -(-self.proxy_cam.width // self.rcfg.tile_w)
        grid_y = -(-self.proxy_cam.height // self.rcfg.tile_h)
        P = int(self.state.splats.capacity)
        natural = min(P * grid_x * grid_y, self.max_pairs_ceiling)
        npairs = float(metrics.get("num_pairs", 0.0))
        new_mp = min(max(2 * mp, int(1.25 * npairs)), natural)
        if new_mp > mp:
            self.rcfg = dataclasses.replace(self.rcfg, max_pairs=new_mp)
            self._steps.clear()
            log.warning("pair list overflowed (demand %d): growing "
                        "max_pairs to %d", int(npairs), new_mp)
        else:
            log.warning("pair list overflowed at the hard ceiling "
                        "(max_pairs=%s): renders truncated", mp)

    def _maybe_shrink_pair_cap(self, it: int) -> None:
        """Shrink max_pairs toward the observed demand high-water mark
        (factor-2 hysteresis, 500-iteration cooldown; the mark spans every
        view seen since the last resize)."""
        mp = self.rcfg.max_pairs
        hwm = self._demand_hwm
        if hwm <= 0 or it - self._last_cap_resize < 500:
            return
        target = max(int(1.5 * hwm), 1 << 16)
        target = ((target + 127) // 128) * 128
        if target * 2 > mp:
            return
        self.rcfg = dataclasses.replace(self.rcfg, max_pairs=target)
        self._steps.clear()
        self._last_cap_resize = it
        self._demand_hwm = 0.0
        log.info("pair demand HWM %d far below cap %d: shrinking max_pairs "
                 "to %d", int(hwm), mp, target)

    def poses_as_matrices(self, poses=None) -> np.ndarray:
        """[N,7] learnable quat + t -> [N,4,4] w2c matrices ordered by
        colmap id (save_pose, gaussian_field.py:68-84)."""
        qt = self.state.poses if poses is None else torch.as_tensor(poses)
        mats = camera_from_tensor(qt.detach()).cpu().numpy()
        order = np.argsort([c.colmap_id for c in self.cams])
        return mats[order]

    # ---------------- outputs ----------------

    def save_pose_org(self, save_dir: str, save_iterations) -> None:
        """Nominal (pre-training) poses per save iteration
        (gaussian_field.py:141-144)."""
        nominal = tensor_from_camera(torch.as_tensor(
            np.stack([c.w2c for c in self.cams]).astype(np.float32)))
        for it in save_iterations:
            d = os.path.join(save_dir, f"pose/iter_{it}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, "pose_org.npy"),
                    self.poses_as_matrices(nominal))

    def save_snapshot(self, save_dir: str, it: int) -> None:
        """The PLY snapshot (with the language and instance channels) and
        the optimised poses of iteration ``it`` (gaussian_field.py:516-525)."""
        from ..scene.ply_io import save_ply
        save_ply(self.state.splats, os.path.join(
            save_dir, f"point_cloud/iteration_{it}/point_cloud.ply"))
        os.makedirs(os.path.join(save_dir, f"pose/iter_{it}"), exist_ok=True)
        np.save(os.path.join(save_dir, f"pose/iter_{it}/pose_optimized.npy"),
                self.poses_as_matrices())

    def save_checkpoint(self, save_dir: str, it: int) -> None:
        """``save_dir/chkpnt<it>``: ``{"field_state": state_dict(state),
        "trainer": ...}``, where ``trainer`` is what the next iteration
        needs besides the state: the pair caps and their bookkeeping, the
        SH degree, the view stack and the two generators (ints, floats,
        strings and tensors only)."""
        from .checkpoint import save_checkpoint
        save_checkpoint(save_dir, dict(
            field_state=state_dict(self.state), trainer=dict(
                max_pairs=self.rcfg.max_pairs,
                big_splats=self.rcfg.big_splats,
                demand_hwm=self._demand_hwm,
                last_cap_resize=self._last_cap_resize,
                active_sh_degree=self.active_sh_degree,
                viewpoint_stack=list(self._viewpoint_stack),
                numpy_rng=json.dumps(self.rng.bit_generator.state),
                torch_rng=self.gen.get_state())), it)

    def restore(self, path: str, iteration: Optional[int] = None) -> int:
        """Resume from ``path/chkpnt<it>`` (the latest, or ``iteration``)
        or from a ``chkpnt<it>`` file: the TrainState onto this trainer's
        device and the trainer's own state that :meth:`save_checkpoint`
        stored. Returns the iteration; train on from ``first_iteration =
        it + 1``."""
        from .checkpoint import restore_checkpoint
        payload, it = restore_checkpoint(path, iteration=iteration)
        self.state = state_from_dict(payload["field_state"], self.device)
        t = payload["trainer"]
        self.rcfg = dataclasses.replace(self.rcfg, max_pairs=t["max_pairs"],
                                        big_splats=t["big_splats"])
        self._steps.clear()
        self._demand_hwm = t["demand_hwm"]
        self._last_cap_resize = t["last_cap_resize"]
        self.active_sh_degree = t["active_sh_degree"]
        self._viewpoint_stack = list(t["viewpoint_stack"])
        self.rng.bit_generator.state = json.loads(t["numpy_rng"])
        self.gen.set_state(t["torch_rng"])
        return it

    @torch.no_grad()
    def _eval_render(self, ci: int, include_feature: bool,
                     return_plane: bool) -> RenderOutput:
        """Render camera ci with the nominal (not the optimised) pose and
        the current splats (the training_report contract,
        gaussian_field.py:562-565)."""
        with L.exact_f32():
            return render_view(self.state.splats, None,
                               self._camera_arrays(ci)["w2c"],
                               self.proxy_cam, self.bg,
                               self.active_sh_degree, include_feature,
                               return_plane, None, self.rcfg)

    def training_report(self, it: int, save_dir: str) -> dict:
        """test_iterations validation (gaussian_field.py:562-602): render
        the training cameras [5, 10, 15, 20, 25] (mod N) with the exposure
        affine, L1 and PSNR, and write render | gt side by side to
        ``save_dir/valid/{it}_{uid}.png``."""
        os.makedirs(os.path.join(save_dir, "valid"), exist_ok=True)
        idxs = [i % len(self.cams) for i in range(5, 30, 5)]
        l1_t, psnr_t = 0.0, 0.0
        for ci in idxs:
            out = self._eval_render(ci, False, False)
            a, b = self.state.app_ab[ci]
            image = torch.clamp(torch.exp(a) * out.color + b, 0.0, 1.0)
            gt = torch.clamp(self._camera_arrays(ci)["gt_image"], 0.0, 1.0)
            l1_t += float((image - gt).abs().mean())
            mse = float(((image - gt) ** 2).mean())
            psnr_t += -10.0 * math.log10(max(mse, 1e-12))
            side = torch.cat([image, gt], 2).cpu().numpy()
            write_png(os.path.join(save_dir, "valid",
                                   f"{it}_{self.cams[ci].uid}.png"),
                      (side.transpose(1, 2, 0) * 255).astype(np.uint8))
        l1_t /= len(idxs)
        psnr_t /= len(idxs)
        log.info("[ITER %d] Evaluating train: L1 %.5f PSNR %.3f", it, l1_t,
                 psnr_t)
        return {"l1": l1_t, "psnr": psnr_t}

    def debug_collage(self, it: int, ci: int, save_dir: str) -> None:
        """The 8-panel debug image (gaussian_field.py:342-378), as
        ``save_dir/debug/{it:05d}_{name}.png``: row 0 gt | render |
        rendered normal | distance, row 1 image weight | plane depth |
        depth normal | normal prior."""
        from ..ops.depth_normal import normal_from_depth
        from ..utils.colormaps import apply_colormap, normalize

        os.makedirs(os.path.join(save_dir, "debug"), exist_ok=True)
        cam = self.cams[ci]
        arrs = self._camera_arrays(ci)
        out = self._eval_render(ci, False, True)

        def u8(chw):
            x = np.clip(np.asarray(chw), 0, 1)
            return (x.transpose(1, 2, 0) * 255).astype(np.uint8)

        def cmap_u8(x):
            return (apply_colormap(np.asarray(x)) * 255).astype(np.uint8)

        def host(t):
            return t.detach().cpu().numpy()

        depth = out.plane_depth
        with L.exact_f32():
            dn = host(normal_from_depth(depth, torch.as_tensor(
                cam.K(), device=depth.device)))
        w2c = host(arrs["w2c"])
        dn_world = dn @ w2c[:3, :3]                       # cam -> world rows
        row0 = np.concatenate([
            u8(host(arrs["gt_image"])), u8(host(out.color)),
            u8((host(out.all_map[:3]) + 1.0) * 0.5),
            cmap_u8(normalize(host(out.all_map[4])))], axis=1)
        row1 = np.concatenate([
            cmap_u8(host(L.image_grad_weight(arrs["gt_image"]))),
            cmap_u8(normalize(host(depth))),
            ((np.clip(dn_world, -1, 1) + 1) * 0.5 * 255).astype(np.uint8),
            u8((host(arrs["normal_prior"]) + 1.0) * 0.5)], axis=1)
        name = cam.image_name or str(cam.uid)
        write_png(os.path.join(save_dir, "debug", f"{it:05d}_{name}.png"),
                  np.concatenate([row0, row1], axis=0))

    # ---------------- main loop ----------------

    def _iteration(self, it: int, save_dir, save_iterations, test_iterations,
                   collage_interval: int) -> dict:
        """Iteration ``it`` of :meth:`train` up to its pair-cap check: the
        phase flags, the view and draws, the step, densification, the
        snapshots and the check. Returns the step's metrics."""
        cfg = self.cfg
        if it % 100 == 0 and self.active_sh_degree < self.sh_degree_max:
            self.active_sh_degree += 1

        flags = phase_flags(it, cfg)

        # instance-phase boundary: copy semantic -> instance features
        # (gaussian_field.py:469-471)
        if it == cfg.instance_supervision_from_iter:
            s = self.state.splats
            self.state.splats = dataclasses.replace(
                s, instance_feature=s.language_feature.clone())

        with span("field.batch"):
            if not self._viewpoint_stack:
                self._viewpoint_stack = list(range(len(self.cams)))
            ci = self._viewpoint_stack.pop(
                int(self.rng.integers(len(self._viewpoint_stack))))
            batch = self._camera_batch(ci, flags)
            samples = self.draw_samples(flags)
        step = self._get_step(flags)
        with span("field.step"):
            self.state, metrics = step(self.state, batch, samples,
                                       self.active_sh_degree)

        # densification (gaussian_field.py:528-535)
        if (cfg.densify_from_iter < it
                < min(cfg.max_geo_iter, cfg.densify_until_iter)
                and it % cfg.densification_interval == 0):
            with span("field.densify"):
                size_th = 20 if it > cfg.opacity_reset_interval else None
                noise = torch.randn((self.state.splats.capacity, 3),
                                    generator=self.gen, device=self.device)
                res = densify_and_prune(noise, self.state.splats,
                                        self.state.stats, cfg,
                                        self.scene_extent, size_th)
                self.state.splats = res.state
                self.state.stats = res.stats
                self.state.splat_opt = zero_moments_at(self.state.splat_opt,
                                                       res.written_slots)

        if save_dir and it in set(save_iterations):
            self.save_snapshot(save_dir, it)
        if save_dir and it in set(test_iterations):
            self.training_report(it, save_dir)
        if save_dir and collage_interval and it % collage_interval == 0:
            self.debug_collage(it, ci, save_dir)

        # overflow check: every 10 iterations while densification and
        # scale dynamics are active, every 100 after (one device fetch)
        check_every = 10 if it <= cfg.densify_until_iter else 100
        if it % check_every == 0:
            with span("field.check"):
                if float(metrics["pair_overflow"]) > 0:
                    self._grow_pair_caps(metrics)
                    self._demand_hwm = 0.0
                    self._last_cap_resize = it
                elif self.rcfg.max_pairs is not None:
                    self._demand_hwm = max(
                        self._demand_hwm,
                        float(metrics.get("num_pairs", 0.0)))
                    self._maybe_shrink_pair_cap(it)
        return metrics

    def train(self, iterations: Optional[int] = None, log_every: int = 0,
              callback=None, save_dir: Optional[str] = None,
              save_iterations=(), checkpoint_iterations=(),
              test_iterations=(), collage_interval: int = 0,
              first_iteration: int = 1):
        """Main loop over iterations ``first_iteration..iterations``. With
        ``save_dir``: PLY and pose snapshots at ``save_iterations``,
        checkpoints at ``checkpoint_iterations``, the training report at
        ``test_iterations`` and the debug collage every
        ``collage_interval`` iterations (gaussian_field.py:516-549)."""
        cfg = self.cfg
        iterations = iterations or cfg.iterations
        metrics = {}
        ema_loss = 0.0
        for it in range(first_iteration, iterations + 1):
            with span("field.iter"):
                metrics = self._iteration(it, save_dir, save_iterations,
                                          test_iterations, collage_interval)
            if save_dir and it in set(checkpoint_iterations):
                self.save_checkpoint(save_dir, it)
            if log_every and it % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                # EMA postfix (decay 0.4/0.6, gaussian_field.py:490-511)
                ema_loss = 0.4 * m.get("total", 0.0) + 0.6 * ema_loss
                n = int(self.state.splats.num_alive)
                print(f"[{it}] alive={n} ema={ema_loss:.5f} " +
                      " ".join(f"{k}={v:.4f}" for k, v in m.items()))
            if callback is not None:
                callback(it, self.state, metrics)
        return self.state, metrics
