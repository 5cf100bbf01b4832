"""Field-construction training, port of the JAX ``train/field.py``.

Parity target: GaussianField.train (field_construction/gaussian_field.py:
113-560), in the JAX package's restructuring:

  - one step function per static phase-flag combination (:class:`StepFlags`);
    frozen groups are masked by zeroing their gradients
    (``train/optim.phase_grad_mask``);
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
trainer. Not ported yet: checkpoints, PLY/pose snapshots, the training
report and the debug collage (the ``save_dir`` branches of
:meth:`GaussianFieldTrainer.train` raise ``NotImplementedError``), the
normal prior (``normal_optim``), the per-point Adam (``pp_optimizer``) and
the view-parallel multi-device step.

Deviation kept from the JAX package: in pose-optimised mode the all_map
plane channels are built consistently in the render camera frame (the
reference builds them with the nominal camera on already-moved means).
"""
from __future__ import annotations

import dataclasses
import logging
import math
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
from .densify import densify_and_prune
from .multiview import multi_view_loss
from .optim import (AdamState, make_app_optimizer, make_pose_optimizer,
                    make_splat_optimizer, phase_grad_mask, splat_params,
                    zero_moments_at)

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
    out = render_view(splats, pose, batch.w2c, proxy_cam, batch.bg,
                      sh_degree, include_feature=True, return_plane=True,
                      mean2d_offset=m2d_off, rcfg=rcfg,
                      mean2d_abs_hook=m2d_abs)
    metrics = {}
    total = torch.zeros((), device=dev)
    image = out.color
    eff_w2c = camera_from_tensor(pose) if pose is not None else batch.w2c

    if flags.image:
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
        min_scale = splats.get_scaling().min(-1).values
        n_vis = torch.clamp(vis.sum(), min=1)
        total = total + cfg.scale_loss_weight * torch.where(
            vis, min_scale, 0.0).sum() / n_vis

    if flags.single_view:
        # depth -> normal consistency (gaussian_field.py:255-283)
        pts = _pix_rays(H, W, fx, fy, dev) * out.plane_depth[..., None]
        depth_normal = points_to_normals(pts).permute(2, 0, 1)
        depth_normal = depth_normal * out.all_map[3].detach()[None]
        normal_ch = out.all_map[:3]
        if cfg.normal_optim:
            raise NotImplementedError("the normal prior (normal_optim) is "
                                      "not ported")
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
        near_out = render_view(
            splats, near_pose, batch.near_w2c, proxy_cam, batch.bg,
            sh_degree, include_feature=False, return_plane=True,
            mean2d_offset=None, rcfg=rcfg)
        Kmat = torch.tensor([[fx, 0, W * 0.5], [0, fy, H * 0.5],
                             [0, 0, 1.0]], dtype=torch.float32, device=dev)
        near_eff = (camera_from_tensor(near_pose) if near_pose is not None
                    else batch.near_w2c)
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
            ol = L.loss_cls_3d(samples.obj_idx, splats.xyz.detach(),
                               splats.language_feature, cfg.reg3d_k,
                               cfg.reg3d_lambda_val)
            total = total + ol
            metrics["obj3d_loss"] = ol

    if flags.instance:
        inst_flat = out.instance.reshape(3, -1).T
        lang_flat = out.language.detach().reshape(3, -1).T
        if cfg.grouping_loss:
            gl = L.loss_instance_group(samples.group_idx, flat_seg,
                                       inst_flat, lang_flat)
            total = total + gl
            metrics["ins_grouping_loss"] = gl
        if cfg.loss_obj_3d:
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


def loss_and_grads(cfg: OptimizationConfig, flags: StepFlags,
                   rcfg: RasterConfig, proxy_cam: RasterCamera,
                   state: "TrainState", batch: CameraBatch,
                   samples: StepSamples, sh_degree: int):
    """The phase-gated loss of one view and its gradients, in exact f32.
    Returns (total, metrics, radii, visible, grads): ``grads`` maps each
    splat parameter group, ``poses``, ``app_ab``, ``mean2d`` (the signed
    screen-space gradient, from a fresh zero offset) and ``mean2d_abs``
    (the per-splat sum of |screen-space gradient|, from the abs hook) to
    a tensor, zeros where the loss does not reach it."""
    cap = state.splats.capacity
    dev = state.splats.device
    with L.exact_f32():
        leaves = {k: v.detach().requires_grad_()
                  for k, v in splat_params(state.splats).items()}
        leaves["poses"] = state.poses.detach().requires_grad_()
        leaves["app_ab"] = state.app_ab.detach().requires_grad_()
        leaves["mean2d"] = torch.zeros((cap, 2), device=dev,
                                       requires_grad=True)
        leaves["mean2d_abs"] = torch.zeros((cap, 2), device=dev,
                                           requires_grad=True)
        params = {k: leaves[k] for k in splat_params(state.splats)}
        total, (metrics, radii, _, visible) = view_loss(
            cfg, flags, rcfg, proxy_cam, sh_degree, state.splats.alive,
            params, leaves["poses"], leaves["app_ab"], leaves["mean2d"],
            batch, samples, leaves["mean2d_abs"])
        gs = torch.autograd.grad(total, list(leaves.values()),
                                 allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), gs)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, radii, visible, grads


def make_train_step(cfg: OptimizationConfig, flags: StepFlags,
                    rcfg: RasterConfig, proxy_cam: RasterCamera,
                    spatial_lr_scale: float):
    """Build the single-view step for one flag combination:
    ``step(state, batch, samples, sh_degree) -> (new state, metrics)``.
    Metrics stay on the device (no host sync)."""
    splat_tx = make_splat_optimizer(cfg, spatial_lr_scale)
    pose_tx = make_pose_optimizer(cfg)
    app_tx = make_app_optimizer()
    H, W = proxy_cam.height, proxy_cam.width

    @torch.no_grad()
    def update(state: TrainState, metrics, radii, visible, grads):
        # densify stats in the reference's NDC-gradient units
        # (backward.cu:663 ddelx_dx = 0.5*W); the abs channel is exact
        scale = torch.tensor([0.5 * W, 0.5 * H], device=radii.device)
        ndc_grad = grads["mean2d"] * scale
        ndc_abs = torch.maximum(ndc_grad.abs(), grads["mean2d_abs"] * scale)
        stats = state.stats
        if state.step < min(cfg.max_geo_iter, cfg.densify_until_iter):
            stats = stats.update(ndc_grad, ndc_abs, radii,
                                 visible & (radii > 0))

        params = splat_params(state.splats)
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
            step=state.step + 1), metrics

    def step_fn(state: TrainState, batch: CameraBatch, samples: StepSamples,
                sh_degree: int):
        _, metrics, radii, visible, grads = loss_and_grads(
            cfg, flags, rcfg, proxy_cam, state, batch, samples, sh_degree)
        return update(state, metrics, radii, visible, grads)

    return step_fn


class GaussianFieldTrainer:
    """Host-side trainer (the Python loop of gaussian_field.train):
    view shuffling, phase switching, densification cadence, the instance
    feature copy at the instance phase boundary, the SH degree ramp and
    adaptive pair-buffer sizing. Cameras share one resolution. Training
    runs on the device of ``splats``."""

    def __init__(self, cams: list[Camera], splats: GaussianState,
                 cfg: OptimizationConfig, scene_extent: float,
                 sh_degree_max: int = 3, rcfg: RasterConfig = RasterConfig(),
                 white_background: bool = False, seed: int = 42,
                 lang_dir: Optional[str] = None):
        if cfg.normal_optim:
            raise NotImplementedError("the normal prior (normal_optim) is "
                                      "not ported")
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
            splat_opt=make_splat_optimizer(cfg, scene_extent).init(
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
        cfg = self.cfg
        H, W = self.proxy_cam.height, self.proxy_cam.width

        def perm_prefix(n, k):
            return torch.randperm(n, generator=self.gen,
                                  device=self.device)[:min(k, n)]
        mv_sel = group_idx = obj_idx = None
        if flags.multiview:
            mv_sel = perm_prefix(H * W, cfg.multi_view_sample_num)
        if (flags.lang or flags.instance) and cfg.grouping_loss:
            group_idx = perm_prefix(H * W, GROUP_SAMPLES_LANG if flags.lang
                                    else GROUP_SAMPLES_INSTANCE)
        if (flags.lang or flags.instance) and cfg.loss_obj_3d:
            obj_idx = perm_prefix(self.state.splats.capacity, OBJ3D_SAMPLES)
        return StepSamples(mv_sel=mv_sel, group_idx=group_idx,
                           obj_idx=obj_idx)

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

    # ---------------- main loop ----------------

    def train(self, iterations: Optional[int] = None, log_every: int = 0,
              callback=None, save_dir: Optional[str] = None,
              save_iterations=(), checkpoint_iterations=(),
              test_iterations=(), collage_interval: int = 0,
              first_iteration: int = 1):
        """Main loop over iterations ``first_iteration..iterations``.
        Snapshots, checkpoints, the training report and the debug collage
        (everything under ``save_dir``) are not ported yet."""
        if save_dir and (save_iterations or checkpoint_iterations
                         or test_iterations or collage_interval):
            raise NotImplementedError(
                "save_dir outputs (PLY/pose snapshots, checkpoints, report, "
                "collage) are not ported")
        cfg = self.cfg
        iterations = iterations or cfg.iterations
        metrics = {}
        ema_loss = 0.0
        for it in range(first_iteration, iterations + 1):
            if it % 100 == 0 and self.active_sh_degree < self.sh_degree_max:
                self.active_sh_degree += 1

            flags = phase_flags(it, cfg)

            # instance-phase boundary: copy semantic -> instance features
            # (gaussian_field.py:469-471)
            if it == cfg.instance_supervision_from_iter:
                s = self.state.splats
                self.state.splats = dataclasses.replace(
                    s, instance_feature=s.language_feature.clone())

            if not self._viewpoint_stack:
                self._viewpoint_stack = list(range(len(self.cams)))
            ci = self._viewpoint_stack.pop(
                int(self.rng.integers(len(self._viewpoint_stack))))

            batch = self._camera_batch(ci, flags)
            step = self._get_step(flags)
            self.state, metrics = step(self.state, batch,
                                       self.draw_samples(flags),
                                       self.active_sh_degree)

            # densification (gaussian_field.py:528-535)
            if (cfg.densify_from_iter < it
                    < min(cfg.max_geo_iter, cfg.densify_until_iter)
                    and it % cfg.densification_interval == 0):
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

            # overflow check: every 10 iterations while densification and
            # scale dynamics are active, every 100 after (one device fetch)
            check_every = 10 if it <= cfg.densify_until_iter else 100
            if it % check_every == 0:
                if float(metrics["pair_overflow"]) > 0:
                    self._grow_pair_caps(metrics)
                    self._demand_hwm = 0.0
                    self._last_cap_resize = it
                elif self.rcfg.max_pairs is not None:
                    self._demand_hwm = max(
                        self._demand_hwm,
                        float(metrics.get("num_pairs", 0.0)))
                    self._maybe_shrink_pair_cap(it)
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
