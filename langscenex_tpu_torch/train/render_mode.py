"""Render mode and eval mode, port of the JAX ``train/render_mode.py``
(entry_point modes ``render`` and ``eval``).

Parity targets: GaussianField.render (gaussian_field.py:605-865): load a
PLY snapshot, render every camera's RGB, depth, normal, language and
instance maps, TSDF-fuse the depths into a mesh, normalise the language
maps globally and write PCA colormaps, plus a second mesh coloured by the
language features; and GaussianField.eval (:870-971): per test camera,
freeze the splats and fit only that camera's pose against RGB L1 + SSIM
before rendering.

Port notes. Rendering and the TSDF fuse run on the splats' device; PNGs
are written through ``utils/png`` (no PIL) with the JAX package's 8-bit
conversion (``(x * 255).astype(uint8)``, a truncation). The pose fit's
``optax.adam(1e-3)`` is the functional Adam of ``train/optim`` with
optax's defaults, and the gradient reaches the pose through
``render_view``'s pose shim. ``render_result`` returns the fuse, mesh
extraction and clean-up times of each mesh (the JAX one returns None).
"""
from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..ops import losses as L
from ..ops.quat import tensor_from_camera
from ..ops.rasterize import RasterConfig
from ..ops.tsdf import (create_volume, extract_mesh, integrate,
                        post_process_mesh, save_mesh_ply)
from ..scene.cameras import Camera
from ..scene.gaussians import GaussianState
from ..utils.png import write_png
from .field import render_view
from .optim import GroupAdam


def pca_colormap(feat: np.ndarray) -> np.ndarray:
    """[C,H,W] features -> [3,H,W] PCA visualisation in [0,1]
    (cogvideox_interpolation/utils/colormaps.apply_pca_colormap:180:
    project to the top 3 principal components, 2-98 percentile
    normalise). numpy, as in the JAX package, so the SVD's signs agree."""
    C, H, W = feat.shape
    x = feat.reshape(C, -1).T
    x = x - x.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[:3].T
    lo = np.percentile(proj, 2, axis=0)
    hi = np.percentile(proj, 98, axis=0)
    proj = np.clip((proj - lo) / np.maximum(hi - lo, 1e-8), 0, 1)
    return proj.T.reshape(3, H, W)


def save_png(path: str, chw: np.ndarray) -> None:
    """[C,H,W] or [H,W] in [0,1] -> 8-bit PNG (gray for one channel)."""
    x = np.clip(np.asarray(chw), 0, 1)
    if x.ndim == 2:
        x = x[None]
    arr = (x.transpose(1, 2, 0) * 255).astype(np.uint8)
    write_png(path, arr[..., 0] if arr.shape[-1] == 1 else arr)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_all_views(splats: GaussianState, cams: List[Camera],
                     rcfg: RasterConfig, sh_degree: int = 3,
                     bg: Optional[torch.Tensor] = None,
                     include_feature: bool = True
                     ) -> Iterator[tuple[Camera, dict]]:
    """Yield (camera, dict of rendered maps) per camera, rendering on the
    splats' device. Besides the JAX package's maps (tensors here, in its
    [C,H,W] / [H,W] layouts) each dict carries the view's binning
    counters ``num_pairs``, ``pairs_overflowed`` and ``k_overflowed``."""
    device = splats.device
    bg = torch.zeros(3, device=device) if bg is None else bg
    rcam = cams[0].raster_camera(device=device)
    for cam in cams:
        w2c = torch.as_tensor(cam.w2c, device=device)
        out = render_view(splats, None, w2c, rcam, bg, sh_degree,
                          include_feature, True, None, rcfg)
        maps = {
            "render": out.color,
            "plane_depth": out.plane_depth,
            "rendered_normal": out.all_map[:3],
            "alpha": out.all_map[3],
            "num_pairs": out.num_pairs,
            "pairs_overflowed": out.pairs_overflowed,
            "k_overflowed": out.k_overflowed,
        }
        if include_feature:
            maps["language_feature"] = out.language
            maps["instance_feature"] = out.instance
        yield cam, maps


def render_result(splats: GaussianState, cams: List[Camera], out_dir: str,
                  rcfg: RasterConfig = RasterConfig(), sh_degree: int = 3,
                  voxel_size: float = 0.01, mesh: bool = True,
                  feature_mesh: bool = True) -> dict:
    """Render mode (gaussian_field.py:605-865): per view
    ``<name>_{render,depth,normal,language_pca}.png`` and
    ``<name>_language.npy``, then ``mesh.ply`` / ``mesh_post.ply`` and
    ``feature_mesh.ply`` / ``feature_mesh_post.ply``. Returns each mesh's
    times (s) and sizes by file name."""
    os.makedirs(out_dir, exist_ok=True)
    views, lang_maps = [], []
    with torch.no_grad():
        for cam, maps in render_all_views(splats, cams, rcfg, sh_degree):
            name = cam.image_name or f"{cam.uid:04d}"
            host = {k: maps[k].cpu().numpy() for k in
                    ("render", "plane_depth", "rendered_normal",
                     "language_feature")}
            save_png(os.path.join(out_dir, f"{name}_render.png"),
                     host["render"])
            d = host["plane_depth"]
            save_png(os.path.join(out_dir, f"{name}_depth.png"),
                     (d - d.min()) / max(d.max() - d.min(), 1e-8))
            save_png(os.path.join(out_dir, f"{name}_normal.png"),
                     (host["rendered_normal"] + 1) / 2)
            lang_maps.append((name, host["language_feature"]))
            np.save(os.path.join(out_dir, f"{name}_language.npy"),
                    host["language_feature"])
            views.append((cam, {k: maps[k] for k in
                                ("render", "plane_depth",
                                 "language_feature")}))

    # global min/max normalisation + PCA colormaps (:757-818)
    if lang_maps:
        stack = np.stack([m for _, m in lang_maps])
        lo, hi = stack.min(), stack.max()
        for name, m in lang_maps:
            save_png(os.path.join(out_dir, f"{name}_language_pca.png"),
                     pca_colormap((m - lo) / max(hi - lo, 1e-8)))

    stats = {}
    if mesh and views:
        stats["mesh.ply"] = _fuse_and_save(views, "render", out_dir,
                                           "mesh.ply", voxel_size)
    if feature_mesh and views and lang_maps:
        stats["feature_mesh.ply"] = _fuse_and_save(
            views, "language_feature", out_dir, "feature_mesh.ply",
            voxel_size)
    return stats


def _fuse_and_save(view_maps, color_key, out_dir, name, voxel_size) -> dict:
    """TSDF-fuse the plane depths with a chosen colour channel into a mesh
    (:707-740 and :836-865), written as ``name`` and ``<stem>_post.ply``
    (the floater filter's pass). Returns the seconds of the fuse, the
    extraction and the clean-up, and the vertex and face counts."""
    cams = [c for c, _ in view_maps]
    dev = view_maps[0][1]["plane_depth"].device
    centers = np.stack([c.cam_center for c in cams])
    lo = centers.min(0) - 2.0
    hi = centers.max(0) + 2.0
    dims = np.minimum(((hi - lo) / voxel_size).astype(int) + 1, 192)
    vs = float(np.max((hi - lo) / np.maximum(dims, 1)))
    t0 = time.perf_counter()
    vol = create_volume(lo, vs, tuple(int(d) for d in dims), device=dev)
    for cam, maps in view_maps:
        col = maps.get(color_key, maps["render"])
        vol = integrate(vol, maps["plane_depth"], cam.K(), cam.w2c, col[:3],
                        trunc=4 * vs)
    _sync(dev)
    t1 = time.perf_counter()
    verts, faces, cols = extract_mesh(vol)
    t2 = time.perf_counter()
    save_mesh_ply(os.path.join(out_dir, name), verts, faces, cols)
    pverts, pfaces, pcols = post_process_mesh(verts, faces, cols)
    stem, ext = os.path.splitext(name)
    save_mesh_ply(os.path.join(out_dir, stem + "_post" + ext),
                  pverts, pfaces, pcols)
    t3 = time.perf_counter()
    return dict(fuse_s=t1 - t0, extract_s=t2 - t1, post_s=t3 - t2,
                dims=tuple(int(d) for d in dims), vertices=len(verts),
                faces=len(faces), post_vertices=len(pverts),
                post_faces=len(pfaces))


def eval_result(splats: GaussianState, test_cams: List[Camera],
                out_dir: str, rcfg: RasterConfig = RasterConfig(),
                sh_degree: int = 3, pose_optim_iters: int = 100):
    """Eval mode with the reference's artifact tree
    (gaussian_field.py:892-971): ``out_dir/eval/{renders_rgb (render|gt
    side by side), renders_lang, renders_instance, renders_lang_npy,
    renders_instance_npy ([H,W,C] float npys), renders_depth,
    renders_depth_npy, renders_normal}`` per test view, after the
    pose-only fit. Returns the per-view results (camera, psnr, pose)."""
    base = os.path.join(out_dir, "eval")
    for d in ("renders_rgb", "renders_depth", "renders_depth_npy",
              "renders_normal", "renders_lang", "renders_instance",
              "renders_lang_npy", "renders_instance_npy"):
        os.makedirs(os.path.join(base, d), exist_ok=True)

    results = []
    for cam, pose, maps, psnr in eval_views(
            splats, test_cams, rcfg, sh_degree, pose_optim_iters):
        name = cam.image_name or f"{cam.uid:04d}"
        gt, _ = cam.load_image()
        save_png(os.path.join(base, "renders_rgb", name + ".png"),
                 np.concatenate([np.clip(maps["render"], 0, 1),
                                 np.clip(gt, 0, 1)], axis=2))
        for key, dpng, dnpy in (
                ("language_feature", "renders_lang", "renders_lang_npy"),
                ("instance_feature", "renders_instance",
                 "renders_instance_npy")):
            feat = maps[key]
            np.save(os.path.join(base, dnpy, name + ".npy"),
                    feat.transpose(1, 2, 0))
            save_png(os.path.join(base, dpng, name + ".png"),
                     pca_colormap((feat - feat.min())
                                  / max(feat.max() - feat.min(), 1e-8)))
        d = maps["plane_depth"]
        np.save(os.path.join(base, "renders_depth_npy", name + ".npy"), d)
        save_png(os.path.join(base, "renders_depth", name + ".png"),
                 (d - d.min()) / max(d.max() - d.min(), 1e-8))
        save_png(os.path.join(base, "renders_normal", name + ".png"),
                 (maps["rendered_normal"] + 1.0) * 0.5)
        results.append({"camera": name, "psnr": psnr,
                        "pose": pose.tolist()})
    return results


def eval_views(splats: GaussianState, test_cams: List[Camera],
               rcfg: RasterConfig = RasterConfig(), sh_degree: int = 3,
               pose_optim_iters: int = 100, lr: float = 1e-3,
               lambda_dssim: float = 0.2):
    """Novel-view eval protocol (gaussian_field.py:870-971): per test
    camera, fit ONLY its pose (splats frozen) against RGB L1 + SSIM, then
    render with features and planes. Yields (camera, fitted pose [7]
    quat + t as numpy, maps as numpy, psnr)."""
    dev = splats.device
    bg = torch.zeros(3, device=dev)
    eye = torch.eye(4, device=dev)
    proxy = test_cams[0].raster_camera(device=dev)
    tx = GroupAdam(lr_fn=lambda count: {"pose": lr})      # optax defaults

    def loss_fn(pose, gt):
        out = render_view(splats, pose, eye, proxy, bg, sh_degree, False,
                          False, None, rcfg)
        return ((1 - lambda_dssim) * L.l1_loss(out.color, gt)
                + lambda_dssim * (1 - L.ssim(out.color, gt)))

    for cam in test_cams:
        gt = torch.as_tensor(cam.load_image()[0], device=dev)
        pose = tensor_from_camera(torch.as_tensor(
            np.asarray(cam.w2c, np.float32), device=dev))
        opt = tx.init({"pose": pose})
        for _ in range(pose_optim_iters):
            with L.exact_f32():
                p = pose.detach().requires_grad_()
                (g,) = torch.autograd.grad(loss_fn(p, gt), [p])
            new, opt = tx.update({"pose": g}, opt, {"pose": pose})
            pose = new["pose"]
        with torch.no_grad(), L.exact_f32():
            out = render_view(splats, pose, eye, proxy, bg, sh_degree, True,
                              True, None, rcfg)
            mse = float(((out.color - gt) ** 2).mean())
        maps = {"render": out.color, "language_feature": out.language,
                "instance_feature": out.instance,
                "plane_depth": out.plane_depth,
                "rendered_normal": out.all_map[:3]}
        yield (cam, pose.cpu().numpy(),
               {k: v.cpu().numpy() for k, v in maps.items()},
               -10.0 * np.log10(max(mse, 1e-12)))
