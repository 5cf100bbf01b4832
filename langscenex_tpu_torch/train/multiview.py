"""Multi-view geometric consistency + patch-NCC photometric loss, port of
the JAX ``train/multiview.py``.

Parity target: the multi-view block of the training loop
(field_construction/gaussian_field.py:285-444) with its helpers
get_points_from_depth / get_points_depth_in_depth_map
(scene/gaussian_model.py:726-758), patch_offsets / patch_warp
(utils/graphics_utils.py:183-196) and lncc (utils/loss_utils.py:120-155).

As in the JAX package, ``sample_num`` pixels are taken from a random
permutation of ALL pixels and invalid ones get weight zero; the
permutation ``sel`` is an argument here (the trainer draws it from a
``torch.Generator``; the tests inject JAX's draw). Two NCC forms:

- ``ncc_dense=True`` (default): warp the near image into the reference
  frame once per pixel, each through its own plane homography, compute
  the windowed NCC densely with box sums, then gather the sampled
  centres. Equal to the patch form wherever the rendered plane is
  constant over a patch;
- ``ncc_dense=False``: the reference's literal form, a 7x7 patch gathered
  around every sampled centre from both images.

The small matrix products of the reprojection are written as explicit f32
sums, so TF32 never touches point coordinates (a 2^-10 relative error is
pixel-scale against the 1 px geometric threshold).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.interp import bilinear_sample_border
from ..ops.losses import lncc


class MultiViewOut(NamedTuple):
    geo_loss: torch.Tensor
    ncc_loss: torch.Tensor
    n_valid: torch.Tensor


def _apply(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts [N,3] @ M.T for a [3,3] M, as an explicit f32 sum."""
    return (pts[:, None, :] * M[None]).sum(-1)


def _pixel_grid(H: int, W: int, device, offset: float = 0.0):
    ix = torch.arange(W, dtype=torch.float32, device=device) - offset
    iy = torch.arange(H, dtype=torch.float32, device=device) - offset
    gy, gx = torch.meshgrid(iy, ix, indexing="ij")
    return gx, gy


def _box_sums(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 VALID window sums of an r-extended [H+2r, W+2r] array, as
    shifted-slice sums (an integral image would cancel catastrophically in
    f32 at image scale)."""
    k = 2 * r + 1
    H, W = x.shape[0] - 2 * r, x.shape[1] - 2 * r
    y = sum(x[i:i + H, :] for i in range(k))
    return sum(y[:, j:j + W] for j in range(k))


def _lncc_dense(ref: torch.Tensor, nea: torch.Tensor, r: int):
    """Windowed NCC map from r-extended [H+2r, W+2r] images (the formula
    and eps of ops.losses.lncc). Returns (ncc [H,W], mask [H,W])."""
    tps = (2 * r + 1) ** 2
    ref_sum = _box_sums(ref, r)
    nea_sum = _box_sums(nea, r)
    ref2_sum = _box_sums(ref * ref, r)
    nea2_sum = _box_sums(nea * nea, r)
    ref_nea_sum = _box_sums(ref * nea, r)
    ref_avg = ref_sum / tps
    nea_avg = nea_sum / tps
    cross = ref_nea_sum - nea_avg * ref_sum
    ref_var = ref2_sum - ref_avg * ref_sum
    nea_var = nea2_sum - nea_avg * nea_sum
    cc = cross * cross / (ref_var * nea_var + 1e-8)
    ncc = torch.clamp(1.0 - cc, 0.0, 2.0)
    return ncc, ncc < 0.9


def multi_view_loss(sel: torch.Tensor,
                    plane_depth: torch.Tensor,        # [H,W] view cam
                    rendered_normal: torch.Tensor,    # [3,H,W] camera frame
                    rendered_distance: torch.Tensor,  # [H,W]
                    near_plane_depth: torch.Tensor,   # [H,W]
                    gt_gray: torch.Tensor,            # [1,H,W]
                    near_gt_gray: torch.Tensor,       # [1,H,W]
                    view_w2c: torch.Tensor,           # [4,4]
                    near_w2c: torch.Tensor,           # [4,4]
                    K: torch.Tensor,                  # [3,3]
                    patch_size: int = 3,
                    pixel_noise_th: float = 1.0,
                    geo_weight: float = 0.03,
                    ncc_weight: float = 0.15,
                    wo_geo_occ_aware: bool = False,
                    compute_ncc: bool = True,
                    ncc_dense: bool = True) -> MultiViewOut:
    """``sel`` [S] are the sampled pixel indices (row-major, S <= H*W)."""
    H, W = plane_depth.shape
    dev = plane_depth.device
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    # ---- forward reprojection (gaussian_field.py:316-336)
    gx, gy = _pixel_grid(H, W, dev)
    rays = torch.stack([(gx - cx) / fx, (gy - cy) / fy,
                        torch.ones_like(gx)], -1)            # [H,W,3]
    pts_cam = rays * plane_depth[..., None]
    Rv, tv = view_w2c[:3, :3], view_w2c[:3, 3]
    Rn, tn = near_w2c[:3, :3], near_w2c[:3, 3]
    # x_w = Rv^T (x_cam - tv)
    pts_world = _apply(Rv.T, pts_cam.reshape(-1, 3) - tv)
    pts_near = _apply(Rn, pts_world) + tn

    # sample the nearest cam's depth at the projections (:337-341)
    proj_near = torch.stack([pts_near[:, 0] * fx / pts_near[:, 2] + cx,
                             pts_near[:, 1] * fy / pts_near[:, 2] + cy], -1)
    d_mask = ((proj_near[:, 0] > 0) & (proj_near[:, 0] < W)
              & (proj_near[:, 1] > 0) & (proj_near[:, 1] < H)
              & (pts_near[:, 2] > 0.1))
    map_z = bilinear_sample_border(near_plane_depth[None], proj_near)[0]

    # back-project with the nearest cam's surface depth and return (:343-355)
    pts_near_surf = pts_near / pts_near[:, 2:3] * map_z[:, None]
    pts_world2 = _apply(Rn.T, pts_near_surf - tn)
    pts_view2 = _apply(Rv, pts_world2) + tv
    proj_back = torch.stack([pts_view2[:, 0] * fx / pts_view2[:, 2] + cx,
                             pts_view2[:, 1] * fy / pts_view2[:, 2] + cy], -1)

    pixels = torch.stack([gx, gy], -1).reshape(-1, 2)
    diff = proj_back - pixels
    pixel_noise = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-16))

    if not wo_geo_occ_aware:
        d_mask = d_mask & (pixel_noise < pixel_noise_th)
        weights = (1.0 / torch.exp(pixel_noise)).detach()
    else:
        weights = torch.ones_like(pixel_noise)
    weights = torch.where(d_mask, weights, 0.0)

    n_valid = d_mask.sum()
    geo_loss = (geo_weight * (weights * pixel_noise).sum()
                / torch.clamp(n_valid, min=1))

    if not compute_ncc:
        return MultiViewOut(geo_loss=geo_loss,
                            ncc_loss=torch.zeros((), device=dev),
                            n_valid=n_valid)

    # ---- LNCC photometric loss (:385-444)
    take = sel.shape[0]
    sel_w = weights[sel]
    sel_pix = pixels[sel]
    R_rel = _apply(Rv, Rn)                                   # Rn @ Rv^T
    t_rel = -(R_rel * tv[None]).sum(-1) + tn
    Kinv = torch.linalg.inv(K)

    def homographies(n, d):
        """[N,3,3] K (R_rel - t n^T / d) K^-1 per plane (n [N,3], d [N])."""
        Hm = (R_rel[None] - t_rel[None, :, None] * n[:, None, :]
              / (d[:, None, None] + 1e-12))
        Hm = (K[None, :, :, None] * Hm[:, None, :, :]).sum(2)
        return (Hm[:, :, :, None] * Kinv[None, None, :, :]).sum(2)

    def warp(Hm, homo):
        w = (Hm * homo[..., None, :]).sum(-1)
        return w[..., :2] / (w[..., 2:] + 1e-10)

    if ncc_dense:
        # per-pixel plane homography at the pixel's own location, over an
        # r-extended grid so border windows see the same out-of-image warps
        # as the gathered patches (warped, THEN border-clamped)
        r = patch_size
        He, We = H + 2 * r, W + 2 * r
        ne = F.pad(rendered_normal[None], (r, r, r, r),
                   mode="replicate")[0]
        de = F.pad(rendered_distance[None, None], (r, r, r, r),
                   mode="replicate")[0, 0]
        egx, egy = _pixel_grid(He, We, dev, offset=float(r))
        epix = torch.stack([egx, egy], -1).reshape(-1, 2)
        Hm = homographies(ne.reshape(3, -1).T, de.reshape(-1))
        homo = torch.cat([epix, torch.ones_like(epix[:, :1])], -1)
        wxy = warp(Hm, homo)
        near_warp = bilinear_sample_border(near_gt_gray, wxy)[0]
        ref_ext = bilinear_sample_border(gt_gray, epix).reshape(He, We)
        ncc_map, mask_map = _lncc_dense(ref_ext.detach(),
                                        near_warp.reshape(He, We), r)
        ncc_v = ncc_map.reshape(-1)[sel]
        m = mask_map.reshape(-1)[sel] & (sel_w > 0)
    else:
        ps = 2 * patch_size + 1
        o = torch.arange(-patch_size, patch_size + 1, dtype=torch.float32,
                         device=dev)
        # (x, y) offsets in the JAX package's order (x outer, y inner)
        ox, oy = torch.meshgrid(o, o, indexing="ij")
        offs = torch.stack([ox, oy], -1).reshape(-1, 2)
        patch_pix = sel_pix[:, None, :] + offs[None]          # [S,pp,2]
        ref_gray = bilinear_sample_border(
            gt_gray, patch_pix.reshape(-1, 2)).reshape(take, ps * ps)
        n_local = rendered_normal.reshape(3, -1).T[sel]
        d_local = rendered_distance.reshape(-1)[sel]
        Hm = homographies(n_local, d_local)
        homo = torch.cat([patch_pix, torch.ones_like(patch_pix[..., :1])],
                         -1)
        warped = warp(Hm[:, None], homo)
        near_gray = bilinear_sample_border(
            near_gt_gray, warped.reshape(-1, 2)).reshape(take, ps * ps)
        ncc_vals, ncc_mask = lncc(ref_gray.detach(), near_gray)
        ncc_v = ncc_vals[:, 0]
        m = ncc_mask[:, 0] & (sel_w > 0)
    ncc = ncc_v * sel_w
    ncc_loss = (ncc_weight * torch.where(m, ncc, 0.0).sum()
                / torch.clamp(m.sum(), min=1))
    return MultiViewOut(geo_loss=geo_loss, ncc_loss=ncc_loss,
                        n_valid=n_valid)
