"""SfM helpers in numpy, port of the JAX ``utils/sfm.py`` (the reference's
utils/sfm_utils.py): image listing and sorting (:73), the train/test
split (:55), DUSt3R-convention image loading (:125), weighted rigid
registration (:103), the COLMAP sparse export tree (:109, :205, :230,
:253, :322, written by ``scene/colmap_io``), co-visibility masks in both
semantics (the confidence-ordered redundancy masks of :345-420 that the
MASt3R/CUT3R export uses, and a symmetric any-other-view variant), depth
normalisation (:374), GT-pose reading (:437), Procrustes pose alignment
(:467) and the timing log (:45). ``storePly`` (:498) is
``scene/dataset_readers.write_ply_points``.

Images are PNGs read by ``utils/png`` (no PIL): ``load_images`` resizes
with its Lanczos, which equals PIL's. ``compute_redundancy_masks`` stays
in float64 numpy on the host, as in the JAX package: its pixel
coordinates are truncated, so a float32 projection would move pixels.
``save_points3D``'s confidence-weighted downsample draws from ``rng``
(the global ``np.random`` unless the caller gives a ``RandomState``).
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.quat import rotmat_to_quat
from ..scene.colmap_io import (ColmapCamera, ColmapImage, qvec_to_rotmat,
                               read_images_binary, write_cameras_binary,
                               write_cameras_text, write_images_binary,
                               write_images_text)
from ..scene.dataset_readers import write_ply_points
from .png import read_png, resize_lanczos, to_rgb, write_png


def round_to_multiple(x: int, m: int = 16) -> int:
    return max(m, (x // m) * m)


def resize_to_512(w: int, h: int) -> Tuple[int, int]:
    """Long side to 512, both sides multiples of 16 (sfm_utils.load_images
    :125 sizing rule)."""
    scale = 512.0 / max(w, h)
    return round_to_multiple(int(w * scale)), round_to_multiple(int(h * scale))


def project_points(pts_world: np.ndarray, K: np.ndarray,
                   w2c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N,3] world -> ([N,2] pixels, [N] depth)."""
    cam = pts_world @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    u = cam[:, 0] / np.maximum(z, 1e-8) * K[0, 0] + K[0, 2]
    v = cam[:, 1] / np.maximum(z, 1e-8) * K[1, 1] + K[1, 2]
    return np.stack([u, v], -1), z


def compute_co_vis_masks(depths: List[np.ndarray], Ks: List[np.ndarray],
                         w2cs: List[np.ndarray],
                         depth_tol: float = 0.05) -> List[np.ndarray]:
    """Per view: the pixels whose unprojected point another view sees
    depth-consistently (within ``depth_tol`` relative;
    sfm_utils.compute_co_vis_masks:378)."""
    n = len(depths)
    pts_all = []
    for i in range(n):
        H, W = depths[i].shape
        ys, xs = np.mgrid[0:H, 0:W]
        z = depths[i]
        K = Ks[i]
        x_cam = (xs - K[0, 2]) / K[0, 0] * z
        y_cam = (ys - K[1, 2]) / K[1, 1] * z
        cam = np.stack([x_cam, y_cam, z], -1).reshape(-1, 3)
        pts_all.append((cam - w2cs[i][:3, 3]) @ w2cs[i][:3, :3])
    masks = []
    for i in range(n):
        H, W = depths[i].shape
        vis = np.zeros(H * W, bool)
        for j in range(n):
            if j == i:
                continue
            uv, z = project_points(pts_all[i], Ks[j], w2cs[j])
            Hj, Wj = depths[j].shape
            ui = np.round(uv[:, 0]).astype(int)
            vi = np.round(uv[:, 1]).astype(int)
            ok = (z > 0) & (ui >= 0) & (ui < Wj) & (vi >= 0) & (vi < Hj)
            dj = np.zeros_like(z)
            dj[ok] = depths[j][vi[ok], ui[ok]]
            vis |= ok & (np.abs(dj - z) < depth_tol * np.maximum(z, 1e-6))
        masks.append(vis.reshape(H, W))
    return masks

# --------------------------------------------------------------- files

_IMAGE_EXTS = {'.png', '.jpg', '.jpeg', '.bmp', '.tiff'}


def get_sorted_image_files(image_dir: str) -> Tuple[List[str], str]:
    """Image paths sorted by the first integer in the stem, and the first
    one's suffix (sfm_utils.get_sorted_image_files:73)."""
    def key(p: Path):
        m = re.search(r"\d+", p.stem)
        return int(m.group()) if m else float("inf")

    files = sorted((p for p in Path(image_dir).iterdir()
                    if p.is_file() and p.suffix.lower() in _IMAGE_EXTS),
                   key=key)
    if not files:
        return [], ""
    return [str(p) for p in files], files[0].suffix


def split_train_test(image_files: Sequence[str], llffhold: int = 8,
                     n_views: Optional[int] = None):
    """12 test views linspaced over the interior, the rest for training
    (optionally subsampled to n_views); sfm_utils.split_train_test:55
    (``llffhold`` is accepted and ignored, as in the reference)."""
    del llffhold
    n = len(image_files)
    test_idx = set(np.linspace(1, n - 2, num=min(12, max(n - 2, 1)),
                               dtype=int).tolist())
    train_idx = [i for i in range(n) if i not in test_idx]
    if n_views:
        keep = np.linspace(0, len(train_idx) - 1, num=n_views, dtype=int)
        train_idx = [train_idx[i] for i in keep]
    return ([image_files[i] for i in train_idx],
            [image_files[i] for i in sorted(test_idx)])


def load_images(folder_or_list, size: int = 512, square_ok: bool = False,
                verbose: bool = False):
    """Load and resize images the DUSt3R way (sfm_utils.load_images:125):
    long side to ``size`` with PIL's Lanczos, both sides multiples of 16.
    Returns ([{img (float32 HWC in [-1, 1]), true_shape, idx, instance},
    ...], (org_W, org_H))."""
    del square_ok, verbose
    if isinstance(folder_or_list, (str, Path)):
        files, _ = get_sorted_image_files(str(folder_or_list))
    else:
        files = list(folder_or_list)
    out, org_shape = [], None
    for i, f in enumerate(files):
        img = to_rgb(read_png(f))
        h0, w0 = img.shape[:2]
        if org_shape is None:
            org_shape = (w0, h0)
        scale = size / max(w0, h0)
        w, h = (round_to_multiple(int(w0 * scale)),
                round_to_multiple(int(h0 * scale)))
        arr = resize_lanczos(img, (w, h)).astype(np.float32) / 127.5 - 1.0
        out.append(dict(img=arr, true_shape=np.array([[h, w]], np.int32),
                        idx=i, instance=str(i)))
    return out, org_shape


# ----------------------------------------------------------- alignment

def rigid_points_registration(pts1: np.ndarray, pts2: np.ndarray,
                              conf: Optional[np.ndarray] = None):
    """Weighted similarity registration: (s, R, T) minimising
    sum_i w_i ||s R p1_i + T - p2_i||^2 (sfm_utils:103, roma's
    rigid_points_registration with compute_scaling=True)."""
    p = pts1.reshape(-1, 3).astype(np.float64)
    q = pts2.reshape(-1, 3).astype(np.float64)
    w = (np.ones(len(p)) if conf is None
         else np.asarray(conf, np.float64).reshape(-1))
    w = w / w.sum()
    mu_p = w @ p
    mu_q = w @ q
    pc = p - mu_p
    qc = q - mu_q
    cov = (w[:, None] * qc).T @ pc
    U, D, Vt = np.linalg.svd(cov)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    var_p = np.sum(w * np.sum(pc * pc, -1))
    s = np.trace(np.diag(D) @ S) / max(var_p, 1e-12)
    return s, R, mu_q - s * R @ mu_p


def align_pose(pose1: np.ndarray, pose2: np.ndarray):
    """Orthogonal Procrustes of two centre sets, each made zero-mean with
    unit Frobenius norm (sfm_utils.align_pose:467). Returns (m1,
    m2_aligned, R)."""
    m1 = np.asarray(pose1, np.float64).copy()
    m2 = np.asarray(pose2, np.float64).copy()
    if m1.shape != m2.shape or m1.ndim != 2 or m1.size == 0:
        raise ValueError("pose sets must be same-shape non-empty 2-D")
    m1 -= m1.mean(0)
    m2 -= m2.mean(0)
    n1, n2 = np.linalg.norm(m1), np.linalg.norm(m2)
    if n1 == 0 or n2 == 0:
        raise ValueError("pose sets must contain >1 unique points")
    m1 /= n1
    m2 /= n2
    from scipy.linalg import orthogonal_procrustes
    R, s = orthogonal_procrustes(m1, m2)
    return m1, m2 * s, R


def normalize_depth(depth_map: np.ndarray) -> np.ndarray:
    """Min-max to [0, 1] (sfm_utils:374)."""
    lo, hi = np.min(depth_map), np.max(depth_map)
    return (depth_map - lo) / max(hi - lo, 1e-12)


def compute_redundancy_masks(sorted_conf_indices: np.ndarray,
                             depthmaps: np.ndarray,
                             pointmaps: np.ndarray,
                             Ks: np.ndarray, w2cs: np.ndarray,
                             image_sizes, depth_threshold: float = 0.1):
    """Confidence-ordered co-visibility (sfm_utils:345-420): walk the
    frames by falling confidence and mark each frame's pixels that the
    union of the more confident frames' points already covers
    (normalised-depth consistency). True = redundant; callers invert it
    to keep the fresh points."""
    num_images, h, w = image_sizes[0], image_sizes[1], image_sizes[2]
    pointmaps = pointmaps.reshape(num_images, h, w, 3)
    masks = np.zeros((num_images, h, w), bool)
    for i, idx in enumerate(sorted_conf_indices):
        if i == 0:
            continue
        prev = sorted_conf_indices[:i]
        pts = pointmaps[prev].reshape(-1, 3)
        depths = normalize_depth(depthmaps[prev].reshape(-1))
        curr_depth = normalize_depth(depthmaps[idx].reshape(h, w))
        uv, _ = project_points(pts, Ks[idx], w2cs[idx])
        xi = uv[:, 0].astype(int)
        yi = uv[:, 1].astype(int)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi, yi, d = xi[ok], yi[ok], depths[ok]
        close = np.abs(d - curr_depth[yi, xi]) < depth_threshold
        masks[idx][yi[close], xi[close]] = True
    return masks


# ------------------------------------------------------ COLMAP export

def init_filestructure(save_path, n_views: Optional[int] = None):
    """sparse_{n}/0 and sparse_{n}/1 (sfm_utils:109)."""
    save_path = Path(save_path)
    tag = f"sparse_{n_views}" if n_views else "sparse_0"
    sparse_0 = save_path / tag / "0"
    sparse_1 = save_path / tag / "1"
    sparse_0.mkdir(exist_ok=True, parents=True)
    sparse_1.mkdir(exist_ok=True, parents=True)
    return save_path, sparse_0, sparse_1


def save_extrinsic(sparse_path, extrinsics_w2c, img_files, image_suffix):
    """images.bin and images.txt from [N,4,4] w2c (sfm_utils:205); the
    quaternion in float32, as the JAX package computes it."""
    sparse_path = Path(sparse_path)
    images = {}
    for i, (w2c, f) in enumerate(zip(extrinsics_w2c, img_files), start=1):
        q = rotmat_to_quat(torch.from_numpy(
            np.asarray(w2c[:3, :3], np.float32))).numpy()
        images[i] = ColmapImage(i, q, np.asarray(w2c[:3, 3]), i,
                                Path(f).stem + image_suffix)
    write_images_binary(images, str(sparse_path / "images.bin"))
    write_images_text(images, str(sparse_path / "images.txt"))


def save_intrinsics(sparse_path, focals, org_imgs_shape, imgs_shape,
                    save_focals: bool = False):
    """cameras.bin and cameras.txt: PINHOLE at the ORIGINAL resolution,
    the focals rescaled from the processing resolution (sfm_utils:230)."""
    sparse_path = Path(sparse_path)
    org_w, org_h = org_imgs_shape
    sx = org_w / imgs_shape[2]
    sy = org_h / imgs_shape[1]
    cams = {i: ColmapCamera(i, "PINHOLE", org_w, org_h,
                            np.array([f * sx, f * sy,
                                      org_w / 2, org_h / 2]))
            for i, f in enumerate(np.asarray(focals).reshape(-1), start=1)}
    write_cameras_binary(cams, str(sparse_path / "cameras.bin"))
    write_cameras_text(cams, str(sparse_path / "cameras.txt"))
    if save_focals:
        np.save(sparse_path / "non_scaled_focals.npy", np.asarray(focals))


def save_points3D(sparse_path, imgs, pts3d, confs, masks=None,
                  use_masks: bool = True, save_all_pts: bool = False,
                  save_txt_path=None, depth_threshold: float = 0.1,
                  max_pts_num: int = 150 * 10 ** 10, rng=None) -> int:
    """points3D.ply, the confidence npys and the pts_num.txt log
    (sfm_utils:253): optional per-view keep-masks, then a confidence-
    weighted downsample past ``max_pts_num`` drawn from ``rng`` (a
    ``np.random.RandomState``; the global one by default)."""
    rng = np.random if rng is None else rng
    sparse_path = Path(sparse_path)
    imgs = np.asarray(imgs)
    pts3d = np.asarray(pts3d)
    confs = np.asarray(confs)
    np.save(sparse_path / "confidence.npy", confs)

    if use_masks and masks is not None:
        flat_masks = np.asarray(masks).reshape(len(masks), -1)
        pts = np.concatenate([p.reshape(-1, 3)[m]
                              for p, m in zip(pts3d, flat_masks)])
        col = np.concatenate([c.reshape(-1, 3)[m]
                              for c, m in zip(imgs, flat_masks)])
        conf = np.concatenate([c.reshape(-1)[m]
                               for c, m in zip(confs, flat_masks)])
    else:
        pts = pts3d.reshape(-1, 3)
        col = imgs.reshape(-1, 3)
        conf = confs.reshape(-1)

    n_raw = pts3d.reshape(-1, 3).shape[0]
    n_masked = pts.shape[0]
    n_final = n_masked
    if n_masked > max_pts_num:
        c = conf.astype(np.float64)
        c = (c - c.min()) / max(c.max() - c.min(), 1e-12) + 1.0
        idx = rng.choice(n_masked, max_pts_num, replace=False,
                         p=c / c.sum())
        pts, col, conf = pts[idx], col[idx], conf[idx]
        n_final = pts.shape[0]
    np.save(sparse_path / "confidence_dsp.npy", conf)

    write_ply_points(str(sparse_path / "points3D.ply"), pts,
                     np.clip(col, 0, 1))
    if save_all_pts:
        np.save(sparse_path / "points3D_all.npy", pts3d)
        np.save(sparse_path / "pointsColor_all.npy", imgs)

    if save_txt_path is not None:
        with open(Path(save_txt_path) / "pts_num.txt", "a") as f:
            f.write(f"Depth threshold: {depth_threshold}\n"
                    f"Vanilla points num: {n_raw}\n"
                    f"Co_Mask DSP points num: {n_masked}\n"
                    f"Co_Mask DSP ratio: {n_masked / max(n_raw, 1)}\n")
            if n_masked > max_pts_num:
                f.write(f"Conf_Mask DSP points num: {n_final}\n"
                        f"Conf_Mask DSP ratio: {n_final / max(n_raw, 1)}\n")
            f.write("\n")
    return n_final


def save_images_and_masks(sparse_0_path, n_views, imgs, overlapping_masks,
                          image_files, image_suffix):
    """The processed images and the redundancy masks as PNG trees
    (sfm_utils:322)."""
    sparse_0_path = Path(sparse_0_path)
    img_dir = sparse_0_path / f"imgs_{n_views}"
    mask_dir = sparse_0_path / f"overlapping_masks_{n_views}"
    img_dir.mkdir(exist_ok=True, parents=True)
    mask_dir.mkdir(exist_ok=True, parents=True)
    for img, name, mask in zip(imgs, image_files, overlapping_masks):
        stem = Path(name).stem
        write_png(str(mask_dir / f"{stem}{image_suffix}"),
                  (np.repeat(mask[..., None], 3, -1) * 255).astype(np.uint8))
        write_png(str(img_dir / f"{stem}{image_suffix}"),
                  np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8))


def read_colmap_gt_pose(gt_pose_path: str, llffhold: int = 8):
    """[N,4,4] matrices (R^T | t) from sparse/0/images.bin, sorted by name
    (sfm_utils.read_colmap_gt_pose:437)."""
    del llffhold
    images = read_images_binary(
        os.path.join(gt_pose_path, "sparse", "0", "images.bin"))
    poses = []
    for im in sorted(images.values(), key=lambda im: im.name):
        pose = np.eye(4)
        pose[:3, :3] = qvec_to_rotmat(im.qvec).T
        pose[:3, 3] = im.tvec
        poses.append(pose)
    return np.array(poses)


def save_time(time_dir, process_name: str, seconds: float):
    """Append a stage's timing line (sfm_utils.save_time:45)."""
    Path(time_dir).mkdir(exist_ok=True, parents=True)
    with open(Path(time_dir) / "time.txt", "a") as f:
        f.write(f"{process_name}: {seconds:.6f}\n")
