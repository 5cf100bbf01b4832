"""The pose-estimation stage: VGGT's feed-forward initialisation and its
alternatives, port of the JAX ``pose_estimation.py`` (the reference's
field_construction/pose_estimator/__init__.py: the get_pose_estimator
factory :296-303, VGGTEstimator :227-294 (the default), ColmapEstimator
:25-96, and the MASt3R/CUT3R COLMAP-export contract :99-225, reached here
through VGGT, as in the JAX package).

Each estimator takes the model (a ``models/vggt.VGGT``, or its state_dict
in facebook/VGGT-1B's keys, loaded into ``VGGT(cfg)``) and runs on
``device`` (``cuda:0`` unless the caller names another). Frames are the
PNGs of ``input/``, resized to the model's square with ``utils/png.
resize_bicubic`` (PIL's default resize, bit for bit).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.png import read_png, resize_bicubic, to_rgb

log = logging.getLogger(__name__)


def load_vggt(model, cfg=None, device: torch.device | str | None = None):
    """``model`` as a VGGT in eval mode on ``device``: a module is moved
    there, a state_dict (facebook/VGGT-1B's keys) is loaded strictly into
    ``VGGT(cfg)``. None raises: no weights ship with the port."""
    from .models.vggt import VGGT, VGGTConfig
    if model is None:
        raise ValueError(
            "VGGT weights required: pass a VGGT or the state_dict of "
            "facebook/VGGT-1B (the reference loads it from the HF hub)")
    dev = resolve_device(device)
    if isinstance(model, dict):
        sd = model
        model = VGGT(cfg or VGGTConfig(), device=dev)
        model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


def load_frames(paths, size: int) -> np.ndarray:
    """PNG frames -> [N, 3, size, size] float32 in [0, 1] (PIL's
    ``convert("RGB").resize((size, size))``, then / 255)."""
    return np.stack([
        resize_bicubic(to_rgb(read_png(p)), (size, size)).astype(np.float32)
        .transpose(2, 0, 1) / 255.0 for p in paths])


def run_vggt(model, frames: np.ndarray) -> dict:
    """One forward of [N,3,S,S] frames as a batch of one clip; returns the
    outputs of its one batch element on the model's device and the
    extrinsics [N,3,4] and intrinsics [N,3,3] decoded from ``pose_enc``."""
    from .models.vggt import pose_encoding_to_extri_intri
    batch = torch.from_numpy(frames).to(model.device)[None]
    with torch.no_grad():
        out = {k: v[0] for k, v in model(batch).items()}
    out["extri"], out["K"] = pose_encoding_to_extri_intri(
        out["pose_enc"], tuple(batch.shape[-2:]))
    return out


def _square(cfg) -> int:
    return cfg.img_size - cfg.img_size % cfg.patch_size


def estimate_poses_vggt(data_path: str, model=None, cfg=None,
                        target_wh=(720, 480),
                        device: torch.device | str | None = None) -> dict:
    """Run VGGT over ``data_path/input``; write camera/%04d.npz {pose
    (c2w), intrinsics} and points3D.ply from the first and last frames'
    unprojected depth (pose_estimator/__init__.py:232-294: intrinsics
    rescaled to 720x480, only the first and last frames' points kept,
    strided to at most about 200k). Returns the model's outputs."""
    from .models.vggt import unproject_depth_to_points
    from .scene.dataset_readers import write_ply_points
    model = load_vggt(model, cfg, device)
    input_dir = os.path.join(data_path, "input")
    names = sorted(n for n in os.listdir(input_dir)
                   if n.endswith((".png", ".jpg")))
    S = _square(model.cfg)
    imgs = load_frames([os.path.join(input_dir, n) for n in names], S)
    out = run_vggt(model, imgs)
    extri, K = out["extri"], out["K"]

    # the intrinsics at the target video resolution (:268-272)
    tw, th = target_wh
    Ks = K.cpu().numpy().copy()
    Ks[:, 0] *= tw / S
    Ks[:, 1] *= th / S
    cam_dir = os.path.join(data_path, "camera")
    os.makedirs(cam_dir, exist_ok=True)
    extri_np = extri.cpu().numpy()
    n = len(names)
    for i in range(n):
        E = np.eye(4, dtype=np.float32)
        E[:3] = extri_np[i]
        np.savez(os.path.join(cam_dir, f"{i + 1:04d}.npz"),
                 pose=np.linalg.inv(E), intrinsics=Ks[i])

    # the initial cloud from the first and last frames only (:274-278)
    pts = torch.cat([unproject_depth_to_points(
        out["depth"][i], extri[i], K[i]).reshape(-1, 3)
        for i in (0, n - 1)]).cpu().numpy()
    cols = np.concatenate([imgs[i].transpose(1, 2, 0).reshape(-1, 3)
                           for i in (0, n - 1)], 0)
    stride = max(len(pts) // 200_000, 1)
    write_ply_points(os.path.join(data_path, "points3D.ply"),
                     pts[::stride], cols[::stride])
    return out


def estimate_poses_colmap(data_path: str, colmap_bin: str = "colmap") -> None:
    """COLMAP as a subprocess (ColmapEstimator :25-96): feature_extractor,
    exhaustive_matcher, mapper. Raises without the binary."""
    import shutil
    import subprocess
    if shutil.which(colmap_bin) is None:
        raise RuntimeError("colmap binary not available")
    db = os.path.join(data_path, "database.db")
    sparse = os.path.join(data_path, "sparse")
    os.makedirs(sparse, exist_ok=True)

    def run(*a):
        subprocess.run(list(a), check=True, capture_output=True)
    run(colmap_bin, "feature_extractor", "--database_path", db,
        "--image_path", os.path.join(data_path, "input"))
    run(colmap_bin, "exhaustive_matcher", "--database_path", db)
    run(colmap_bin, "mapper", "--database_path", db,
        "--image_path", os.path.join(data_path, "input"),
        "--output_path", sparse)


def estimate_poses_dense_init(data_path: str, model=None, cfg=None,
                              n_views: Optional[int] = None,
                              co_vis_dsp: bool = True,
                              depth_thre: float = 0.1,
                              max_pts_num: int = 1_500_000,
                              device: torch.device | str | None = None,
                              rng=None) -> int:
    """The MASt3R/CUT3R COLMAP export (pose_estimator/__init__.py:99-225):
    per-view pointmaps and confidences -> confidence-ordered redundancy
    masks -> sparse_{n}/0/{images,cameras}.{bin,txt}, points3D.ply,
    confidence(_dsp).npy and pts_num.txt. The reference reaches it through
    the mast3r/cut3r packages; like the JAX package, the port reaches the
    same tree through VGGT, which predicts the same quantities. ``rng``
    draws the confidence-weighted downsample (``utils/sfm.save_points3D``).
    Returns the number of points written."""
    from .models.vggt import unproject_depth_to_points
    from .utils import sfm
    model = load_vggt(model, cfg, device)
    image_files, suffix = sfm.get_sorted_image_files(
        os.path.join(data_path, "input"))
    S = _square(model.cfg)
    h0, w0 = read_png(image_files[0]).shape[:2]
    imgs = load_frames(image_files, S)
    out = run_vggt(model, imgs)
    n = len(image_files)
    pointmaps = torch.stack([unproject_depth_to_points(
        out["depth"][i], out["extri"][i], out["K"][i])
        for i in range(n)]).cpu().numpy()
    extri, K = out["extri"].cpu().numpy(), out["K"].cpu().numpy()
    depth = out["depth"].cpu().numpy()
    conf = out["depth_conf"].cpu().numpy()

    w2cs = np.tile(np.eye(4), (n, 1, 1))
    w2cs[:, :3] = extri
    order = np.argsort(conf.reshape(n, -1).mean(-1))[::-1]
    if depth_thre > 0:
        masks = ~sfm.compute_redundancy_masks(
            order, depth, pointmaps, K, w2cs, (n, S, S),
            depth_threshold=depth_thre)
    else:
        co_vis_dsp, masks = False, None

    _, sparse_0, _ = sfm.init_filestructure(data_path, n_views)
    sfm.save_extrinsic(sparse_0, w2cs, image_files, suffix)
    sfm.save_intrinsics(sparse_0, K[:, 0, 0], (w0, h0), (n, S, S),
                        save_focals=True)
    n_pts = sfm.save_points3D(sparse_0, imgs.transpose(0, 2, 3, 1),
                              pointmaps, conf.reshape(n, -1), masks,
                              use_masks=co_vis_dsp, save_all_pts=False,
                              save_txt_path=data_path,
                              depth_threshold=depth_thre,
                              max_pts_num=max_pts_num, rng=rng)
    log.info("dense-init export: %d points -> %s", n_pts, sparse_0)
    return n_pts


ESTIMATORS = {
    "vggt": estimate_poses_vggt,
    "colmap": estimate_poses_colmap,
    # the reference reaches these two through external torch packages;
    # both resolve to the same COLMAP-export contract
    "mast3r": estimate_poses_dense_init,
    "cut3r": estimate_poses_dense_init,
}


def get_pose_estimator(name: str):
    """The factory (pose_estimator/__init__.py:296-303)."""
    if name not in ESTIMATORS:
        raise ValueError(f"unknown pose estimator {name!r}; "
                         f"have {sorted(ESTIMATORS)}")
    return ESTIMATORS[name]
