"""Scene readers, port of the JAX ``scene/dataset_readers.py``: COLMAP
sparse directories, CUT3R/VGGT camera-npz directories and NeRF-synthetic
``transforms_*.json`` scenes, assembled into a :class:`SceneInfo` (camera
list, initial point cloud, NeRF++ extent) with the same shuffle and
nearest-camera sets (dataset_readers.py readColmapSceneInfo:166-232,
read_camera_npz:234-293, readCUT3RInfo:296-353, getNerfppNorm:58-79;
scene/__init__.py:26-153). Host data is numpy. A blender scene's image
sizes come from its PNG headers (``utils/png.png_size``), not from PIL.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from ..ops.transforms import focal2fov, fov2focal
from ..utils.png import png_size
from . import colmap_io
from .cameras import Camera, compute_nearest_cameras


@dataclasses.dataclass
class SceneInfo:
    cameras: List[Camera]
    points: np.ndarray       # [N,3]
    colors: np.ndarray       # [N,3] in [0,1]
    nerf_norm_radius: float
    nerf_norm_translate: np.ndarray


def nerfpp_norm(cams: List[Camera]) -> Tuple[np.ndarray, float]:
    """Camera-bounding "NeRF++" normalization (dataset_readers.py:58-79)."""
    centers = np.stack([c.cam_center for c in cams], axis=1)
    center = centers.mean(axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers - center, axis=0))
    return -center.flatten(), diagonal * 1.1


def _camera_from_colmap(iid: int, uid: int, im: colmap_io.ColmapImage,
                        cam: colmap_io.ColmapCamera,
                        images_dir: str) -> Camera:
    R = colmap_io.qvec_to_rotmat(im.qvec).T     # stored transposed (c2w)
    T = im.tvec
    if cam.model == "SIMPLE_PINHOLE":
        fx = fy = cam.params[0]
    elif cam.model == "PINHOLE":
        fx, fy = cam.params[0], cam.params[1]
    else:
        raise ValueError(f"unsupported camera model {cam.model} "
                         "(undistort first, as the reference requires)")
    return Camera(
        uid=uid, colmap_id=iid, R=R, T=T,
        fovx=focal2fov(fx, cam.width), fovy=focal2fov(fy, cam.height),
        width=cam.width, height=cam.height,
        image_name=os.path.splitext(im.name)[0],
        image_path=os.path.join(images_dir, im.name))


def read_colmap_scene(path: str, images_subdir: str = "images") -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    try:
        cams = colmap_io.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = colmap_io.read_images_binary(os.path.join(sparse, "images.bin"))
        xyz, rgb, _ = colmap_io.read_points3d_binary(
            os.path.join(sparse, "points3D.bin"))
    except FileNotFoundError:
        cams = colmap_io.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = colmap_io.read_images_text(os.path.join(sparse, "images.txt"))
        xyz, rgb, _ = colmap_io.read_points3d_text(
            os.path.join(sparse, "points3D.txt"))
    images_dir = os.path.join(path, images_subdir)
    cam_list = []
    for uid, iid in enumerate(sorted(imgs)):
        im = imgs[iid]
        cam_list.append(_camera_from_colmap(iid, uid, im,
                                            cams[im.camera_id], images_dir))
    translate, radius = nerfpp_norm(cam_list)
    return SceneInfo(cameras=cam_list, points=xyz,
                     colors=rgb / 255.0, nerf_norm_radius=radius,
                     nerf_norm_translate=translate)


def read_camera_npz_dir(camera_dir: str):
    """camera/*.npz -> (w2c poses, intrinsics, names). Each file carries
    pose (c2w 4x4) and intrinsics (3x3); image size is inferred from the
    principal point as 2*cx x 2*cy exactly like the reference
    (dataset_readers.py:264-265)."""
    entries = []
    for fn in sorted(os.listdir(camera_dir)):
        if not fn.endswith(".npz"):
            continue
        data = np.load(os.path.join(camera_dir, fn))
        pose = data["pose"]
        K = data["intrinsics"]
        Rc2w = pose[:3, :3]
        tc2w = pose[:3, 3]
        Rw2c = Rc2w.T
        tw2c = -Rw2c @ tc2w
        entries.append((os.path.splitext(fn)[0], Rw2c, tw2c, K))
    return entries


def read_cut3r_scene(path: str, images_subdir: str = "input",
                     ply_name: str = "points3D.ply") -> SceneInfo:
    """CUT3R/VGGT npz scene (readCUT3RInfo:296-353): camera/*.npz poses +
    points3D.ply initial cloud."""
    entries = read_camera_npz_dir(os.path.join(path, "camera"))
    images_dir = os.path.join(path, images_subdir)
    cam_list = []
    for uid, (name, Rw2c, tw2c, K) in enumerate(entries):
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        width, height = int(cx * 2), int(cy * 2)
        cam_list.append(Camera(
            uid=uid, colmap_id=uid + 1, R=Rw2c.T, T=tw2c,
            fovx=focal2fov(fx, width), fovy=focal2fov(fy, height),
            width=width, height=height, image_name=name,
            image_path=os.path.join(images_dir, name + ".png")))
    pts, cols = read_ply_points(os.path.join(path, ply_name))
    translate, radius = nerfpp_norm(cam_list)
    return SceneInfo(cameras=cam_list, points=pts, colors=cols,
                     nerf_norm_radius=radius,
                     nerf_norm_translate=translate)


def read_ply_points(path: str):
    """Minimal point-cloud PLY reader (binary_little_endian or ascii) for
    x y z [red green blue] vertex elements."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(l for l in header if l.startswith("element vertex")
                     ).split()[-1])
        props = [l.split()[1:] for l in header if l.startswith("property ")]
        names = [p[1] for p in props]
        fmt = next(l for l in header if l.startswith("format"))
        np_types = {"float": "<f4", "double": "<f8", "uchar": "u1",
                    "uint8": "u1", "int": "<i4", "float32": "<f4",
                    "float64": "<f8"}
        if "ascii" in fmt:
            rows = np.loadtxt(f, max_rows=n)
            data = {nm: rows[:, i] for i, nm in enumerate(names)}
        else:
            dt = np.dtype([(nm, np_types[p[0]]) for p, nm in zip(props, names)])
            raw = np.frombuffer(f.read(n * dt.itemsize), dtype=dt)
            data = {nm: raw[nm] for nm in names}
    pts = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    if "red" in data:
        cols = np.stack([data["red"], data["green"], data["blue"]],
                        -1).astype(np.float32)
        if cols.max() > 1.5:
            cols = cols / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    return pts, cols


def write_ply_points(path: str, pts: np.ndarray, cols: Optional[np.ndarray] = None):
    n = pts.shape[0]
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if cols is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        if cols is not None:
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec = np.empty(n, dt)
            rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
            c = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
            rec["r"], rec["g"], rec["b"] = c[:, 0], c[:, 1], c[:, 2]
            f.write(rec.tobytes())
        else:
            f.write(pts.astype("<f4").tobytes())


def read_blender_scene(path: str, white_background: bool = False,
                       extension: str = ".png",
                       seed: int = 0) -> SceneInfo:
    """NeRF-synthetic transforms_*.json scenes (readNerfSyntheticInfo
    :399-432 + readCamerasFromTransforms): c2w matrices with the OpenGL
    y/z flip, fov from camera_angle_x; random init cloud in [-1.3, 1.3]^3
    when no points3d.ply exists."""
    import json

    def read_transforms(fname):
        with open(os.path.join(path, fname)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        cams = []
        for uid, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"], np.float64)
            # blender/OpenGL -> COLMAP: flip y and z axes
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            img_rel = frame["file_path"] + extension
            img_path = os.path.join(path, img_rel.lstrip("./"))
            W = H = 800
            if os.path.exists(img_path):
                W, H = png_size(img_path)
            fovy = focal2fov(fov2focal(fovx, W), H)
            cams.append(Camera(
                uid=uid, colmap_id=uid + 1, R=w2c[:3, :3].T, T=w2c[:3, 3],
                fovx=fovx, fovy=fovy, width=W, height=H,
                image_name=os.path.splitext(os.path.basename(img_rel))[0],
                image_path=img_path))
        return cams

    cams = read_transforms("transforms_train.json")
    test_path = os.path.join(path, "transforms_test.json")
    if os.path.exists(test_path):
        cams.extend(read_transforms("transforms_test.json"))

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        pts, cols = read_ply_points(ply_path)
    else:
        rng = np.random.default_rng(seed)
        pts = (rng.random((100_000, 3)) * 2.6 - 1.3).astype(np.float32)
        cols = (rng.random((100_000, 3)) / 255.0 * 0.28209479177387814
                + 0.5).astype(np.float32)
    translate, radius = nerfpp_norm(cams)
    return SceneInfo(cameras=cams, points=pts, colors=cols,
                     nerf_norm_radius=radius,
                     nerf_norm_translate=translate)


def load_scene(path: str, kind: str = "auto",
               multi_view_num: int = 8, max_angle: float = 30.0,
               min_dis: float = 0.01, max_dis: float = 1.5,
               shuffle: bool = True, seed: int = 0) -> SceneInfo:
    """Scene assembly (scene/__init__.py:26-153): load, shuffle cameras,
    compute nearest-view sets."""
    if kind == "auto":
        if os.path.isdir(os.path.join(path, "sparse")):
            kind = "colmap"
        elif os.path.exists(os.path.join(path, "transforms_train.json")):
            kind = "blender"
        else:
            kind = "cut3r"
    if kind == "colmap":
        info = read_colmap_scene(path)
    elif kind == "blender":
        info = read_blender_scene(path)
    else:
        info = read_cut3r_scene(path)
    if shuffle:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(info.cameras))
        info.cameras = [info.cameras[i] for i in order]
        for uid, c in enumerate(info.cameras):
            c.uid = uid
    compute_nearest_cameras(info.cameras, multi_view_num, max_angle,
                            min_dis, max_dis)
    return info
