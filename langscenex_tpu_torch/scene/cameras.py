"""Host-side camera objects, port of the JAX ``scene/cameras.py``: pose,
field of view and size, ``raster_camera()`` for the render device, the
training image (in memory), the ``*_f.npy`` / ``*_s.npy`` language
features and ``compute_nearest_cameras``. Host data is numpy.

Not ported yet: reading image files (``load_image`` with no in-memory
image needs PIL, which the GPU machine may lack) and ``load_normal`` (the
normal prior is off by default, ``normal_optim=False``).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.projection import RasterCamera
from ..ops.transforms import fov2focal, projection_matrix, world_to_view

ZNEAR = 0.01
ZFAR = 100.0


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """[3,H,W] -> [1,H,W] luma (cameras.py:51)."""
    return (0.299 * img[0] + 0.587 * img[1] + 0.114 * img[2])[None]


@dataclasses.dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray            # [3,3] cam-to-world rotation (COLMAP reader style)
    T: np.ndarray            # [3] world-to-cam translation
    fovx: float
    fovy: float
    width: int
    height: int
    image_name: str = ""
    image_path: str = ""
    image: Optional[np.ndarray] = None         # [3,H,W] float32 in [0,1]
    image_gray: Optional[np.ndarray] = None    # [1,H,W]
    ncc_scale: float = 1.0
    nearest_id: List[int] = dataclasses.field(default_factory=list)
    nearest_names: List[str] = dataclasses.field(default_factory=list)
    trans: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    @property
    def fx(self) -> float:
        return fov2focal(self.fovx, self.width)

    @property
    def fy(self) -> float:
        return fov2focal(self.fovy, self.height)

    @property
    def w2c(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale)

    @property
    def cam_center(self) -> np.ndarray:
        w = self.w2c
        return -w[:3, :3].T @ w[:3, 3]

    def K(self, scale: float = 1.0) -> np.ndarray:
        return np.array([[self.fx / scale, 0, 0.5 * self.width / scale],
                         [0, self.fy / scale, 0.5 * self.height / scale],
                         [0, 0, 1]], np.float32)

    def raster_camera(self, w2c_override: Optional[np.ndarray] = None,
                      device: torch.device | str = "cpu") -> RasterCamera:
        w2c = self.w2c if w2c_override is None else w2c_override
        proj = projection_matrix(ZNEAR, ZFAR, self.fovx, self.fovy)
        return RasterCamera(
            w2c=torch.as_tensor(np.asarray(w2c, np.float32), device=device),
            proj=torch.as_tensor(proj, device=device),
            width=self.width, height=self.height,
            tan_fovx=math.tan(self.fovx * 0.5),
            tan_fovy=math.tan(self.fovy * 0.5))

    def load_image(self) -> Tuple[np.ndarray, np.ndarray]:
        """(image [3,H,W], gray [1,H,W]) held in memory; ``image_gray`` is
        derived when only the image was given."""
        if self.image is None:
            raise NotImplementedError(
                "reading image files is not ported: set Camera.image")
        if self.image_gray is None:
            self.image_gray = rgb_to_gray(self.image)
        return self.image, self.image_gray

    def load_language_feature(self, feature_dir: str):
        """(feature [3,H,W], mask [H,W], seg [H,W]) from the *_f.npy /
        *_s.npy filesystem contract (cameras.py get_language_feature
        :137-151). The feature map is bilinearly resized to image size."""
        base = os.path.join(feature_dir, self.image_name)
        fmap = np.load(base + "_f.npy").astype(np.float32)
        if fmap.ndim < 4:
            fmap = fmap[None]
        fmap = _resize_bilinear_chw(fmap[0], self.height, self.width)
        seg = np.load(base + "_s.npy")
        if seg.ndim == 3:
            seg = seg[0]
        seg = _resize_nearest(seg.astype(np.int64), self.height, self.width)
        return fmap, seg != -1, seg


def _resize_bilinear_chw(x: np.ndarray, H: int, W: int) -> np.ndarray:
    """[C,h,w] -> [C,H,W] bilinear, align_corners=False (torch interpolate)."""
    C, h, w = x.shape
    if (h, w) == (H, W):
        return x
    ys = (np.arange(H) + 0.5) * h / H - 0.5
    xs = (np.arange(W) + 0.5) * w / W - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[None, :, None]
    wx = np.clip(xs - x0, 0, 1)[None, None, :]
    a = x[:, y0][:, :, x0]
    b = x[:, y0][:, :, x1]
    c = x[:, y1][:, :, x0]
    d = x[:, y1][:, :, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx).astype(np.float32)


def _resize_nearest(x: np.ndarray, H: int, W: int) -> np.ndarray:
    h, w = x.shape
    if (h, w) == (H, W):
        return x
    ys = np.clip((np.arange(H) * h) // H, 0, h - 1)
    xs = np.clip((np.arange(W) * w) // W, 0, w - 1)
    return x[ys][:, xs]


def compute_nearest_cameras(cams: List[Camera], multi_view_num: int = 8,
                            max_angle: float = 30.0, min_dis: float = 0.01,
                            max_dis: float = 1.5) -> None:
    """Fill cam.nearest_id by distance + angle criteria (scene/__init__.py
    :89-127). Mutates the cameras."""
    centers = np.stack([c.cam_center for c in cams])
    fwd = np.stack([c.w2c[2, :3] for c in cams])     # camera forward axes
    for i, cam in enumerate(cams):
        d = np.linalg.norm(centers - centers[i], axis=-1)
        cosang = np.clip(fwd @ fwd[i], -1, 1)
        ang = np.degrees(np.arccos(cosang))
        ok = (d > min_dis) & (d < max_dis) & (ang < max_angle)
        ok[i] = False
        order = np.argsort(d + (~ok) * 1e9)
        sel = [int(j) for j in order[:multi_view_num] if ok[j]]
        cam.nearest_id = sel
        cam.nearest_names = [cams[j].image_name for j in sel]
