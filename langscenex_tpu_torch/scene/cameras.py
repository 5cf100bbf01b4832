"""Host-side camera objects, port of the JAX ``scene/cameras.py``: pose,
field of view and size, and ``raster_camera()`` for the render device.
Image, normal and feature loading belong to the training slice and are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.projection import RasterCamera
from ..ops.transforms import projection_matrix, world_to_view

ZNEAR = 0.01
ZFAR = 100.0


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
    trans: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    @property
    def w2c(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale)

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
