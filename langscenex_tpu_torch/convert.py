"""Carry state across from the JAX package, as numpy arrays.

``gaussian_state_from_numpy`` takes the JAX ``GaussianState`` fields
(``np.asarray`` of each leaf) and builds the port's ``GaussianState`` on a
device; ``raster_camera_from_numpy`` does the same for a ``RasterCamera``.
PLY files need no converter: each package's ``load_ply`` reads the
other's ``save_ply``.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.projection import RasterCamera
from .scene.gaussians import GaussianState

GAUSSIAN_FIELDS = ("xyz", "knn_f", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity", "language_feature",
                   "instance_feature", "alive")


def gaussian_state_from_numpy(d: dict, device: torch.device | str = "cpu"
                              ) -> GaussianState:
    missing = [k for k in GAUSSIAN_FIELDS if k not in d]
    if missing:
        raise KeyError(f"missing GaussianState fields: {missing}")
    out = {}
    for k in GAUSSIAN_FIELDS:
        a = np.asarray(d[k])
        a = a.astype(bool) if k == "alive" else a.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return GaussianState(**out)


def raster_camera_from_numpy(w2c: np.ndarray, proj: np.ndarray, width: int,
                             height: int, tan_fovx: float, tan_fovy: float,
                             device: torch.device | str = "cpu"
                             ) -> RasterCamera:
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)
    return RasterCamera(w2c=t(w2c), proj=t(proj), width=int(width),
                        height=int(height), tan_fovx=float(tan_fovx),
                        tan_fovy=float(tan_fovy))
