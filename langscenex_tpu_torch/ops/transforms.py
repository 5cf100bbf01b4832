"""Camera transform / projection matrices, port of the JAX
``ops/transforms.py``.

Math convention throughout: ``x_cam = W2C[:3, :3] @ x_world + W2C[:3, 3]``
(the reference stores the transposes; values are identical). Matrices
built on the host are numpy float32, exactly as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=(0.0, 0.0, 0.0), scale: float = 1.0) -> np.ndarray:
    """4x4 world-to-camera from COLMAP-style (R cam-to-world rotation,
    t world-to-camera translation), with the optional recenter/rescale of
    the camera center (graphics_utils.getWorld2View2)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + np.asarray(translate)) * scale
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection (graphics_utils.py:141-163)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def ndc_to_pix(v: torch.Tensor, size) -> torch.Tensor:
    """((v + 1) * S - 1) / 2 — auxiliary.h ndc2Pix."""
    return ((v + 1.0) * size - 1.0) * 0.5
