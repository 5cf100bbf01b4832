"""Quaternion math (wxyz convention), port of the JAX ``ops/quat.py``.

Parity targets: field_construction/utils/pose_utils.py (quad2rotation,
quadmultiply, get_camera_from_tensor) and the rasterizer's quat->rot
(forward.cu:119-152).
"""
from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # sqrt(max(...)) keeps the gradient finite at q == 0
    norm = torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True),
                                  min=eps * eps))
    return q / norm


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3, 3]. Does NOT normalize q."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1*q2, wxyz (pose_utils.quadmultiply)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def camera_from_tensor(qt: torch.Tensor) -> torch.Tensor:
    """[..., 7] (quat wxyz, t xyz) -> [..., 4, 4] world-to-camera matrix
    (pose_utils.get_camera_from_tensor; the quat is normalized)."""
    q = quat_normalize(qt[..., :4])
    t = qt[..., 4:7]
    R = quat_to_rotmat(q)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=qt.dtype,
                          device=qt.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
