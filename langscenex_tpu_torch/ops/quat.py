"""Quaternion math (wxyz convention), port of the JAX ``ops/quat.py``.

Parity targets: field_construction/utils/pose_utils.py (quad2rotation,
rotation2quad, quadmultiply, get_camera_from_tensor,
get_tensor_from_camera) and the rasterizer's quat->rot
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


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w,x,y,z), branch-free Shepperd's method as
    in the JAX package: all four candidate quats, the one with the largest
    pivot selected, sign canonicalised to w >= 0, normalized."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cand = torch.stack([
        torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                     (m10 - m01) / (4 * w0)], -1),
        torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1),
                     (m02 + m20) / (4 * x1)], -1),
        torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2,
                     (m12 + m21) / (4 * y2)], -1),
        torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3),
                     (m12 + m21) / (4 * z3), z3], -1),
    ], dim=-2)                                  # [..., 4 candidates, 4]
    pivots = torch.stack([tr, m00, m11, m22], -1)
    best = torch.argmax(pivots, dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


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


def tensor_from_camera(RT: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] w2c -> [..., 7] (quat wxyz, t)
    (pose_utils.get_tensor_from_camera)."""
    return torch.cat([rotmat_to_quat(RT[..., :3, :3]), RT[..., :3, 3]], -1)
