"""Depth map -> camera-space point map -> cross-product normals, port of
the JAX ``ops/depth_normal.py``.

Parity targets: field_construction/utils/graphics_utils.py depth2point_cam
(:28-40), depth_pcd2normal (:49-77, no-offset path) and
normal_from_depth_image (:80-86).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def depth_to_points_cam(depth: torch.Tensor,
                        intrinsic: torch.Tensor) -> torch.Tensor:
    """[H,W] depth + [3,3] K -> [H,W,3] camera-space points:
    [u z, v z, z] @ K^-T, as the JAX version computes it."""
    H, W = depth.shape
    xs = torch.arange(W, dtype=torch.float32, device=depth.device)
    ys = torch.arange(H, dtype=torch.float32, device=depth.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    uvz = torch.stack([gx * depth, gy * depth, depth], dim=-1)
    Kinv = torch.linalg.inv(intrinsic)
    # explicit f32 contraction: TF32 would quantise the point map whose
    # neighbouring differences make the normals
    return (uvz[..., None, :] * Kinv).sum(-1)


def points_to_normals(xyz: torch.Tensor) -> torch.Tensor:
    """[H,W,3] points -> [H,W,3] unit normals via the central-difference
    cross product, zero border."""
    bottom = xyz[2:, 1:-1]
    top = xyz[:-2, 1:-1]
    right = xyz[1:-1, 2:]
    left = xyz[1:-1, :-2]
    n = torch.linalg.cross(right - left, top - bottom, dim=-1)
    # gradient-safe normalize: the gradient of ||n|| at n = 0 is NaN
    norm = torch.sqrt(torch.clamp((n * n).sum(-1, keepdim=True), min=1e-24))
    n = n / norm
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def normal_from_depth(depth: torch.Tensor,
                      intrinsic: torch.Tensor) -> torch.Tensor:
    """[H,W] depth + K -> [H,W,3] camera-space normals."""
    return points_to_normals(depth_to_points_cam(depth, intrinsic))
