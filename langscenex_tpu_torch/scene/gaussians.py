"""Gaussian splat scene state, port of the JAX ``scene/gaussians.py``.

Fixed-capacity tensors with an ``alive`` mask, in the reference
GaussianModel's raw parameter space (gaussian_model.py:44-841):
log-space scaling (exp activation), logit-space opacity (sigmoid),
unnormalized wxyz rotation (normalized on use), SH dc + rest, and the
knn_f(6), language(3) and instance(3) channels; ``create_from_points``
initialises it from a point cloud and ``DensifyStats`` carries the
densification statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.knn import mean_dist3_sq
from ..ops.quat import quat_normalize, quat_to_rotmat
from ..ops.sh import rgb_to_sh
from ..utils.device import resolve_device


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def _round_capacity(n: int, multiple: int = 256) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


@dataclasses.dataclass
class GaussianState:
    """All per-splat parameters, capacity-padded (leading dim CAP)."""
    xyz: torch.Tensor               # [CAP,3]
    knn_f: torch.Tensor             # [CAP,6]
    features_dc: torch.Tensor       # [CAP,1,3]
    features_rest: torch.Tensor     # [CAP,R,3]  R=(max_sh+1)^2-1
    scaling: torch.Tensor           # [CAP,3] log-space
    rotation: torch.Tensor          # [CAP,4] wxyz unnormalized
    opacity: torch.Tensor           # [CAP,1] logit-space
    language_feature: torch.Tensor  # [CAP,3]
    instance_feature: torch.Tensor  # [CAP,3]
    alive: torch.Tensor             # [CAP] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_rotation(self) -> torch.Tensor:
        return quat_normalize(self.rotation)

    def get_features(self) -> torch.Tensor:
        """[CAP, 1+R, 3] concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_normal(self, cam_center: torch.Tensor) -> torch.Tensor:
        """Per-splat normal: the shortest scaling axis, flipped toward the
        camera (gaussian_model.py get_normal:231-236)."""
        R = quat_to_rotmat(self.get_rotation())            # [CAP,3,3]
        shortest = torch.argmin(self.scaling, dim=-1)      # log monotone
        # columns of R are the principal axes in world space
        normal = torch.gather(
            R, -1, shortest[:, None, None].expand(-1, 3, 1))[..., 0]
        to_cam = cam_center[None, :] - self.xyz
        sign = torch.sign((normal * to_cam).sum(-1, keepdim=True))
        return normal * torch.where(sign == 0, 1.0, sign)


def create_from_points(points: np.ndarray, colors: np.ndarray,
                       max_sh_degree: int = 3,
                       capacity: Optional[int] = None, seed: int = 0,
                       device: torch.device | str | None = None
                       ) -> GaussianState:
    """Initialise splats from a point cloud (gaussian_model.create_from_pcd
    :267-301): SH-DC from RGB, log-sqrt-kNN scales (the JAX package's
    morton-window kNN), identity rotations, opacity 0.1, standard-normal
    knn_f, zero language/instance features. knn_f is drawn from a
    ``torch.Generator`` seeded with ``seed``, so it differs from the JAX
    package's draw (same distribution)."""
    device = resolve_device(device)
    n = points.shape[0]
    cap = capacity or _round_capacity(int(n * 1.5))
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} points")
    R = (max_sh_degree + 1) ** 2 - 1
    f32 = dict(dtype=torch.float32, device=device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)

    xyz = torch.zeros((cap, 3), **f32)
    xyz[:n] = pts
    features_dc = torch.zeros((cap, 1, 3), **f32)
    features_dc[:n, 0] = rgb_to_sh(
        torch.as_tensor(np.asarray(colors, np.float32), device=device))
    dist = torch.sqrt(torch.clamp(mean_dist3_sq(pts), min=1e-7))
    scaling = torch.zeros((cap, 3), **f32)
    scaling[:n] = torch.log(dist)[:, None].expand(n, 3)
    rotation = torch.zeros((cap, 4), **f32)
    rotation[:, 0] = 1.0
    opacity = torch.full((cap, 1), float(inverse_sigmoid(
        torch.tensor(0.1, dtype=torch.float32))), **f32)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    knn_f = torch.zeros((cap, 6), **f32)
    knn_f[:n] = torch.randn((n, 6), generator=gen).to(device)
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return GaussianState(
        xyz=xyz, knn_f=knn_f, features_dc=features_dc,
        features_rest=torch.zeros((cap, R, 3), **f32), scaling=scaling,
        rotation=rotation, opacity=opacity,
        language_feature=torch.zeros((cap, 3), **f32),
        instance_feature=torch.zeros((cap, 3), **f32), alive=alive)


@dataclasses.dataclass
class DensifyStats:
    """Densification statistics accumulated over iterations
    (gaussian_model.py:75-80, 720-724)."""
    xyz_gradient_accum: torch.Tensor      # [CAP]
    xyz_gradient_accum_abs: torch.Tensor  # [CAP]
    denom: torch.Tensor                   # [CAP]
    denom_abs: torch.Tensor               # [CAP]
    max_radii2D: torch.Tensor             # [CAP]

    @classmethod
    def zeros(cls, cap: int, device: torch.device | str | None = None
              ) -> "DensifyStats":
        device = resolve_device(device)

        def z():
            return torch.zeros(cap, dtype=torch.float32, device=device)
        return cls(xyz_gradient_accum=z(), xyz_gradient_accum_abs=z(),
                   denom=z(), denom_abs=z(), max_radii2D=z())

    def update(self, mean2d_grad: torch.Tensor,
               mean2d_grad_abs: torch.Tensor, radii: torch.Tensor,
               update_filter: torch.Tensor) -> "DensifyStats":
        """add_densification_stats (gaussian_model.py:720-724) + the
        max_radii2D tracking of the train loop (gaussian_field.py:523-526)."""
        gn = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
        ga = torch.linalg.norm(mean2d_grad_abs[:, :2], dim=-1)
        f = update_filter
        ff = f.to(torch.float32)
        return DensifyStats(
            xyz_gradient_accum=self.xyz_gradient_accum
            + torch.where(f, gn, 0.0),
            xyz_gradient_accum_abs=self.xyz_gradient_accum_abs
            + torch.where(f, ga, 0.0),
            denom=self.denom + ff, denom_abs=self.denom_abs + ff,
            max_radii2D=torch.where(
                f, torch.maximum(self.max_radii2D, radii), self.max_radii2D))
