"""Gaussian splat scene state, port of the JAX ``scene/gaussians.py``.

Fixed-capacity tensors with an ``alive`` mask, in the reference
GaussianModel's raw parameter space (gaussian_model.py:44-841):
log-space scaling (exp activation), logit-space opacity (sigmoid),
unnormalized wxyz rotation (normalized on use), SH dc + rest, and the
knn_f(6), language(3) and instance(3) channels. ``create_from_points``
and ``DensifyStats`` belong to the training slice and are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.quat import quat_normalize, quat_to_rotmat


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
