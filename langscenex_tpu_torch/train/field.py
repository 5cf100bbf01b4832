"""The render shim of field construction, port of ``render_view`` from the
JAX ``train/field.py`` (gaussian_renderer/__init__.py:42-239). The train
step, losses and trainer belong to the training slice.

Two pose modes, as in the JAX package: with ``pose`` (a [7] quat+t w2c
tensor) the splats are moved into the camera frame and rendered with an
identity view matrix; without it ``w2c`` is the view matrix. The all_map
plane channels are built in the render camera frame in both modes.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.projection import RasterCamera
from ..ops.quat import camera_from_tensor, quat_multiply
from ..ops.rasterize import RasterConfig, RenderOutput, rasterize
from ..scene.gaussians import GaussianState


def render_view(splats: GaussianState, pose: Optional[torch.Tensor],
                w2c: torch.Tensor, cam: RasterCamera, bg: torch.Tensor,
                sh_degree: int, include_feature: bool, return_plane: bool,
                mean2d_offset: Optional[torch.Tensor],
                rcfg: RasterConfig) -> RenderOutput:
    opacity = splats.get_opacity()[:, 0] * splats.alive
    scales = splats.get_scaling()
    rot = splats.get_rotation()

    if pose is not None:
        rel = camera_from_tensor(pose)
        means = splats.xyz @ rel[:3, :3].T + rel[:3, 3]
        quats = quat_multiply(pose[None, :4] / torch.linalg.norm(pose[:4]),
                              rot)
        render_w2c = torch.eye(4, dtype=torch.float32, device=pose.device)
        eff_w2c = rel        # the true frame the rasterizer sees
    else:
        means = splats.xyz
        quats = rot
        render_w2c = w2c
        eff_w2c = w2c

    rcam = RasterCamera(w2c=render_w2c, proj=cam.proj, width=cam.width,
                        height=cam.height, tan_fovx=cam.tan_fovx,
                        tan_fovy=cam.tan_fovy)

    all_map = None
    if return_plane:
        cam_center = -(eff_w2c[:3, :3].T @ eff_w2c[:3, 3])
        global_normal = splats.get_normal(cam_center)
        local_normal = global_normal @ eff_w2c[:3, :3].T
        pts_in_cam = splats.xyz @ eff_w2c[:3, :3].T + eff_w2c[:3, 3]
        local_distance = torch.abs((local_normal * pts_in_cam).sum(-1))
        all_map = torch.cat([local_normal,
                             torch.ones_like(local_distance[:, None]),
                             local_distance[:, None]], -1)

    return rasterize(
        means, scales, quats, opacity, rcam, bg,
        shs=splats.get_features(), sh_degree=sh_degree,
        language_feature=splats.language_feature if include_feature else None,
        instance_feature=splats.instance_feature if include_feature else None,
        all_map=all_map, mean2d_offset=mean2d_offset, cfg=rcfg)
