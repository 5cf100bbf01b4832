"""Render mode, port of ``render_all_views`` from the JAX
``train/render_mode.py`` (gaussian_field.py:651-705). PNG writing, PCA
colormaps and TSDF fusion (``render_result``) are not ported yet.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from ..ops.rasterize import RasterConfig
from ..scene.cameras import Camera
from ..scene.gaussians import GaussianState
from .field import render_view


def render_all_views(splats: GaussianState, cams: List[Camera],
                     rcfg: RasterConfig, sh_degree: int = 3,
                     bg: Optional[torch.Tensor] = None,
                     include_feature: bool = True
                     ) -> Iterator[tuple[Camera, dict]]:
    """Yield (camera, dict of rendered maps) per camera, rendering on the
    splats' device. Besides the JAX package's maps (tensors here, in its
    [C,H,W] / [H,W] layouts) each dict carries the view's binning
    counters ``num_pairs``, ``pairs_overflowed`` and ``k_overflowed``."""
    device = splats.device
    bg = torch.zeros(3, device=device) if bg is None else bg
    rcam = cams[0].raster_camera(device=device)
    for cam in cams:
        w2c = torch.as_tensor(cam.w2c, device=device)
        out = render_view(splats, None, w2c, rcam, bg, sh_degree,
                          include_feature, True, None, rcfg)
        maps = {
            "render": out.color,
            "plane_depth": out.plane_depth,
            "rendered_normal": out.all_map[:3],
            "alpha": out.all_map[3],
            "num_pairs": out.num_pairs,
            "pairs_overflowed": out.pairs_overflowed,
            "k_overflowed": out.k_overflowed,
        }
        if include_feature:
            maps["language_feature"] = out.language
            maps["instance_feature"] = out.instance
        yield cam, maps
