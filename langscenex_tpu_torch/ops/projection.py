"""Per-splat preprocess pass: cull, project, cov2D, conic, radii, tile AABB.

Port of the JAX ``ops/projection.py`` (parity target: forward.cu
preprocessCUDA:156-268). Plain batched tensor code on [P] component
vectors, in the JAX package's operation order.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import sh as sh_ops
from .covariance import compute_cov3d, compute_cov2d, conic_and_radius
from .transforms import ndc_to_pix

# Near-plane cull threshold (auxiliary.h in_frustum: p_view.z <= 0.2).
NEAR_CULL_Z = 0.2


@dataclasses.dataclass(frozen=True)
class RasterCamera:
    """Camera for rasterization. ``w2c`` and ``proj`` are [4,4] float32
    math-convention tensors on the render device (x_cam = W2C @ x_w);
    ``full_proj = proj @ w2c``. Width and height are python ints."""
    w2c: torch.Tensor
    proj: torch.Tensor
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_fovy)

    @property
    def cx(self) -> float:
        # rasterizer_impl.cu:339 — principal point fixed at image center
        return self.width * 0.5

    @property
    def cy(self) -> float:
        return self.height * 0.5

    @property
    def full_proj(self) -> torch.Tensor:
        return self.proj @ self.w2c

    @property
    def cam_center(self) -> torch.Tensor:
        R = self.w2c[:3, :3]
        t = self.w2c[:3, 3]
        return -R.T @ t


class ProcessedSplats(NamedTuple):
    mean2d: torch.Tensor        # [P,2] pixel coords
    depth: torch.Tensor         # [P] camera-space z
    conic: torch.Tensor         # [P,3] inverse 2D covariance (a,b,c)
    radius: torch.Tensor        # [P] float, 0 for culled
    rgb: torch.Tensor           # [P,3] view-dependent color
    visible: torch.Tensor       # [P] bool
    rect_min: torch.Tensor      # [P,2] int32 tile coords (x,y)
    rect_max: torch.Tensor      # [P,2] int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # [P] int32


def _to_i32(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Float -> int32 truncation as XLA does it (saturating, NaN -> 0),
    for a result the caller clips to [lo, hi]. Clamping to [lo-1, hi+1]
    first keeps the cast in range without changing the clipped value."""
    x = torch.nan_to_num(x, nan=0.0).clamp(lo - 1.0, hi + 1.0)
    return x.to(torch.int32)


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    cam: RasterCamera,
    shs: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    tile_w: int = 128,
    tile_h: int = 8,
    mean2d_offset: Optional[torch.Tensor] = None,
    opacity: Optional[torch.Tensor] = None,
) -> ProcessedSplats:
    """Vectorized splat preprocess (forward.cu:156-268)."""
    mx, my, mz = means3d[..., 0], means3d[..., 1], means3d[..., 2]

    w2c = cam.w2c
    depth = w2c[2, 0] * mx + w2c[2, 1] * my + w2c[2, 2] * mz + w2c[2, 3]
    in_front = depth > NEAR_CULL_Z

    fp = cam.full_proj
    hx = fp[0, 0] * mx + fp[0, 1] * my + fp[0, 2] * mz + fp[0, 3]
    hy = fp[1, 0] * mx + fp[1, 1] * my + fp[1, 2] * mz + fp[1, 3]
    hw = fp[3, 0] * mx + fp[3, 1] * my + fp[3, 2] * mz + fp[3, 3]
    # culled splats can sit at w ~ 0; clamp so the divide stays finite
    inv_w = 1.0 / torch.clamp(hw + 1e-7, min=1e-3)
    mean2d = torch.stack([ndc_to_pix(hx * inv_w, cam.width),
                          ndc_to_pix(hy * inv_w, cam.height)], -1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    cov3d = cov3d_precomp if cov3d_precomp is not None else compute_cov3d(
        scales, quats, scale_modifier)
    cov2d = compute_cov2d(means3d, cov3d, cam.w2c, cam.focal_x, cam.focal_y,
                          cam.tan_fovx, cam.tan_fovy)
    if opacity is None:
        conic, radius, det_ok = conic_and_radius(cov2d)
        r_bin = radius
    else:
        conic, radius, det_ok, r_bin = conic_and_radius(cov2d, opacity)

    # Tile AABB (auxiliary.h getRect), exclusive max
    grid_x = (cam.width + tile_w - 1) // tile_w
    grid_y = (cam.height + tile_h - 1) // tile_h
    m2x, m2y = mean2d[..., 0], mean2d[..., 1]
    rmin_x = _to_i32((m2x - r_bin) / tile_w, 0, grid_x).clamp(0, grid_x)
    rmin_y = _to_i32((m2y - r_bin) / tile_h, 0, grid_y).clamp(0, grid_y)
    rmax_x = _to_i32((m2x + radius + tile_w - 1) / tile_w,
                     0, grid_x).clamp(0, grid_x)
    rmax_y = _to_i32((m2y + radius + tile_h - 1) / tile_h,
                     0, grid_y).clamp(0, grid_y)
    if opacity is not None:
        # the tight rect is a proper ceil on r_bin intersected with the
        # 3-sigma rect (see the JAX preprocess for the dead-zone argument)
        rmax_x = torch.minimum(rmax_x, (_to_i32(torch.floor(
            (m2x + r_bin) / tile_w), -1, grid_x - 1) + 1).clamp(0, grid_x))
        rmax_y = torch.minimum(rmax_y, (_to_i32(torch.floor(
            (m2y + r_bin) / tile_h), -1, grid_y - 1) + 1).clamp(0, grid_y))
    tiles = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    visible = in_front & det_ok & (tiles > 0)
    radius = torch.where(visible, radius, torch.zeros_like(radius))
    tiles = torch.where(visible, tiles, torch.zeros_like(tiles)).to(
        torch.int32)

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        if shs is None:
            raise ValueError("preprocess needs shs or colors_precomp")
        cc = cam.cam_center
        dx, dy, dz = mx - cc[0], my - cc[1], mz - cc[2]
        inv_n = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz,
                                             min=1e-24))
        rgb = sh_ops.sh_to_rgb_fast(sh_degree, shs,
                                    dx * inv_n, dy * inv_n, dz * inv_n)

    return ProcessedSplats(
        mean2d=mean2d, depth=depth, conic=conic, radius=radius, rgb=rgb,
        visible=visible,
        rect_min=torch.stack([rmin_x, rmin_y], -1),
        rect_max=torch.stack([rmax_x, rmax_y], -1),
        tiles_touched=tiles)
