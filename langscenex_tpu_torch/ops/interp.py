"""Border-clamped bilinear sampling in pixel coordinates, port of
``bilinear_sample_border`` from the JAX ``ops/interp.py``
(grid_sample mode='bilinear', padding='border', align_corners=True). The
bicubic resize of that module belongs to other stages and is not ported
yet."""
from __future__ import annotations

import torch


def bilinear_sample_border(img: torch.Tensor, xy: torch.Tensor
                           ) -> torch.Tensor:
    """Sample [C,H,W] at pixel coordinates xy [N,2] (x, y), border-clamped
    bilinear. Returns [C,N]."""
    C, H, W = img.shape
    x = torch.clamp(xy[:, 0], 0.0, W - 1.0)
    y = torch.clamp(xy[:, 1], 0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = x - x0
    wy = y - y0
    a = img[:, y0, x0]
    b = img[:, y0, x1]
    c = img[:, y1, x0]
    d = img[:, y1, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)
