"""Sampling and resizing, ports of the JAX ``ops/interp.py`` and of the
``jax.image.resize`` calls of the SAM models.

- ``bilinear_sample_border``: border-clamped bilinear sampling in pixel
  coordinates (grid_sample mode='bilinear', padding='border',
  align_corners=True);
- ``resize_bicubic_torch``: torch's own bicubic (the JAX package's
  ``resize_bicubic_torch``);
- ``resize_linear`` and ``resize_nearest``: ``jax.image.resize``'s
  'bilinear' (a triangle kernel widened by the scale when it shrinks, with
  ``antialias``, its weights renormalised at the edges) and 'nearest'
  (half-pixel centres, floor((i + 0.5) * in / out) in float32) on the last
  two axes. ``F.interpolate`` differs from both at the edges and in its
  antialiased weights, so the linear resize builds JAX's separable weight
  matrices (in float32, as JAX does) and applies them as two matmuls.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_F = np.float32


def _linear_weights(n_in: int, n_out: int, antialias: bool) -> np.ndarray:
    """jax.image's compute_weight_mat for the triangle kernel: [in, out]."""
    inv_scale = _F(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, _F(1.0)) if antialias else _F(1.0)
    sample_f = (np.arange(n_out, dtype=_F) + _F(0.5)) * inv_scale - _F(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=_F)[:, None]
               ) / kernel_scale
    w = np.maximum(_F(0), _F(1) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=_F)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(_F).eps),
                 w / np.where(total != 0, total, _F(1)), _F(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, _F(0)).astype(_F)


def resize_linear(x: torch.Tensor, size: Tuple[int, int],
                  antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, (..., *size), 'bilinear', antialias)`` over
    the last two axes of a float tensor."""
    H, W = x.shape[-2:]
    if H != size[0]:
        wh = torch.from_numpy(_linear_weights(H, size[0], antialias))
        x = torch.einsum("...hw,ho->...ow", x, wh.to(x.device, x.dtype))
    if W != size[1]:
        ww = torch.from_numpy(_linear_weights(W, size[1], antialias))
        x = torch.einsum("...hw,wo->...ho", x, ww.to(x.device, x.dtype))
    return x


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """jax.image's nearest source index of each output sample."""
    off = (np.arange(n_out, dtype=_F) + _F(0.5)) * _F(n_in) / _F(n_out)
    return np.floor(off.astype(_F)).astype(np.int64)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (..., *size), 'nearest')`` over the last two
    axes (torch's 'nearest-exact' up to the float32 rounding)."""
    H, W = x.shape[-2:]
    if H != size[0]:
        x = x.index_select(-2, torch.from_numpy(
            nearest_index(H, size[0])).to(x.device))
    if W != size[1]:
        x = x.index_select(-1, torch.from_numpy(
            nearest_index(W, size[1])).to(x.device))
    return x


def resize_bicubic_torch(x: torch.Tensor, size: Tuple[int, int]
                         ) -> torch.Tensor:
    """Bicubic resize of [B, C, H, W] (torch's align_corners=False,
    antialias=False), which the JAX package reproduces with matmuls."""
    return F.interpolate(x, size=tuple(size), mode="bicubic",
                         align_corners=False)


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
