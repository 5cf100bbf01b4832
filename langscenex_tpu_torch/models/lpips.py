"""LPIPS perceptual distance (VGG16 features and learned linear heads).

Port of the JAX ``langscenex_tpu/models/lpips.py`` (taming-style LPIPS:
the input shifted and scaled, VGG16's relu1_2 .. relu5_3 features, each
unit-normalised over channels, squared differences through learned 1x1
heads, a spatial mean, summed over the five layers). The unit norm is the
JAX package's ``x / sqrt(max(sum x^2, eps^2))``, not taming's
``x / (|x| + eps)``.

The module's state_dict uses taming's keys: ``scaling_layer.{shift,
scale}``, ``net.slice{1..5}.<torchvision index>.{weight,bias}`` and
``lin{0..4}.model.1.weight``, so the reference ``vgg_lpips`` checkpoint
(its ``lin*`` heads) and torchvision's VGG16 features load with
``load_state_dict``; ``convert.lpips_from_numpy`` carries the JAX
model's params across. ``per_frame`` adapts it to the trainer's
[B, T, 3, H, W] videos.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..utils.device import resolve_device

SHIFT = (-.030, -.088, -.188)
SCALE = (.458, .448, .450)

VGG_CFG = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
           512, 512, 512, 'M', 512, 512, 512)
TAP_CHANNELS = (64, 128, 256, 512, 512)
# torchvision VGG16 ``features`` indices of each slice (taming's vgg16)
SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))


class VGG16Features(nn.Module):
    """taming's vgg16: torchvision's ``features`` cut into five slices,
    each ending at a tap; modules keep their torchvision indices."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in VGG_CFG:
            if v == 'M':
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        for s, (a, b) in enumerate(SLICES):
            sl = nn.Sequential()
            for i in range(a, b):
                sl.add_module(str(i), layers[i])
            setattr(self, f"slice{s + 1}", sl)

    def forward(self, x: torch.Tensor) -> list:
        """x [B,3,H,W] (already scaled) -> the five taps [B,C,h,w]."""
        taps = []
        for s in range(len(SLICES)):
            x = getattr(self, f"slice{s + 1}")(x)
            taps.append(x)
        return taps


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT)[None, :, None,
                                                         None])
        self.register_buffer("scale", torch.tensor(SCALE)[None, :, None,
                                                         None])

    def forward(self, x):
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """taming's head: ``model.1`` is the 1x1 conv (index 0, taming's
    dropout, holds nothing and is the identity here)."""

    def __init__(self, cin: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(cin, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    n = torch.sqrt(torch.clamp((x * x).sum(1, keepdim=True), min=eps * eps))
    return x / n


class LPIPS(nn.Module):
    """[B,3,H,W] pairs in [-1, 1] -> [B] perceptual distances. Parameters
    on ``device`` (the GPU unless the caller names another)."""

    def __init__(self, device: torch.device | str | None = None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.scaling_layer = ScalingLayer()
            self.net = VGG16Features()
            for i, c in enumerate(TAP_CHANNELS):
                setattr(self, f"lin{i}", NetLinLayer(c))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = self.net(self.scaling_layer(a))
        fb = self.net(self.scaling_layer(b))
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            d = (_unit_normalize(xa) - _unit_normalize(xb)) ** 2
            total = total + getattr(self, f"lin{i}")(d).mean((1, 2, 3))
        return total


def per_frame(lpips: nn.Module):
    """``lpips_fn`` for the VAE trainer: [B,T,3,H,W] pairs -> per-frame
    distances [B,T,1,1,1], which broadcast over the pixel-wise error."""
    def fn(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        B, T = recon.shape[:2]
        d = lpips(recon.reshape(B * T, *recon.shape[2:]),
                  target.reshape(B * T, *target.shape[2:]))
        return d.reshape(B, T, 1, 1, 1)
    return fn
