"""The per-scene language autoencoder (768-d CLIP/OpenSeg -> 3-d), port of
the JAX ``models/autoencoder.py`` (the reference's
field_construction/auto_encoder.py:28-73): an encoder MLP 768 -> [512,
256, 128, 64, 32, 16] -> 3 with BatchNorm1d + ReLU before every hidden
Linear, a ReLU-MLP decoder 3 -> [16, 32, 64, 128, 256, 512] -> 768; the
latent and the output are L2-normalised by x / sqrt(max(sum x^2,
1e-12)) (not ``F.normalize``, which clamps the norm, not its square).

The state_dict has the reference's keys (``encoder.{0,3,6,...}`` Linear,
``encoder.{1,4,...}`` BatchNorm1d, ``decoder.{0,2,...}`` Linear). The
batch norm is flax's ``BatchNorm(momentum=0.9)`` as the JAX package runs
it, which ``nn.BatchNorm1d`` is not: in training it normalises with the
biased batch variance E[x^2] - E[x]^2 (clipped at 0) and updates the
running variance with that same biased value (torch's uses the unbiased
one), with weight 0.1 on the batch. ``convert.autoencoder_from_numpy``
carries the JAX params and batch_stats across.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device

ENCODER_DIMS = (512, 256, 128, 64, 32, 16, 3)
DECODER_DIMS = (16, 32, 64, 128, 256, 512, 768)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                      min=eps))


class BatchNorm(nn.Module):
    """BatchNorm1d's parameters and buffers with flax's statistics (see
    the module's docstring); ``momentum`` is flax's (0.9 keeps 90% of the
    running value)."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if self.training:
            mean = x.mean(0)
            var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (self.weight * torch.rsqrt(var + self.eps)) \
            + self.bias


class Autoencoder(nn.Module):
    """``encode``/``decode``/``forward`` as the JAX model's methods; the
    batch norms use the batch's statistics in ``train()`` mode and the
    running ones in ``eval()`` mode. Parameters on ``device`` (the GPU
    unless the caller names another)."""

    def __init__(self, encoder_dims: Sequence[int] = ENCODER_DIMS,
                 decoder_dims: Sequence[int] = DECODER_DIMS,
                 input_dim: int = 768,
                 device: torch.device | str | None = None):
        super().__init__()
        with torch.device(resolve_device(device)):
            enc, prev = [], input_dim
            for i, d in enumerate(encoder_dims):
                if i > 0:
                    enc += [BatchNorm(prev), nn.ReLU()]
                enc.append(nn.Linear(prev, d))
                prev = d
            dec = []
            for i, d in enumerate(decoder_dims):
                if i > 0:
                    dec.append(nn.ReLU())
                dec.append(nn.Linear(prev, d))
                prev = d
            self.encoder = nn.ModuleList(enc)
            self.decoder = nn.ModuleList(dec)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.encoder:
            x = m(x)
        return _l2norm(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        for m in self.decoder:
            z = m(z)
        return _l2norm(z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def init_autoencoder_params(model: Autoencoder, seed: int = 0
                            ) -> Autoencoder:
    """Seeded random weights in place with flax's default laws (Dense
    kernels N(0, 1/fan_in), biases 0, batch norms 1 and 0, running mean 0
    and variance 1)."""
    gen = torch.Generator(device=model.encoder[0].weight.device
                          ).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                 generator=gen)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
    return model


def cos_loss_axis0(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference's loss_utils.cos_loss: 1 - mean cosine similarity
    along axis 0 (the batch axis)."""
    num = (x * y).sum(0)
    den = (torch.sqrt(torch.clamp((x * x).sum(0), min=1e-16))
           * torch.sqrt(torch.clamp((y * y).sum(0), min=1e-16)))
    return 1.0 - (num / den).mean()


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.mse_loss(x, y)
