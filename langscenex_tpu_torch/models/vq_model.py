"""The VQ autoencoder of the LSeg branch, port of the JAX
``models/vq_model.py``: diffusers' ``VQModel`` at the reference's LSeg
compressor configuration (field_construction/preprocessor.py:115-127:
512 channels in and out, 4 latent channels, blocks [256, 64, 16], one
layer per block, GroupNorm in the encoder, SpatialNorm in the decoder,
1,024 codes).

The branch saves ``encode``'s CONTINUOUS latents, quant_conv(encoder(x))
before the codebook (diffusers' ``VQModel.encode().latents``), as
``lang_features_dim4/*_f.npy``; ``quantize`` (the nearest code by L2) and
``decode`` (lookup, post_quant_conv, the spatial-norm decoder) complete
the model. Diffusers hard-codes 32 GroupNorm groups, which the 16- and
64-channel stages of this plan cannot take; the JAX package uses 2
(``norm_num_groups``), and so does the port.

The state_dict has diffusers' keys (``encoder.down_blocks.N.resnets.M``,
``...downsamplers.0.conv``, ``mid_block.{resnets.0/1, attentions.0}``,
``quantize.embedding.weight``, the decoder's ``norm*.{norm_layer,
conv_y, conv_b}``); ``convert.vq_model_from_numpy`` carries the JAX params
across. Tensors are NCHW.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import resize_nearest
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VQConfig:
    in_channels: int = 512
    out_channels: int = 512
    latent_channels: int = 4
    norm_num_groups: int = 2
    block_out_channels: Tuple[int, ...] = (256, 64, 16)
    layers_per_block: int = 1
    num_vq_embeddings: int = 1024
    norm_type: str = "spatial"   # the decoder's norms; the encoder's: group


class SpatialNorm(nn.Module):
    """diffusers SpatialNorm: GN(f) * conv_y(zq) + conv_b(zq), zq
    nearest-resized (``jax.image.resize``'s 'nearest') to f's size."""

    def __init__(self, ch: int, zq_ch: int, groups: int):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, ch, eps=1e-6)
        self.conv_y = nn.Conv2d(zq_ch, ch, 1)
        self.conv_b = nn.Conv2d(zq_ch, ch, 1)

    def forward(self, f, zq):
        zq = resize_nearest(zq, tuple(f.shape[-2:]))
        return self.norm_layer(f) * self.conv_y(zq) + self.conv_b(zq)


def _norm(ch: int, cfg: VQConfig, spatial: bool) -> nn.Module:
    if spatial:
        return SpatialNorm(ch, cfg.latent_channels, cfg.norm_num_groups)
    return nn.GroupNorm(cfg.norm_num_groups, ch, eps=1e-6)


def _apply_norm(norm, x, zq):
    return norm(x, zq) if isinstance(norm, SpatialNorm) else norm(x)


class ResnetBlock2D(nn.Module):
    """(norm -> silu -> conv) twice and a 1x1 shortcut when the width
    changes; ``spatial`` norms take the latents zq."""

    def __init__(self, cin: int, cout: int, cfg: VQConfig,
                 spatial: bool = False):
        super().__init__()
        self.norm1 = _norm(cin, cfg, spatial)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout, cfg, spatial)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, zq=None):
        h = self.conv1(F.silu(_apply_norm(self.norm1, x, zq)))
        h = self.conv2(F.silu(_apply_norm(self.norm2, h, zq)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """The VAE mid-block's single-head attention over the flattened
    grid."""

    def __init__(self, ch: int, cfg: VQConfig, spatial: bool = False):
        super().__init__()
        if spatial:
            self.spatial_norm = SpatialNorm(ch, cfg.latent_channels,
                                            cfg.norm_num_groups)
        else:
            self.group_norm = nn.GroupNorm(cfg.norm_num_groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Dropout(0.0)])
        self.spatial = spatial

    def forward(self, x, zq=None):
        B, C, H, W = x.shape
        h = self.spatial_norm(x, zq) if self.spatial else self.group_norm(x)
        h = h.reshape(B, C, H * W).transpose(1, 2)[:, None]  # [B,1,HW,C]
        o = F.scaled_dot_product_attention(self.to_q(h), self.to_k(h),
                                           self.to_v(h))
        o = self.to_out[0](o[:, 0]).transpose(1, 2).reshape(B, C, H, W)
        return x + o


class Downsample(nn.Module):
    """A stride-2 3x3 conv after diffusers' asymmetric (0, 1) pad."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(resize_nearest(x, (2 * x.shape[-2],
                                            2 * x.shape[-1])))


class _Block(nn.Module):
    """An up or down block: its resnets and, but for the last, its
    ``downsamplers``/``upsamplers`` list of one."""

    def __init__(self, resnets, sampler_name, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self._sampler_name = sampler_name if sampler is not None else None
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))

    @property
    def sampler(self):
        if self._sampler_name is None:
            return None
        return getattr(self, self._sampler_name)[0]


class _MidBlock(nn.Module):
    def __init__(self, ch: int, cfg: VQConfig, spatial: bool):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, cfg, spatial),
                                      ResnetBlock2D(ch, ch, cfg, spatial)])
        self.attentions = nn.ModuleList([Attention(ch, cfg, spatial)])

    def forward(self, h, zq=None):
        h = self.resnets[0](h, zq)
        h = self.attentions[0](h, zq)
        return self.resnets[1](h, zq)


class Encoder(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks, prev = [], ch[0]
        for i, c in enumerate(ch):
            res = [ResnetBlock2D(prev if j == 0 else c, c, cfg)
                   for j in range(cfg.layers_per_block)]
            blocks.append(_Block(res, "downsamplers", Downsample(c)
                                 if i < len(ch) - 1 else None))
            prev = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(ch[-1], cfg, spatial=False)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[-1],
                                          eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if blk.sampler is not None:
                h = blk.sampler(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    """The mirror decoder with layers_per_block + 1 resnets per up block;
    with norm_type 'spatial' every norm is a SpatialNorm on zq."""

    def __init__(self, cfg: VQConfig):
        super().__init__()
        sp = cfg.norm_type == "spatial"
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], cfg, spatial=sp)
        blocks, prev = [], rev[0]
        for i, c in enumerate(rev):
            res = [ResnetBlock2D(prev if j == 0 else c, c, cfg, sp)
                   for j in range(cfg.layers_per_block + 1)]
            blocks.append(_Block(res, "upsamplers", Upsample(c)
                                 if i < len(rev) - 1 else None))
            prev = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _norm(rev[-1], cfg, sp)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z, zq):
        h = self.mid_block(self.conv_in(z), zq)
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h, zq)
            if blk.sampler is not None:
                h = blk.sampler(h)
        return self.conv_out(F.silu(_apply_norm(self.conv_norm_out, h, zq)))


class _Quantizer(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n, dim)


class VQModel(nn.Module):
    """x [B, in, H, W] -> ``encode`` -> continuous latents [B, 4, H/4, W/4]
    (three blocks); ``quantize`` -> (codebook rows, indices); ``decode``
    the lookup, post_quant_conv and the decoder; ``forward`` is decode of
    encode. Parameters on ``device`` (the GPU unless the caller names
    another)."""

    def __init__(self, cfg: VQConfig = VQConfig(),
                 device: torch.device | str | None = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)
            self.quant_conv = nn.Conv2d(cfg.latent_channels,
                                        cfg.latent_channels, 1)
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                             cfg.latent_channels, 1)
            self.quantize = _Quantizer(cfg.num_vq_embeddings,
                                       cfg.latent_channels)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def quantize_latents(self, z: torch.Tensor):
        """[B,C,H,W] -> (quantised z, code indices [B,H,W]): the nearest
        code by L2, |z|^2 - 2 z.c + |c|^2 as the JAX package computes it."""
        cb = self.quantize.embedding.weight
        flat = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1])
        d = ((flat ** 2).sum(-1, keepdim=True) - 2.0 * flat @ cb.T
             + (cb ** 2).sum(-1)[None])
        idx = torch.argmin(d, -1)
        zq = cb[idx].reshape(z.shape[0], z.shape[2], z.shape[3], -1)
        return zq.permute(0, 3, 1, 2), idx.reshape(z.shape[0], *z.shape[2:])

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        zq, _ = self.quantize_latents(z)
        return self.decoder(self.post_quant_conv(zq), zq)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def init_vq_params(model: VQModel, seed: int = 0) -> VQModel:
    """Seeded random weights in place with the laws of the JAX package's
    flax initialisers: conv and linear kernels N(0, 1/fan_in), biases 0,
    GroupNorms 1 and 0, the codebook uniform in [-1/n, 1/n) as diffusers'
    VectorQuantizer."""
    gen = torch.Generator(device=model.quant_conv.weight.device
                          ).manual_seed(seed)
    n = model.cfg.num_vq_embeddings
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()),
                                 generator=gen)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        model.quantize.embedding.weight.uniform_(-1.0 / n, 1.0 / n,
                                                 generator=gen)
    return model
