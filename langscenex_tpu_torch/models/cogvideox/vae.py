"""CogVideoX 3D causal VAE (encoder + decoder).

Port of the JAX ``langscenex_tpu/models/cogvideox/vae.py`` (architecture
of diffusers' AutoencoderKLCogVideoX): 8× spatial / 4× temporal
compression, 16 latent channels, causal 3D convolutions (the first frame
replicated into the past, so frame t never sees t+1), GroupNorm + SiLU
ResNet blocks over the channel ladder [128, 256, 256, 512], a decoder
whose every norm is conditioned on the latent z (SpatialNorm3D), and
temporal down/upsampling at the first two blocks with the odd frame-count
convention (4k+1 frames: the first frame is held out).

The state_dict uses diffusers' keys, so a diffusers checkpoint loads as
it is; ``convert.cogvideox_vae_from_numpy`` carries the JAX model's
params across. Internally tensors are [B, C, T, H, W]; the public
``encode``/``decode`` keep the JAX layout [B, T, C, H, W]. There is no
Pallas kernel here: the convolutions and GroupNorms are PyTorch's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Sequence[int] = (128, 256, 256, 512)
    layers_per_block: int = 3
    temporal_compression: int = 4     # 2 temporal stages (log2)
    norm_groups: int = 32
    scaling_factor: float = 1.15258426

    @property
    def temporal_levels(self) -> int:
        return {4: 2, 2: 1, 1: 0}[self.temporal_compression]


class CausalConv3d(nn.Module):
    """CogVideoXCausalConv3d: replicate the first frame (kt-1)× into the
    past, zero-pad space, convolve. Key ``<name>.conv``."""

    def __init__(self, cin: int, cout: int, k=3):
        super().__init__()
        k = (k, k, k) if isinstance(k, int) else tuple(k)
        self.kt = k[0]
        self.conv = nn.Conv3d(cin, cout, k, padding=(0, k[1] // 2, k[2] // 2))

    def forward(self, x):                      # [B, C, T, H, W]
        if self.kt > 1:
            x = torch.cat([x[:, :, :1].expand(-1, -1, self.kt - 1, -1, -1),
                           x], dim=2)
        return self.conv(x)


def _nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    return torch.arange(n_out, device=device) * n_in // n_out


def _nearest_resize(z: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """Nearest resize of z [B, C, T, H, W] to (t, h, w): output index i
    reads input i·n_in // n_out on each axis (torch's nearest)."""
    _, _, T, H, W = z.shape
    dev = z.device
    z = z.index_select(2, _nearest_index(t, T, dev))
    z = z.index_select(3, _nearest_index(h, H, dev))
    return z.index_select(4, _nearest_index(w, W, dev))


class SpatialNorm3D(nn.Module):
    """CogVideoXSpatialNorm3D: GroupNorm(f)·conv_y(zq) + conv_b(zq), zq
    the latent nearest-resized to f's (T, H, W) with the odd-frame
    first/rest split."""

    def __init__(self, f_ch: int, z_ch: int, groups: int):
        super().__init__()
        self.norm_layer = nn.GroupNorm(min(groups, f_ch), f_ch, eps=1e-6)
        self.conv_y = CausalConv3d(z_ch, f_ch, 1)
        self.conv_b = CausalConv3d(z_ch, f_ch, 1)

    def forward(self, f, zq):
        Tf, Hf, Wf = f.shape[2:]
        if Tf > 1 and Tf % 2 == 1:
            zq = torch.cat([_nearest_resize(zq[:, :, :1], 1, Hf, Wf),
                            _nearest_resize(zq[:, :, 1:], Tf - 1, Hf, Wf)],
                           dim=2)
        else:
            zq = _nearest_resize(zq, Tf, Hf, Wf)
        return self.norm_layer(f) * self.conv_y(zq) + self.conv_b(zq)


class ResnetBlock3D(nn.Module):
    """CogVideoXResnetBlock3D; with ``z_ch`` the norms are z-conditioned
    SpatialNorm3D (decoder), otherwise GroupNorm."""

    def __init__(self, cin: int, cout: int, groups: int, z_ch=None):
        super().__init__()
        self.spatial = z_ch is not None
        if self.spatial:
            self.norm1 = SpatialNorm3D(cin, z_ch, groups)
            self.norm2 = SpatialNorm3D(cout, z_ch, groups)
        else:
            self.norm1 = nn.GroupNorm(min(groups, cin), cin, eps=1e-6)
            self.norm2 = nn.GroupNorm(min(groups, cout), cout, eps=1e-6)
        self.conv1 = CausalConv3d(cin, cout, 3)
        self.conv2 = CausalConv3d(cout, cout, 3)
        self.conv_shortcut = nn.Conv3d(cin, cout, 1) if cin != cout else None

    def forward(self, x, zq=None):
        def norm(m, h):
            return m(h, zq) if self.spatial else m(h)

        h = self.conv1(F.silu(norm(self.norm1, x)))
        h = self.conv2(F.silu(norm(self.norm2, h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _avg_pool_time(x: torch.Tensor) -> torch.Tensor:
    """Odd T keeps frame 0 and averages the rest in pairs; even T averages
    every pair."""
    B, C, T, H, W = x.shape
    if T % 2 == 1:
        rest = x[:, :, 1:]
        if rest.shape[2] > 0:
            rest = rest.reshape(B, C, (T - 1) // 2, 2, H, W).mean(3)
        return torch.cat([x[:, :, :1], rest], dim=2)
    return x.reshape(B, C, T // 2, 2, H, W).mean(3)


class Downsample3D(nn.Module):
    """CogVideoXDownsample3D: optional temporal average pool, then a
    per-frame 3×3 stride-2 conv after a (right, bottom) zero pad. Key
    ``conv`` is the diffusers Conv2d."""

    def __init__(self, ch: int, compress_time: bool):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)
        self.compress_time = compress_time

    def forward(self, x):
        if self.compress_time:
            x = _avg_pool_time(x)
        x = F.pad(x, (0, 1, 0, 1))
        return F.conv3d(x, self.conv.weight[:, :, None], self.conv.bias,
                        stride=(1, 2, 2))


def _upsample2x(x: torch.Tensor, time: bool) -> torch.Tensor:
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return x.repeat_interleave(2, dim=2) if time else x


class Upsample3D(nn.Module):
    """CogVideoXUpsample3D: nearest 2× upsampling (an odd T > 1 holds the
    first frame out of the temporal doubling), then a per-frame 3×3
    conv."""

    def __init__(self, ch: int, compress_time: bool):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)
        self.compress_time = compress_time

    def forward(self, x):
        T = x.shape[2]
        if self.compress_time and T > 1 and T % 2 == 1:
            x = torch.cat([_upsample2x(x[:, :, :1], False),
                           _upsample2x(x[:, :, 1:], True)], dim=2)
        else:
            x = _upsample2x(x, self.compress_time and T > 1)
        return F.conv3d(x, self.conv.weight[:, :, None], self.conv.bias,
                        padding=(0, 1, 1))


class _Blocks(nn.Module):
    """A down/up block (resnets + optional sampler) or the mid block,
    with diffusers' key names."""

    def __init__(self, resnets, sampler=None, sampler_name=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class Encoder(nn.Module):
    """CogVideoXEncoder3D: down blocks (time compression at the first
    ``temporal_levels``), a 2-resnet mid block, GroupNorm + SiLU +
    conv_out to 2·latent moments."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs, g = cfg.block_out_channels, cfg.norm_groups
        self.conv_in = CausalConv3d(cfg.in_channels, chs[0], 3)
        blocks = []
        for i, ch in enumerate(chs):
            cin = chs[i - 1] if i > 0 else chs[0]
            resnets = [ResnetBlock3D(cin if j == 0 else ch, ch, g)
                       for j in range(cfg.layers_per_block)]
            down = (Downsample3D(ch, i < cfg.temporal_levels)
                    if i < len(chs) - 1 else None)
            blocks.append(_Blocks(resnets, down, "downsamplers"))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Blocks([ResnetBlock3D(chs[-1], chs[-1], g)
                                  for _ in range(2)])
        self.norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = CausalConv3d(chs[-1], 2 * cfg.latent_channels, 3)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        for r in self.mid_block.resnets:
            h = r(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """CogVideoXDecoder3D: conv_in, a spatial-norm mid block, up blocks
    (layers_per_block + 1 resnets, time expansion at the first
    ``temporal_levels``), SpatialNorm + SiLU + conv_out; every norm is
    conditioned on the input latent z."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs, g = list(reversed(cfg.block_out_channels)), cfg.norm_groups
        z = cfg.latent_channels
        self.conv_in = CausalConv3d(z, chs[0], 3)
        self.mid_block = _Blocks([ResnetBlock3D(chs[0], chs[0], g, z)
                                  for _ in range(2)])
        blocks = []
        for i, ch in enumerate(chs):
            cin = chs[i - 1] if i > 0 else chs[0]
            resnets = [ResnetBlock3D(cin if j == 0 else ch, ch, g, z)
                       for j in range(cfg.layers_per_block + 1)]
            up = (Upsample3D(ch, i < cfg.temporal_levels)
                  if i < len(chs) - 1 else None)
            blocks.append(_Blocks(resnets, up, "upsamplers"))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = SpatialNorm3D(chs[-1], z, g)
        self.conv_out = CausalConv3d(chs[-1], cfg.out_channels, 3)

    def forward(self, zq):
        h = self.conv_in(zq)
        for r in self.mid_block.resnets:
            h = r(h, zq)
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h, zq)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.norm_out(h, zq)))


class AutoencoderKL3D(nn.Module):
    """The VAE, its parameters allocated on ``device`` (the GPU unless the
    caller names another; ``"meta"`` allocates nothing).
    ``encode``/``decode`` take and return [B, T, C, H, W]. No quant convs
    (``use_quant_conv=False`` in the CogVideoX config)."""

    def __init__(self, cfg: VAEConfig = VAEConfig(),
                 device: torch.device | str | None = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)

    def encode(self, video: torch.Tensor):
        """[B,T,3,H,W] -> (mean, logvar), each [B,T',16,H/8,W/8]."""
        m = self.encoder(video.permute(0, 2, 1, 3, 4))
        return m.permute(0, 2, 1, 3, 4).chunk(2, dim=2)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """[B,T',16,H',W'] -> [B,T,3,8H',8W']."""
        out = self.decoder(latents.permute(0, 2, 1, 3, 4))
        return out.permute(0, 2, 1, 3, 4)


def _blend_profile(n: int, ramp: int, device=None) -> torch.Tensor:
    w = torch.ones(n, device=device)
    if ramp > 0:
        r = torch.linspace(0, 1, ramp, device=device)
        w[:ramp] = torch.minimum(w[:ramp], r)
        w[-ramp:] = torch.minimum(w[-ramp:], r.flip(0))
    return w


def spatial_tile_decode(apply_fn: Callable, latents: torch.Tensor,
                        tile: int = 32, overlap: int = 8) -> torch.Tensor:
    """Memory-bounded tiled decode: decode overlapping spatial latent
    tiles with ``apply_fn`` and blend the seams linearly. Returns f32."""
    B, T, C, H, W = latents.shape
    sf = 8
    out = wsum = None
    step = tile - overlap
    for yi in range(0, max(H - overlap, 1), step):
        for xi in range(0, max(W - overlap, 1), step):
            dec = apply_fn(latents[:, :, :, yi:yi + tile, xi:xi + tile])
            if out is None:
                out = torch.zeros((B, dec.shape[1], dec.shape[2], H * sf,
                                   W * sf), device=dec.device)
                wsum = torch.zeros((H * sf, W * sf), device=dec.device)
            hh, ww = dec.shape[-2:]
            wmap = (_blend_profile(hh, overlap * sf, dec.device)[:, None]
                    * _blend_profile(ww, overlap * sf, dec.device)[None])
            ys, xs = slice(yi * sf, yi * sf + hh), slice(xi * sf,
                                                         xi * sf + ww)
            out[..., ys, xs] += dec.float() * wmap
            wsum[ys, xs] += wmap
    return out / torch.clamp(wsum, min=1e-8)
