"""Hiera hierarchical ViT image encoder + FPN neck.

Port of the JAX ``langscenex_tpu/models/sam2/hiera.py`` (the reference's
sam2/modeling/backbones/hieradet.py and image_encoder.py, Hiera-L of
sam2_hiera_l.yaml: embed 144, heads 2, stages [2, 6, 36, 4], global
attention at blocks 23/33/43, window spec [8, 4, 16, 8], a (7, 7)
background position embedding, FPN top-down levels [2, 3], scalp 1).

The window size lags one stage (a stage's first block runs with the
previous stage's window); q-pooling blocks partition into windows first
and max-pool the queries inside each window; the absolute position
embedding is torch's bicubic resize of the background plus the tiled
window embedding. The top-down FPN path is ``jax.image.resize``'s nearest
(``ops/interp.resize_nearest``). Attention is
``scaled_dot_product_attention``.

Tensors are channels-first as in the reference ([B, C, H, W] between
modules; the trunk's blocks work on [B, H, W, C]); the state_dict uses
the sam2_hiera_large.pt keys under ``image_encoder``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.interp import resize_bicubic_torch, resize_nearest


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 144
    num_heads: int = 2
    stages: Sequence[int] = (2, 6, 36, 4)
    global_att_blocks: Sequence[int] = (23, 33, 43)
    window_spec: Sequence[int] = (8, 4, 16, 8)
    pos_embed_bkg_size: Tuple[int, int] = (7, 7)
    patch_size: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    mlp_ratio: float = 4.0
    q_pool: int = 3                      # number of pooling stage shifts
    neck_dim: int = 256
    fpn_top_down_levels: Sequence[int] = (2, 3)
    scalp: int = 1

    @property
    def stage_ends(self):
        s = self.stages
        return [sum(s[:i]) - 1 for i in range(1, len(s) + 1)]

    @property
    def q_pool_blocks(self):
        return [e + 1 for e in self.stage_ends[:-1]][:self.q_pool]

    @property
    def channel_list(self):
        """The trunk's stage widths, lowest resolution first (the neck's
        convs take them in this order)."""
        return [self.embed_dim * 2 ** i
                for i in range(len(self.stages))][::-1]


def window_partition(x: torch.Tensor, ws: int):
    """[B,H,W,C] -> ([B*nW, ws, ws, C], padded (Hp, Wp))."""
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = x.shape[0] // ((Hp // ws) * (Wp // ws))
    x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of [B,H,W,C]."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    """Fused qkv at dim_out, an optional 2x2 max pool of the query grid."""

    def __init__(self, dim: int, dim_out: int, heads: int,
                 q_pool: bool = False):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)
        self.heads = heads
        self.q_pool = q_pool

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.heads, -1)
        q, k, v = qkv.unbind(2)
        if self.q_pool:
            q = _pool2(q.reshape(B, H, W, -1))
            H, W = q.shape[1:3]
            q = q.reshape(B, H * W, self.heads, -1)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.proj(o.transpose(1, 2).reshape(B, H, W, -1))


class MultiScaleBlock(nn.Module):
    """``window_size`` is the pre-pool window (0 = global); q-pool blocks
    attend inside those windows and come out at half resolution."""

    def __init__(self, dim: int, dim_out: int, heads: int, window_size: int,
                 q_pool: bool, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, heads, q_pool)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        hidden = int(dim_out * mlp_ratio)
        self.mlp = nn.Module()
        self.mlp.layers = nn.ModuleList([nn.Linear(dim_out, hidden),
                                         nn.Linear(hidden, dim_out)])
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.dim, self.dim_out = dim, dim_out
        self.window_size = window_size
        self.q_pool = q_pool

    def forward(self, x):
        B, H, W, _ = x.shape
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_pool:
                shortcut = _pool2(shortcut)
        ws = self.window_size
        xw, pad_hw = window_partition(x, ws) if ws > 0 else (x, None)
        xw = self.attn(xw)
        if self.q_pool:
            ws = ws // 2
            H, W = shortcut.shape[1:3]
            if ws > 0:
                pad_hw = (-(-H // ws) * ws, -(-W // ws) * ws)
        x = (window_unpartition(xw, ws, pad_hw, (H, W))
             if self.window_size > 0 else xw)
        x = shortcut + x
        h = self.mlp.layers[1](F.gelu(self.mlp.layers[0](self.norm2(x))))
        return x + h


class Hiera(nn.Module):
    """[B,3,H,W] -> the four stage outputs [B, C_i, H_i, W_i], high
    resolution first."""

    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(
            3, cfg.embed_dim, cfg.patch_size, cfg.patch_stride,
            cfg.patch_padding)
        bh, bw = cfg.pos_embed_bkg_size
        w0 = cfg.window_spec[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.embed_dim, bh, bw))
        self.pos_embed_window = nn.Parameter(
            torch.zeros(1, cfg.embed_dim, w0, w0))
        stage_ends, q_pool_blocks = cfg.stage_ends, cfg.q_pool_blocks
        blocks = []
        dim, heads, cur_stage = cfg.embed_dim, cfg.num_heads, 1
        for i in range(sum(cfg.stages)):
            dim_out = dim
            ws = cfg.window_spec[cur_stage - 1]       # lags one stage
            if i in cfg.global_att_blocks:
                ws = 0
            if i - 1 in stage_ends:
                dim_out, heads = dim * 2, heads * 2
                cur_stage += 1
            blocks.append(MultiScaleBlock(dim, dim_out, heads, ws,
                                          i in q_pool_blocks,
                                          cfg.mlp_ratio))
            dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.patch_embed.proj(x)
        H, W = x.shape[-2:]
        pos = resize_bicubic_torch(self.pos_embed, (H, W))
        win = self.pos_embed_window
        pos = pos + win.tile([1, 1, H // win.shape[2], W // win.shape[3]])
        x = (x + pos).permute(0, 2, 3, 1)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.cfg.stage_ends:
                outs.append(x.permute(0, 3, 1, 2))
        return outs


def sine_pos_embed(h: int, w: int, dim: int, temperature: float = 10000.0,
                   device=None) -> torch.Tensor:
    """PositionEmbeddingSine (normalize=True, scale=2*pi): [dim, h, w],
    channels [y (dim/2), x (dim/2)], each interleaved (sin, cos) pairs at
    shared frequencies."""
    npf = dim // 2
    eps = 1e-6
    scale = 2.0 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device) / (
        h + eps) * scale
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device) / (
        w + eps) * scale
    i = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = temperature ** (2.0 * torch.floor(i / 2.0) / npf)

    def enc(v):
        a = v[:, None] / dim_t
        return torch.stack([a[:, 0::2].sin(), a[:, 1::2].cos()],
                           dim=-1).reshape(v.shape[0], npf)
    ye = enc(y)[:, None, :].expand(h, w, npf)
    xe = enc(x)[None, :, :].expand(h, w, npf)
    return torch.cat([ye, xe], -1).permute(2, 0, 1)


class _NeckConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)


class ImageEncoder(nn.Module):
    """Hiera trunk + FPN neck: per-level 1x1 convs indexed in reversed
    order (convs.0 takes the lowest-resolution stage), top-down nearest
    upsampling only at ``fpn_top_down_levels``, sine position encodings
    per level; ``scalp`` drops the lowest-resolution levels. Returns
    (backbone_fpn [B,C,h,w] high resolution first, vision_pos_enc [C,h,w]
    per level)."""

    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = Hiera(cfg)
        self.neck = nn.Module()
        self.neck.convs = nn.ModuleList([_NeckConv(c, cfg.neck_dim)
                                         for c in cfg.channel_list])

    def forward(self, images):
        xs = self.trunk(images)
        n = len(xs) - 1
        out, pos = [None] * len(xs), [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lat = self.neck.convs[n - i].conv(xs[i])
            if i in self.cfg.fpn_top_down_levels and prev is not None:
                prev = lat + resize_nearest(prev, lat.shape[-2:])
            else:
                prev = lat
            out[i] = prev
            pos[i] = sine_pos_embed(prev.shape[-2], prev.shape[-1],
                                    self.cfg.neck_dim, device=prev.device)
        if self.cfg.scalp > 0:
            out, pos = out[:-self.cfg.scalp], pos[:-self.cfg.scalp]
        return out, pos
