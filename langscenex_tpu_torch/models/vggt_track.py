"""VGGT's track head: iterative point tracking over the frames, port of the
JAX ``models/vggt_track.py``.

Parity targets: vggt/heads/track_head.py:12-108 (the DPT feature
extractor at down ratio 2 and BaseTrackerPredictor),
track_modules/base_track_predictor.py:17-209 (correlation-pyramid
sampling and EfficientUpdateFormer refinement, 4 iterations),
track_modules/blocks.py (the update transformer with 64 virtual tracks
and interleaved time/space attention; CorrBlock's pyramid) and
track_modules/{modules,utils}.py (attention blocks whose residual adds
the NORMALISED input, CoTracker's linear-frequency 2D flow embedding,
align-corners bilinear sampling with zero padding, here
``F.grid_sample``).

The reference's quirks are kept: x = norm1(x); x = x + attn(x); the flow
embedding's frequencies rise linearly (arange(0, C, 2) * 1000 / C); the
virtual tracks' key is torch's historical typo ``virual_tracks``;
coordinates refine at feature scale and are reported times the stride.
The state_dict has the reference's keys (``ffeat_norm`` is a
GroupNorm(1, C), the same formula as the JAX package's LayerNorm). The
norms' eps is flax's 1e-6, as in the JAX package (the reference's torch
modules use 1e-5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .vggt import Mlp

EPS = 1e-6                       # flax's LayerNorm default


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    features: int = 128          # latent dim (the extractor's output)
    hidden_size: int = 384
    iters: int = 4
    stride: int = 2
    corr_levels: int = 7
    corr_radius: int = 4
    depth: int = 6               # time depth == space depth
    num_heads: int = 8
    mlp_ratio: float = 4.0
    num_virtual_tracks: int = 64
    max_scale: float = 518.0
    predict_conf: bool = True

    @property
    def transformer_dim(self) -> int:
        return 3 * self.features + 4


# ----------------------------------------------------------- sampling

def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img [M, C, H, W], xy [M, h, w, 2] (x, y) align-corners pixel
    coordinates -> [M, C, h, w]; taps outside the image read 0."""
    H, W = img.shape[-2:]
    gx = 2.0 * xy[..., 0] / max(W - 1, 1) - 1.0
    gy = 2.0 * xy[..., 1] / max(H - 1, 1) - 1.0
    return F.grid_sample(img, torch.stack([gx, gy], -1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def get_2d_embedding(xy: torch.Tensor, C: int) -> torch.Tensor:
    """[..., 2] -> [..., 2C]: CoTracker's LINEAR frequency ramp
    (track_modules/utils.py:93-124), sin/cos interleaved per axis."""
    div = torch.arange(0, C, 2, dtype=torch.float32,
                       device=xy.device) * (1000.0 / C)

    def axis_pe(v):
        s = torch.sin(v[..., None] * div)
        c = torch.cos(v[..., None] * div)
        return torch.stack([s, c], -1).reshape(*v.shape, C)

    return torch.cat([axis_pe(xy[..., 0]), axis_pe(xy[..., 1])], -1)


def sincos_pos_embed_2d(dim: int, HH: int, WW: int) -> torch.Tensor:
    """[HH, WW, dim]: the halves encode the x then the y grid with
    10000^-t frequencies (utils.get_2d_sincos_pos_embed:18-90), computed
    in float64 and rounded to float32 as the JAX package does."""
    def axis(pos, d):
        omega = 1.0 / (10000.0 ** (np.arange(d // 2, dtype=np.float64)
                                   / (d / 2.0)))
        out = pos.reshape(-1)[:, None] * omega[None]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gx, gy = np.meshgrid(np.arange(WW, dtype=np.float32),
                         np.arange(HH, dtype=np.float32), indexing="xy")
    emb = np.concatenate([axis(gx, dim // 2), axis(gy, dim // 2)], axis=1)
    return torch.from_numpy(emb.reshape(HH, WW, dim).astype(np.float32))


# -------------------------------------------------------------- blocks

class MHA(nn.Module):
    """nn.MultiheadAttention's parameters (fused in_proj, out_proj), the
    attention through scaled_dot_product_attention."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, kv):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        B, N, d = q.shape

        def heads(x):
            return x.reshape(B, x.shape[1], self.heads, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            heads(F.linear(q, wq, bq)), heads(F.linear(kv, wk, bk)),
            heads(F.linear(kv, wv, bv)))
        return self.out_proj(o.transpose(1, 2).reshape(B, N, d))


class AttnBlock(nn.Module):
    """blocks.py:148-185: the residual adds the NORMALISED x."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.attn = MHA(dim, heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = self.norm1(x)
        x = x + self.attn(x, x)
        return x + self.mlp(self.norm2(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.norm_context = nn.LayerNorm(dim, eps=EPS)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.cross_attn = MHA(dim, heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, context):
        x = self.norm1(x)
        x = x + self.cross_attn(x, self.norm_context(context))
        return x + self.mlp(self.norm2(x))


class EfficientUpdateFormer(nn.Module):
    """blocks.py:19-146: time self-attention, then space attention through
    the virtual tracks, at every one of ``depth`` steps."""

    def __init__(self, c: TrackConfig):
        super().__init__()
        h, d_in = c.hidden_size, c.transformer_dim
        self.cfg = c
        self.input_norm = nn.LayerNorm(d_in, eps=EPS)
        self.input_transform = nn.Linear(d_in, h)
        self.output_norm = nn.LayerNorm(h, eps=EPS)
        self.flow_head = nn.Linear(h, c.features + 2)
        self.virual_tracks = nn.Parameter(
            torch.zeros(1, c.num_virtual_tracks, 1, h))

        def blocks(cls):
            return nn.ModuleList([cls(h, c.num_heads, c.mlp_ratio)
                                  for _ in range(c.depth)])
        self.time_blocks = blocks(AttnBlock)
        self.space_virtual_blocks = blocks(AttnBlock)
        self.space_point2virtual_blocks = blocks(CrossAttnBlock)
        self.space_virtual2point_blocks = blocks(CrossAttnBlock)

    def forward(self, x):
        """x [B, N, S, D_in] -> delta [B, N, S, features + 2]."""
        tokens = self.input_transform(self.input_norm(x))
        init_tokens = tokens
        B, N, S, h = tokens.shape
        tokens = torch.cat([tokens, self.virual_tracks.expand(
            B, -1, S, -1)], 1)
        Nv = tokens.shape[1]
        for i in range(self.cfg.depth):
            tokens = self.time_blocks[i](tokens.reshape(B * Nv, S, h)
                                         ).reshape(B, Nv, S, h)
            sp = tokens.transpose(1, 2).reshape(B * S, Nv, h)
            pts, vt = sp[:, :N], sp[:, N:]
            vt = self.space_virtual2point_blocks[i](vt, pts)
            vt = self.space_virtual_blocks[i](vt)
            pts = self.space_point2virtual_blocks[i](pts, vt)
            tokens = torch.cat([pts, vt], 1).reshape(B, S, Nv, h
                                                     ).transpose(1, 2)
        tokens = tokens[:, :N] + init_tokens
        return self.flow_head(self.output_norm(tokens))


# ------------------------------------------------------------- tracker

def corr_pyramid(fmaps: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """fmaps [B,S,C,H,W] -> the avg-pooled levels (avg_pool2d k=2 s=2,
    which floors odd sizes)."""
    pyr = [fmaps]
    cur = fmaps
    for _ in range(levels - 1):
        B, S, C, H, W = cur.shape
        cur = F.avg_pool2d(cur.reshape(B * S, C, H, W), 2, 2)
        cur = cur.reshape(B, S, C, *cur.shape[-2:])
        pyr.append(cur)
    return pyr


def corr_sample(pyr, targets: torch.Tensor, coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """targets [B,S,N,C], coords [B,S,N,2] at feature scale -> [B,S,N,L]
    (CorrBlock.corr_sample, blocks.py:186-240)."""
    r = radius
    d1 = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    dy, dx = torch.meshgrid(d1, d1, indexing="ij")
    dxy = torch.stack([dx, dy], -1)              # [2r+1, 2r+1, (x, y)]
    B, S, N, _ = targets.shape
    out = []
    for i, fm in enumerate(pyr):
        C, H, W = fm.shape[2:]
        corr = torch.einsum("bsnc,bschw->bsnhw", targets, fm) / math.sqrt(C)
        pts = (coords / (2.0 ** i))[:, :, :, None, None, :] + dxy
        samp = bilinear_sample(corr.reshape(B * S * N, 1, H, W),
                               pts.reshape(B * S * N, 2 * r + 1, 2 * r + 1,
                                           2))
        out.append(samp.reshape(B, S, N, -1))
    return torch.cat(out, -1)


class BaseTrackerPredictor(nn.Module):
    """base_track_predictor.py:17-209."""

    def __init__(self, c: TrackConfig):
        super().__init__()
        self.cfg = c
        self.fmap_norm = nn.LayerNorm(c.features, eps=EPS)
        self.corr_mlp = Mlp(c.corr_levels * (2 * c.corr_radius + 1) ** 2,
                            c.hidden_size, c.features)
        self.updateformer = EfficientUpdateFormer(c)
        self.ffeat_norm = nn.GroupNorm(1, c.features, eps=EPS)
        self.ffeat_updater = nn.Sequential(nn.Linear(c.features, c.features),
                                           nn.GELU())
        self.query_ref_token = nn.Parameter(
            torch.zeros(1, 2, c.transformer_dim))
        self.vis_predictor = nn.Sequential(nn.Linear(c.features, 1))
        self.conf_predictor = nn.Sequential(nn.Linear(c.features, 1)) \
            if c.predict_conf else None

    def forward(self, query_points: torch.Tensor, fmaps: torch.Tensor,
                iters: Optional[int] = None):
        """query_points [B,N,2] full-resolution pixels; fmaps [B,S,C,H,W]
        at feature scale. Returns (coordinate predictions, vis, conf)."""
        c = self.cfg
        iters = iters or c.iters
        B, N, _ = query_points.shape
        S, C, HH, WW = fmaps.shape[1:]
        D = c.transformer_dim
        fmaps = self.fmap_norm(fmaps.permute(0, 1, 3, 4, 2)).permute(
            0, 1, 4, 2, 3)
        qp = query_points / float(c.stride)
        coords = qp[:, None].expand(B, S, N, 2)

        def at_queries(img):            # [B, ch, H, W] -> [B, N, ch]
            return bilinear_sample(img, qp[:, None]).reshape(
                B, img.shape[1], N).transpose(1, 2)
        track_feats = at_queries(fmaps[:, 0])[:, None].expand(B, S, N, C)
        pyr = corr_pyramid(fmaps, c.corr_levels)
        pos_grid = sincos_pos_embed_2d(D, HH, WW).to(fmaps.device)
        pos_of_query = at_queries(pos_grid.permute(2, 0, 1)[None].expand(
            B, D, HH, WW))                                    # [B,N,D]
        ref = torch.cat([self.query_ref_token[:, :1],
                         self.query_ref_token[:, 1:].expand(1, S - 1, D)],
                        1)

        coord_preds = []
        for _ in range(iters):
            coords = coords.detach()
            fcorrs = self.corr_mlp(corr_sample(pyr, track_feats, coords,
                                               c.corr_radius))
            flows = coords - coords[:, :1]
            femb = torch.cat([get_2d_embedding(flows, c.features // 2),
                              flows / c.max_scale, flows / c.max_scale], -1)
            x = torch.cat([femb, fcorrs, track_feats], -1)
            x = x + pos_of_query[:, None] + ref[:, :, None]
            delta = self.updateformer(x.transpose(1, 2)).transpose(1, 2)
            df = delta[..., 2:].reshape(-1, c.features)
            track_feats = track_feats + self.ffeat_updater(
                self.ffeat_norm(df)).reshape(B, S, N, c.features)
            coords = coords + delta[..., :2]
            # frame 0 back to the query positions (:186-189)
            coords = torch.cat([qp[:, None], coords[:, 1:]], 1)
            coord_preds.append(coords * c.stride)

        vis = torch.sigmoid(self.vis_predictor(track_feats)[..., 0])
        conf = None
        if self.conf_predictor is not None:
            conf = torch.sigmoid(self.conf_predictor(track_feats)[..., 0])
        return coord_preds, vis, conf
