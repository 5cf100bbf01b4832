"""SAM2 streaming memory: memory attention + memory encoder.

Port of the JAX ``langscenex_tpu/models/sam2/memory.py`` (the reference's
sam/transformer.py RoPEAttention, position_encoding.compute_axial_cis,
memory_attention.py and memory_encoder.py with sam2_hiera_l.yaml's
flags): axial rotary encodings over the query grid, repeated over the
memory's spatial slots for the cross attention, with the trailing object
pointer tokens left unrotated (``num_k_exclude_rope``); four pre-LN
layers (RoPE self attention, RoPE cross attention into the 64-channel
memory, a ReLU FFN), +0.1 * pos at the input and a final LayerNorm; the
memory encoder's 4x stride-2 mask downsampler, 1x1 pixel projection, two
ConvNeXt fuser blocks and a 256 -> 64 projection.

The attention is ``scaled_dot_product_attention``: at 64 objects the
cross attention's logits would be 64 x 4,096 x (7 x 4,096 + pointers)
floats (about 30 GB a layer), which its memory-efficient backend never
allocates. LayerNorms use eps 1e-6 as the JAX package's do. The
state_dict uses the sam2_hiera_large.pt keys (``memory_attention``,
``memory_encoder``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .decoder import LN_EPS, AttentionDS, LayerNorm2d


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    dim: int = 256          # image feature dim (d_model)
    mem_dim: int = 64       # memory channel dim (kv_in_dim of cross attn)
    num_heads: int = 1
    depth: int = 4
    ffn_dim: int = 2048
    rope_theta: float = 10000.0
    num_maskmem: int = 7    # spatial memories kept (1 cond + 6 recent)
    max_obj_ptrs: int = 16


def axial_rope_cos_sin(dim: int, end_x: int, end_y: int, theta: float,
                       device=None):
    """(cos, sin) [end_x*end_y, dim/2]: the first dim/4 pairs rotate with
    x = idx % end_x, the rest with y = idx // end_x."""
    quarter = dim // 4
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 4, dtype=torch.float32,
                                          device=device)[:quarter] / dim))
    t = torch.arange(end_x * end_y, dtype=torch.float32, device=device)
    tx, ty = t % end_x, torch.floor(t / end_x)
    ang = torch.cat([tx[:, None] * freqs, ty[:, None] * freqs], -1)
    return ang.cos(), ang.sin()


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., N, hd]; (even, odd) channel pairs as (real, imag)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).flatten(-2)


class RoPEAttention(AttentionDS):
    def __init__(self, dim: int, heads: int, downsample_rate: int = 1,
                 kv_in_dim=None, rope_theta: float = 10000.0,
                 rope_k_repeat: bool = False):
        super().__init__(dim, heads, downsample_rate, kv_in_dim)
        self.rope_theta = rope_theta
        self.rope_k_repeat = rope_k_repeat

    def forward(self, q, k, v, num_k_exclude_rope: int = 0):
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        n_q, hd = q.shape[-2], q.shape[-1]
        side = int(round(math.sqrt(n_q)))
        cos, sin = axial_rope_cos_sin(hd, side, side, self.rope_theta,
                                      q.device)
        q = apply_rotary(q, cos, sin)
        n_rot = k.shape[-2] - num_k_exclude_rope
        if self.rope_k_repeat and n_rot != n_q:
            r = n_rot // n_q
            cos, sin = cos.repeat(r, 1), sin.repeat(r, 1)
        if num_k_exclude_rope > 0:
            k = torch.cat([apply_rotary(k[..., :n_rot, :], cos, sin),
                           k[..., n_rot:, :]], -2)
        else:
            k = apply_rotary(k, cos, sin)
        return self._merge(F.scaled_dot_product_attention(q, k, v))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: MemoryConfig):
        super().__init__()
        d = cfg.dim
        self.self_attn = RoPEAttention(d, cfg.num_heads,
                                       rope_theta=cfg.rope_theta)
        self.cross_attn_image = RoPEAttention(
            d, cfg.num_heads, 1, cfg.mem_dim, rope_theta=cfg.rope_theta,
            rope_k_repeat=True)
        self.linear1 = nn.Linear(d, cfg.ffn_dim)
        self.linear2 = nn.Linear(cfg.ffn_dim, d)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, tgt, memory, pos, num_k_exclude_rope: int = 0):
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2)
        t2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(t2, memory + pos, memory,
                                          num_k_exclude_rope)
        t2 = self.norm3(tgt)
        return tgt + self.linear2(F.relu(self.linear1(t2)))


class MemoryAttention(nn.Module):
    def __init__(self, cfg: MemoryConfig):
        super().__init__()
        self.layers = nn.ModuleList([MemoryAttentionLayer(cfg)
                                     for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(cfg.dim, eps=LN_EPS)

    def forward(self, curr, memory, curr_pos, memory_pos,
                num_obj_ptr_tokens: int = 0):
        """curr [B,T,C] current-frame tokens; memory [B,M,mem_dim] (the
        spatial memories and the trailing object-pointer tokens)."""
        x = curr + 0.1 * curr_pos
        for layer in self.layers:
            x = layer(x, memory, memory_pos, num_obj_ptr_tokens)
        return self.norm(x)


class _MaskDownSampler(nn.Module):
    """k3 s2 p1 convs 1 -> 4 -> 16 -> 64 -> 256 with LayerNorm2d + GELU,
    then a 1x1 conv to embed_dim (Sequential indices 0..12)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        enc = nn.Sequential()
        ch = 1
        for _ in range(4):
            enc.append(nn.Conv2d(ch, ch * 4, 3, 2, 1))
            enc.append(LayerNorm2d(ch * 4))
            enc.append(nn.GELU())
            ch *= 4
        enc.append(nn.Conv2d(ch, embed_dim, 1))
        self.encoder = enc

    def forward(self, m):
        return self.encoder(m)


class CXBlock(nn.Module):
    """ConvNeXt block: 7x7 depthwise conv, LayerNorm2d, 1x1 expand 4x,
    GELU, 1x1 project, layer scale."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(1e-6 * torch.ones(dim))

    def forward(self, x):
        h = self.norm(self.dwconv(x)).permute(0, 2, 3, 1)
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + (self.gamma * h).permute(0, 3, 1, 2)


class MemoryEncoder(nn.Module):
    def __init__(self, cfg: MemoryConfig):
        super().__init__()
        self.mask_downsampler = _MaskDownSampler(cfg.dim)
        self.pix_feat_proj = nn.Conv2d(cfg.dim, cfg.dim, 1)
        self.fuser = nn.Module()
        self.fuser.layers = nn.ModuleList([CXBlock(cfg.dim)
                                           for _ in range(2)])
        self.out_proj = nn.Conv2d(cfg.dim, cfg.mem_dim, 1)

    def forward(self, pix_feat, mask_for_mem):
        """pix_feat [B,C,h,w]; mask_for_mem [B,1,16h,16w] (sigmoid and
        scale/bias already applied) -> [B,mem_dim,h,w]."""
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler(
            mask_for_mem)
        for layer in self.fuser.layers:
            x = layer(x)
        return self.out_proj(x)
