"""CogVideoX 3D-full-attention DiT.

Port of the JAX ``langscenex_tpu/models/cogvideox/transformer.py``
(architecture of diffusers' CogVideoXTransformer3DModel): per-frame 2×2
patch embedding, text tokens prepended, joint full attention over
[text; all video patches] with qk-LayerNorm and 3D RoPE on the video
tokens only, adaLN-Zero ("expert" LayerNormZero with separate video/text
gates) from the sinusoidal timestep embedding, GELU (tanh) MLP, final
AdaLayerNorm and linear unpatchify.

The state_dict uses diffusers' keys (``patch_embed.proj``,
``transformer_blocks.N.attn1.to_q``, ``norm_out.linear`` …), so a
diffusers checkpoint loads as it is; ``convert.cogvideox_dit_from_numpy``
carries the JAX model's params across (the JAX model fuses q/k/v per
head; here they stay separate). ``proj_out`` rows are in diffusers'
(c, ph, pw) order and the unpatchify reads them so.

Kernels: LayerNormZero runs K8 (``ops/ln_modulate``) and the joint
attention K5 forward and K7 backward (``ops/flash_attention``) on CUDA
tensors;
``CogVideoXTransformer.set_use_kernels(False)`` runs their plain versions
on any device (the reference the kernels are held against on the
card). ``TransformerConfig.remat`` recomputes each block in the
backward (``torch.utils.checkpoint``), as the JAX ``nn.remat`` does for
training: only the residual stream between blocks is kept, and K5 and K8
run twice per block and step.
Shapes: latents [B, F, C, H, W], text [B, L, text_dim], timestep [B].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.flash_attention import attention_bthd
from ...ops.ln_modulate import ln_modulate, ln_modulate_plain
from ...utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    # defaults = CogVideoX-5b(-I2V) scale
    num_layers: int = 42
    num_heads: int = 48
    head_dim: int = 64
    in_channels: int = 32          # 16 noisy + 16 conditioning latents
    out_channels: int = 16
    patch_size: int = 2
    text_embed_dim: int = 4096
    time_embed_dim: int = 512
    use_rotary: bool = True
    rope_base: float = 10000.0
    attn_dtype: torch.dtype = torch.bfloat16
    remat: bool = False   # recompute each block in the backward (training)

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim


def sinusoidal_timestep(t: torch.Tensor, dim: int,
                        max_period: float = 10000.0) -> torch.Tensor:
    """[cos, sin] timestep features [B, dim] in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_3d(cfg: TransformerConfig, frames: int, height: int, width: int,
            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D rotary tables over the (t, h, w) patch grid: head_dim split 1/4
    temporal, 3/8 height, 3/8 width. Returns (cos, sin), each
    [frames·height·width, head_dim // 2] f32."""
    if cfg.head_dim % 16:
        raise ValueError("3D RoPE needs head_dim % 16 == 0")
    dims = (cfg.head_dim // 4, cfg.head_dim * 3 // 8, cfg.head_dim * 3 // 8)

    def axis_freqs(n, dim):
        inv = 1.0 / (cfg.rope_base ** (torch.arange(
            0, dim, 2, dtype=torch.float32, device=device) / dim))
        return torch.outer(torch.arange(n, dtype=torch.float32,
                                        device=device), inv)

    ft, fh, fw = (axis_freqs(n, d) for n, d in zip((frames, height, width),
                                                   dims))
    shape = (frames, height, width)
    freqs = torch.cat([
        ft[:, None, None, :].expand(*shape, -1),
        fh[None, :, None, :].expand(*shape, -1),
        fw[None, None, :, :].expand(*shape, -1)], dim=-1)
    freqs = freqs.reshape(frames * height * width, -1)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Interleaved-pair rotation of x [..., T, D] (diffusers
    ``apply_rotary_emb`` with ``use_real_unbind_dim=-1``)."""
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def rope_full_tables(cos: torch.Tensor, sin: torch.Tensor, text_len: int):
    """Full-width tables (C, S), each [text_len + T_video, D], such that
    ``x·C + swap_pairs(x)·S`` is the interleaved rotation on video rows
    and the identity on text rows."""
    half = cos.shape[1]
    c = torch.repeat_interleave(cos, 2, dim=-1)
    sgn = torch.where(torch.arange(2 * half, device=cos.device) % 2 == 1,
                      1.0, -1.0)
    s = torch.repeat_interleave(sin, 2, dim=-1) * sgn[None]
    c = torch.cat([torch.ones((text_len, 2 * half), dtype=c.dtype,
                              device=c.device), c], 0)
    s = torch.cat([torch.zeros((text_len, 2 * half), dtype=s.dtype,
                               device=s.device), s], 0)
    return c, s


def apply_rope_fused(x: torch.Tensor, cos_full: torch.Tensor,
                     sin_full: torch.Tensor) -> torch.Tensor:
    """Rotation over the whole joint sequence with the tables of
    :func:`rope_full_tables` (broadcast against x [..., T, D])."""
    D = x.shape[-1]
    xs = x.reshape(x.shape[:-1] + (D // 2, 2)).flip(-1).reshape(x.shape)
    return x * cos_full.to(x.dtype) + xs * sin_full.to(x.dtype)


class LayerNormZero(nn.Module):
    """CogVideoXLayerNormZero: SiLU(temb) → 6·hidden (shift, scale, gate
    for the video rows, then for the text rows); LayerNorm of the joint
    stream modulated per stream (K8), and the two gates."""

    def __init__(self, time_dim: int, hidden: int):
        super().__init__()
        self.linear = nn.Linear(time_dim, 6 * hidden)
        self.norm = nn.LayerNorm(hidden, eps=1e-5)
        self.use_kernels = True

    def forward(self, x, temb, text_len: int):
        emb = self.linear(F.silu(temb))
        shift, scale, gate, t_shift, t_scale, t_gate = emb.chunk(6, dim=-1)
        fn = ln_modulate if self.use_kernels else ln_modulate_plain
        out = fn(x, self.norm.weight, self.norm.bias, scale, shift, t_scale,
                 t_shift, text_len)
        return out, gate[:, None], t_gate[:, None]


class JointAttention(nn.Module):
    """Joint attention over the [text; video] stream [B, T, hidden] in the
    [B, T, H, D] layout: separate q/k/v projections, qk-LayerNorm, the
    fused RoPE, K5."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.to_q = nn.Linear(h, h)
        self.to_k = nn.Linear(h, h)
        self.to_v = nn.Linear(h, h)
        self.norm_q = nn.LayerNorm(cfg.head_dim, eps=1e-6)
        self.norm_k = nn.LayerNorm(cfg.head_dim, eps=1e-6)
        self.to_out = nn.ModuleList([nn.Linear(h, h), nn.Identity()])
        self.use_kernels = True

    def qkv(self, x, rope):
        """(q, k, v) [B, T, H, D] after qk-norm and RoPE."""
        cfg = self.cfg
        B, T, _ = x.shape

        def heads(lin):
            return lin(x).view(B, T, cfg.num_heads, cfg.head_dim)

        q = self.norm_q(heads(self.to_q))
        k = self.norm_k(heads(self.to_k))
        v = heads(self.to_v)
        if rope is not None:
            cos_full, sin_full = rope
            q = apply_rope_fused(q, cos_full[:, None], sin_full[:, None])
            k = apply_rope_fused(k, cos_full[:, None], sin_full[:, None])
        return q, k, v

    def forward(self, x, rope):
        cfg = self.cfg
        B, T, _ = x.shape
        q, k, v = self.qkv(x, rope)
        out = attention_bthd(q, k, v, dtype=cfg.attn_dtype,
                             plain=not self.use_kernels)
        return self.to_out[0](out.reshape(B, T, cfg.hidden))


class _GELUProj(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """diffusers FeedForward(gelu-approximate): ``net.0.proj``, ``net.2``."""

    def __init__(self, hidden: int):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(hidden, 4 * hidden),
                                  nn.Identity(),
                                  nn.Linear(4 * hidden, hidden)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class Block(nn.Module):
    """One DiT block on the joint [text; video] residual stream; the first
    ``text_len`` rows are text."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.norm1 = LayerNormZero(cfg.time_embed_dim, cfg.hidden)
        self.attn1 = JointAttention(cfg)
        self.norm2 = LayerNormZero(cfg.time_embed_dim, cfg.hidden)
        self.ff = FeedForward(cfg.hidden)

    def forward(self, x, temb, rope, text_len: int):
        def gated(y, g, tg):
            return torch.cat([tg * y[:, :text_len], g * y[:, text_len:]],
                             dim=1)

        n, g, tg = self.norm1(x, temb, text_len)
        x = x + gated(self.attn1(n, rope), g, tg)
        n, g, tg = self.norm2(x, temb, text_len)
        return x + gated(self.ff(n), g, tg)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden, p, stride=p)
        self.text_proj = nn.Linear(cfg.text_embed_dim, cfg.hidden)


class _TimestepEmbedding(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.linear_1 = nn.Linear(cfg.hidden, cfg.time_embed_dim)
        self.linear_2 = nn.Linear(cfg.time_embed_dim, cfg.time_embed_dim)


class _AdaLayerNorm(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.linear = nn.Linear(cfg.time_embed_dim, 2 * cfg.hidden)
        self.norm = nn.LayerNorm(cfg.hidden, eps=1e-5)


class CogVideoXTransformer(nn.Module):
    """The DiT, its parameters allocated on ``device`` (the GPU unless the
    caller names another; ``"meta"`` allocates nothing)."""

    def __init__(self, cfg: TransformerConfig = TransformerConfig(),
                 device: torch.device | str | None = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.patch_embed = _PatchEmbed(cfg)
            self.time_embedding = _TimestepEmbedding(cfg)
            self.transformer_blocks = nn.ModuleList(
                [Block(cfg) for _ in range(cfg.num_layers)])
            self.norm_final = nn.LayerNorm(cfg.hidden, eps=1e-5)
            self.norm_out = _AdaLayerNorm(cfg)
            self.proj_out = nn.Linear(
                cfg.hidden, cfg.patch_size ** 2 * cfg.out_channels)

    def embed(self, latents, text, timestep):
        """(joint stream [B, L + F·Hp·Wp, hidden], temb [B, time_dim],
        rope tables or None) before the first block."""
        cfg = self.cfg
        B, Fr, C, H, W = latents.shape
        p = cfg.patch_size
        x = self.patch_embed.proj(latents.reshape(B * Fr, C, H, W))
        x = x.flatten(2).transpose(1, 2).reshape(B, -1, cfg.hidden)
        text_h = self.patch_embed.text_proj(text)
        te = self.time_embedding
        temb = sinusoidal_timestep(timestep, cfg.hidden).to(
            te.linear_1.weight.dtype)
        temb = te.linear_2(F.silu(te.linear_1(temb))).to(latents.dtype)
        rope = None
        if cfg.use_rotary:
            rope = rope_full_tables(
                *rope_3d(cfg, Fr, H // p, W // p, device=latents.device),
                text_len=text.shape[1])
        return torch.cat([text_h, x], dim=1), temb, rope

    def head(self, joint, temb, text_len: int, shape) -> torch.Tensor:
        """Final norms, AdaLayerNorm and unpatchify of the video rows to
        [B, F, C_out, H, W]; ``shape`` is the latents' (B, F, C, H, W)."""
        cfg = self.cfg
        B, Fr, _, H, W = shape
        p = cfg.patch_size
        video = self.norm_final(joint)[:, text_len:]
        shift, scale = self.norm_out.linear(F.silu(temb)).chunk(2, dim=-1)
        video = (self.norm_out.norm(video) * (1 + scale[:, None])
                 + shift[:, None])
        video = self.proj_out(video)
        video = video.reshape(B, Fr, H // p, W // p, cfg.out_channels, p, p)
        return video.permute(0, 1, 4, 2, 5, 3, 6).reshape(
            B, Fr, cfg.out_channels, H, W)

    def forward(self, latents: torch.Tensor, text: torch.Tensor,
                timestep: torch.Tensor) -> torch.Tensor:
        """latents [B,F,C,H,W], text [B,L,text_dim], timestep [B] ->
        noise prediction [B,F,out_channels,H,W]."""
        joint, temb, rope = self.embed(latents, text, timestep)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.transformer_blocks:
            if remat:
                joint = checkpoint(blk, joint, temb, rope, text.shape[1],
                                   use_reentrant=False)
            else:
                joint = blk(joint, temb, rope, text.shape[1])
        return self.head(joint, temb, text.shape[1], latents.shape)

    def set_use_kernels(self, flag: bool) -> None:
        """Run K5/K8 (True) or their plain versions (False) from now on,
        with the same weights."""
        for m in self.modules():
            if isinstance(m, (LayerNormZero, JointAttention)):
                m.use_kernels = flag


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in place: normal with std 1/sqrt(fan_in) for
    every linear and convolution weight, zero biases, unit norm scales
    and zero norm shifts."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
